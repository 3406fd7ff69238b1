"""The training API of the PyTorch port against the JAX package.

Validation sets binned with ``Dataset(reference=)`` (and file input),
per-iteration ``record_evaluation`` histories, early stopping from the
params and from the callback (``min_delta``, ``first_metric_only``),
continued training from ``init_model`` (a port model file and the
reference's ``reg_model.txt``), ``rollback_one_iter``,
``reset_parameter`` and ``feval``: same params, same data (made with
numpy from a seed), both packages on the CPU.

Regression (L2) is the JAX package's bit for bit in the port on the CPU
(``tests/test_torch_train.py``), so its histories, best iterations,
trees and scores are held bit for bit. Binary goes through ``exp``,
whose last ulp differs between XLA's CPU and torch (ROADMAP C1(a)): its
metric histories are held within 1e-6.
"""
import gc
import os
import weakref

import numpy as np
import pytest
import torch
from conftest import GOLDEN_DIR, load_golden_csv

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = {"device_type": "cpu"}


def _trees(model_str):
    """The tree blocks of a model's text."""
    return model_str[model_str.index("Tree=0"):
                     model_str.index("end of trees")]


def _data(rng, objective, n=600, f=6, noise=0.5):
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.05, 2] = np.nan
    signal = X[:, 0] * 2 + np.sin(X[:, 1] * 3) - np.nan_to_num(X[:, 2])
    if objective == "binary":
        return X, (signal + rng.normal(size=n) > 0).astype(np.float64)
    return X, signal + rng.normal(scale=noise, size=n)


def _params(objective, **extra):
    return {"objective": objective, "num_leaves": 15, "verbosity": -1,
            "min_data_in_leaf": 5, **CPU, **extra}


def _both(rng, objective, n_valid=2, n=600):
    """Training and validation data, and each package's Datasets."""
    X, y = _data(rng, objective, n)
    valid = [_data(rng, objective, 300) for _ in range(n_valid)]
    out = {}
    for pkg in (lgb, lgt):
        tr = pkg.Dataset(X, label=y)
        out[pkg] = (tr, [tr.create_valid(Xv, label=yv)
                         for Xv, yv in valid])
    return X, y, valid, out


def test_reference_dataset_bins_equal_jax(rng):
    X, y = _data(rng, "regression")
    Xv = rng.normal(size=(300, 6)) * 2          # outside the train range
    Xv[::7, 3] = np.nan
    jtr, ttr = lgb.Dataset(X, label=y), lgt.Dataset(X, label=y)
    jv = lgb.Dataset(Xv, label=Xv[:, 0], reference=jtr)
    tv = lgt.Dataset(Xv, label=Xv[:, 0], reference=ttr)
    np.testing.assert_array_equal(tv.binned.bins.T, jv.binned.bins)
    assert tv.binned.bin_mappers is ttr.binned.bin_mappers
    assert tv.binned.max_bin == ttr.binned.max_bin == 255
    s = lgt.Dataset(Xv, label=Xv[:, 0]).set_reference(ttr)
    np.testing.assert_array_equal(s.binned.bins, tv.binned.bins)
    with pytest.raises(LightGBMError, match="constructed"):
        s.set_reference(lgt.Dataset(X, label=y))


def test_file_dataset_bins_equal_jax():
    path = os.path.join(GOLDEN_DIR, "reg_train.csv")
    jd, td = lgb.Dataset(path), lgt.Dataset(path)
    np.testing.assert_array_equal(td.binned.bins.T, jd.binned.bins)
    np.testing.assert_array_equal(td.binned.metadata.label,
                                  jd.binned.metadata.label)
    y, X = load_golden_csv("reg_train.csv")
    np.testing.assert_array_equal(td.binned.bins,
                                  lgt.Dataset(X, label=y).binned.bins)
    assert td.num_data() == len(y) and td.num_feature() == X.shape[1]
    tv = td.create_valid(path)
    np.testing.assert_array_equal(tv.binned.bins, td.binned.bins)


def test_libsvm_file_dataset_equal_jax(tmp_path):
    path = tmp_path / "d.svm"
    path.write_text("1 0:0.5 2:1.5\n0 1:2.0\n1 0:-1 1:3 2:0.25\n" * 30)
    jd, td = lgb.Dataset(str(path)), lgt.Dataset(str(path))
    np.testing.assert_array_equal(td.binned.bins.T, jd.binned.bins)
    np.testing.assert_array_equal(td.binned.metadata.label,
                                  jd.binned.metadata.label)


@pytest.mark.parametrize("objective,metrics", [
    pytest.param("regression", ["l2", "auc"], id="regression"),
    pytest.param("binary", ["binary_logloss", "auc"], id="binary")])
def test_record_evaluation_matches_jax(rng, objective, metrics):
    _, _, _, ds = _both(rng, objective)
    params = _params(objective, metric=metrics)
    hist = {}
    for pkg in (lgb, lgt):
        tr, vs = ds[pkg]
        rec = {}
        pkg.train(params, tr, num_boost_round=8, valid_sets=[tr] + vs,
                  valid_names=["train", "va", "vb"],
                  callbacks=[pkg.record_evaluation(rec)])
        hist[pkg] = rec
    assert list(hist[lgt]) == ["train", "va", "vb"]
    for name in hist[lgb]:
        for m in metrics:
            j, t = hist[lgb][name][m], hist[lgt][name][m]
            assert len(t) == len(j) == 8
            if objective == "regression":
                assert t == j, (name, m)
            else:
                np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=m)


@pytest.mark.parametrize("extra,callback", [
    pytest.param({"early_stopping_round": 3}, None, id="params"),
    pytest.param({"early_stopping_round": 3,
                  "early_stopping_min_delta": 0.02}, None, id="min_delta"),
    pytest.param({"early_stopping_round": 3, "first_metric_only": True,
                  "metric": ["auc", "l2"]}, None, id="first_metric_only"),
    pytest.param({"metric": ["l2", "auc"]}, (4, False, [0.01, 0.0]),
                 id="callback")])
def test_early_stopping_matches_jax(rng, extra, callback):
    _, _, valid, ds = _both(rng, "regression", n_valid=1)
    params = _params("regression", learning_rate=0.3, num_leaves=31,
                     **extra)
    out = {}
    for pkg in (lgb, lgt):
        tr, vs = ds[pkg]
        cbs = ([pkg.early_stopping(*callback[:2], verbose=False,
                                   min_delta=callback[2])]
               if callback else None)
        out[pkg] = pkg.train(params, tr, num_boost_round=60,
                             valid_sets=vs, callbacks=cbs)
    jb, tb = out[lgb], out[lgt]
    assert 0 < tb.best_iteration < 60
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees() == jb.num_trees() < 60
    assert tb.best_score == jb.best_score
    Xv = valid[0][0]
    np.testing.assert_array_equal(tb.predict(Xv), jb.predict(Xv))
    assert not np.array_equal(
        tb.predict(Xv), tb.predict(Xv, num_iteration=tb.num_trees()))


def test_min_delta_stops_sooner(rng):
    _, _, _, ds = _both(rng, "regression", n_valid=1)
    tr, vs = ds[lgt]
    base = _params("regression", learning_rate=0.3, early_stopping_round=3)
    b0 = lgt.train(base, tr, num_boost_round=60, valid_sets=vs)
    b1 = lgt.train({**base, "early_stopping_min_delta": 0.05}, tr,
                   num_boost_round=60, valid_sets=vs)
    assert b1.best_iteration <= b0.best_iteration


@pytest.mark.parametrize("source", ["port_file", "reg_model"])
def test_init_model_continuation_matches_jax(rng, tmp_path, source):
    if source == "reg_model":
        y, X = load_golden_csv("reg_train.csv")
        path = os.path.join(GOLDEN_DIR, "reg_model.txt")
    else:
        X, y = _data(rng, "regression")
        path = str(tmp_path / "m.txt")
        lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                  num_boost_round=5).save_model(path)
    params = _params("regression")
    Xv, yv = X[::3] + 0.1, y[::3]
    out = {}
    for pkg in (lgb, lgt):
        tr = pkg.Dataset(X, label=y)
        out[pkg] = pkg.train(params, tr, num_boost_round=4,
                             init_model=path,
                             valid_sets=[tr.create_valid(Xv, label=yv)],
                             keep_training_booster=True)
    jb, tb = out[lgb], out[lgt]
    n_init = lgt.Booster(CPU, model_file=path).num_trees()
    assert tb.num_trees() == jb.num_trees() == n_init + 4
    assert _trees(tb.model_to_string()) == _trees(jb.model_to_string())
    np.testing.assert_array_equal(tb._engine.score.numpy(),
                                  np.asarray(jb._engine.score))
    np.testing.assert_array_equal(tb._engine.valid_sets[0].score.numpy(),
                                  np.asarray(jb._engine.valid_sets[0].score))
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))


@pytest.mark.parametrize("extra", [
    {"tpu_row_scheduling": "compact"}, {"tpu_row_scheduling": "full"},
    {"tpu_row_scheduling": "level"},
    {"use_quantized_grad": True, "max_bin": 511, "min_data_in_bin": 1}],
    ids=["compact", "full", "level", "quantized-u16"])
def test_replayed_text_gives_the_trained_score_bit_for_bit(rng, extra):
    """A model replayed from its text (init_model) gives the training and
    validation scores it ended with, bit for bit, and keeps its trees,
    whichever grower built it."""
    X, y = _data(rng, "binary")
    Xv, yv = _data(rng, "binary", 300)
    params = _params("binary", **extra)
    tr = lgt.Dataset(X, label=y)
    b1 = lgt.train(params, tr, num_boost_round=6,
                   valid_sets=[tr.create_valid(Xv, label=yv)])
    loaded = lgt.Booster(CPU, model_str=b1.model_to_string())
    b2 = lgt.Booster(params, lgt.Dataset(X, label=y))
    assert b2._engine.train_set.bins.dtype == (
        np.uint16 if "max_bin" in extra else np.uint8)
    b2._engine.init_from_model(loaded._engine)
    b2.add_valid(b2.train_set.create_valid(Xv, label=yv), "va")
    np.testing.assert_array_equal(b2._engine.score.numpy(),
                                  b1._engine.score.numpy())
    np.testing.assert_array_equal(b2._engine.valid_sets[0].score.numpy(),
                                  b1._engine.valid_sets[0].score.numpy())
    b2.update()
    assert _trees(b2.model_to_string()).startswith(
        _trees(b1.model_to_string()))
    assert loaded._engine.models[0].from_text      # the source is intact


def test_valid_score_equals_host_walk(rng):
    X, y = _data(rng, "binary")
    Xv, yv = _data(rng, "binary", 300)
    tr = lgt.Dataset(X, label=y)
    seen = []

    def check(env):
        vs = env.model._engine.valid_sets[0].score[0].numpy()
        raw = env.model.predict(Xv, raw_score=True,
                                num_iteration=env.iteration + 1)
        seen.append(float(np.abs(vs - raw).max()))

    lgt.train(_params("binary"), tr, num_boost_round=5,
              valid_sets=[tr.create_valid(Xv, label=yv)], callbacks=[check])
    assert len(seen) == 5 and max(seen) < 1e-5


def test_rollback_matches_jax(rng):
    X, y, valid, _ = _both(rng, "regression", n_valid=1)
    params = _params("regression")
    state = {}
    for pkg in (lgb, lgt):
        tr = pkg.Dataset(X, label=y)
        b = pkg.Booster(params, tr)
        b.add_valid(tr.create_valid(*valid[0]), "va")
        for _ in range(3):
            b.update()
        score = [np.array(b._engine.score),
                 np.array(b._engine.valid_sets[0].score)]
        b.update()
        b.rollback_one_iter()
        after = [np.array(b._engine.score),
                 np.array(b._engine.valid_sets[0].score)]
        b.update()
        state[pkg] = (score, after, b.model_to_string(), b.num_trees())
    (js, ja, jm, jn), (ts, ta, tm, tn) = state[lgb], state[lgt]
    assert tn == jn == 4 and _trees(tm) == _trees(jm)
    for j, t in zip(ja, ta):
        np.testing.assert_array_equal(t, j)
    for before, back in zip(ts, ta):        # one f32 rounding of a + d - d
        np.testing.assert_allclose(back, before, rtol=0,
                                   atol=4 * 2.0 ** -23 * np.abs(before).max())


def test_rollback_keeps_init_model_trees(rng):
    X, y = _data(rng, "regression")
    first = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                      num_boost_round=3)
    b = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                  num_boost_round=1, init_model=first,
                  keep_training_booster=True)
    b.rollback_one_iter().rollback_one_iter()
    assert b.num_trees() == 3
    np.testing.assert_array_equal(b.predict(X), first.predict(X))


def test_reset_parameter_callback_matches_jax(rng):
    X, y = _data(rng, "regression")
    rates = [0.3, 0.2, 0.1, 0.05, 0.05]
    text = {}
    for pkg in (lgb, lgt):
        b = pkg.train(_params("regression"), pkg.Dataset(X, label=y),
                      num_boost_round=5,
                      callbacks=[pkg.reset_parameter(learning_rate=rates)])
        text[pkg] = _trees(b.model_to_string())
    assert text[lgt] == text[lgb]
    assert "shrinkage=0.3\n" in text[lgt] and "shrinkage=0.05\n" in text[lgt]


def test_feval_and_eval_match_jax(rng):
    X, y, valid, _ = _both(rng, "regression", n_valid=1)

    def max_err(raw, dataset):
        label = dataset.binned.metadata.label
        return "max_err", float(np.abs(raw - label).max()), False

    res = {}
    for pkg in (lgb, lgt):
        tr = pkg.Dataset(X, label=y)
        vs = tr.create_valid(*valid[0])
        rec = {}
        b = pkg.train(_params("regression"), tr, num_boost_round=4,
                      valid_sets=[vs], valid_names=["va"], feval=max_err,
                      callbacks=[pkg.record_evaluation(rec)],
                      keep_training_booster=True)
        res[pkg] = (rec, b.eval(vs, "again", feval=max_err),
                    b.eval(tr, "train"))
    assert res[lgt] == res[lgb]
    assert res[lgt][0]["va"]["max_err"][-1] > 0


def test_log_evaluation_and_callback_order(rng, capfd):
    X, y = _data(rng, "regression")
    order = []

    def before(env):
        order.append(("before", env.iteration,
                      env.model.current_iteration()))
    before.before_iteration = True

    def after(env):
        order.append(("after", env.iteration, len(env.evaluation_result_list)))
    after.order = 5

    tr = lgt.Dataset(X, label=y)
    lgt.train({**_params("regression"), "verbosity": 1}, tr,
              num_boost_round=2, valid_sets=[tr], valid_names=["t"],
              callbacks=[lgt.log_evaluation(1), before, after])
    assert order == [("before", 0, 0), ("after", 0, 1),
                     ("before", 1, 1), ("after", 1, 1)]
    assert "[2]\tt's l2:" in capfd.readouterr().err


def test_keep_training_booster(rng):
    X, y = _data(rng, "regression")
    kept = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                     num_boost_round=2, keep_training_booster=True)
    kept.update()
    assert kept.num_trees() == 3
    freed = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                      num_boost_round=2)
    with pytest.raises(LightGBMError, match="no training data"):
        freed.update()


@pytest.mark.parametrize("weighted", [False, True])
def test_device_metrics_equal_host_metrics(rng, weighted):
    """``tpu_device_eval=true`` computes each metric on the score's
    device (here the CPU) in f64; the values equal the host path's."""
    X, y = _data(rng, "binary")
    w = rng.uniform(0.5, 2.0, size=len(y)) if weighted else None
    params = _params("binary", metric=["binary_logloss", "auc"])
    out = {}
    for mode in ("false", "true"):
        b = lgt.Booster({**params, "tpu_device_eval": mode},
                        lgt.Dataset(X, label=y, weight=w))
        b.update()
        b._engine.score[0, ::5] = 0.25     # runs of tied scores for AUC
        out[mode] = b.eval_train()
    for (_, n, v, h), (_, n2, v2, h2) in zip(out["false"], out["true"]):
        assert (n, h) == (n2, h2)
        np.testing.assert_allclose(v2, v, rtol=1e-12, err_msg=n)


@pytest.mark.parametrize("weighted", [False, True])
def test_device_auc_equals_host_auc_with_ties(rng, weighted):
    from lightgbm_tpu_torch.core.metrics import AUCMetric, _auc
    from lightgbm_tpu_torch.io.dataset_core import Metadata
    n = 5000
    md = Metadata(n)
    md.set_label((rng.uniform(size=n) < 0.3).astype(np.float32))
    md.set_weight(rng.uniform(0.1, 3.0, size=n) if weighted else None)
    m = AUCMetric(lgt.Config())
    m.init(md, n)
    for score in (np.round(rng.normal(size=n), 1),    # long runs of ties
                  np.zeros(n), rng.normal(size=n)):
        host = _auc(md.label > 0, score, m.weight)
        (_, dev, hib), = m.eval_device(torch.as_tensor(score,
                                                       dtype=torch.float32))
        assert hib and dev.dtype == torch.float64 and dev.dim() == 0
        np.testing.assert_allclose(float(dev), host, rtol=1e-12)
    md.set_label(np.ones(n, np.float32))
    m.init(md, n)
    (_, dev, _), = m.eval_device(torch.zeros(n))
    assert float(dev) == 1.0


@pytest.mark.parametrize("what", ["ranking_objective",
                                  "tpu_fallback_to_cpu", "reset_parameter",
                                  "valid_without_reference"])
def test_unported_training_api_is_refused(rng, what):
    X, y = _data(rng, "regression")
    tr = lgt.Dataset(X, label=y)
    params = _params("regression")
    kw = {}
    # ranking without query data (Dataset(group=)) is refused
    match = {"ranking_objective": "require query information",
             "tpu_fallback_to_cpu": "does not fall back",
             "reset_parameter": "tpu_num_devices=2 in a world of 1",
             "valid_without_reference": "reference="}[what]
    if what == "ranking_objective":
        params["objective"] = "lambdarank"
    elif what == "tpu_fallback_to_cpu":
        params["tpu_fallback_to_cpu"] = True
    elif what == "valid_without_reference":
        kw["valid_sets"] = [lgt.Dataset(X, label=y)]
    with pytest.raises(LightGBMError, match=match):
        if what == "reset_parameter":
            b = lgt.Booster(params, tr)
            b.reset_parameter({"tree_learner": "voting",
                               "tpu_num_devices": 2})
        else:
            lgt.train(params, tr, num_boost_round=2, **kw)


def test_train_on_cuda_without_a_card_raises_for_init_model(rng,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(rng, "regression")
    with pytest.raises(LightGBMError, match="device_type"):
        lgt.train({"objective": "regression", "verbosity": -1},
                  lgt.Dataset(X, label=y), num_boost_round=1,
                  init_model=os.path.join(GOLDEN_DIR, "reg_model.txt"))


def test_resume_from_finishes_the_run_as_the_jax_package(rng, tmp_path):
    """``resume_from`` (once refused, ROADMAP A12.7): a run that stopped
    after 3 checkpointed rounds, resumed to 5, gives the JAX package's
    resumed L2 model and the port's own uninterrupted one, string for
    string."""
    X, y = _data(rng, "regression")
    out = {}
    for pkg in (lgb, lgt):
        ckdir = str(tmp_path / pkg.__name__)
        params = _params("regression")
        pkg.train(params, pkg.Dataset(X, label=y), num_boost_round=3,
                  callbacks=[pkg.checkpoint_callback(ckdir)])
        out[pkg] = pkg.train(params, pkg.Dataset(X, label=y),
                             num_boost_round=5, resume_from=ckdir)
    full = lgt.train(_params("regression"), lgt.Dataset(X, label=y),
                     num_boost_round=5)
    assert out[lgt].current_iteration() == 5
    assert _trees(out[lgt].model_to_string()) == \
        _trees(out[lgb].model_to_string()) == _trees(full.model_to_string())


def test_dropped_booster_frees_its_engine_without_the_cyclic_collector(rng):
    """The model list holds its engine's generation bump weakly, so a
    Booster that is dropped frees its engine (and on the card its device
    tensors) at once, not when the cyclic collector next runs; the bump
    still reaches a live engine."""
    X, y = _data(rng, "regression")
    b = lgt.Booster(_params("regression"), lgt.Dataset(X, label=y))
    b.update()
    b.update()
    gen = b._engine._model_gen
    b.rollback_one_iter()
    assert b._engine._model_gen == gen + 1
    engine = weakref.ref(b._engine)
    gc.disable()
    try:
        del b
        assert engine() is None
    finally:
        gc.enable()
