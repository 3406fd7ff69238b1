"""Multiclass training in the PyTorch port against the JAX package.

Softmax (``multiclass``) and one-vs-all (``multiclassova``) grow K trees
an iteration, one per class, through the compact, hybrid (level) and full
growers, with quantized gradients and over u16 bins (``max_bin=1023``),
softmax also through the pure level grower and the full one over u16
bins, at 2,000 rows, 7 features, 3 classes, 15 leaves, 4
rounds.

The trees are held to the binary standard of ``tests/test_torch_train.py``:
the gradients go through ``exp``, whose last ulp differs between XLA's CPU
and torch (ROADMAP C1(a)), so a near-tie may be decided differently. Split
features, counts and shapes are identical; ``default_left`` may differ only
at a node with no missing value, and a threshold only where no row of the
node lies between the two thresholds (an equal-gain run of bins empty at
that node, told apart by the rounding left in a histogram obtained by
subtraction): each node sends the same training rows left in both
packages. Hessian sums agree to 1e-6 · N · max h, leaf values to
1e-6 · rate · N · max|g| / H, raw scores to 1e-5 of their largest
magnitude, probabilities to rtol 1e-5 (atol 1e-7), the training metric to
rtol 1e-6.

A custom objective with dyadic gradients and ``num_class=3`` has no
``exp``: its trees, its model text (bar the parameters block) and its
scores are the JAX package's bit for bit, which checks the K-tree
plumbing alone.
"""
import numpy as np
import pytest
import torch
from test_torch_model_io import _no_params
from test_torch_train import STRUCTURE_KEYS, _rows_at_nodes, _trees

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

K = 3
N = 2000
ROUNDS = 4
RATE = 0.1
PATHS = {"compact": {},
         "hybrid": {"tpu_row_scheduling": "level"},
         "full": {"tpu_row_scheduling": "full"},
         "quantized": {"use_quantized_grad": True},
         "max_bin_1023": {"max_bin": 1023}}
# softmax on the pure level grower and on the full one over u16 bins
MORE_PATHS = {"full_quantized_max_bin_1023": {"tpu_row_scheduling": "full",
                                              "use_quantized_grad": True,
                                              "max_bin": 1023},
              "level_depth_4_quantized": {"tpu_row_scheduling": "level",
                                          "max_depth": 4,
                                          "use_quantized_grad": True}}


def _data(rng, n=N, f=7, k=K):
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    s = np.stack([X[:, 0], X[:, 1] - X[:, 2], 0.5 * X[:, 4] ** 2,
                  np.nan_to_num(X[:, 3]) - X[:, 5]][:k])
    y = np.argmax(s + 0.5 * rng.normal(size=s.shape), axis=0)
    return X, y.astype(np.float64)


def _params(objective, **extra):
    return {"objective": objective, "num_class": K, "num_leaves": 15,
            "learning_rate": RATE, "device_type": "cpu", "verbosity": -1,
            **extra}


def _max_grad_hess(objective):
    # |p - onehot| <= 1; softmax h = K/(K-1) p (1-p), OVA h = p (1-p)
    return 1.0, (K / (K - 1.0) if objective == "multiclass" else 1.0) / 4


def assert_trees_to_binary_standard(jb, tb, X, objective=None,
                                    g_max=None, h_max=None, rate=RATE,
                                    converted=True, bags=None):
    """The binary standard (module docstring) over every tree; ``g_max``
    and ``h_max`` bound a row's |gradient| and hessian (by default the
    multiclass ``objective``'s). ``converted=False`` for an objective
    whose prediction is the raw score (ranking), held by the raw check
    alone. ``bags`` gives each tree's bool row mask under row sampling:
    a row out of the bag adds nothing to a histogram, so only the bag's
    rows of a node count there, and the predictions are held on the rows
    of every bag."""
    n = len(X)
    if g_max is None:
        g_max, h_max = _max_grad_hess(objective)
    jt, tt = _trees(jb.model_to_string()), _trees(tb.model_to_string())
    assert len(tt) == len(jt)
    for ti, (j, t, host) in enumerate(zip(jt, tt, jb._engine.models)):
        for key in STRUCTURE_KEYS:
            if key != "threshold":
                assert t[key] == j[key], key
        node_rows = _rows_at_nodes(host, X) if host.num_leaves > 1 else []
        if bags is not None:
            node_rows = [rows & bags[ti] for rows in node_rows]
        jthr = np.asarray(j["threshold"].split(), float) \
            if "threshold" in j else np.zeros(0)
        tthr = np.asarray(t["threshold"].split(), float) \
            if "threshold" in t else np.zeros(0)
        for i in np.flatnonzero(tthr != jthr):
            x = X[node_rows[i], host.split_feature[i]]
            lo, hi = sorted((tthr[i], jthr[i]))
            assert not ((x > lo) & (x <= hi)).any(), (i, lo, hi)
        if "decision_type" in j:
            jd = np.asarray(j["decision_type"].split(), int)
            td = np.asarray(t["decision_type"].split(), int)
            np.testing.assert_array_equal(td & ~2, jd & ~2)
            for i in np.flatnonzero(td != jd):
                assert not np.isnan(
                    X[node_rows[i], host.split_feature[i]]).any()
        tw, jw = (np.asarray(v["leaf_weight"].split(), float)
                  for v in (t, j))
        tv, jv = (np.asarray(v["leaf_value"].split(), float)
                  for v in (t, j))
        np.testing.assert_array_less(np.abs(tw - jw), 1e-6 * n * h_max)
        if len(jw) > 1:
            np.testing.assert_array_less(np.abs(tv - jv),
                                         1e-6 * rate * n * g_max / jw)
    if bags is not None:
        # a row outside a tree's bag may lie between its two thresholds:
        # the predictions are held on the rows of every bag
        X = X[np.logical_and.reduce(bags)]
    jraw = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jraw, rtol=0,
                               atol=1e-5 * np.abs(jraw).max())
    if converted:
        np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))


@pytest.mark.parametrize("objective,path", [
    *((obj, path) for obj in ("multiclass", "multiclassova")
      for path in PATHS),
    *(("multiclass", path) for path in MORE_PATHS)])
def test_multiclass_matches_jax(rng, objective, path):
    X, y = _data(rng)
    params = _params(objective, metric=["multi_logloss", "multi_error"],
                     **{**PATHS, **MORE_PATHS}[path])
    jds, tds = lgb.Dataset(X, label=y), lgt.Dataset(X, label=y)
    jb = lgb.train(params, jds, num_boost_round=ROUNDS, valid_sets=[jds],
                   valid_names=["train"])
    tb = lgt.train(params, tds, num_boost_round=ROUNDS, valid_sets=[tds],
                   valid_names=["train"])
    assert tb.num_trees() == jb.num_trees() == ROUNDS * K
    assert tb.num_model_per_iteration() == K
    if path.endswith("max_bin_1023"):
        assert tds.binned.bins.dtype == np.uint16
    assert_trees_to_binary_standard(jb, tb, X, objective)
    prob = tb.predict(X)
    assert prob.shape == (N, K)
    if objective == "multiclass":
        np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    for metric in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(tb.best_score["train"][metric],
                                   jb.best_score["train"][metric], rtol=1e-6)


def _dyadic_fobj(y):
    """A custom objective whose gradients are multiples of 1/8 and
    hessians 1: sums add exactly, so every tree is determined bit for
    bit."""
    onehot = (y[None, :] == np.arange(K)[:, None]).astype(np.float64)

    def fobj(score, dataset):
        assert score.shape == (K, len(y))
        grad = np.clip(np.round(score * 8.0) / 8.0, -4.0, 4.0) - onehot
        return grad.reshape(-1), np.ones(K * len(y))
    return fobj


@pytest.mark.parametrize("how", ["train", "update"])
def test_custom_dyadic_objective_bit_for_bit(rng, how):
    """``train(params={"objective": fobj})`` and ``Booster.update(fobj=)``
    with ``num_class=3``: trees, model text and scores of both packages
    are equal, and the port's two entry points agree."""
    X, y = _data(rng)
    fobj = _dyadic_fobj(y)
    out = {}
    for pkg in (lgb, lgt):
        if how == "train":
            b = pkg.train(_params(fobj, num_leaves=7), pkg.Dataset(X, label=y),
                          num_boost_round=ROUNDS, keep_training_booster=True)
        else:
            b = pkg.Booster(_params("custom", num_leaves=7),
                            pkg.Dataset(X, label=y))
            for _ in range(ROUNDS):
                b.update(fobj=fobj)
        out[pkg] = (b.model_to_string(), np.asarray(b._engine.score),
                    b.predict(X, raw_score=True))
    (jm, js, jp), (tm, ts, tp) = out[lgb], out[lgt]
    assert _no_params(tm) == _no_params(jm)
    assert len(_trees(tm)) == ROUNDS * K
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)


def test_gradients_come_from_the_score_before_the_iteration(rng,
                                                            monkeypatch):
    """The gradients of all K classes come from the score before any tree
    of the iteration is added (the JAX package's models/gbdt.py:2211).
    Taking class k's gradients after the trees of classes < k were added,
    as a per-class loop over the live score does, grows a second tree
    that differs from the JAX package's."""
    X, y = _data(rng)
    params = _params("multiclass", num_leaves=7)
    jb = lgb.Booster(params, lgb.Dataset(X, label=y))
    jb.update()
    tb = lgt.Booster(params, lgt.Dataset(X, label=y))
    tb.update()
    assert_trees_to_binary_standard(jb, tb, X, "multiclass")

    class _Live:
        """``grad[k]`` read from the live score when class k's turn
        comes."""

        def __init__(self, eng, which):
            self.eng, self.which = eng, which

        def __getitem__(self, k):
            return self.eng.objective.get_gradients(self.eng.score)[
                self.which][k]

    late = lgt.Booster(params, lgt.Dataset(X, label=y))
    eng = late._engine
    original = eng._gradients

    def per_class(gradients, hessians):
        init_scores, _, _ = original(gradients, hessians)
        return init_scores, _Live(eng, 0), _Live(eng, 1)
    monkeypatch.setattr(eng, "_gradients", per_class)
    late.update()
    jt, tt, lt = (_trees(b.model_to_string()) for b in (jb, tb, late))
    assert lt[0] == tt[0]
    jv, lv = (np.asarray(t[1]["leaf_value"].split(), float)
              for t in (jt, lt))
    assert lv.shape != jv.shape or np.abs(lv - jv).max() > 1e-3


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_jax_model_text_loads_and_predicts(rng, objective):
    """A multiclass model written by the JAX package, loaded by the port:
    the header round-trips, the host walk gives the JAX package's
    probabilities bit for bit, the raw device route (on the CPU) within
    1e-5 in every class column, and the port writes the text back
    unchanged."""
    X, y = _data(rng)
    jb = lgb.train(_params(objective, num_leaves=7), lgb.Dataset(X, label=y),
                   num_boost_round=3)
    text = jb.model_to_string()
    obj_line = ("objective=multiclass num_class:3" if objective == "multiclass"
                else "objective=multiclassova num_class:3 sigmoid:1")
    for line in ("num_class=3", "num_tree_per_iteration=3", obj_line):
        assert line in text.splitlines()
    tb = lgt.Booster({"device_type": "cpu"}, model_str=text)
    assert tb.num_model_per_iteration() == K and tb.num_trees() == 3 * K
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_allclose(tb.predict(X, device=True), tb.predict(X),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tb.predict(X, start_iteration=1,
                                             num_iteration=2),
                                  jb.predict(X, start_iteration=1,
                                             num_iteration=2))
    assert _no_params(tb.model_to_string()) == _no_params(text)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_device_prediction_matches_host_walk(rng, objective):
    """``predict(device=True)`` of a trained multiclass model on the CPU,
    by the binned route and, for the trees loaded back from text, by the
    raw route, against the host walk in every class column; also over a
    window of iterations that starts past 0 (``_accumulate_iters`` adds
    tree ``i`` of the window into class ``(t0 + i) % K``)."""
    X, y = _data(rng)
    tb = lgt.train(_params(objective), lgt.Dataset(X, label=y),
                   num_boost_round=ROUNDS, keep_training_booster=True)
    loaded = lgt.Booster({"device_type": "cpu"},
                         model_str=tb.model_to_string())
    for start, num in ((0, None), (1, 2), (3, 1)):
        kw = dict(start_iteration=start, num_iteration=num)
        host = tb.predict(X, raw_score=True, **kw)
        for b in (tb, loaded):
            np.testing.assert_allclose(
                b.predict(X, raw_score=True, device=True, **kw), host,
                rtol=0, atol=1e-5)
            np.testing.assert_allclose(b.predict(X, device=True, **kw),
                                       tb.predict(X, **kw), rtol=0,
                                       atol=1e-5)
    # training score = the device route over the training rows
    np.testing.assert_allclose(tb.predict(X, raw_score=True, device=True),
                               tb._engine.score.numpy().T, rtol=0, atol=0)


def _noisy_valid(rng):
    Xv, yv = _data(rng, n=600)
    flip = rng.uniform(size=len(yv)) < 0.3
    return Xv, np.where(flip, rng.integers(0, K, size=len(yv)), yv)


def test_validation_set_and_early_stopping_match_jax(rng):
    """``multi_logloss`` and ``multi_error`` on a validation set under the
    dyadic custom objective, early stopping after 3 rounds without a
    better ``multi_logloss``: the same best iteration, trees and history
    bit for bit in both packages."""
    X, y = _data(rng, n=800)
    Xv, yv = _noisy_valid(rng)
    params = _params(_dyadic_fobj(y), learning_rate=0.5, min_data_in_leaf=2,
                     metric=["multi_logloss", "multi_error"],
                     early_stopping_round=3, first_metric_only=True)
    out = {}
    for pkg in (lgb, lgt):
        rec = {}
        tr = pkg.Dataset(X, label=y)
        b = pkg.train(dict(params), tr, num_boost_round=40,
                      valid_sets=[tr.create_valid(Xv, label=yv)],
                      valid_names=["va"],
                      callbacks=[pkg.record_evaluation(rec)])
        out[pkg] = (b.best_iteration, rec["va"], _trees(b.model_to_string()))
    (jbest, jrec, jt), (tbest, trec, tt) = out[lgb], out[lgt]
    assert 1 < tbest == jbest < len(trec["multi_logloss"]) < 40
    assert tt == jt and trec == jrec


def test_validation_scores_follow_the_host_walk(rng):
    """Softmax with a validation set and early stopping in the port: the
    validation set's ``multi_logloss`` and ``multi_error`` each iteration
    are those of the host walk of the trees so far, to 1e-6 (f32 scores
    on the training device against f64 sums on the host)."""
    from lightgbm_tpu_torch.core.metrics import (MultiErrorMetric,
                                                 MultiLoglossMetric)
    X, y = _data(rng, n=1500)
    Xv, yv = _noisy_valid(rng)
    params = _params("multiclass", learning_rate=0.2, num_leaves=31,
                     min_data_in_leaf=2,
                     metric=["multi_logloss", "multi_error"],
                     early_stopping_round=3, first_metric_only=True)
    rec = {}
    tr = lgt.Dataset(X, label=y)
    va = tr.create_valid(Xv, label=yv)
    b = lgt.train(params, tr, num_boost_round=40, valid_sets=[va],
                  valid_names=["va"], callbacks=[lgt.record_evaluation(rec)],
                  keep_training_booster=True)
    n_iter = len(rec["va"]["multi_logloss"])
    assert 1 < b.best_iteration < n_iter < 40
    assert b.num_trees() == n_iter * K
    metrics = [MultiLoglossMetric(b.config), MultiErrorMetric(b.config)]
    for m in metrics:
        m.init(va.binned.metadata, len(yv))
    for it in range(n_iter):
        raw = b.predict(Xv, raw_score=True, num_iteration=it + 1).T
        for m in metrics:
            (name, value, _), = m.eval(raw)
            np.testing.assert_allclose(rec["va"][name][it], value, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_class_without_a_split_takes_its_init_score(rng, objective):
    """With ``boost_from_average=false`` a class whose first tree cannot
    split (a class of random rows, under ``min_gain_to_split``) starts
    from its boost-from-average score as a constant tree, while the
    others split (the JAX package's models/gbdt.py:2320-2333); both
    packages agree."""
    X, y = _data(rng)
    # class 2: 5% of the rows at random, so its best gain (about 5 at
    # the first tree) stays under min_gain_to_split while the others'
    # (about 200) do not
    y[y == 2] = 0
    y[rng.uniform(size=len(y)) < 0.05] = 2
    params = _params(objective, boost_from_average=False, num_leaves=7,
                     min_gain_to_split=20.0)
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3)
    tb = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3)
    models = tb._engine.models
    assert [t.num_leaves > 1 for t in models[:K]] == [True, True, False]
    assert models[2].leaf_value[0] == \
        tb._engine.objective.boost_from_score(2) != 0.0
    assert_trees_to_binary_standard(jb, tb, X, objective)


@pytest.mark.parametrize("where", ["train", "valid"])
def test_multiclass_init_score_matches_jax(rng, where):
    """A class-major ``init_score`` of K x N values (ROADMAP C7): 300
    rows, 3 classes, on the training set or on a validation set; the
    trees, the scores and the validation metric agree with the JAX
    package's (the binary standard)."""
    X, y = _data(rng, n=300)
    init = 0.3 * rng.normal(size=(K, len(y)))
    params = _params("multiclass", num_leaves=7, min_data_in_leaf=5,
                     metric=["multi_logloss"])
    out = {}
    for pkg in (lgb, lgt):
        train_init = init.reshape(-1) if where == "train" else None
        tr = pkg.Dataset(X, label=y, init_score=train_init)
        va = pkg.Dataset(X[:100], label=y[:100], reference=tr,
                         init_score=(init[:, :100].reshape(-1)
                                     if where == "valid" else None))
        rec = {}
        b = pkg.train(params, tr, num_boost_round=2, valid_sets=[va],
                      valid_names=["va"],
                      callbacks=[pkg.record_evaluation(rec)])
        out[pkg] = (b, np.asarray(b._engine.valid_sets[0].score),
                    rec["va"]["multi_logloss"])
    (jb, jvs, jrec), (tb, tvs, trec) = out[lgb], out[lgt]
    assert tb.num_trees() == jb.num_trees() == 2 * K
    assert_trees_to_binary_standard(jb, tb, X, "multiclass")
    np.testing.assert_allclose(tvs, jvs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(trec, jrec, rtol=1e-6)


@pytest.mark.parametrize("objective", ["regression", "custom"])
def test_quantized_continued_training_draws_the_jax_chain(rng, objective):
    """Stochastic rounding draws ``fold_in(key, iter * K + k)`` with
    ``iter`` the iterations this engine trained, as the JAX package does,
    not the iteration counted from the init model's first tree: training
    continued from an init model with quantized gradients grows the JAX
    package's trees bit for bit (regression, K = 1; the dyadic custom
    objective, K = 3)."""
    X, y = _data(rng)
    if objective == "regression":
        params = {"objective": "regression", "num_leaves": 7,
                  "device_type": "cpu", "verbosity": -1}
        y = X[:, 0] + np.nan_to_num(X[:, 3]) + 0.1 * rng.normal(size=N)
    else:
        params = _params(_dyadic_fobj(y), num_leaves=7)
    params["use_quantized_grad"] = True
    text = {}
    for pkg in (lgb, lgt):
        first = pkg.train(dict(params), pkg.Dataset(X, label=y),
                          num_boost_round=2)
        b = pkg.train(dict(params), pkg.Dataset(X, label=y),
                      num_boost_round=2, init_model=first)
        text[pkg] = _trees(b.model_to_string())
    k = 1 if objective == "regression" else K
    assert len(text[lgt]) == 4 * k
    assert text[lgt] == text[lgb]


def test_multiclass_on_cuda_without_a_card_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(rng)
    with pytest.raises(lgt.basic.LightGBMError, match="device_type"):
        lgt.train({"objective": "multiclass", "num_class": K,
                   "verbosity": -1}, lgt.Dataset(X, label=y),
                  num_boost_round=1)
