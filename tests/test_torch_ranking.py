"""Ranking in the PyTorch port against the JAX package, on the CPU.

- Query metadata: ``group`` and ``position`` from arrays, from a file's
  group column and from ``.query`` / ``.position`` sidecars give the JAX
  package's ``query_boundaries`` and ``position``, equal.
- Lambdarank gradients and hessians on seeded scores (query sizes 3-89
  plus one of 700 documents, so several length buckets; ties in the
  scores): within rtol 1e-5, atol 1e-6 of the JAX package's jitted ones
  (the tolerance of ``tests/test_ranking_buckets.py``; ``log2`` and the
  logistic function differ in the last ulps, ROADMAP C1(a)), with
  ``lambdarank_norm`` on and off, truncation at 3 and 30 and a custom
  ``label_gain``. The buckets' widths and queries are the JAX package's.
  The pairwise pass chunked one query at a time equals it unchunked bit
  for bit; a -0.0 added back comes out +0.0.
- rank_xendcg: the 2-D uniforms are ``jax.random.uniform(key, (Q, M),
  minval=tiny)`` bit for bit; the Gumbel values within 2 ulp of
  max(1, |g|) (``log`` differs in the last ulp); the gradients of three
  successive calls within rtol 1e-5, atol 1e-6.
- The position biases after 3 iterations agree within 1e-6 of the
  largest bias (each sums lambdas whose last ulps differ).
- Training, lambdarank, 5 rounds compact and 3 hybrid and full: trees to
  the binary standard of ``tests/test_torch_multiclass.py``, ``ndcg@k``
  and ``map@k`` per iteration within rtol 1e-6; ``ndcg`` and ``map`` on
  the same score arrays bit for bit; rank_xendcg for one round (the JAX
  engine's jit traces ``RankXENDCG._iter`` once, so from the second
  iteration on it reuses the first iteration's noise, where the port
  draws fresh noise each iteration as the objective's code states).
- A JAX-trained lambdarank model's text loads in the port and predicts
  the JAX package's host walk bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multiclass import assert_trees_to_binary_standard

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import metrics as jmet
from lightgbm_tpu.core import objective as jobj
from lightgbm_tpu.io.dataset_core import Metadata as JMeta
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core import metrics as tmet
from lightgbm_tpu_torch.core import objective as tobj
from lightgbm_tpu_torch.io.dataset_core import Metadata as TMeta
from lightgbm_tpu_torch.utils import prng
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = torch.device("cpu")
EPS32 = 2.0 ** -23
RATE = 0.1
EVAL_AT = [1, 3, 5, 10]
TRAIN_ROUNDS = {"compact": 5, "hybrid": 3, "full": 3}
SCHED = {"compact": "compact", "hybrid": "level", "full": "full"}


def _sizes(rng, n_queries=40, long_query=700):
    return np.r_[rng.integers(3, 90, size=n_queries), long_query]


def _grad_inputs(seed=0):
    """Query sizes, labels 0-4 and f32 scores with ties (0.25 steps)."""
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng)
    n = int(sizes.sum())
    label = rng.integers(0, 5, size=n).astype(np.float32)
    score = (np.round(rng.normal(size=n) * 4) / 4).astype(np.float32)
    return sizes, label, score


def _objectives(params, sizes, label, position=None):
    """The same objective of both packages, initialised on equal
    metadata."""
    n = len(label)
    out = []
    for meta_cls, cfg_cls, mod in ((JMeta, JConfig, jobj),
                                   (TMeta, TConfig, tobj)):
        meta = meta_cls(n)
        meta.set_label(label)
        meta.set_query(sizes)
        meta.set_position(position)
        obj = mod.create_objective(params["objective"], cfg_cls(params))
        if mod is jobj:
            obj.init(meta, n)
        else:
            obj.init(meta, n, CPU)
        out.append(obj)
    return out


def _ranking_data(rng, n_queries=50):
    sizes = np.r_[rng.integers(5, 60, size=n_queries), 200]
    n = int(sizes.sum())
    X = rng.normal(size=(n, 8))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    rel = X[:, 0] * 1.5 + 0.5 * np.nan_to_num(X[:, 3]) \
        + rng.normal(scale=0.7, size=n)
    y = np.clip(np.floor(rel), 0, 4)
    pos = np.concatenate([np.arange(s) for s in sizes]) % 10
    return X, y, sizes, pos


def _train_params(objective="lambdarank", path="compact", **extra):
    return {"objective": objective, "num_leaves": 15, "learning_rate": RATE,
            "min_data_in_leaf": 5, "metric": ["ndcg", "map"],
            "eval_at": EVAL_AT, "verbosity": -1,
            "tpu_row_scheduling": SCHED[path], **extra}


def _train_both(X, y, sizes, params, rounds, position=None):
    out = {}
    for pkg in (lgb, lgt):
        p = dict(params, device_type="cpu") if pkg is lgt else params
        ds = pkg.Dataset(X, label=y, group=sizes, position=position)
        rec = {}
        b = pkg.train(p, ds, num_boost_round=rounds, valid_sets=[ds],
                      valid_names=["train"],
                      callbacks=[pkg.record_evaluation(rec)],
                      keep_training_booster=True)
        out[pkg] = (b, rec["train"])
    return out


@pytest.fixture(scope="module")
def trained():
    """One JAX and one port model per path on one ranking set (the JAX
    models are reused by every test of this file)."""
    rng = np.random.default_rng(11)
    X, y, sizes, _ = _ranking_data(rng)
    runs = {path: _train_both(X, y, sizes, _train_params(path=path),
                              rounds)
            for path, rounds in TRAIN_ROUNDS.items()}
    return X, y, sizes, runs


# -- query metadata --------------------------------------------------------

def test_group_and_position_from_arrays(rng):
    sizes = rng.integers(1, 12, size=30)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 4))
    y = rng.integers(0, 3, size=n).astype(np.float64)
    pos = rng.integers(0, 6, size=n)
    jd = lgb.Dataset(X, label=y, group=sizes, position=pos).construct()
    td = lgt.Dataset(X, label=y, group=sizes, position=pos).construct()
    jm, tm = jd.binned.metadata, td.binned.metadata
    assert tm.query_boundaries.dtype == jm.query_boundaries.dtype == np.int32
    np.testing.assert_array_equal(tm.query_boundaries, jm.query_boundaries)
    assert tm.position.dtype == jm.position.dtype == np.int32
    np.testing.assert_array_equal(tm.position, jm.position)
    assert tm.num_queries == jm.num_queries == len(sizes)
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    np.testing.assert_array_equal(td.get_position(), jd.get_position())
    # set after construction reaches the binned metadata
    td.set_group(sizes[::-1])
    jd.set_group(sizes[::-1])
    np.testing.assert_array_equal(td.binned.metadata.query_boundaries,
                                  jd.binned.metadata.query_boundaries)
    td.set_position(pos[::-1])
    np.testing.assert_array_equal(td.get_position(), pos[::-1])
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        lgt.Dataset(X, label=y, group=np.r_[sizes, 1]).construct()
    va = td.create_valid(X[:sizes[0]], label=y[:sizes[0]],
                         group=sizes[:1], position=pos[:sizes[0]])
    np.testing.assert_array_equal(va.construct().binned.metadata
                                  .query_boundaries, [0, sizes[0]])


def test_group_column_of_a_file(rng, tmp_path):
    sizes = rng.integers(2, 9, size=12)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 3))
    y = rng.integers(0, 3, size=n).astype(np.float64)
    qid = np.repeat(np.arange(len(sizes)) * 7 + 3, sizes)
    path = str(tmp_path / "rank_qid.csv")
    np.savetxt(path, np.column_stack([y, qid, X]), delimiter=",",
               fmt="%.8g")
    params = {"objective": "lambdarank", "group_column": "1",
              "verbose": -1}
    jd = lgb.Dataset(path, params=params).construct()
    td = lgt.Dataset(path, params=params).construct()
    np.testing.assert_array_equal(td.binned.metadata.query_boundaries,
                                  jd.binned.metadata.query_boundaries)
    np.testing.assert_array_equal(td.get_group(), sizes)
    assert td.num_feature() == jd.num_feature() == 3


@pytest.mark.parametrize("ext", [".query", ".group"])
def test_query_and_position_sidecars(rng, tmp_path, ext):
    """Mirror of ``tests/test_api_parity.py::test_position_side_file``."""
    sizes = rng.integers(5, 12, size=15)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 4))
    y = rng.integers(0, 3, size=n).astype(np.float64)
    pos = np.concatenate([np.arange(s) for s in sizes])
    path = str(tmp_path / "rank.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.6g")
    np.savetxt(path + ext, sizes, fmt="%d")
    np.savetxt(path + ".position", pos, fmt="%d")
    params = {"objective": "lambdarank", "verbose": -1}
    jd = lgb.Dataset(path, params=params).construct()
    td = lgt.Dataset(path, params=params).construct()
    jm, tm = jd.binned.metadata, td.binned.metadata
    np.testing.assert_array_equal(tm.position, pos)
    np.testing.assert_array_equal(tm.position, jm.position)
    np.testing.assert_array_equal(tm.query_boundaries, jm.query_boundaries)


# -- lambdarank gradients --------------------------------------------------

GRAD_CASES = {
    "norm": {},
    "no_norm": {"lambdarank_norm": False},
    "truncation_3": {"lambdarank_truncation_level": 3},
    "truncation_3_no_norm": {"lambdarank_truncation_level": 3,
                             "lambdarank_norm": False},
    "label_gain": {"label_gain": [0.0, 0.5, 2.0, 5.5, 9.0]},
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_lambdarank_gradients_match_jax(case):
    sizes, label, score = _grad_inputs()
    params = {"objective": "lambdarank", **GRAD_CASES[case]}
    jo, to = _objectives(params, sizes, label)
    assert [tuple(bk.idx.shape) for bk in jo.buckets] == \
        [bk.shape for bk in to.buckets]
    assert len(to.buckets) >= 4
    for jb, tb in zip(jo.buckets, to.buckets):
        np.testing.assert_array_equal(tb.qids, jb.qids)
        np.testing.assert_array_equal(tb.idx.numpy(), np.asarray(jb.idx))
    jg, jh = jax.jit(jo.get_gradients)(jnp.asarray(score))
    tg, th = to.get_gradients(torch.as_tensor(score))
    assert tg.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(np.asarray(jg)).max() > 0.01


@pytest.mark.parametrize("norm", [True, False])
def test_chunked_pairwise_pass_equals_unchunked(monkeypatch, norm):
    """One query a chunk against one chunk a bucket: bit for bit."""
    sizes, label, score = _grad_inputs(seed=3)
    _, to = _objectives({"objective": "lambdarank",
                         "lambdarank_norm": norm}, sizes, label)
    s = torch.as_tensor(score)
    monkeypatch.setattr(tobj, "PAIR_CHUNK_BYTES", 1 << 40)
    assert all(len(to.chunks(bk)) == 1 for bk in to.buckets)
    g1, h1 = to.get_gradients(s)
    monkeypatch.setattr(tobj, "PAIR_CHUNK_BYTES", 1)
    assert [len(to.chunks(bk)) for bk in to.buckets] == \
        [bk.shape[0] for bk in to.buckets]
    g2, h2 = to.get_gradients(s)
    assert torch.equal(g1, g2) and torch.equal(h1, h2)
    # the default budget: the 700-document query's bucket (1,024 wide,
    # 4 MiB a query) fits one chunk
    monkeypatch.undo()
    assert to.chunks(to.buckets[-1]) == [(0, 1)]


def test_scatter_back_adds_into_positive_zero():
    sizes, label, _ = _grad_inputs()
    jo, to = _objectives({"objective": "lambdarank"}, sizes, label)
    bk = to.buckets[0]
    flat = to.scatter_back(None, bk, torch.full(bk.shape, -0.0))
    jflat = np.asarray(jo.scatter_back(
        [jnp.full(b.idx.shape, -0.0) for b in jo.buckets]))
    assert not torch.signbit(flat).any()
    assert not np.signbit(jflat).any()


# -- rank_xendcg -----------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 6, 123456])
def test_xendcg_uniforms_and_gumbel_match_jax(seed):
    tiny = jnp.finfo(jnp.float32).tiny
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    tkeys = prng.split(prng.prng_key(seed), 3)
    for key, tkey, shape in zip(keys, tkeys, [(7, 16), (33, 64), (3, 1024)]):
        ju = np.asarray(jax.random.uniform(key, shape, minval=tiny))
        tu = prng.uniform(tkey, shape, minval=prng.F32_TINY).numpy()
        np.testing.assert_array_equal(tu.view(np.uint32),
                                      ju.view(np.uint32))
        jg = np.asarray(jax.random.gumbel(key, shape), np.float64)
        tg = prng.gumbel(tkey, shape).numpy()
        assert tg.dtype == np.float32
        np.testing.assert_array_less(
            np.abs(tg - jg), 2 * EPS32 * np.maximum(1.0, np.abs(jg)) + 1e-300)


def test_xendcg_gradients_match_jax():
    """Three successive calls, each with its fresh keys, against the JAX
    objective called the same way (eagerly: its ``_iter`` advances)."""
    sizes, label, score = _grad_inputs(seed=1)
    jo, to = _objectives({"objective": "rank_xendcg"}, sizes, label)
    for _ in range(3):
        jg, jh = jo.get_gradients(jnp.asarray(score))
        tg, th = to.get_gradients(torch.as_tensor(score))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6)
    assert to._iter == jo._iter == 3


# -- training --------------------------------------------------------------

def _grad_hess_bounds(jb):
    """Twice the largest |lambda| and hessian at the zero score and at
    the JAX engine's last score."""
    eng = jb._engine
    g_max = h_max = 0.0
    for score in (jnp.zeros_like(eng.score[0]), eng.score[0]):
        g, h = (np.abs(np.asarray(a))
                for a in jax.jit(eng.objective.get_gradients)(score))
        g_max, h_max = max(g_max, g.max()), max(h_max, h.max())
    return 2 * g_max, 2 * h_max


@pytest.mark.parametrize("path", sorted(TRAIN_ROUNDS))
def test_lambdarank_trains_like_jax(trained, path):
    X, _, _, runs = trained
    (jb, jrec), (tb, trec) = runs[path][lgb], runs[path][lgt]
    assert tb.num_trees() == jb.num_trees() == TRAIN_ROUNDS[path]
    g_max, h_max = _grad_hess_bounds(jb)
    assert_trees_to_binary_standard(jb, tb, X, g_max=g_max, h_max=h_max,
                                    converted=False)
    assert sorted(trec) == sorted(jrec) == sorted(
        [f"ndcg@{k}" for k in EVAL_AT] + [f"map@{k}" for k in EVAL_AT])
    for name in jrec:
        np.testing.assert_allclose(trec[name], jrec[name], rtol=1e-6,
                                   err_msg=name)
    assert trec["ndcg@10"][-1] > trec["ndcg@10"][0]


def test_ranking_metrics_on_the_same_scores_bit_for_bit(trained):
    X, y, sizes, runs = trained
    jb = runs["compact"][lgb][0]
    rng = np.random.default_rng(4)
    n = len(y)
    jm, tm = JMeta(n), TMeta(n)
    for m in (jm, tm):
        m.set_label(y)
        m.set_query(sizes)
    cases = [jb.predict(X), np.round(rng.normal(size=n) * 2) / 2,
             np.zeros(n)]
    for name in ("ndcg", "map", "ndcg@2,7", "map@4"):
        j = jmet.create_metric(name, JConfig({"eval_at": EVAL_AT}))
        t = tmet.create_metric(name, TConfig({"eval_at": EVAL_AT}))
        j.init(jm, n)
        t.init(tm, n)
        assert t.names == j.names
        for score in cases:
            assert t.eval(score) == j.eval(score), name


def test_position_bias_matches_jax():
    rng = np.random.default_rng(12)
    X, y, sizes, pos = _ranking_data(rng, n_queries=30)
    params = _train_params(lambdarank_position_bias_regularization=0.5)
    out = _train_both(X, y, sizes, params, 3, position=pos)
    jo, to = (out[pkg][0]._engine.objective for pkg in (lgb, lgt))
    assert to.uses_position_bias and to.num_position_ids == 10
    assert np.abs(to.pos_biases).min() > 0
    # each bias sums the lambdas of its position's rows, whose last ulps
    # differ: held relative to the largest bias
    np.testing.assert_allclose(to.pos_biases, jo.pos_biases, rtol=0,
                               atol=1e-6 * np.abs(jo.pos_biases).max())
    (jb, jrec), (tb, trec) = out[lgb], out[lgt]
    g_max, h_max = _grad_hess_bounds(jb)
    assert_trees_to_binary_standard(jb, tb, X, g_max=g_max, h_max=h_max,
                                    converted=False)
    np.testing.assert_allclose(trec["ndcg@5"], jrec["ndcg@5"], rtol=1e-6)


def test_xendcg_first_round_matches_jax():
    rng = np.random.default_rng(13)
    X, y, sizes, _ = _ranking_data(rng, n_queries=30)
    out = _train_both(X, y, sizes, _train_params("rank_xendcg",
                                                 lambda_l2=1.0), 1)
    (jb, jrec), (tb, trec) = out[lgb], out[lgt]
    g_max, h_max = _grad_hess_bounds(jb)
    assert_trees_to_binary_standard(jb, tb, X, g_max=g_max, h_max=h_max,
                                    converted=False)
    np.testing.assert_allclose(trec["ndcg@10"], jrec["ndcg@10"], rtol=1e-6)


def test_lambdarank_learns(rng):
    """Mirror of ``tests/test_engine.py::test_lambdarank``, in the port."""
    n_queries, docs_per_q = 60, 20
    n = n_queries * docs_per_q
    X = rng.normal(size=(n, 8))
    rel = np.clip((X[:, 0] * 2 + rng.normal(scale=0.5, size=n)), 0, None)
    y = np.minimum(rel.astype(np.int64), 4).astype(np.float64)
    train = lgt.Dataset(X, label=y, group=np.full(n_queries, docs_per_q))
    params = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [5],
              "num_leaves": 15, "verbosity": -1, "min_data_in_leaf": 5,
              "device_type": "cpu"}
    record = {}
    lgt.train(params, train, num_boost_round=30, valid_sets=[train],
              valid_names=["train"], callbacks=[lgt.record_evaluation(record)])
    ndcg = record["train"]["ndcg@5"]
    assert ndcg[-1] > ndcg[0]
    assert ndcg[-1] > 0.8


def test_xendcg_trains_with_buckets(rng):
    """Mirror of ``tests/test_ranking_buckets.py::
    test_xendcg_trains_with_buckets``, in the port."""
    sizes = rng.integers(3, 70, size=30)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.float32)
    bst = lgt.train({"objective": "rank_xendcg", "verbose": -1,
                     "min_data_in_leaf": 5, "metric": "ndcg",
                     "device_type": "cpu"},
                    lgt.Dataset(X, label=y, group=sizes), num_boost_round=8)
    assert len(bst._engine.objective.buckets) > 1
    assert np.isfinite(bst.predict(X)).all()


def test_jax_lambdarank_text_loads_and_predicts(trained):
    X, _, _, runs = trained
    jb = runs["compact"][lgb][0]
    loaded = lgt.Booster({"device_type": "cpu"},
                         model_str=jb.model_to_string())
    assert loaded._engine.objective.NAME == "lambdarank"
    np.testing.assert_array_equal(loaded.predict(X), jb.predict(X))
    np.testing.assert_allclose(loaded.predict(X, device=True), jb.predict(X),
                               rtol=0, atol=1e-5)
