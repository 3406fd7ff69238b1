"""Level-synchronous and hybrid growth in the PyTorch port against the JAX
package (``tpu_row_scheduling=level``).

The binary objective's first tree has dyadic gradients (g = 0.5 - y,
h = 0.25 with ``boost_from_average=false``), so every histogram sum is
exact in f32 whatever the order of its adds, and a first tree must match
split for split and value for value: the port's pure level tree
(``max_depth <= MAX_LEVEL_DEPTH``) and hybrid tree (``max_depth=-1``)
against the JAX package's trees of the same scheduling, node for node.
Against the port's own compact tree they hold the same splits and give
the same predictions (as tests/test_level_grower.py:53, 181 compare
them); the node numbering may differ, as it does in the JAX package
(ROADMAP C2). Quantized gradients make every sum an exact int32 too
(tests/test_level_grower.py:233): against the JAX package with
``stochastic_rounding=false`` (the port cannot draw jax.random's bits),
against the port's own compact tree with rounding on (one seed, one
generator, the same draws).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.core import level_grower as jlevel
from lightgbm_tpu_torch.core import hybrid_grower as thybrid
from lightgbm_tpu_torch.core import level_grower as tlevel
from lightgbm_tpu_torch.ops import hist_level_cuda as hist_level_cuda_mod
from lightgbm_tpu_torch.utils import log


def _data(seed=5, n=4000, f=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logit = (X[:, 0] * 1.5 + np.square(X[:, 1]) - X[:, 2] +
             0.3 * rng.normal(size=n))
    return X, (logit > 0).astype(np.float32)


def _params(sched, **kw):
    p = {"objective": "binary", "num_leaves": 31, "max_depth": 6,
         "min_data_in_leaf": 20, "verbosity": -1, "device_type": "cpu",
         "boost_from_average": False, "tpu_row_scheduling": sched}
    p.update(kw)
    return p


def _trees(bst):
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


def _first_tree(pkg, X, y, **params):
    return pkg.train(params, pkg.Dataset(X, label=y), num_boost_round=1)


def _splits(bst):
    t = bst._engine.models[0]
    return sorted(zip(t.split_feature.tolist(), t.threshold_real.tolist()))


def assert_same_splits(a, b, X):
    """The same set of splits and the same predictions, whatever the node
    numbering."""
    assert _splits(a) == _splits(b)
    np.testing.assert_array_equal(a.predict(X), b.predict(X))


@pytest.mark.parametrize("depth,leaves", [(6, 31), (3, 64)])
def test_level_first_tree_exact(depth, leaves):
    X, y = _data()
    kw = dict(max_depth=depth, num_leaves=leaves)
    t_lvl = _first_tree(lgt, X, y, **_params("level", **kw))
    j_lvl = _first_tree(lgb, X, y, **_params("level", **kw))
    t_cmp = _first_tree(lgt, X, y, **_params("compact", **kw))
    assert _trees(t_lvl) == _trees(j_lvl)
    np.testing.assert_array_equal(t_lvl.predict(X), j_lvl.predict(X))
    assert_same_splits(t_lvl, t_cmp, X)


@pytest.mark.parametrize("d0", [1, 5])
def test_hybrid_first_tree_exact(d0):
    """max_depth=-1, 63 leaves: the level phase to D0 and the compact
    tail; d0=1 puts nearly the whole tree in the tail, d0=5 most of it
    in the level phase."""
    X, y = _data(seed=13, n=4000)
    kw = dict(max_depth=-1, num_leaves=63, min_data_in_leaf=5,
              tpu_level_handoff_depth=d0)
    t_hyb = _first_tree(lgt, X, y, **_params("level", **kw))
    t_cmp = _first_tree(lgt, X, y, **_params("compact", **kw))
    j_hyb = _first_tree(lgb, X, y, **_params("level", **kw))
    assert _trees(t_hyb) == _trees(j_hyb)
    assert max(t.num_leaves for t in t_hyb._engine.models) == 63
    assert_same_splits(t_hyb, t_cmp, X)


@pytest.mark.parametrize("depth", [6, -1])
def test_quantized_level_and_hybrid_exact(depth):
    X, y = _data(seed=5)
    kw = dict(max_depth=depth, use_quantized_grad=True, seed=3)
    t_lvl = _first_tree(lgt, X, y, **_params("level", **kw))
    t_cmp = _first_tree(lgt, X, y, **_params("compact", **kw))
    assert_same_splits(t_lvl, t_cmp, X)
    if depth == 6:
        kw["stochastic_rounding"] = False
        t_lvl = _first_tree(lgt, X, y, **_params("level", **kw))
        j_lvl = _first_tree(lgb, X, y, **_params("level", **kw))
        assert _trees(t_lvl) == _trees(j_lvl)


@pytest.mark.parametrize("depth", [6, -1])
def test_bf16_level_matches_compact(depth):
    """bf16 histograms: 0.5 - y and 0.25 are exact in bf16, so the first
    tree is the f32 level tree of the JAX package, and holds the f32
    compact tree's splits."""
    X, y = _data(seed=7)
    kw = dict(max_depth=depth, tpu_hist_dtype="bfloat16")
    t_lvl = _first_tree(lgt, X, y, **_params("level", **kw))
    t_cmp = _first_tree(lgt, X, y, **_params("compact", max_depth=depth))
    j_lvl = _first_tree(lgb, X, y, **_params("level", max_depth=depth))
    assert _trees(t_lvl) == _trees(j_lvl)
    assert_same_splits(t_lvl, t_cmp, X)


def test_level_histograms_once_per_depth(monkeypatch):
    """The pure level grower makes one level histogram per scanned depth
    and the hybrid one per depth 0..D0; neither builds row-major ones
    until the tail."""
    X, y = _data(seed=3, n=2000)
    calls = []
    plain = hist_level_cuda_mod.hist_level

    def counting(bins, gh, local, in_lvl, n_nodes, num_bin):
        calls.append(n_nodes)
        return plain(bins, gh, local, in_lvl, n_nodes, num_bin)

    # the wrapper runs its plain version for CPU tensors
    monkeypatch.setattr(hist_level_cuda_mod, "hist_level", counting)
    b = lgt.Booster(_params("level", max_depth=4), lgt.Dataset(X, label=y))
    b.update()
    assert calls == [1, 2, 4, 8]
    calls.clear()
    b = lgt.Booster(_params("level", max_depth=-1, num_leaves=31),
                    lgt.Dataset(X, label=y))
    b.update()
    assert calls == [1 << d for d in range(thybrid.auto_handoff_depth(31)
                                           + 1)]


@pytest.mark.parametrize("cut", [False, True])
def test_rank_and_slots_matches_jax_on_monotone_gains(cut):
    """Where every node's gain is below its parent's (e = the least gain
    on the root path = the node's own gain), the port's ranking and the
    JAX package's agree on every output."""
    import jax.numpy as jnp
    rng = np.random.default_rng(23)
    D, L = 5, 20
    T = 2 ** (D + 1) - 1
    gain = np.zeros(T, np.float32)
    gain[0] = 100.0
    for v in range(1, T):
        gain[v] = gain[(v - 1) // 2] * rng.uniform(0.3, 0.99)
    gain[rng.uniform(size=T) < 0.2] = -np.inf
    if not cut:
        gain[T // 2:] = -np.inf     # the pure grower's unscanned last level
    e = gain.copy()
    for v in range(1, T):       # e = -inf below an invalid node
        e[v] = min(e[v], e[(v - 1) // 2])
    mask = np.floor(np.log2(np.arange(T) + 1)) == D
    port = tlevel.rank_and_slots(gain, L, D, cut_depth=D if cut else None)
    ref = jlevel.rank_and_slots(jnp.asarray(e), L, D,
                                cut_mask=jnp.asarray(mask) if cut else None)
    rank, k = port[0], port[1]
    assert k == int(ref[1]) > 0
    np.testing.assert_array_equal(rank[:T][port[2]],
                                  np.asarray(ref[0])[port[2]])
    for a, b in zip(port[2:], ref[2:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cut", [False, True])
def test_rank_and_slots_matches_jax_on_any_gains(seed, cut):
    """Gains in any order (children out-gaining their parents, ties of e,
    invalid nodes): the port derives e from the gains as the JAX level
    phase does, and ranks, cuts and numbers exactly as the JAX package's
    ``rank_and_slots`` (ROADMAP C2)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    D, L = 5, 24
    T = 2 ** (D + 1) - 1
    gain = rng.choice(np.float32([1.0, 2.0, 3.0, 5.0, 8.0]),
                      size=T).astype(np.float32)
    gain[rng.uniform(size=T) < 0.15] = -np.inf
    gain[rng.uniform(size=T) < 0.05] = 0.0
    gain[0] = 4.0
    if not cut:
        gain[T // 2:] = -np.inf
    e = np.where(gain > 0, gain, -np.inf).astype(np.float32)
    for v in range(1, T):
        e[v] = min(gain[v], e[(v - 1) // 2]) if gain[v] > 0 else -np.inf
    mask = np.floor(np.log2(np.arange(T) + 1)) == D
    port = tlevel.rank_and_slots(gain, L, D, cut_depth=D if cut else None)
    ref = jlevel.rank_and_slots(jnp.asarray(e), L, D,
                                cut_mask=jnp.asarray(mask) if cut else None)
    assert port[1] == int(ref[1]) > 0
    for a, b in zip(port[:1] + port[2:], ref[:1] + ref[2:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _interaction_data(seed=0, n=4000, f=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logit = (X[:, 0] - 0.5 * X[:, 1] * X[:, 2] + 0.25 * X[:, 3] ** 2
             + 0.1 * rng.normal(size=n))
    return X, (logit > np.median(logit)).astype(np.float32)


@pytest.mark.parametrize("depth", [6, -1])
def test_level_order_follows_compact_where_jax_level_does_not(depth):
    """ROADMAP C2, repaired. A split whose children both gain more than
    it does gives them the same e, and the JAX package's level grower
    then expands them in heap order where its compact grower expands the
    larger gain first: same splits, other node numbering. The port ranks
    as the JAX package does, so its level (max_depth=6) and hybrid
    (max_depth=-1) trees are the JAX package's node for node, and hold the
    compact tree's splits where the JAX level tree's numbering departs
    from the compact one's."""
    X, y = _interaction_data()
    kw = dict(max_depth=depth, num_leaves=31)
    j_lvl = _first_tree(lgb, X, y, **_params("level", **kw))
    j_cmp = _first_tree(lgb, X, y, **_params("compact", **kw))
    t_lvl = _first_tree(lgt, X, y, **_params("level", **kw))
    t_cmp = _first_tree(lgt, X, y, **_params("compact", **kw))
    assert _trees(j_lvl) != _trees(j_cmp)           # the reference's order
    assert _trees(t_cmp) == _trees(j_cmp)
    assert _trees(t_lvl) == _trees(j_lvl)
    assert_same_splits(t_lvl, t_cmp, X)
    np.testing.assert_array_equal(t_lvl.predict(X), j_lvl.predict(X))


def test_hybrid_over_memory_budget_falls_back(capsys):
    X, y = _data(seed=3, n=1000)
    log.logged_once.clear()
    b = lgt.Booster(_params("level", max_depth=-1, verbosity=0,
                            histogram_pool_size=0.01),
                    lgt.Dataset(X, label=y))
    assert b._engine.row_sched == "compact"
    assert "histogram memory over budget" in capsys.readouterr().err
    b.update()


def test_handoff_depth_is_clamped(capsys):
    X, y = _data(seed=3, n=1000)
    b = lgt.Booster(_params("level", max_depth=-1, verbosity=0,
                            tpu_level_handoff_depth=12),
                    lgt.Dataset(X, label=y))
    assert "clamping" in capsys.readouterr().err
    assert thybrid.resolve_handoff_depth(31, 12) == tlevel.MAX_LEVEL_DEPTH
    assert not b.update()
    cmp = _first_tree(lgt, X, y, **_params("compact", max_depth=-1))
    assert_same_splits(b, cmp, X)
    with pytest.raises(ValueError):
        tlevel.make_level_grower(b._engine.grower_cfg,
                                 b._engine.feature_meta)


def test_level_trains_and_saves(tmp_path):
    X, y = _data(seed=9, n=3000)
    bst = lgt.train(_params("level", max_depth=5, num_leaves=15,
                            boost_from_average=True, use_quantized_grad=True,
                            metric=["binary_logloss", "auc"]),
                    lgt.Dataset(X, label=y), num_boost_round=6)
    losses = bst.eval_train()
    assert dict((m, v) for _, m, v, _ in losses)["auc"] > 0.9
    path = tmp_path / "m.txt"
    bst.save_model(path)
    assert path.read_text() == bst.model_to_string()
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, bst._engine.score[0].numpy(), rtol=0,
                               atol=1e-5)
    assert torch.is_tensor(bst._engine.score)
