"""Exclusive Feature Bundling in the PyTorch port against the JAX package.

``io/bundling.py``: ``find_bundles`` over the port's row-major bins
gives the JAX package's ``BundleInfo`` (group, offset, default bin, bin
counts, group bin counts and the gather map), from dense input and from
CSR input packed straight into groups; ``pack_bins`` and
``pack_sparse_direct`` give the transpose of the JAX package's group
columns, a feature whose zeros are not its default bin included;
``make_expand_hist`` and ``decode_logical_bin`` are the JAX package's
bit for bit.

Training over the groups at 2,000 rows of 20 one-hot columns of 8
values (160 features, one of them categorical inside a bundle), 15
leaves, 3 rounds, checks that the port BUNDLES (its ``BundleInfo`` is
the JAX engine's, with fewer groups than features) and then: L2 through
the compact grower and quantized gives the JAX package's model text
string for string; full scheduling and the level growers (pure at depth
4, and the hybrid) on a custom objective of dyadic gradients do too (on
L2 gradients the two packages add their histograms in other orders
there, ROADMAP C1(b), C1(c), with or without bundles); binary is held to
the binary standard (``tests/test_torch_multiclass.py``). An EFB
dataset keeps the hybrid where the logical feature count would have sent
it to compact.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_torch_categorical import _dyadic_fobj
from test_torch_model_io import _no_params
from test_torch_multiclass import assert_trees_to_binary_standard

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import bundling as jb
from lightgbm_tpu.io.dataset_core import BinnedDataset as JBinned
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core.hybrid_grower import resolve_handoff_depth
from lightgbm_tpu_torch.io import bundling as tb
from lightgbm_tpu_torch.io.dataset_core import BinnedDataset

BASE = {"num_leaves": 15, "verbosity": -1, "device_type": "cpu",
        "min_data_in_leaf": 5}
ROUNDS = 3
INFO_FIELDS = ("group", "offset", "default_bin", "num_bin", "group_num_bin")


def onehot_csr(rng, n=2000, groups=20, cols_per_group=8, with_cat=True):
    """One-hot rows (one active column per group; group 0 also has a
    "none" value, on about 30% of rows) and, with ``with_cat``, one last
    categorical column whose categories 1..4 fall exactly on group 0's
    "none" rows (0 elsewhere): it is exclusive with group 0's columns.
    Returns (CSR matrix, L2 label, the categorical column's index)."""
    F = groups * cols_per_group
    choice = rng.integers(0, cols_per_group, size=(n, groups))
    none0 = rng.uniform(size=n) < 0.3
    rows = np.repeat(np.arange(n), groups)
    cols = (np.arange(groups) * cols_per_group)[None, :] + choice
    keep = np.ones((n, groups), bool)
    keep[:, 0] = ~none0
    rows, cols = rows[keep.reshape(-1)], cols.reshape(-1)[keep.reshape(-1)]
    vals = np.ones(len(rows))
    cat = np.where(none0, rng.integers(1, 5, size=n), 0)
    if with_cat:
        on = np.flatnonzero(cat)
        rows = np.concatenate([rows, on])
        cols = np.concatenate([cols, np.full(len(on), F)])
        vals = np.concatenate([vals, cat[on].astype(float)])
        F += 1
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, F))
    y = ((choice[:, 0] % 3) - (choice[:, 1] % 2) * 1.5 + 0.8 * (cat == 2)
         - 0.6 * (cat == 3) + 0.3 * rng.normal(size=n))
    return X, y, F - 1


@pytest.fixture(scope="module")
def data():
    X, y, cat = onehot_csr(np.random.default_rng(11))
    return {"X": X, "Xd": X.toarray(), "y": y, "cat": cat}


def _train_both(params, X, y, cats=()):
    j = lgb.train({k: v for k, v in params.items() if k != "device_type"},
                  lgb.Dataset(X, label=y, categorical_feature=list(cats)),
                  num_boost_round=ROUNDS)
    t = lgt.train(params, lgt.Dataset(X, label=y,
                                      categorical_feature=list(cats)),
                  num_boost_round=ROUNDS)
    return j, t


def assert_same_bundles(jinfo, tinfo):
    """The port's BundleInfo against the JAX package's (a BundleInfo or
    the JAX engine's bundle dict)."""
    get = (jinfo.get if isinstance(jinfo, dict)
           else lambda k: getattr(jinfo, k, None))
    assert tinfo.num_groups == get("num_groups")
    for k in INFO_FIELDS + ("gather_map",):
        if get(k) is not None:
            np.testing.assert_array_equal(getattr(tinfo, k), get(k), k)


def _nb(ds):
    return np.asarray([ds.bin_mappers[i].num_bin
                       for i in ds.used_feature_map], np.int64)


# ---------------------------------------------------------------------------
# bundling, packing, expansion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.05])
def test_find_bundles_matches_jax_from_dense(data, rate):
    cfg = {"max_bin": 255, "min_data_in_leaf": 5}
    t = BinnedDataset.from_matrix(data["Xd"], Config(cfg))
    j = JBinned.from_matrix(data["Xd"], JConfig(cfg))
    np.testing.assert_array_equal(t.bins, j.bins.T)
    ti = tb.find_bundles(t.bins, _nb(t), max_conflict_rate=rate)
    ji = jb.find_bundles(j.bins, _nb(j), max_conflict_rate=rate)
    assert ti is not None and ti.num_groups < t.bins.shape[1]
    ti.build_gather_map(64)
    ji.build_gather_map(64)
    assert_same_bundles(ji, ti)
    np.testing.assert_array_equal(tb.pack_bins(t.bins, ti),
                                  jb.pack_bins(j.bins, ji).T)


def test_csr_packs_directly_into_the_jax_groups(data):
    """CSR input under the auto rule: no logical bins, the groups and the
    BundleInfo of the JAX package's direct packing, which is
    ``pack_bins`` of the dense matrix's bins."""
    cfg = {"max_bin": 255, "min_data_in_leaf": 5}
    t = lgt.Dataset(data["X"], label=data["y"], params=cfg).binned
    j = lgb.Dataset(data["X"], label=data["y"], params=cfg).construct()._binned
    assert t.bins is None and t.bins_mv is None
    assert_same_bundles(j.efb_info, t.efb_info)
    np.testing.assert_array_equal(t.bins_grouped, j.bins_grouped.T)
    dense = BinnedDataset.from_matrix(data["Xd"], Config(cfg))
    np.testing.assert_array_equal(
        t.bins_grouped, tb.pack_bins(dense.bins, t.efb_info))


def test_pack_sparse_direct_nonzero_default(rng):
    """A near-dense column whose most frequent bin is not the bin of 0.0
    takes the densified branch; the groups still equal ``pack_bins``."""
    n = 3000
    X = np.zeros((n, 40))
    X[np.arange(n), rng.integers(0, 39, size=n)] = 1.0
    X[:, 39] = np.where(rng.uniform(size=n) < 0.8, 2.0, 0.0)
    csr = sp.csr_matrix(X)
    cfg = Config({"max_bin": 255})
    ds = BinnedDataset.from_matrix(X, cfg)
    info = tb.find_bundles(ds.bins, _nb(ds))
    m = ds.bin_mappers[39]
    assert info.default_bin[39] != m.value_to_bin(np.zeros(1))[0]
    got = tb.pack_sparse_direct(csr.tocsc(), ds.bin_mappers,
                                ds.used_feature_map, info)
    np.testing.assert_array_equal(got, tb.pack_bins(ds.bins, info))
    jinfo = jb.find_bundles(ds.bins.T.copy(), _nb(ds))
    np.testing.assert_array_equal(
        got, jb.pack_sparse_direct(csr.tocsc(), ds.bin_mappers,
                                   ds.used_feature_map, jinfo).T)


@pytest.mark.parametrize("B", [9, 40])
def test_expand_hist_and_decode_match_jax(data, rng, B):
    """Group histograms of non-dyadic values expanded with non-dyadic
    totals, singly and batched over nodes, and every group bin decoded
    for every feature: bit for bit (B = 40 past XLA's 32-wide reduce
    window)."""
    ds = BinnedDataset.from_matrix(data["Xd"], Config({"max_bin": 255}))
    info = tb.find_bundles(ds.bins, _nb(ds))
    info.build_gather_map(B)
    jbundle = dict(gather_map=info.gather_map, default_bin=info.default_bin)
    G = info.num_groups
    hg = rng.normal(size=(3, G, B, 3)).astype(np.float32)
    tot = rng.normal(size=(3, 3)).astype(np.float32) * 50
    expand = tb.make_expand_hist(info, "cpu")
    jexp = jb.make_expand_hist(jbundle)
    for n in range(3):
        want = np.asarray(jexp(jnp.asarray(hg[n]), *jnp.asarray(tot[n])))
        got = expand(torch.from_numpy(hg[n]), torch.from_numpy(tot[n]))
        np.testing.assert_array_equal(got.numpy(), want)
    batched = expand(torch.from_numpy(hg), torch.from_numpy(tot)).numpy()
    for n in range(3):
        np.testing.assert_array_equal(batched[n], np.asarray(jexp(
            jnp.asarray(hg[n]), *jnp.asarray(tot[n]))))
    col = torch.arange(B).repeat(3)
    for f in range(len(info.group)):
        args = (int(info.offset[f]), int(info.num_bin[f]),
                int(info.default_bin[f]))
        np.testing.assert_array_equal(
            tb.decode_logical_bin(col, *args).numpy(),
            np.asarray(jb.decode_logical_bin(jnp.asarray(col.numpy()),
                                             *args)))


# ---------------------------------------------------------------------------
# training over bundles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def compact_pair(data):
    return _train_both({"objective": "regression", **BASE}, data["X"],
                       data["y"], cats=[data["cat"]])


@pytest.mark.parametrize("case", ["compact_csr", "compact_dense",
                                  "quantized_csr"])
def test_l2_over_bundles_equals_jax(data, compact_pair, case):
    """Dense input is bundled at training (``find_bundles``), CSR input
    was packed into its groups at construction."""
    X = data["Xd"] if case.endswith("dense") else data["X"]
    if case == "compact_csr":
        jbst, tbst = compact_pair
    else:
        extra = {"use_quantized_grad": True} if "quantized" in case else {}
        jbst, tbst = _train_both(
            {"objective": "regression", **BASE, **extra}, X, data["y"],
            cats=[data["cat"]])
    te, je = tbst._engine, jbst._engine
    assert te._bundle is not None and te._bundle.num_groups < X.shape[1]
    assert_same_bundles(je._bundle, te._bundle)
    assert _no_params(tbst.model_to_string()) == \
        _no_params(jbst.model_to_string())


@pytest.mark.parametrize("extra", [
    pytest.param({"tpu_row_scheduling": "full"}, id="full"),
    pytest.param({"tpu_row_scheduling": "level", "max_depth": 4},
                 id="level"),
    pytest.param({"tpu_row_scheduling": "level",
                  "tpu_level_handoff_depth": 2}, id="hybrid")])
def test_dyadic_trees_over_bundles_equal_jax(data, extra):
    yq = np.round(data["y"] * 8) / 8
    params = {"objective": _dyadic_fobj(yq), **BASE, **extra}
    jbst, tbst = _train_both(params, data["X"], yq, cats=[data["cat"]])
    te = tbst._engine
    assert te._bundle is not None
    assert_same_bundles(jbst._engine._bundle, te._bundle)
    assert te.row_sched == extra["tpu_row_scheduling"]
    assert _no_params(tbst.model_to_string()) == \
        _no_params(jbst.model_to_string())


def test_categorical_feature_inside_a_bundle(data, compact_pair):
    """The categorical column shares its group with group 0's one-hot
    columns, and the model splits on it: the JAX package's text."""
    jbst, tbst = compact_pair
    info = tbst._engine._bundle
    g = info.group[data["cat"]]
    assert (info.group == g).sum() > 1
    assert "cat_threshold=" in tbst.model_to_string()
    assert _no_params(tbst.model_to_string()) == \
        _no_params(jbst.model_to_string())


def test_binary_over_bundles_to_the_binary_standard(data):
    yb = (data["y"] > np.median(data["y"])).astype(np.float64)
    jbst, tbst = _train_both({"objective": "binary", **BASE}, data["X"], yb)
    assert tbst._engine._bundle is not None
    assert_trees_to_binary_standard(jbst, tbst, data["Xd"], g_max=1.0,
                                    h_max=0.25)


def test_efb_dataset_keeps_the_hybrid(data):
    """The hybrid's memory gate budgets the stored groups, as the JAX
    package's ``_hist_budget`` does: a budget that the pool and level
    histograms of the groups fit, and of the 161 logical features would
    not, keeps the hybrid (a gate over the logical count sends it to
    compact)."""
    ds = lgt.Dataset(data["X"], label=data["y"]).construct()
    params = {"objective": "regression", **BASE,
              "tpu_row_scheduling": "level"}
    eng = lgt.Booster(params, ds)._engine
    G, F, B = eng._bundle.num_groups, eng.num_used_features, eng.num_bin_max
    T = 2 ** (resolve_handoff_depth(15, 0) + 1) - 1
    # 15 leaves + T level nodes of [G, B, 3] f32 fit; of [F, B, 3] not
    need = lambda cols: (15 + T) * cols * B * 12
    assert need(G) < need(F)
    mb = (need(G) + 1) / (1 << 20)
    bst = lgt.Booster({**params, "histogram_pool_size": mb}, ds)
    assert bst._engine.row_sched == "level"
    assert bst._engine.grower_cfg.hist_pool == "full"
    jbst = lgb.Booster({k: v for k, v in params.items()
                        if k != "device_type"} | {"histogram_pool_size": mb},
                       lgb.Dataset(data["X"], label=data["y"]))
    assert jbst._engine.grower_cfg.row_sched == "level"
