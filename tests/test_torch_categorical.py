"""Categorical features in the PyTorch port against the JAX package.

The categorical split scan (``ops/split._categorical_scan``: one-hot for
few categories, else bins stable-sorted by grad/(hess + cat_smooth) and
prefixes scanned from both ends, ``max_cat_threshold`` long, thinned by
``min_data_per_group``, ``cat_l2`` added) is held to the JAX package's
bit for bit over histograms built from rows: every record field and the
category set, one-hot and sorted, thinned, tied ratios, at the
``max_cat_to_onehot`` edge, on dyadic and on other values.

Training at 1,500 rows with three categorical features (30, 5 and 300
categories; one with NaNs) and a numerical one, 15 leaves, 3 rounds: L2
through the compact grower, quantized and over u16 bins gives the JAX
package's model text string for string (its trees, category bitsets and
leaf values bit for bit); through full, level and hybrid scheduling,
whose sums the two packages add in other orders (ROADMAP C1(b), C1(c)),
a custom objective of dyadic gradients gives the same text; bf16 histograms on
dyadic gradients give the JAX grower's tree bit for bit; binary and
3-class softmax are held to the binary standard
(``tests/test_torch_multiclass.py``). A categorical ``init_model``
continues as in the JAX package; the binned device route agrees with the
host walk, unseen categories, NaN and negative values included; a model
loaded from text takes the host walk; ``pred_contrib`` rows sum to the
raw score.
"""
import numpy as np
import pytest
import torch
from test_torch_model_io import _no_params
from test_torch_multiclass import assert_trees_to_binary_standard
from test_torch_train import STRUCTURE_KEYS, _trees

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.core import grower as jgrower
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.core import grower as tgrower
from lightgbm_tpu_torch.core.level_grower import go_left_rows
from lightgbm_tpu_torch.io.binning import BinMapper
from lightgbm_tpu_torch.ops import split as tsplit

CAT_KEYS = STRUCTURE_KEYS + ("decision_type", "cat_boundaries",
                             "cat_threshold")
CATS = [0, 2, 3]
N = 1500
ROUNDS = 3
BASE = {"num_leaves": 15, "verbosity": -1, "device_type": "cpu",
        "min_data_in_leaf": 5, "min_data_per_group": 20, "cat_smooth": 5.0}


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _hists(rng, num_bins, n_leaves, dyadic=True, tie=False, R=3000):
    """[N, F, B, 3] histograms of R rows per leaf (each feature's sums are
    the leaf's), and the leaf totals."""
    F, B = len(num_bins), max(num_bins)
    hist = np.zeros((n_leaves, F, B, 3), np.float32)
    for n in range(n_leaves):
        if dyadic:
            g = rng.integers(-32, 33, size=R) / 16.0
            h = rng.integers(1, 9, size=R) / 8.0
        else:
            g = rng.normal(size=R)
            h = rng.uniform(0.05, 0.25, size=R)
        for f, nb in enumerate(num_bins):
            if tie:
                # equal counts and per-bin sums repeating across bins:
                # the sort meets exact ties
                b = np.arange(R) % nb
                g = np.asarray([-1.0, 0.5, 0.5, -1.0])[b % 4] / 4
                h = np.full(R, 0.25)
            else:
                p = rng.dirichlet(np.ones(nb) * 0.7)
                b = rng.choice(nb, size=R, p=p)
            for ch, v in enumerate((g, h, np.ones(R))):
                np.add.at(hist[n, f, :, ch], b, v)
    tot = hist[:, 0].sum(axis=1).astype(np.float32)
    return hist, tot


def _metas(num_bins, is_cat):
    F = len(num_bins)
    jm = jsplit.FeatureMeta(
        num_bin=jnp.asarray(num_bins, jnp.int32),
        missing_type=jnp.zeros(F, jnp.int32),
        default_bin=jnp.zeros(F, jnp.int32),
        is_categorical=jnp.asarray(is_cat))
    tm = tsplit.FeatureMeta(
        num_bin=torch.tensor(num_bins, dtype=torch.int32),
        missing_type=torch.zeros(F, dtype=torch.int32),
        default_bin=torch.zeros(F, dtype=torch.int32),
        has_missing=False, is_categorical=torch.tensor(is_cat),
        cat_features=torch.tensor([i for i, c in enumerate(is_cat) if c]),
        cat_num_bin=tuple(nb for nb, c in zip(num_bins, is_cat) if c))
    return jm, tm


SCAN_CASES = {
    # every feature at most max_cat_to_onehot categories
    "one_hot": ([4, 6, 9], dict(max_cat_to_onehot=8), {}),
    # num_bin - 1 == max_cat_to_onehot (one-hot) and one past it (sorted)
    "onehot_edge": ([5, 6, 5, 6], dict(max_cat_to_onehot=4), {}),
    "sorted_subset": ([12, 40, 64], dict(max_cat_threshold=8,
                                         min_data_per_group=10), {}),
    # groups of at least 150 rows: most prefixes are thinned out
    "min_data_per_group": ([40, 64], dict(min_data_per_group=150), {}),
    "tied_ratios": ([12, 33], dict(max_cat_threshold=16,
                                   min_data_per_group=5), dict(tie=True)),
    "non_dyadic": ([9, 30, 64], dict(cat_l2=2.5, cat_smooth=3.0),
                   dict(dyadic=False)),
    "max_cat_threshold_past_bins": ([7, 20], dict(max_cat_threshold=64,
                                                  min_data_per_group=1,
                                                  cat_smooth=1.0), {}),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_categorical_scan_matches_jax(rng, case):
    """``_categorical_scan`` against the JAX package's over three leaves:
    every per-feature array bit for bit, the sets in order."""
    num_bins, hp_kw, hist_kw = SCAN_CASES[case]
    hp = dict(min_data_in_leaf=5, **hp_kw)
    hist, tot = _hists(rng, num_bins, 3, **hist_kw)
    F = len(num_bins)
    jm, tm = _metas(num_bins, [True] * F)
    po = np.zeros(3, np.float32)
    sh2 = torch.from_numpy(tot[:, 1]) + 2 * tsplit.K_EPSILON
    thp = tsplit.SplitHyperParams(**hp)
    args = (torch.from_numpy(hist), torch.from_numpy(tot[:, 0]), sh2,
            torch.from_numpy(tot[:, 2]), torch.from_numpy(po), tm.num_bin,
            thp)
    # every branch (onehot None), and the ones the features take
    runs = [tsplit._categorical_scan(*args),
            tsplit._categorical_scan(*args, onehot=[
                nb - 1 <= thp.max_cat_to_onehot for nb in num_bins])]
    for n in range(3):
        want = jsplit._categorical_scan(
            jnp.asarray(hist[n]), jnp.float32(tot[n, 0]),
            jnp.float32(tot[n, 1]) + 2 * jsplit.K_EPSILON,
            jnp.float32(tot[n, 2]), jnp.float32(0.0), jm,
            jsplit.SplitHyperParams(**hp))
        for got in runs:
            for k, v in want.items():
                mine = (got["vals"][n, :, tsplit.CAT_VALUES.index(k)]
                        if k in tsplit.CAT_VALUES else got[k][n])
                np.testing.assert_array_equal(
                    mine.numpy(), np.asarray(v).astype(mine.numpy().dtype),
                    err_msg=f"{case} leaf {n} {k}")
    assert (runs[0]["net_gain"] > -np.inf).any(), "no valid categorical split"


@pytest.mark.parametrize("case", ["sorted_subset", "non_dyadic",
                                  "min_data_per_group"])
def test_best_split_with_categorical_features_matches_jax(rng, case):
    """The whole selection, batched over leaves, with categorical and
    numerical features side by side: every record field and the set."""
    num_bins, hp_kw, hist_kw = SCAN_CASES[case]
    num_bins = num_bins + [16, 30]
    is_cat = [True] * (len(num_bins) - 2) + [False, False]
    hp = dict(min_data_in_leaf=5, **hp_kw)
    hist, tot = _hists(rng, num_bins, 4, **hist_kw)
    jm, tm = _metas(num_bins, is_cat)
    po = np.asarray([0.0, 0.1, -0.2, 0.0], np.float32)
    rec = tsplit.best_split_for_leaf(
        torch.from_numpy(hist), tot[:, 0], tot[:, 1], tot[:, 2], po, tm,
        tsplit.SplitHyperParams(**hp))
    wins = set()
    for n in range(4):
        want = jsplit.best_split_for_leaf(
            jnp.asarray(hist[n]), jnp.float32(tot[n, 0]),
            jnp.float32(tot[n, 1]), jnp.float32(tot[n, 2]),
            jnp.float32(po[n]), jm, jsplit.SplitHyperParams(**hp))
        for k in want._fields:
            np.testing.assert_array_equal(
                getattr(rec, k)[n].numpy().astype(np.float64),
                np.asarray(getattr(want, k)).astype(np.float64),
                err_msg=f"{case} leaf {n} {k}")
        wins.add(bool(want.num_cat > 0))
    # no feature mask: the batched scan with one mask row a leaf agrees
    mask = torch.ones((4, len(num_bins)), dtype=torch.bool)
    mask[:, :len(is_cat) - 2] = False
    masked = tsplit.best_split_for_leaf(
        torch.from_numpy(hist), tot[:, 0], tot[:, 1], tot[:, 2], po, tm,
        tsplit.SplitHyperParams(**hp), feature_mask=mask)
    assert (masked.num_cat == 0).all()
    assert True in wins


def test_greedy_groups_is_the_sequential_thinning(rng):
    """The slot-parallel ``min_data_per_group`` thinning against the
    reference's loop (group sum, reset on a candidate)."""
    for mdpg in (0.0, 1.0, 50.0, 150.0):
        elig = torch.from_numpy(rng.uniform(size=(5, 3, 2, 32)) < 0.8)
        cnt = torch.from_numpy(rng.integers(0, 90, size=(5, 3, 2, 32))
                               .astype(np.float32))
        got = tsplit._greedy_groups(elig, cnt, mdpg).numpy()
        e, c = elig.numpy(), cnt.numpy()
        want = np.zeros_like(e)
        for idx in np.ndindex(*e.shape[:-1]):
            group = 0.0
            for i in range(32):
                group += c[idx + (i,)]
                if e[idx + (i,)] and group >= mdpg:
                    want[idx + (i,)] = True
                    group = 0.0
        np.testing.assert_array_equal(got, want, err_msg=str(mdpg))


def test_rand_u_is_refused():
    hist, tot = _hists(np.random.default_rng(0), [6], 1)
    _, tm = _metas([6], [True])
    with pytest.raises(NotImplementedError, match="A12.6"):
        tsplit.best_split_for_leaf(torch.from_numpy(hist[0]), tot[0, 0],
                                   tot[0, 1], tot[0, 2], 0.0, tm,
                                   tsplit.SplitHyperParams(),
                                   rand_u=torch.zeros(1))


def test_per_feature_net_gains_takes_the_categorical_scan(rng):
    hist, tot = _hists(rng, [12, 40, 16], 2)
    _, tm = _metas([12, 40, 16], [True, True, False])
    hp = tsplit.SplitHyperParams(min_data_in_leaf=5, min_data_per_group=10)
    net = tsplit.per_feature_net_gains(torch.from_numpy(hist), tot[:, 0],
                                       tot[:, 1], tot[:, 2], [0.0, 0.0],
                                       tm, hp)
    rec = tsplit.best_split_for_leaf(torch.from_numpy(hist), tot[:, 0],
                                     tot[:, 1], tot[:, 2], [0.0, 0.0], tm,
                                     hp)
    np.testing.assert_array_equal(net.max(dim=1).values.numpy(),
                                  rec.gain.numpy())


def test_level_partition_table_equals_the_per_row_set_gather(rng):
    """The level grower's ``[n_nodes, B]`` membership table sends each row
    where the JAX package's ``[R, MAXK]`` gather of its node's set does."""
    R, F, B, nodes, K = 5000, 3, 40, 16, 8
    bins = torch.from_numpy(rng.integers(0, B, size=(R, F)))
    node = torch.from_numpy(rng.integers(0, nodes, size=R))
    sets = torch.from_numpy(rng.integers(0, B, size=(nodes, K)))
    num_cat = torch.from_numpy(rng.integers(0, K + 1, size=nodes))
    sets = torch.where(torch.arange(K) < num_cat[:, None], sets, -1)
    feat = torch.from_numpy(rng.integers(0, F, size=nodes))
    thr = torch.from_numpy(rng.integers(0, B, size=nodes))
    meta = tsplit.FeatureMeta(
        num_bin=torch.full((F,), B, dtype=torch.int32),
        missing_type=torch.tensor([0, 1, 2], dtype=torch.int32),
        default_bin=torch.full((F,), 3, dtype=torch.int32))
    f_row = feat[node]
    col = bins.gather(1, f_row[:, None])[:, 0]
    dl = torch.from_numpy(rng.uniform(size=nodes) < 0.5)
    got = go_left_rows(col, thr[node], dl[node], meta, f_row, node, num_cat,
                       tgrower.cat_table(sets, B))
    plain = go_left_rows(col, thr[node], dl[node], meta, f_row)
    in_set = (col[:, None] == sets[node]).any(dim=1)
    want = torch.where(num_cat[node] > 0, in_set, plain)
    assert torch.equal(got, want)
    assert 0 < int((num_cat[node] > 0).sum()) < R


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _cat_data(rng, n=N, top=300):
    c0 = rng.integers(0, 30, size=n)
    c1 = rng.integers(0, 5, size=n)
    c3 = np.minimum(rng.zipf(1.3, size=n) - 1, top - 1)
    x = rng.normal(size=n)
    X = np.column_stack([c0, x, c1, c3]).astype(np.float64)
    X[rng.uniform(size=n) < 0.03, 0] = np.nan
    eff = [rng.normal(size=30), rng.normal(size=5), rng.normal(size=top)]
    signal = (eff[0][c0] + eff[1][c1] + eff[2][c3] + 0.5 * x)
    return X, signal, rng


def _regression(rng):
    X, s, rng = _cat_data(rng)
    return X, s + 0.3 * rng.normal(size=len(s))


def _train_both(params, X, y, rounds=ROUNDS, **kw):
    jb = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=CATS),
                   num_boost_round=rounds, **kw)
    tb = lgt.train(params, lgt.Dataset(X, label=y, categorical_feature=CATS),
                   num_boost_round=rounds, **kw)
    return jb, tb


@pytest.fixture(scope="module")
def compact_models():
    """The compact L2 model of both packages, reused by the text,
    prediction, SHAP and continuation tests."""
    X, y = _regression(np.random.default_rng(11))
    params = {"objective": "regression", **BASE}
    jb, tb = _train_both(params, X, y)
    return dict(X=X, y=y, params=params, jb=jb, tb=tb)


def test_compact_model_text_equals_jax(compact_models):
    """The saved text string for string: trees, category bitsets, leaf
    values, feature infos."""
    jt = compact_models["jb"].model_to_string()
    tt = compact_models["tb"].model_to_string()
    assert tt == jt
    trees = _trees(tt)
    assert sum(int(t["num_cat"]) for t in trees) >= 3 * ROUNDS
    np.testing.assert_array_equal(
        compact_models["tb"].predict(compact_models["X"], raw_score=True),
        compact_models["jb"].predict(compact_models["X"], raw_score=True))


@pytest.mark.parametrize("extra", [
    pytest.param({"use_quantized_grad": True}, id="quantized"),
    pytest.param({"max_bin": 511}, id="u16_bins")])
def test_regression_text_equals_jax(rng, extra):
    X, y = _regression(rng)
    jb, tb = _train_both({"objective": "regression", **BASE, **extra}, X, y)
    assert tb.model_to_string() == jb.model_to_string()


def _dyadic_fobj(yq):
    """An L2-like custom objective whose gradients are multiples of 1/8
    and hessians 1: every histogram sum is exact in any order, so every
    grower's tree is determined bit for bit."""
    def fobj(score, dataset):
        s = np.asarray(score, np.float64).reshape(-1)
        return np.clip(np.round(s * 8) / 8, -64, 64) - yq, np.ones(len(yq))
    return fobj


@pytest.mark.parametrize("extra", [
    pytest.param({"tpu_row_scheduling": "full"}, id="full"),
    pytest.param({"tpu_row_scheduling": "level", "max_depth": 4},
                 id="level"),
    pytest.param({"tpu_row_scheduling": "level",
                  "tpu_level_handoff_depth": 2}, id="hybrid")])
def test_dyadic_objective_trees_equal_jax(rng, extra):
    """Full scheduling (the JAX package sums its CPU histograms in
    another order, ROADMAP C1(b)) and the level growers (the port's plain
    K2 sums in f64, C1(c)) on dyadic gradients: the model text, trees,
    category sets and leaf values, is the JAX package's bit for bit."""
    X, y = _regression(rng)
    yq = np.round(y * 8) / 8
    params = {"objective": _dyadic_fobj(yq), **BASE, **extra}
    jb, tb = _train_both(params, X, yq)
    jt, tt = _no_params(jb.model_to_string()), _no_params(
        tb.model_to_string())
    assert tt == jt
    assert all(int(t["num_cat"]) > 0 for t in _trees(tt))


def test_bf16_tree_matches_jax_bf16_histograms(rng):
    """bf16 histograms (the JAX grower's einsum path rounds gh to bf16 as
    the port does) over categorical bins, dyadic gradients bf16 holds:
    the tree, its sets included, bit for bit."""
    X, _, rng = _cat_data(rng)
    ds = lgt.Dataset(X, label=np.zeros(len(X)),
                     categorical_feature=CATS).construct().binned
    mappers = ds.used_bin_mappers()
    bins = ds.bins
    R = len(X)
    g = rng.integers(-16, 17, size=R).astype(np.float32) / 8
    gh = np.stack([g, np.ones(R, np.float32), np.ones(R, np.float32)], 1)
    B = max(m.num_bin for m in mappers)
    kw = dict(min_data_in_leaf=5, min_data_per_group=20, cat_smooth=5.0)
    jcfg = jgrower.GrowerConfig(
        num_leaves=15, num_bin=B, hparams=jsplit.SplitHyperParams(**kw),
        row_sched="compact", hist_rm_backend="einsum", hist_dtype="bfloat16",
        partition_mode="scatter", min_bucket=R)
    jt, _ = jgrower.make_tree_grower(
        jcfg, jsplit.FeatureMeta.from_mappers(mappers))(
            jnp.asarray(bins), jnp.asarray(gh))
    tcfg = tgrower.GrowerConfig(num_leaves=15, num_bin=B,
                                hparams=tsplit.SplitHyperParams(**kw),
                                hist_dtype="bfloat16")
    tt, _ = tgrower.make_tree_grower(
        tcfg, tsplit.FeatureMeta.from_mappers(mappers))(
            torch.from_numpy(bins), torch.from_numpy(gh))
    n = int(jt.num_leaves)
    assert tt.num_leaves == n > 1 and (tt.cat_count > 0).any()
    for f in tt._fields:
        if f in ("num_leaves", "shrinkage"):
            continue
        cut = n if f.startswith("leaf") else n - 1
        want = np.asarray(getattr(jt, f))[:cut]
        got = np.asarray(getattr(tt, f))[:cut]
        np.testing.assert_array_equal(got, want[..., :got.shape[-1]]
                                      if got.ndim == 2 else want, f)


def _assert_same_cat_sets(jb, tb):
    for j, t in zip(_trees(jb.model_to_string()),
                    _trees(tb.model_to_string())):
        for k in ("num_cat", "cat_boundaries", "cat_threshold"):
            assert t.get(k) == j.get(k), k


def test_binary_to_the_binary_standard(rng):
    X, s, rng = _cat_data(rng)
    y = (s + 0.5 * rng.normal(size=len(s)) > 0.3).astype(np.float64)
    jb, tb = _train_both({"objective": "binary", **BASE}, X, y)
    _assert_same_cat_sets(jb, tb)
    assert_trees_to_binary_standard(jb, tb, X, g_max=1.0, h_max=0.25)


def test_softmax_to_the_binary_standard(rng):
    X, s, rng = _cat_data(rng)
    y = np.digitize(s + 0.5 * rng.normal(size=len(s)), [-0.5, 0.5])
    params = {"objective": "multiclass", "num_class": 3, **BASE}
    jb, tb = _train_both(params, X, y.astype(np.float64))
    _assert_same_cat_sets(jb, tb)
    assert_trees_to_binary_standard(jb, tb, X, objective="multiclass")


# ---------------------------------------------------------------------------
# continuation, prediction, explanation
# ---------------------------------------------------------------------------

def test_categorical_init_model_continues_like_jax(compact_models, tmp_path):
    """Both packages continue 2 rounds from the JAX package's saved
    model: the init model's bitsets decoded back to this dataset's bins,
    its trees replayed onto the score, the new trees the same."""
    m = compact_models
    path = tmp_path / "init.txt"
    m["jb"].save_model(str(path))
    jb, tb = _train_both(m["params"], m["X"], m["y"], rounds=2,
                         init_model=str(path))
    assert tb.model_to_string() == jb.model_to_string()
    eng = tb._engine
    assert all(t.cat_bins_inner.shape[0] == t.num_leaves - 1
               for t in eng.models)
    np.testing.assert_allclose(eng.score[0].numpy(),
                               tb.predict(m["X"], raw_score=True),
                               rtol=0, atol=1e-5)


def test_category_31_round_trips_through_the_text(rng, tmp_path):
    """A category whose bitset bit is 31 (value 31, 63, ...) sets the top
    bit of a word: the port writes and reads it back (the JAX package's
    loader parses words as int32 and cannot, ROADMAP C, reference side)."""
    n = 2000
    c = rng.integers(0, 64, size=n)
    eff = np.zeros(64)
    eff[[31, 63]] = 3.0
    X = np.column_stack([c, rng.normal(size=n)]).astype(np.float64)
    y = eff[c] + 0.1 * rng.normal(size=n)
    params = {"objective": "regression", **BASE}
    tb = lgt.train(params, lgt.Dataset(X, label=y, categorical_feature=[0]),
                   num_boost_round=2)
    words = np.concatenate([t.cat_threshold for t in tb._engine.models])
    assert (words & np.uint32(1 << 31)).any()
    path = tmp_path / "m.txt"
    tb.save_model(str(path))
    loaded = lgt.Booster(params={"device_type": "cpu"}, model_file=str(path))
    np.testing.assert_array_equal(loaded.predict(X), tb.predict(X))
    more = lgt.train(params, lgt.Dataset(X, label=y, categorical_feature=[0]),
                     num_boost_round=1, init_model=str(path))
    assert more.num_trees() == 3


def test_binned_device_route_agrees_with_the_host_walk(compact_models,
                                                       capfd):
    """Unseen categories, NaN, negative and fractional values through
    the device's bitsets over bins and the host walk's over raw values;
    a model loaded from text answers by the host walk and says so."""
    m = compact_models
    rng = np.random.default_rng(3)
    X = m["X"][:600].copy()
    X[:100, 0] = rng.integers(30, 60, size=100)        # unseen categories
    X[100:150, 3] = np.nan
    X[150:200, 2] = -rng.integers(1, 4, size=50)
    X[200:250, 0] = X[200:250, 0] + 0.5
    tb = m["tb"]
    host = tb.predict(X, raw_score=True)
    dev = tb.predict(X, raw_score=True, device=True)
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(host, m["jb"].predict(X, raw_score=True))
    loaded = lgt.Booster(params={"device_type": "cpu", "verbosity": 0},
                         model_str=tb.model_to_string())
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True,
                                                 device=True), host)
    assert "categorical splits" in capfd.readouterr().err


def test_pred_contrib_sums_to_the_raw_score(compact_models):
    m = compact_models
    X = m["X"][:300]
    contrib = m["tb"].predict(X, pred_contrib=True)
    np.testing.assert_allclose(contrib.sum(axis=1),
                               m["tb"].predict(X, raw_score=True),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(contrib, m["jb"].predict(X, pred_contrib=True),
                               rtol=0, atol=1e-12)


def test_categorical_value_to_bin_equals_the_loop(rng):
    """The one-lookup categorical ``value_to_bin`` bins as the loop over
    categories did: NaN, negative and unseen values to bin 0."""
    sample = np.minimum(rng.zipf(1.4, size=5000) - 1, 400).astype(float)
    m = BinMapper.find_bin(sample, len(sample), 255, 3, 20,
                           bin_type="categorical")
    vals = np.concatenate([rng.integers(-5, 600, size=20000).astype(float),
                           [np.nan, -1.0, 0.5, 3.7, 1e6]])
    want = np.zeros(len(vals), np.int32)
    iv = np.where(np.isnan(vals), -1, vals).astype(np.int64)
    for cat, b in m.categorical_2_bin.items():
        want[iv == cat] = b
    got = m.value_to_bin(vals)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 50
