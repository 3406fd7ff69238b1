"""Monotone and interaction constraints, CEGB and forced splits in the
PyTorch port against the JAX package: the same params and the same rows,
made with numpy from a seed, through both packages on the CPU.

L2 regression on the compact grower is held string for string (the model
text bar its parameters block): monotone constraints by the basic,
intermediate and advanced methods (the refined two also with quantized
gradients), ``monotone_penalty``, interaction groups, CEGB with its three
penalties, forced splits (with ``max_depth``, and a prefix that ends at a
split of no gain). Each constraint is also checked as a property of both
packages' models: predictions monotone along a swept feature, every
tree's features inside one interaction group, the forced prefix at the
top of every tree, fewer features used under CEGB. Binary trees are held
to the binary standard (``test_torch_multiclass``); full scheduling, on a
dyadic objective whose sums are exact in any order, string for string.
``tpu_row_scheduling=level`` with any of these settings logs the JAX
package's reason and trains the compact model.
"""
import json

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu.ops import split as jsplit
from test_torch_categorical import _dyadic_fobj
from test_torch_multiclass import assert_trees_to_binary_standard

N, F, ROUNDS = 2000, 8, 4
MONO = [1, -1, 0, 0, 0, 0, 0, 0]
GROUPS = [[0, 1, 2], [3, 4], [5, 6, 7]]


def _data(seed=0, n=N, objective="regression"):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, F))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    signal = (2 * X[:, 0] - 1.5 * X[:, 1] + np.sin(3 * X[:, 2])
              + X[:, 3] * X[:, 4] + 0.5 * X[:, 5] * X[:, 6])
    signal = np.nan_to_num(signal)
    if objective == "binary":
        return X, (signal + 0.3 * rng.normal(size=n) > 0).astype(float)
    return X, signal + 0.1 * rng.normal(size=n)


def _params(**extra):
    return {"objective": "regression", "num_leaves": 15,
            "min_data_in_leaf": 5, "verbosity": -1, "device_type": "cpu",
            **extra}


def _no_params(model_str):
    return model_str[:model_str.index("\nparameters:")]


_TRAINED = {}


def _train_both(params, seed=0, objective="regression", y=None):
    """Both packages' boosters on the same rows, trained once a module
    for each set of arguments (most of a case's time is the JAX
    package's compile)."""
    key = (tuple(sorted((k, str(v)) for k, v in params.items())), seed,
           objective)
    if key not in _TRAINED:
        X, y0 = _data(seed, objective=objective)
        y = y0 if y is None else y
        _TRAINED[key] = (X, y) + tuple(
            pkg.train(params, pkg.Dataset(X, label=y),
                      num_boost_round=ROUNDS) for pkg in (lgb, lgt))
    return _TRAINED[key]


def assert_same_text(jb, tb):
    assert _no_params(tb.model_to_string()) == \
        _no_params(jb.model_to_string())


def _monotone_along(bst, X, feature, sign):
    """Predictions over 1,000 rows are monotone in ``feature``: each of
    ten base rows swept over 100 values of it."""
    grid = np.linspace(-1, 1, 100)
    probe = np.repeat(X[:10], len(grid), axis=0)
    probe[:, feature] = np.tile(grid, 10)
    d = np.diff(bst.predict(probe).reshape(10, -1), axis=1)
    return bool((sign * d >= -1e-12).all())


def _tree_features(bst):
    """Each tree's set of split features, from its dump."""
    out = []
    for tree in bst.dump_model()["tree_info"]:
        feats, stack = set(), [tree["tree_structure"]]
        while stack:
            node = stack.pop()
            if "split_feature" in node:
                feats.add(int(node["split_feature"]))
                stack += [node["left_child"], node["right_child"]]
        out.append(feats)
    return out


MONOTONE = {
    "basic": {},
    "penalty": {"monotone_penalty": 2.0},
    "intermediate": {"monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints_method": "advanced"},
    "intermediate_quantized": {"monotone_constraints_method":
                               "intermediate", "use_quantized_grad": True},
    "advanced_quantized": {"monotone_constraints_method": "advanced",
                           "use_quantized_grad": True},
}


@pytest.mark.parametrize("variant", MONOTONE)
def test_monotone_matches_jax_and_holds(variant):
    """The monotone methods (intermediate's rescans and advanced's
    recomputed bounds, f32 on the host as the JAX package keeps them)
    give the JAX package's text; both models rise along feature 0 and
    fall along feature 1."""
    X, _, jb, tb = _train_both(_params(monotone_constraints=MONO,
                                       **MONOTONE[variant]))
    assert_same_text(jb, tb)
    for bst in (jb, tb):
        assert _monotone_along(bst, X, 0, +1)
        assert _monotone_along(bst, X, 1, -1)


def test_constraint_binds():
    """Without constraints the same rows break monotonicity, so the
    cases above test something."""
    X, _, jb, tb = _train_both(_params())
    assert_same_text(jb, tb)
    assert not (_monotone_along(tb, X, 0, +1)
                and _monotone_along(tb, X, 1, -1))


def test_monotone_bounds_are_f32_like_jax():
    """A leaf's output bounds enter the scan as f32 (0.1 is not an f32
    value): the split record is the JAX package's bit for bit, the
    categorical side too (a mutant that clamps against f64 bounds rounds
    the gains otherwise)."""
    rng = np.random.default_rng(3)
    B = 32
    hist = rng.normal(size=(F, B, 3)).astype(np.float32)
    hist[..., 1] = np.abs(hist[..., 1]) + 0.1
    hist[..., 2] = rng.integers(5, 40, size=(F, B))
    sums = hist[0].sum(0, dtype=np.float64).astype(np.float32)

    class _M:
        pass
    mappers = []
    for f in range(F):
        m = _M()
        m.num_bin, m.missing_type, m.default_bin = B, "none", 0
        m.bin_type = "categorical" if f == 5 else "numerical"
        mappers.append(m)
    jm = jsplit.FeatureMeta.from_mappers(mappers, monotone=MONO)
    tm = tsplit.FeatureMeta.from_mappers(mappers, monotone=MONO)
    kw = dict(min_data_in_leaf=1, min_data_per_group=5, cat_smooth=1.0)
    # jitted, as the JAX grower runs it (XLA fuses the gain's
    # multiply-add there, ops/split.leaf_gain_at_clamped_output)
    jr = jax.jit(lambda h: jsplit.best_split_for_leaf(
        h, *sums, np.float32(0.05), jm, jsplit.SplitHyperParams(**kw),
        leaf_range=(-0.1, 0.1)))(hist)
    tr = tsplit.best_split_for_leaf(
        torch.tensor(hist), *sums, np.float32(0.05), tm,
        tsplit.SplitHyperParams(**kw), leaf_range=(-0.1, 0.1))
    for name in ("gain", "feature", "threshold", "left_output",
                 "right_output", "left_sum_gradient"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, name)),
                                      getattr(tr, name).numpy(), name)


def test_interaction_constraints_match_jax_and_hold():
    X, _, jb, tb = _train_both(_params(
        interaction_constraints=",".join(
            "[" + ",".join(map(str, g)) + "]" for g in GROUPS)))
    assert_same_text(jb, tb)
    for bst in (jb, tb):
        for feats in _tree_features(bst):
            assert any(feats <= set(g) for g in GROUPS), feats


CEGB = dict(cegb_penalty_split=0.1, cegb_penalty_feature_coupled=[1.0] * F,
            cegb_penalty_feature_lazy=[0.5] * F, cegb_tradeoff=1.5)


def test_cegb_matches_jax_and_uses_fewer_features():
    """All three penalties, with their state across trees (the used
    features, the charged rows of the lazy penalty)."""
    X, _, jb, tb = _train_both(_params(**CEGB))
    assert_same_text(jb, tb)
    _, _, jb0, tb0 = _train_both(_params())
    used = lambda b: len(set().union(*_tree_features(b)))
    for bst, base in ((jb, jb0), (tb, tb0)):
        assert used(bst) < used(base)


def test_modifier_order_matches_jax():
    """feature_contri, then CEGB, then the monotone penalty, each on the
    feature's net gain (the order decides the f32 bits: a mutant that
    subtracts CEGB before feature_contri changes the gains)."""
    _, _, jb, tb = _train_both(_params(
        feature_contri=[0.6, 1.0, 0.9, 0.5, 1.0, 1.0, 0.8, 1.0],
        cegb_penalty_split=0.05, cegb_penalty_feature_coupled=[3.0] * F,
        monotone_constraints=MONO, monotone_penalty=0.5))
    assert_same_text(jb, tb)


def test_cegb_in_random_forest():
    """RF honours CEGB: the penalized twin of feature 1 is never used."""
    params = _params(boosting="rf", bagging_fraction=0.8, bagging_freq=1,
                     cegb_penalty_feature_coupled=[1e6] + [0.0] * (F - 1))
    rng = np.random.default_rng(1)
    X, y = _data(1)
    X[:, 0] = X[:, 1] + 0.01 * rng.normal(size=len(X))
    jb, tb = (pkg.train(params, pkg.Dataset(X, label=y),
                        num_boost_round=ROUNDS) for pkg in (lgb, lgt))
    assert_same_text(jb, tb)
    assert tb.feature_importance()[0] == 0
    assert tb.feature_importance()[1] > 0


def _forced(tmp_path, spec, name="forced.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


SPINE = {"feature": 2, "threshold": 0.0,
         "left": {"feature": 0, "threshold": 0.3,
                  "left": {"feature": 1, "threshold": -0.2}},
         "right": {"feature": 4, "threshold": 0.1}}


def test_forced_splits_match_jax_and_lead_every_tree(tmp_path):
    X, _, jb, tb = _train_both(_params(
        forcedsplits_filename=_forced(tmp_path, SPINE)))
    assert_same_text(jb, tb)
    for tree in tb.dump_model()["tree_info"]:
        root = tree["tree_structure"]
        assert root["split_feature"] == 2
        assert root["left_child"]["split_feature"] == 0
        assert root["right_child"]["split_feature"] == 4
        assert root["left_child"]["left_child"]["split_feature"] == 1


def test_forced_splits_honour_max_depth(tmp_path):
    _, _, jb, tb = _train_both(_params(
        forcedsplits_filename=_forced(tmp_path, SPINE), max_depth=2))
    assert_same_text(jb, tb)

    def depth(node):
        if "split_feature" not in node:
            return 0
        return 1 + max(depth(node["left_child"]), depth(node["right_child"]))
    for bst in (jb, tb):
        for tree in bst.dump_model()["tree_info"]:
            assert depth(tree["tree_structure"]) <= 2


def test_forced_prefix_ends_at_a_split_without_gain(tmp_path):
    """The second forced split sends every row left (no gain): it and the
    rest of the prefix are dropped and best-first growth takes over, as
    in the JAX package (a mutant that goes on with the prefix applies
    the third, on feature 7)."""
    spec = {"feature": 2, "threshold": 0.0,
            "left": {"feature": 5, "threshold": 5.0},
            "right": {"feature": 7, "threshold": 0.0}}
    _, _, jb, tb = _train_both(_params(
        forcedsplits_filename=_forced(tmp_path, spec, "abort.json")))
    assert_same_text(jb, tb)
    root = tb.dump_model()["tree_info"][0]["tree_structure"]
    assert root["split_feature"] == 2
    assert root["right_child"].get("split_feature") != 7


def test_binary_monotone_to_the_binary_standard():
    params = _params(objective="binary", monotone_constraints=MONO,
                     monotone_constraints_method="intermediate")
    X, _, jb, tb = _train_both(params, seed=2, objective="binary")
    assert_trees_to_binary_standard(jb, tb, X, g_max=1.0, h_max=0.25,
                                    rate=0.1)
    assert _monotone_along(tb, X, 0, +1) and _monotone_along(tb, X, 1, -1)


def test_full_scheduling_on_dyadic_gradients(tmp_path):
    """Full scheduling (kernel B2's path) with the intermediate method
    and a forced prefix: on dyadic gradients every histogram sum is
    exact, so the text is the JAX package's (ROADMAP C1(b))."""
    X, y = _data(4)
    yq = np.round(y * 8) / 8
    params = _params(objective=_dyadic_fobj(yq), tpu_row_scheduling="full",
                     monotone_constraints=MONO,
                     monotone_constraints_method="intermediate",
                     forcedsplits_filename=_forced(tmp_path, SPINE))
    jb, tb = (pkg.train(dict(params), pkg.Dataset(X, label=yq),
                        num_boost_round=ROUNDS) for pkg in (lgb, lgt))
    assert tb._engine.row_sched == "full"
    assert_same_text(jb, tb)


LEVEL_REASONS = [
    ({"monotone_constraints": MONO}, "monotone constraints"),
    ({"monotone_penalty": 1.0}, "monotone constraints"),
    ({"interaction_constraints": "[0,1,2],[3,4]"},
     "interaction constraints"),
    ({"cegb_penalty_split": 0.1}, "CEGB penalties"),
    ({"forcedsplits_filename": "SPINE"}, "forced splits"),
    ({"extra_trees": True}, "extra_trees"),
    ({"linear_tree": True}, "linear trees"),
]


@pytest.mark.parametrize("extra,reason", LEVEL_REASONS,
                         ids=[r[1] + "-" + next(iter(r[0]))
                              for r in LEVEL_REASONS])
def test_level_falls_back_to_compact_with_the_jax_reason(extra, reason,
                                                         tmp_path, capsys):
    if "forcedsplits_filename" in extra:
        extra = {"forcedsplits_filename": _forced(tmp_path, SPINE)}
    X, y = _data(5, n=600)
    base = _params(verbosity=0, max_depth=4, **extra)
    lvl = lgt.train({**base, "tpu_row_scheduling": "level"},
                    lgt.Dataset(X, label=y, params=base), num_boost_round=2)
    err = capsys.readouterr().err
    assert "tpu_row_scheduling='level' does not support" in err
    assert reason in err.split("does not support", 1)[1].split("\n")[0]
    assert lvl._engine.row_sched == "compact"
    cmp = lgt.train(base, lgt.Dataset(X, label=y, params=base),
                    num_boost_round=2)
    assert _no_params(lvl.model_to_string()) == \
        _no_params(cmp.model_to_string())


@pytest.mark.parametrize("extra,said", [
    ({"monotone_constraints": MONO,
      "monotone_constraints_method": "intermediate"},
     "re-scans from it; keeping the full pool"),
    ({"forcedsplits_filename": "SPINE"},
     "forced splits need it; keeping the full pool")],
    ids=["intermediate", "forced"])
def test_pool_policy_keeps_the_full_pool(extra, said, tmp_path, capsys):
    """A pool over the budget stays full for the intermediate rescans
    and for forced splits, with the JAX package's warnings."""
    if "forcedsplits_filename" in extra:
        extra = {"forcedsplits_filename": _forced(tmp_path, SPINE)}
    X, y = _data(6, n=600)
    bst = lgt.train(_params(verbosity=0, histogram_pool_size=0.01,
                            **extra),
                    lgt.Dataset(X, label=y), num_boost_round=1)
    assert bst._engine.grower_cfg.hist_pool == "full"
    assert said in capsys.readouterr().err


def _one_hot_rows(n=600, groups=3, per=5, seed=8):
    """Mutually exclusive one-hot blocks that EFB bundles (and that the
    multi-value storage holds sparsely)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, groups * per))
    for g in range(groups):
        X[np.arange(n), g * per + rng.integers(0, per, size=n)] = 1.0
    return X, X[:, 0] - X[:, 6] + 0.1 * rng.normal(size=n)


@pytest.mark.parametrize("storage", ["bundled", "multival"])
def test_forced_splits_with_bundles_and_multivalue(storage, tmp_path,
                                                   capsys):
    """As in the JAX package: forced splits turn EFB bundling off (the
    forced model is the unbundled one's), and multi-value storage
    ignores them; each says so."""
    import scipy.sparse as sp
    X, y = _one_hot_rows()
    spec = {"feature": 0, "threshold": 0.5}
    base = _params(verbosity=0, min_data_in_leaf=2,
                   forcedsplits_filename=_forced(tmp_path, spec))
    if storage == "bundled":
        bst = lgt.train(base, lgt.Dataset(X, label=y), num_boost_round=2)
        assert "disabling bundling" in capsys.readouterr().err
        assert bst._engine._bundle is None and bst._engine._forced
        plain = lgt.train({**base, "enable_bundle": False},
                          lgt.Dataset(X, label=y), num_boost_round=2)
        assert _no_params(bst.model_to_string()) == \
            _no_params(plain.model_to_string())
    else:
        params = {**base, "tpu_sparse_storage": "multival"}
        bst = lgt.train(params, lgt.Dataset(sp.csr_matrix(X), label=y,
                                            params=params),
                        num_boost_round=2)
        assert "not supported with multi-value sparse storage; ignoring" \
            in capsys.readouterr().err
        assert bst._engine._multival and bst._engine._forced is None


def test_monotone_constraints_length_is_checked():
    X, y = _data(7, n=300)
    with pytest.raises(lgt.basic.LightGBMError,
                       match="monotone_constraints has 3 entries"):
        lgt.train(_params(monotone_constraints=[1, 0, 0]),
                  lgt.Dataset(X, label=y), num_boost_round=1)
