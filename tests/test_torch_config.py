"""Settings the PyTorch port cannot honour yet are refused, by name and
with the ROADMAP item that ports them; the settings the port has ported
(quantized gradients, bf16 histograms, level, full and leaf scheduling,
every ``tpu_hist_kernel`` value, DART, random forests, bagging, GOSS,
column sampling and categorical features) train."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import _UNSUPPORTED_WHEN

F = 4
REFUSED = [
    ("tree_learner", "voting", "A13"),
    ("tree_learner", "data", "A13"),
    ("extra_trees", True, "A12"),
    ("monotone_constraints", [1] + [0] * (F - 1), "A12"),
    ("interaction_constraints", "[0,1],[2,3]", "A12"),
    ("forcedsplits_filename", "forced.json", "A12"),
    ("forcedbins_filename", "bins.json", "A12"),
    ("feature_contri", [0.5] * F, "A12"),
    ("cegb_penalty_split", 0.1, "A12"),
    ("cegb_penalty_feature_lazy", [1.0] * F, "A12"),
    ("cegb_penalty_feature_coupled", [1.0] * F, "A12"),
    ("linear_tree", True, "A12"),
]


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, F))
    return X, (X[:, 0] > 0).astype(np.float64)


def test_every_refusal_is_covered():
    assert {name for name, _, _ in REFUSED} == set(_UNSUPPORTED_WHEN)


@pytest.mark.parametrize("name,value,item", REFUSED,
                         ids=[f"{n}={v}" for n, v, _ in REFUSED])
def test_unported_setting_is_refused_with_its_roadmap_item(name, value,
                                                           item):
    X, y = _data()
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              name: value}
    assert any(s.startswith(f"{name}=") and s.endswith(f"(ROADMAP {item})")
               for s in lgt.Config(params).unsupported_settings())
    with pytest.raises(lgt.basic.LightGBMError,
                       match=rf"{name}=.*\(ROADMAP {item}\)"):
        lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)


@pytest.mark.parametrize("extra", [
    {"use_quantized_grad": True, "num_grad_quant_bins": 8,
     "stochastic_rounding": False, "quant_train_renew_leaf": True},
    {"tpu_hist_dtype": "bf16"},
    {"tpu_row_scheduling": "level", "tpu_level_handoff_depth": 2},
    {"tpu_hist_kernel": "einsum"}, {"tpu_hist_kernel": "scatter"},
    {"tpu_hist_kernel": "pallas"}, {"tpu_hist_kernel": "pallas_level"},
    {"tpu_row_scheduling": "full", "tpu_use_pallas": True,
     "tpu_rows_per_block": 512},
    {"tpu_row_scheduling": "leaf", "use_quantized_grad": True},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"boosting": "dart"}, {"data_sample_strategy": "goss"},
    {"bagging_freq": 1, "bagging_fraction": 0.5},
    {"feature_fraction": 0.5}, {"feature_fraction_bynode": 0.5},
    {"categorical_feature": "0"}],
    ids=["quantized", "bf16", "level", "einsum", "scatter", "pallas",
         "pallas_level", "full", "leaf", "boosting=rf", "boosting=dart",
         "data_sample_strategy=goss", "bagging_freq=1",
         "feature_fraction=0.5", "feature_fraction_bynode=0.5",
         "categorical_feature=0"])
def test_ported_settings_train(extra):
    X, y = _data()
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              "num_leaves": 7, **extra}
    assert lgt.Config(params).unsupported_settings() == []
    bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=2)
    assert np.isfinite(bst.predict(X)).all()
