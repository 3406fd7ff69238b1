"""Settings the PyTorch port cannot honour yet are refused, by name and
with the ROADMAP item that ports them; the settings the port has ported
(quantized gradients, bf16 histograms, level, full and leaf scheduling,
every ``tpu_hist_kernel`` value, DART, random forests, bagging, GOSS,
column sampling, categorical features, monotone and interaction
constraints, CEGB, forced splits and bins, ``feature_contri``,
extra_trees and linear trees, asynchronous boosting, the heartbeat file,
the stall budget, the numeric guard and two-round file loading) train."""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import _UNSUPPORTED_WHEN

F = 4
# a case whose item is None was refused once and trains since its item
# was ported: tree_learner since A13a (outside a torch.distributed world
# it runs serial, with the JAX package's warning), two_round since A15
# (an in-memory Dataset ignores it; a file streams through the two-round
# loader)
REFUSED = [
    ("tree_learner", "voting", None),
    ("tree_learner", "data", None),
    ("two_round", True, None),
]


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, F))
    return X, (X[:, 0] > 0).astype(np.float64)


def test_every_refusal_is_covered():
    assert {name for name, _, item in REFUSED if item} == \
        set(_UNSUPPORTED_WHEN)


@pytest.mark.parametrize("name,value,item", REFUSED,
                         ids=[f"{n}={v}" for n, v, _ in REFUSED])
def test_unported_setting_is_refused_with_its_roadmap_item(name, value,
                                                           item):
    X, y = _data()
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              name: value}
    if item is None:
        assert not any(s.startswith(f"{name}=")
                       for s in lgt.Config(params).unsupported_settings())
        bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
        assert bst.num_trees() == 1
        if name == "tree_learner":
            assert bst._engine._tree_learner == "serial"
        return
    assert any(s.startswith(f"{name}=") and s.endswith(f"(ROADMAP {item})")
               for s in lgt.Config(params).unsupported_settings())
    with pytest.raises(lgt.basic.LightGBMError,
                       match=rf"{name}=.*\(ROADMAP {item}\)"):
        lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)


def _forced_files(tmp_path):
    splits = tmp_path / "forced.json"
    splits.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    bins = tmp_path / "bins.json"
    bins.write_text(json.dumps([{"feature": 1,
                                 "bin_upper_bound": [-0.5, 0.5]}]))
    return str(splits), str(bins)


# the settings A12.6 ported, once refused; a value that names a file is
# a key of the files ``_forced_files`` writes
PORTED_A12_6 = [
    ("extra_trees", True),
    ("monotone_constraints", [1] + [0] * (F - 1)),
    ("interaction_constraints", "[0,1],[2,3]"),
    ("forcedsplits_filename", "splits"),
    ("forcedbins_filename", "bins"),
    ("feature_contri", [0.5] * F),
    ("cegb_penalty_split", 0.1),
    ("cegb_penalty_feature_lazy", [1.0] * F),
    ("cegb_penalty_feature_coupled", [1.0] * F),
    ("linear_tree", True),
]


@pytest.mark.parametrize("name,value", PORTED_A12_6,
                         ids=[f"{n}={v}" for n, v in PORTED_A12_6])
def test_a12_6_settings_train(name, value, tmp_path):
    files = dict(zip(("splits", "bins"), _forced_files(tmp_path)))
    X, y = _data()
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              "num_leaves": 7, name: files.get(value, value)
              if isinstance(value, str) else value}
    assert lgt.Config(params).unsupported_settings() == []
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params),
                    num_boost_round=2)
    assert np.isfinite(bst.predict(X)).all()


# the settings A12.7 ported, once refused (the heartbeat file is made
# under the test's own directory)
PORTED_A12_7 = [
    ("tpu_integrity_numeric_guard", True),
    ("tpu_heartbeat_file", "heartbeat.json"),
]


@pytest.mark.parametrize("name,value", PORTED_A12_7,
                         ids=[f"{n}={v}" for n, v in PORTED_A12_7])
def test_a12_7_settings_train(name, value, tmp_path):
    from lightgbm_tpu_torch.robustness import heartbeat
    X, y = _data()
    if name == "tpu_heartbeat_file":
        value = str(tmp_path / value)
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              "num_leaves": 7, "tpu_stall_sec": 120.0,
              "tpu_integrity_loss_spike_factor": 50.0, name: value}
    assert lgt.Config(params).unsupported_settings() == []
    try:
        bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=2)
    finally:
        heartbeat.uninstall()
    assert np.isfinite(bst.predict(X)).all()
    if name == "tpu_heartbeat_file":
        assert heartbeat.read(value).phase == "iter"
    else:
        assert bst._engine._nguard.spike_factor == 50.0


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


@pytest.mark.parametrize("name,value", [("pre_partition", True),
                                        ("tpu_ingest", "sharded")])
def test_sharded_ingestion_in_a_world_of_two_is_refused(name, value):
    """Sharded ingestion is ported: in a world of two it is no longer
    refused (nor in a world of one, which has nothing to shard), while a
    ``tpu_num_devices`` other than the world still is."""
    cfg = lgt.Config({"objective": "binary", name: value})
    assert cfg.distributed_refusals(2) == []
    assert cfg.distributed_refusals(1) == []
    cfg = lgt.Config({"objective": "binary", name: value,
                      "tpu_num_devices": 4})
    refused = cfg.distributed_refusals(2)
    assert len(refused) == 1
    assert refused[0].startswith("tpu_num_devices=4 in a world of 2")


def test_tpu_num_devices_other_than_the_world_is_refused():
    X, y = _data()
    params = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
              "tree_learner": "data", "tpu_num_devices": 2}
    with pytest.raises(lgt.basic.LightGBMError,
                       match="tpu_num_devices=2 in a world of 1"):
        lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)
    for n in (0, 1):
        lgt.train({**params, "tpu_num_devices": n},
                  lgt.Dataset(X, label=y), num_boost_round=1)


def test_launcher_refuses_what_it_cannot_do():
    from lightgbm_tpu_torch import distributed as dist
    # supervised=True launches now: a gang of two that exits 0 returns
    assert [rc for rc, _ in dist.launch_local(
        ["true"], 2, supervised=True, timeout=30, poll=0.05)] == [0, 0]
    with pytest.raises(ValueError, match="one process per device"):
        dist.worker_env("localhost:1", 2, 0, cpu_devices_per_process=2)
    with pytest.raises(ValueError, match="one process per device"):
        dist.launch_local(["true"], 2, cpu_devices_per_process=4)
