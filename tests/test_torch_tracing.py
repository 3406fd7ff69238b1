"""The port's tracing: the LIGHTGBM_TPU_TIMETAG section table and
``tpu_profile_dir``, held to the JAX package's
(tests/test_aux_subsystems.py:14-40).

A compact regression run with a validation set, timer on, names the JAX
package's sections (it has one more, ``GBDT::StopCheck``, on its async
path, which the port has not), each counted once a tree, and trains the
model it trains with the timer off, string for string. ``tpu_profile_dir``
writes a Chrome trace of the boosting loop on the CPU; on the card it must
hold the card's kernels or ``train`` fails.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import engine
from lightgbm_tpu_torch.utils import timer as timer_mod
from lightgbm_tpu_torch.utils.timer import Timer, global_timer

ROUNDS = 3
PARAMS = {"objective": "regression", "verbose": -1, "num_leaves": 7,
          "min_data_in_leaf": 5}


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(1000, 4))
    Xv = rng.normal(size=(300, 4))
    return X, X[:, 0] + 0.5 * X[:, 1], Xv, Xv[:, 0]


def _train_port(timed, **extra):
    X, y, Xv, yv = _data()
    was = global_timer.enabled
    try:
        global_timer.enabled = timed
        global_timer.reset()
        ds = lgt.Dataset(X, label=y)
        bst = lgt.train({**PARAMS, "device_type": "cpu", **extra}, ds,
                        num_boost_round=ROUNDS,
                        valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)])
        return bst, global_timer.totals(), global_timer.table()
    finally:
        global_timer.enabled = was
        global_timer.reset()


@pytest.fixture(scope="module")
def jax_sections():
    import lightgbm_tpu as lgb
    from lightgbm_tpu.utils.timer import global_timer as jax_timer
    X, y, Xv, yv = _data()
    was = jax_timer.enabled
    try:
        jax_timer.enabled = True
        jax_timer.reset()
        ds = lgb.Dataset(X, label=y)
        lgb.train(dict(PARAMS), ds, num_boost_round=ROUNDS,
                  valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)])
        return dict(jax_timer._count)
    finally:
        jax_timer.enabled = was
        jax_timer.reset()


@pytest.fixture(scope="module")
def port_runs():
    timed = _train_port(True)
    plain = _train_port(False)
    return timed, plain


def test_timer_sections_are_the_jax_packages(jax_sections, port_runs):
    (bst, totals, table), _ = port_runs
    assert set(totals) == set(jax_sections) - {"GBDT::StopCheck"}
    assert set(totals) == {"GBDT::Boosting", "TreeLearner::Train",
                           "Tree::ToHost", "GBDT::UpdateScore",
                           "GBDT::UpdateValidScore"}
    for name in totals:
        assert name in table


def test_each_section_counts_once_a_tree(jax_sections, port_runs):
    (bst, totals, _), _ = port_runs
    assert bst.num_trees() == ROUNDS
    assert {k: c for k, (_, c) in totals.items()} == {
        k: bst.num_trees() for k in totals}
    assert {k: c for k, c in jax_sections.items()
            if k in totals} == {k: c for k, (_, c) in totals.items()}
    assert all(t >= 0.0 for t, _ in totals.values())


def test_timer_changes_no_model(port_runs):
    (timed, _, _), (plain, plain_totals, _) = port_runs
    assert plain_totals == {}
    assert timed.model_to_string() == plain.model_to_string()


def test_disabled_section_is_free():
    t = Timer()
    t.enabled = False

    def never():
        raise AssertionError("sync= evaluated while the timer is off")
    with t.section("x", sync=never):
        pass
    t.start("y")
    t.stop("y")
    assert t.totals() == {} and "no timing" in t.table()


def test_section_sync_skips_cpu_tensors(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.cuda.synchronize called for CPU data")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    t = Timer()
    t.enabled = True
    x = torch.ones(3)
    with t.section("a", sync=lambda: [x, {"k": (x, x)}]):
        pass
    with t.section("b", sync=x):
        pass
    assert {k: c for k, (_, c) in t.totals().items()} == {"a": 1, "b": 1}
    # the devices a sync waits for: CUDA ones only, each once
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    devs = timer_mod._cuda_devices([x, cuda, (cuda, {"z": x})], set())
    assert devs == {torch.device("cuda", 0)}


def _trees(text):
    return text[:text.index("\nparameters:")]


def test_profile_dir_writes_a_trace_on_cpu(tmp_path, port_runs):
    _, (plain, _, _) = port_runs
    d = tmp_path / "trace"
    bst, _, _ = _train_port(False, tpu_profile_dir=str(d))
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(d, files[0]), encoding="utf-8") as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    # tracing changes no tree (only the parameter section names the dir)
    assert _trees(bst.model_to_string()) == _trees(plain.model_to_string())


def test_profile_refuses_a_card_trace_without_cuda_activity(tmp_path,
                                                            monkeypatch):
    card = types.SimpleNamespace(
        _engine=types.SimpleNamespace(device=torch.device("cuda", 0)))
    cpu = types.SimpleNamespace(
        _engine=types.SimpleNamespace(device=torch.device("cpu")))
    import torch.profiler as tp
    monkeypatch.setattr(tp, "supported_activities",
                        lambda: {tp.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUPTI"):
        engine._profile_start(card)
    host_only = tmp_path / "host.json"
    host_only.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add"}]}))
    engine._check_trace(str(host_only), cpu)          # the CPU: fine
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        engine._check_trace(str(host_only), card)
    with_kernel = tmp_path / "card.json"
    with_kernel.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "hist_rowmajor_kernel"}]},
        indent=1))
    engine._check_trace(str(with_kernel), card)
