"""The distributed learners' grower hooks in a threaded world, injected
collectives, and the collective-liveness layer of the PyTorch port.

``ThreadComm`` is a world of W threads in one process with the
``parallel.mesh.Comm`` interface (a fixed-order sum, as a two-rank
all-reduce adds), so the grower hooks of data, voting and feature
parallel run here without spawning a gang: on quantized gradients with
deterministic rounding the histogram sums are exact, so each learner's
tree equals the serial grower's bit for bit (the JAX package's
``tests/test_parallel.py``, ``test_parallel_learners.py`` and
``test_hist_reduce.py``). The windows' combine keeps a winner's -0.0 and
sends an exact tie to the lower feature id.

The injected world is the JAX package's ``tests/test_injected_collectives.py``:
two threads train a Booster each on half the rows (bins shared through
``reference=``) with a barrier all-reduce as ``reduce_sum``; quantized
with deterministic rounding, both hold one model, which predicts as the
JAX package's centralized model does within rtol 1e-6 (the init score is
the mean of the workers' means). The collective-liveness cases are the
JAX package's ``tests/test_gang.py:199-296``.
"""
import logging
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import distributed as dist
from lightgbm_tpu_torch.core.grower import (B_FEAT, B_GAIN, B_LO, NB,
                                            GrowerConfig, make_tree_grower)
from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyperParams
from lightgbm_tpu_torch.parallel import (make_data_parallel_grower,
                                         make_distributed_train_step,
                                         make_feature_parallel_grower,
                                         make_global_best_combine,
                                         make_voting_parallel_grower)
from lightgbm_tpu_torch.parallel.data_parallel import RowShards
from lightgbm_tpu_torch.parallel.feature_parallel import (
    FeatureShardedLearner, feature_window, host_feature_slice)
from lightgbm_tpu_torch.robustness import faults


class ThreadWorld:
    """W threads exchanging tensors through a barrier."""

    def __init__(self, world):
        self.world = world
        self.barrier = threading.Barrier(world)
        self.bufs = [None] * world

    def exchange(self, rank, t):
        self.bufs[rank] = t.clone()
        self.barrier.wait()
        out = torch.stack(self.bufs)
        self.barrier.wait()          # all read before the next deposit
        return out


class ThreadComm:
    """``parallel.mesh.Comm``'s interface over a ``ThreadWorld``."""

    def __init__(self, tw, rank):
        self.tw, self.rank, self.world = tw, rank, tw.world
        self.device = torch.device("cpu")
        self.stats = {}

    def _ex(self, t, kind):
        self.stats[kind] = self.stats.get(kind, 0) + 1
        return self.tw.exchange(self.rank, t)

    def all_reduce_sum(self, t, kind="all_reduce"):
        a = self._ex(t, kind)
        out = a[0].clone()
        for x in a[1:]:
            out = out + x
        return out

    def all_reduce_max(self, t, kind="all_reduce_max"):
        return self._ex(t, kind).max(dim=0).values

    def reduce_scatter(self, t, kind="reduce_scatter"):
        s = self.all_reduce_sum(t, kind)
        k = t.shape[0] // self.world
        return s[self.rank * k:(self.rank + 1) * k]

    def all_gather(self, t, kind="all_gather"):
        return self._ex(t, kind)

    def broadcast_from(self, t, src, kind="broadcast"):
        return self._ex(t, kind)[src]


def run_threads(world, fn):
    """``fn(rank, comm)`` on W threads; their results in rank order."""
    tw = ThreadWorld(world)
    out, errs = [None] * world, []

    def body(r):
        try:
            out[r] = fn(r, ThreadComm(tw, r))
        except Exception as e:  # pragma: no cover — relayed below
            errs.append((r, e))
            tw.barrier.abort()
    threads = [threading.Thread(target=body, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    return out


def _problem(rng, n=2001, f=7, num_bin=16, dyadic=False):
    """Bins, gh, meta and a grower config: quantized with deterministic
    rounding, or f32 over dyadic gradients (sums exact in any order)."""
    bins = rng.integers(0, num_bin, size=(n, f)).astype(np.uint8)
    bins[:, 5] = bins[:, 1]                # an exact tie across shards
    g = (bins[:, 0] / num_bin - 0.5 + 0.3 * (bins[:, 1] > 7)
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    if dyadic:
        g = np.round(g * 64) / np.float32(64)
    gh = torch.from_numpy(np.stack([g, np.ones(n, np.float32),
                                    np.ones(n, np.float32)], 1))
    meta = FeatureMeta(num_bin=torch.full((f,), num_bin, dtype=torch.int32),
                       missing_type=torch.zeros(f, dtype=torch.int32),
                       default_bin=torch.zeros(f, dtype=torch.int32),
                       has_missing=False)
    cfg = GrowerConfig(num_leaves=15, num_bin=num_bin,
                       hparams=SplitHyperParams(min_data_in_leaf=5),
                       quantized=not dyadic, stochastic_rounding=False)
    return torch.from_numpy(bins), gh, meta, cfg


def _rows_of(tree):
    n = tree.num_leaves
    return (tree.split_feature[:n - 1].tolist(),
            tree.threshold_bin[:n - 1].tolist(),
            tree.leaf_value[:n].tolist())


def _row_sharded(world, make, bins, gh):
    """Each thread's tree and the leaf ids gathered in row order."""
    def fn(r, comm):
        sh = RowShards(bins.shape[0], comm)
        grow = make(comm)
        b = torch.from_numpy(sh.host_rows(bins.numpy()))
        tree, leaf = grow(b, sh.local_gh(gh))
        return tree, sh.gather_leaf(leaf)
    return run_threads(world, fn)


@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("world", [2, 3])
def test_data_parallel_hooks_match_serial(rng, mode, world):
    bins, gh, meta, cfg = _problem(rng)
    tree_s, leaf_s = make_tree_grower(cfg, meta)(bins, gh)
    out = _row_sharded(world, lambda c: make_data_parallel_grower(
        cfg, meta, c, hist_reduce=mode), bins, gh)
    for tree, leaf in out:
        assert _rows_of(tree) == _rows_of(tree_s)
        assert torch.equal(leaf, leaf_s)


@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter"])
def test_voting_full_coverage_matches_data_parallel(rng, mode):
    """top_k >= F votes every feature in: voting is data parallel (f32
    on dyadic gradients: the local pool's subtractions are exact)."""
    bins, gh, meta, cfg = _problem(rng, dyadic=True)
    data = _row_sharded(2, lambda c: make_data_parallel_grower(
        cfg, meta, c, hist_reduce=mode), bins, gh)
    vote = _row_sharded(2, lambda c: make_voting_parallel_grower(
        cfg, meta, c, top_k=7, hist_reduce=mode), bins, gh)
    for (tree_d, leaf_d), (tree_v, leaf_v) in zip(data, vote):
        assert _rows_of(tree_v) == _rows_of(tree_d)
        assert torch.equal(leaf_v, leaf_d)


def test_voting_small_k_trains(rng):
    bins, gh, meta, cfg = _problem(rng)
    out = _row_sharded(2, lambda c: make_voting_parallel_grower(
        cfg, meta, c, top_k=1), bins, gh)
    assert _rows_of(out[0][0]) == _rows_of(out[1][0])
    assert out[0][0].num_leaves > 2


@pytest.mark.parametrize("f", [6, 7])    # even and ragged over 2 ranks
@pytest.mark.parametrize("full", [False, True])
def test_feature_parallel_matches_serial(rng, f, full):
    bins, gh, meta, cfg = _problem(rng, f=f)
    if full:
        cfg = GrowerConfig(**{**cfg.__dict__, "row_sched": "full"})
    fm_of = (lambda b: b.T.contiguous()) if full else (lambda b: b)
    tree_s, leaf_s = make_tree_grower(cfg, meta)(fm_of(bins), gh)

    def fn(r, comm):
        lo, Fd = feature_window(f, comm)
        grow = make_feature_parallel_grower(cfg, meta, comm)
        b = fm_of(torch.from_numpy(host_feature_slice(bins.numpy(), lo,
                                                      Fd)))
        return FeatureShardedLearner(grow, b).grow(gh, None, None)
    for tree, leaf in run_threads(2, fn):
        assert _rows_of(tree) == _rows_of(tree_s)
        assert torch.equal(leaf, leaf_s)


def _record(gain, feat, lo=0.5):
    row = torch.zeros(1, NB)
    row[0, B_GAIN], row[0, B_FEAT], row[0, B_LO] = gain, feat, lo
    return row


def test_global_best_combine_keeps_negative_zero_and_ties_low():
    def fn(r, comm):
        sb = make_global_best_combine(comm)
        # leaf 0: rank 0 wins with a -0.0 output; leaf 1: an exact tie
        # goes to the lower feature id, held by rank 1
        rows = torch.cat([_record(2.0 - r, 1 + r, lo=-0.0 if r == 0 else 1.0),
                          _record(3.0, 6 - 2 * r)])
        return sb(rows, None)[0]
    for rows in run_threads(2, fn):
        assert rows[0, B_FEAT] == 1 and torch.signbit(rows[0, B_LO])
        assert rows[1, B_FEAT] == 4


def test_no_valid_split_replicates_invalid_record():
    def fn(r, comm):
        return make_global_best_combine(comm)(
            _record(-np.inf, -1, lo=float(r)), None)[0]
    for rows in run_threads(2, fn):
        assert rows[0, B_FEAT] == -1 and rows[0, B_LO] == 0.0


def test_train_step_serial_remap_logs_and_trains(rng, caplog):
    bins, gh, meta, cfg = _problem(rng)
    label = gh[:, 0].clone()

    def grad_fn(score, y):
        return score - y, torch.ones_like(score)

    def fn(r, comm):
        sh = RowShards(bins.shape[0], comm)
        step = make_distributed_train_step(cfg, meta, comm, grad_fn, 0.5,
                                           tree_learner="serial")
        b = torch.from_numpy(sh.host_rows(bins.numpy()))
        y = sh.local_gh(label[:, None])[:, 0]
        mask = sh.local_gh(torch.ones(bins.shape[0], 1))[:, 0]
        score = torch.zeros_like(y)
        loss0 = float(((score - y) ** 2 * mask).sum())
        for _ in range(3):
            score, tree, _ = step(b, y, score, mask)
        return loss0, float(((score - y) ** 2 * mask).sum())
    with caplog.at_level(logging.INFO):
        out = run_threads(2, fn)
    for loss0, loss in out:
        assert loss < 0.7 * loss0
    with pytest.raises(ValueError, match="row-sharded step"):
        make_distributed_train_step(cfg, meta, None, None, 0.1,
                                    tree_learner="feature")


class ThreadAllreduce:
    """Deterministic host all-reduce over threads (the injected
    ``reduce_sum`` / ``reduce_max``)."""

    def __init__(self, world):
        self.world = world
        self.barrier = threading.Barrier(world)
        self.bufs = [None] * world
        self.calls = 0

    def _exchange(self, rank, arr, op):
        self.bufs[rank] = np.asarray(arr).copy()
        self.barrier.wait()
        out = (self.bufs[0].astype(np.float64) if op == "sum"
               else self.bufs[0])
        for b in self.bufs[1:]:
            out = out + b if op == "sum" else np.maximum(out, b)
        self.calls += 1
        self.barrier.wait()
        return out.astype(np.asarray(arr).dtype)

    def make(self, rank):
        return (lambda a: self._exchange(rank, a, "sum"),
                lambda a: self._exchange(rank, a, "max"))


INJ_PARAMS = {"objective": "regression", "num_leaves": 15,
              "learning_rate": 0.2, "min_data_in_leaf": 5,
              "use_quantized_grad": True, "stochastic_rounding": False,
              "verbosity": -1}
INJ_ROUNDS = 6


def test_injected_two_worker_world_matches_centralized(rng):
    import lightgbm_tpu as lgb
    n, f = 600, 6
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] * X[:, 2] +
         0.05 * rng.normal(size=n)).astype(np.float32)
    jax_c = lgb.train(dict(INJ_PARAMS), lgb.Dataset(X, label=y),
                      num_boost_round=INJ_ROUNDS)
    params = {**INJ_PARAMS, "device_type": "cpu",
              "tpu_row_scheduling": "level"}
    full = lgt.Dataset(X, label=y, params={"device_type": "cpu"})
    allred = ThreadAllreduce(2)
    halves = [(X[:n // 2], y[:n // 2]), (X[n // 2:], y[n // 2:])]
    boosters = []
    try:
        for rank in range(2):
            rsum, rmax = allred.make(rank)
            dist.inject_collectives(rsum, reduce_max=rmax, rank=rank,
                                    num_machines=2)
            ds = lgt.Dataset(halves[rank][0], label=halves[rank][1],
                             reference=full)
            boosters.append(lgt.Booster(dict(params), ds))
    finally:
        dist.clear_collectives()
    # the level grower cannot take the injected collectives
    assert boosters[0]._engine.row_sched == "compact"
    errs = []

    def run(rank):
        try:
            for _ in range(INJ_ROUNDS):
                boosters[rank].update()
        except Exception as e:  # pragma: no cover — relayed below
            errs.append((rank, e))
            allred.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    assert allred.calls > 0
    assert boosters[0].model_to_string() == boosters[1].model_to_string()
    np.testing.assert_allclose(boosters[0].predict(X), jax_c.predict(X),
                               rtol=1e-6, atol=1e-7)


def test_inject_validation():
    with pytest.raises(TypeError):
        dist.inject_collectives("not callable")
    dist.clear_collectives()
    assert dist.injected_collectives() is None
    assert dist.make_injected_hooks() is None


def test_collective_timeout_raises_within_deadline_not_retried():
    calls = []

    def blocked(a):
        calls.append(1)
        time.sleep(10)
        return a
    dist.set_collective_timeout(0.2)
    try:
        t0 = time.monotonic()
        with pytest.raises(dist.CollectiveTimeout) as ei:
            dist.retried_collective(blocked, np.zeros(2), what="t")
        took = time.monotonic() - t0
    finally:
        dist.set_collective_timeout(0)
    assert took < 3.0
    assert "DEADLINE_EXCEEDED" in str(ei.value)
    assert len(calls) == 1


def test_collective_timeout_passthrough_errors_and_resolution(monkeypatch):
    dist.set_collective_timeout(5.0)
    try:
        out = dist.retried_collective(lambda a: a + 1, np.zeros(3))
        np.testing.assert_array_equal(out, np.ones(3))
        with pytest.raises(ZeroDivisionError):
            dist.retried_collective(lambda a: 1 / 0, np.zeros(1))
    finally:
        dist.set_collective_timeout(0)
    monkeypatch.delenv(dist.ENV_COLLECTIVE_TIMEOUT, raising=False)
    assert dist.collective_timeout() == dist.DEFAULT_COLLECTIVE_TIMEOUT
    monkeypatch.setenv(dist.ENV_COLLECTIVE_TIMEOUT, "42.5")
    assert dist.collective_timeout() == 42.5
    dist.set_collective_timeout(7.0)
    try:
        assert dist.collective_timeout() == 7.0
    finally:
        dist.set_collective_timeout(0)


def test_collective_fault_sites_inside_the_deadline(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("LGBM_TPU_RETRY_MAX_DELAY", "0.002")
    dist.set_collective_timeout(10.0)
    try:
        with faults.inject("collective_delay:sec=0.05"):
            out = dist.retried_collective(lambda a: a + 2, np.zeros(2))
        np.testing.assert_array_equal(out, np.full(2, 2.0))
        # a lost request (the collective site) is retried
        calls = []
        with faults.inject("collective:n=2"):
            dist.retried_collective(lambda a: calls.append(1) or a,
                                    np.zeros(1))
        assert len(calls) == 1
    finally:
        dist.set_collective_timeout(0)


def test_slices_and_launcher_env():
    assert dist.feature_slice(10, 3, 4) == (9, 10)
    assert [dist.feature_slice(5, r, 4) for r in range(4)] == \
        [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert [dist.row_slice(7, r, 3) for r in range(3)] == \
        [(0, 2), (2, 4), (4, 7)]
    env = dist.worker_env("localhost:1234", 2, 1, base_env={},
                          backend="gloo")
    assert env == {dist.ENV_COORDINATOR: "localhost:1234",
                   dist.ENV_NUM_PROCESSES: "2", dist.ENV_PROCESS_ID: "1",
                   dist.ENV_BACKEND: "gloo"}
    # outside a world: a world of one, rank 0
    assert dist.num_processes() == 1 and dist.process_index() == 0
    assert dist.allgather_bytes(b"abc") == [b"abc"]
