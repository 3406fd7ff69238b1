"""The supervised gang of the PyTorch port and its manifests, against the
JAX package's ``tests/test_gang.py`` (:69-200, :316-464).

- gang manifests: round trip, CRC corruption falling back, torn commits
  skipped (a manifest without its checkpoint, or of another iteration),
  pruning; each package reads the other's manifests and checkpoints;
- the resume gate: a fresh start, checkpoints without a manifest, another
  world size, another shard digest or row count refused (with each
  rank's diagnosis), and the restart anchored at the newest committed
  iteration;
- ``GangSupervisor``: a rank's death SIGTERMs the survivors, the special
  exit codes are named, a silent rank is classified, a clean gang
  returns its outputs; ``launch_local``'s timeout carries each rank's
  diagnosis; ``run_supervised`` relaunches and is bounded;
- one supervised gang on the CPU (the module fixture runs this file as
  a two-rank gloo worker): sharded ingestion, quantized data parallel,
  rank 0 checkpointing each iteration; the first attempt carries
  ``rank_kill:rank=1:after=2``, the gang is relaunched once, resumes
  from the newest valid manifest and ends on the fault-free text (the
  serial quantized model, the sharded contract) string for string.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

N, F = 2001, 8
ROUNDS = 4
WORLD = 2
SHARDS = (900, 1101)
KILL = "rank_kill:rank=1:after=2"
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "verbosity": -1, "device_type": "cpu", "tree_learner": "data",
          "pre_partition": True, "use_quantized_grad": True,
          "stochastic_rounding": False}


def _synth():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, F))
    X[rng.random((N, F)) < 0.02] = np.nan
    y = (np.nan_to_num(X[:, 0]) * 2 - np.nan_to_num(X[:, 1])
         + 0.5 * np.nan_to_num(X[:, 2] * X[:, 3]) > 0).astype(np.float64)
    return X, y


def _worker(out_dir: str) -> None:
    """One rank: its shard only, a checkpoint a round on rank 0, resumed
    from the shared directory."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed as dist

    torch.set_num_threads(1)
    rank = dist.init_from_env()
    X, y = _synth()
    lo = sum(SHARDS[:rank])
    hi = lo + SHARDS[rank]
    ckpt = os.path.join(out_dir, "ckpt")
    cbs = [lgt.checkpoint_callback(ckpt, every_n=1, keep_last=50)] \
        if rank == 0 else []
    bst = lgt.train(PARAMS, lgt.Dataset(X[lo:hi], label=y[lo:hi]),
                    num_boost_round=ROUNDS, callbacks=cbs,
                    resume_from=ckpt)
    assert bst._engine.train_set.bins.shape[0] == hi - lo
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"text": bst.model_to_string(),
                   "resumed_from": bst._engine.num_init_iteration}, fh)
    dist.shutdown_distributed()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(sys.argv[1])
    sys.exit(0)


import pytest  # noqa: E402

from lightgbm_tpu_torch.distributed import launch_local  # noqa: E402
from lightgbm_tpu_torch.io.dataset_core import ShardInfo  # noqa: E402
from lightgbm_tpu_torch.robustness import checkpoint as ck  # noqa: E402
from lightgbm_tpu_torch.robustness import faults, gang  # noqa: E402
from lightgbm_tpu_torch.robustness.gang import (  # noqa: E402
    GangError, GangSupervisor, GangTimeout, latest_valid_manifest,
    validate_and_select_resume, write_manifest)
from lightgbm_tpu_torch.robustness.heartbeat import (  # noqa: E402
    StallPolicy, rank_path)
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402


def _shard(world=2, counts=(10, 11), digests=(0xDEADBEEF, 0x12345678),
           rank=0):
    return ShardInfo(rank=rank, world=world,
                     row_counts=np.asarray(counts, np.int64),
                     digests=tuple(digests) if digests else None)


def _commit(d, iteration, shard, model=None):
    """One committed checkpoint and its manifest."""
    path = ck.write_checkpoint(
        str(d), {"iteration": iteration,
                 "model": model or f"MODEL{iteration}"})
    write_manifest(str(d), iteration, os.path.basename(path), shard)
    return path


# ---------------------------------------------------------------------------
# gang manifests
# ---------------------------------------------------------------------------

def test_manifest_round_trip(tmp_path):
    _commit(tmp_path, 4, _shard())
    man, ckpt_path = latest_valid_manifest(str(tmp_path))
    assert man["iteration"] == 4
    assert man["world"] == 2
    assert man["row_counts"] == [10, 11]
    assert man["digests"] == ["deadbeef", "12345678"]
    assert man["checkpoint"] == "ckpt_000000004.lgbmckpt"
    assert ck.read_checkpoint(ckpt_path)["model"] == "MODEL4"


def test_manifest_requires_digests(tmp_path):
    with pytest.raises(ValueError, match="digests"):
        write_manifest(str(tmp_path), 1, "ckpt_000000001.lgbmckpt",
                       _shard(digests=None))


def test_manifest_crc_corruption_falls_back(tmp_path):
    shard = _shard()
    _commit(tmp_path, 2, shard)
    _commit(tmp_path, 4, shard)
    newest = tmp_path / gang.manifest_name(4)
    blob = bytearray(newest.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    newest.write_bytes(bytes(blob))
    man, _ = latest_valid_manifest(str(tmp_path))
    assert man["iteration"] == 2


def test_torn_commit_manifest_without_checkpoint_skipped(tmp_path):
    shard = _shard()
    _commit(tmp_path, 2, shard)
    write_manifest(str(tmp_path), 5, ck.checkpoint_name(5), shard)
    man, _ = latest_valid_manifest(str(tmp_path))
    assert man["iteration"] == 2
    p6 = ck.write_checkpoint(str(tmp_path), {"iteration": 6,
                                             "model": "M6"})
    write_manifest(str(tmp_path), 6, os.path.basename(p6), shard)
    blob = bytearray(open(p6, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p6, "wb").write(bytes(blob))
    man, _ = latest_valid_manifest(str(tmp_path))
    assert man["iteration"] == 2


def test_torn_commit_iteration_disagreement_skipped(tmp_path):
    shard = _shard()
    _commit(tmp_path, 2, shard)
    p3 = ck.write_checkpoint(str(tmp_path), {"iteration": 3,
                                             "model": "M3"})
    write_manifest(str(tmp_path), 7, os.path.basename(p3), shard)
    man, _ = latest_valid_manifest(str(tmp_path))
    assert man["iteration"] == 2


def test_prune_manifests_keeps_newest(tmp_path):
    shard = _shard()
    for it in (1, 2, 3, 4):
        _commit(tmp_path, it, shard)
    (tmp_path / (gang.manifest_name(9) + ".tmp.123")).write_text("x")
    assert gang.prune_manifests(str(tmp_path), keep_last=2) == 3
    left = sorted(p.name for p in tmp_path.iterdir()
                  if "manifest" in p.name)
    assert left == [gang.manifest_name(3), gang.manifest_name(4)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifests_read_across_both_packages(tmp_path, writer):
    """A gang directory written by one package resumes in the other: the
    same manifest, the same checkpoint, the same resume state."""
    from lightgbm_tpu.io.dataset_core import ShardInfo as JShardInfo
    from lightgbm_tpu.robustness import checkpoint as jck
    from lightgbm_tpu.robustness import gang as jgang
    counts = np.asarray([10, 11], np.int64)
    shards = {"port": ShardInfo(0, 2, counts, (0xAB, 0xCD)),
              "jax": JShardInfo(0, 2, counts, (0xAB, 0xCD))}
    pkgs = {"port": (ck, gang), "jax": (jck, jgang)}
    w_ck, w_gang = pkgs[writer]
    r_ck, r_gang = pkgs["jax" if writer == "port" else "port"]
    for it in (2, 3):
        path = w_ck.write_checkpoint(str(tmp_path),
                                     {"iteration": it, "model": f"M{it}"})
        w_gang.write_manifest(str(tmp_path), it, os.path.basename(path),
                              shards[writer])
    man, path = r_gang.latest_valid_manifest(str(tmp_path))
    assert man == w_gang.read_manifest(
        os.path.join(str(tmp_path), gang.manifest_name(3)))
    assert r_ck.read_checkpoint(path)["model"] == "M3"
    reader_shard = shards["jax" if writer == "port" else "port"]
    state = r_gang.validate_and_select_resume(str(tmp_path), reader_shard,
                                              None)
    assert state["iteration"] == 3


@pytest.mark.parametrize("shard", ["binned", "u16", "one_row"])
def test_shard_digest_equals_the_jax_packages_on_the_same_shard(shard):
    """The manifest's per-rank fingerprint: the port hashes its
    row-major bins as the JAX package hashes the feature-major ones (a
    shard binned by both packages; u16 bins; a one-row shard)."""
    from lightgbm_tpu.io.dataset_core import _shard_content_digest as jd

    from lightgbm_tpu_torch.io.dataset_core import _shard_content_digest
    if shard == "binned":
        import lightgbm_tpu as lgb

        import lightgbm_tpu_torch as lgt
        X, y = _synth()
        port = lgt.Dataset(X[:SHARDS[0]], label=y[:SHARDS[0]],
                           params={"verbosity": -1}).construct()._binned
        ref = lgb.Dataset(X[:SHARDS[0]], label=y[:SHARDS[0]],
                          params={"verbosity": -1}).construct()._binned
        assert np.array_equal(port.bins, ref.bins.T)
        bins, ref_bins = port.bins, ref.bins
    else:
        rows, dtype = (63, np.uint16) if shard == "u16" else (1, np.uint8)
        bins = np.random.default_rng(2).integers(
            0, 200, size=(rows, 7)).astype(dtype)
        ref_bins = np.ascontiguousarray(bins.T)
    assert _shard_content_digest(bins) == jd(ref_bins)


# ---------------------------------------------------------------------------
# the resume gate
# ---------------------------------------------------------------------------

def test_fresh_start_with_no_checkpoints(tmp_path):
    assert validate_and_select_resume(str(tmp_path), _shard(),
                                      None) is None


def test_checkpoints_without_manifest_refused(tmp_path):
    ck.write_checkpoint(str(tmp_path), {"iteration": 3, "model": "M"})
    with pytest.raises(LightGBMError, match="no valid committed gang"):
        validate_and_select_resume(str(tmp_path), _shard(), None)


def test_world_size_mismatch_refused(tmp_path):
    _commit(tmp_path, 4, _shard())
    sel = ck.latest_valid_checkpoint(str(tmp_path))[1]
    with pytest.raises(LightGBMError, match="mixed-world"):
        validate_and_select_resume(
            str(tmp_path),
            _shard(world=3, counts=(7, 7, 7), digests=(1, 2, 3)), sel)


def test_shard_digest_mismatch_refused_with_rank_diagnosis(tmp_path):
    _commit(tmp_path, 4, _shard())
    sel = ck.latest_valid_checkpoint(str(tmp_path))[1]
    with pytest.raises(LightGBMError) as ei:
        validate_and_select_resume(
            str(tmp_path), _shard(digests=(0xDEADBEEF, 0x1)), sel)
    msg = str(ei.value)
    assert "DIFFERENT sharding" in msg
    assert "rank 1" in msg and "rank 0" not in msg


def test_row_count_mismatch_refused(tmp_path):
    _commit(tmp_path, 4, _shard())
    sel = ck.latest_valid_checkpoint(str(tmp_path))[1]
    with pytest.raises(LightGBMError, match="rank 0"):
        validate_and_select_resume(str(tmp_path),
                                   _shard(counts=(9, 11)), sel)


def test_resume_iteration_agreement_anchors_at_manifest(tmp_path):
    shard = _shard()
    _commit(tmp_path, 4, shard)
    ck.write_checkpoint(str(tmp_path), {"iteration": 6, "model": "M6"})
    sel = ck.latest_valid_checkpoint(str(tmp_path))[1]
    assert sel["iteration"] == 6
    state = validate_and_select_resume(str(tmp_path), shard, sel)
    assert state["iteration"] == 4
    assert state["model"] == "MODEL4"


def test_gang_error_is_transient():
    from lightgbm_tpu_torch.robustness.retry import is_transient_error
    assert is_transient_error(GangError("rank 1 died"))


# ---------------------------------------------------------------------------
# GangSupervisor (small real subprocesses, no torch in them)
# ---------------------------------------------------------------------------

_POLICY = StallPolicy(stall_sec={}, default_stall=60.0, silent_sec=60.0,
                      startup_grace=60.0)


def _child(code):
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _sleeper(seconds=60):
    return _child(f"import time; time.sleep({seconds})")


@pytest.mark.parametrize("rc,needle", [
    (3, "rc=3"), (faults.EXIT_RANK_KILLED, "injected rank_kill"),
    (86, "self-watchdogged")])
def test_gang_supervisor_rank_death_terminates_survivors(tmp_path, rc,
                                                         needle):
    procs = [_sleeper(), _child(f"import sys; sys.exit({rc})")]
    sup = GangSupervisor(procs, str(tmp_path / "g.hb"), policy=_POLICY,
                         poll=0.05, label="testgang", term_grace=10.0)
    with pytest.raises(GangError) as ei:
        sup.watch(timeout=30)
    msg = str(ei.value)
    assert needle in msg and "rank 1" in msg
    assert "DEADLINE_EXCEEDED" in msg
    assert "rank 0" in msg
    assert procs[0].poll() is not None, "survivor was not terminated"
    assert sup.drained_at >= sup.terminated_at


_HB_WRITER = """
import json, os, sys, time
path = sys.argv[1]
rec = {"phase": "iter", "progress": 5, "t": time.monotonic(),
       "ka": time.monotonic(), "pid": os.getpid(), "seq": 1,
       "wall": time.time()}
with open(path, "w") as f:
    f.write(json.dumps(rec))
time.sleep(60)
"""


def test_gang_supervisor_classifies_silent_rank(tmp_path):
    hb = str(tmp_path / "g.hb")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HB_WRITER, rank_path(hb, r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    policy = StallPolicy(stall_sec={}, default_stall=60.0,
                         silent_sec=1.0, startup_grace=20.0)
    sup = GangSupervisor(procs, hb, policy=policy, poll=0.1)
    t0 = time.monotonic()
    with pytest.raises(GangError) as ei:
        sup.watch(timeout=60)
    assert time.monotonic() - t0 < 30
    msg = str(ei.value)
    assert "classified hung" in msg and "silent" in msg
    assert "'iter'" in msg and "/5" in msg
    for p in procs:
        assert p.poll() is not None


def test_gang_supervisor_success_returns_outputs(tmp_path):
    procs = [_child(f"print('hello {r}')") for r in range(2)]
    sup = GangSupervisor(procs, str(tmp_path / "g.hb"), policy=_POLICY,
                         poll=0.05)
    results = sup.watch(timeout=30)
    assert [rc for rc, _ in results] == [0, 0]
    assert [out.strip() for _, out in results] == ["hello 0", "hello 1"]


_ENV_HB_WRITER = """
import json, os, time
path = os.environ["LGBM_TPU_HEARTBEAT"]
rec = {"phase": "compiling", "progress": 0, "t": time.monotonic(),
       "ka": time.monotonic(), "pid": os.getpid(), "seq": 1,
       "wall": time.time()}
with open(path, "w") as f:
    f.write(json.dumps(rec))
time.sleep(60)
"""


def test_launch_local_timeout_carries_rank_diagnosis():
    with pytest.raises(subprocess.TimeoutExpired) as ei:
        launch_local([sys.executable, "-c", _ENV_HB_WRITER], 1,
                     timeout=1.5)
    assert isinstance(ei.value, GangTimeout)
    msg = str(ei.value)
    assert "Per-rank diagnosis" in msg
    assert "'compiling'" in msg and "beat" in msg


_ATTEMPT_WORKER = """
import os, sys
sys.exit(2 if os.environ.get("GANG_TEST_FAIL") else 0)
"""


def test_run_supervised_relaunches_then_succeeds():
    seen = []

    def attempt_env(i):
        seen.append(i)
        return {"GANG_TEST_FAIL": "1"} if i == 0 else {}

    results = gang.run_supervised(
        [sys.executable, "-c", _ATTEMPT_WORKER], 2, timeout=30,
        attempts=3, attempt_env=attempt_env, poll=0.05,
        stall_policy=_POLICY, label="testgang")
    assert [rc for rc, _ in results] == [0, 0]
    assert seen == [0, 1]


def test_run_supervised_bounded_attempts():
    from lightgbm_tpu_torch.robustness.retry import RetryError
    with pytest.raises(RetryError) as ei:
        launch_local([sys.executable, "-c", "import sys; sys.exit(2)"], 2,
                     timeout=30, supervised=True, attempts=2, poll=0.05,
                     stall_policy=_POLICY, label="testgang")
    assert isinstance(ei.value.last, GangError)
    assert ei.value.attempts == 2
    assert gang.default_attempts({}) == 3
    assert gang.default_attempts({gang.ENV_GANG_RELAUNCHES: "0"}) == 1


def test_gang_hb_paths_convention():
    assert gang.gang_hb_paths("/x/b.hb", 1) == ["/x/b.hb"]
    assert gang.gang_hb_paths("/x/b.hb", 2) == ["/x/b.hb.r0",
                                                "/x/b.hb.r1"]
    assert rank_path("/x/b.hb", 1) == "/x/b.hb.r1"


def test_unsupervised_launch_refuses_gang_options():
    with pytest.raises(TypeError, match="supervised=True options"):
        launch_local(["true"], 2, attempts=2)


# ---------------------------------------------------------------------------
# the chaos round trip: one supervised gang on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """The supervised gang killed on its first attempt, and the serial
    quantized model of the whole table, trained while it runs."""
    import threading

    import lightgbm_tpu_torch as lgt
    out = tmp_path_factory.mktemp("chaos")
    seen, sups, box = [], [], {}

    def attempt_env(i):
        seen.append(i)
        return {faults.ENV_FAULTS: KILL if i == 0 else "off"}

    def run():
        box["runs"] = launch_local(
            [sys.executable, os.path.abspath(__file__), str(out)], WORLD,
            timeout=300, supervised=True, backend="gloo", attempts=3,
            attempt_env=attempt_env, poll=0.1, term_grace=10.0,
            escalate_kill=True, supervisors=sups, label="chaos gang")
    t = threading.Thread(target=run)
    t.start()
    X, y = _synth()
    serial = {k: v for k, v in PARAMS.items()
              if k not in ("tree_learner", "pre_partition")}
    ref = lgt.train(serial, lgt.Dataset(X, label=y),
                    num_boost_round=ROUNDS).model_to_string()
    t.join()
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    return {"runs": box["runs"], "ranks": ranks, "seen": seen,
            "sups": sups, "ref": ref, "out": out}


def test_chaos_gang_relaunches_once_and_resumes(chaos):
    assert [rc for rc, _ in chaos["runs"]] == [0, 0]
    assert chaos["seen"] == [0, 1]
    first = chaos["sups"][0]
    assert first.terminated_at is not None
    assert gang.list_manifests(str(chaos["out"] / "ckpt"))
    for rk in chaos["ranks"]:
        assert 1 <= rk["resumed_from"] < ROUNDS


def test_chaos_gang_ends_on_the_fault_free_text(chaos):
    from test_torch_model_io import _no_params
    for rk in chaos["ranks"]:
        assert _no_params(rk["text"]) == _no_params(chaos["ref"])
