"""The distributed learners of the PyTorch port against the JAX package.

One gang a module: a module-scoped fixture runs this file as the worker
of a two-rank gloo world on the CPU (``distributed.launch_local``; the
``__main__`` block), which trains every case below in one process start
and writes each rank's model texts, while the test process trains the
JAX package's models with ``tpu_num_devices=2`` on conftest's virtual CPU
devices (on a few threads: XLA compiles without the interpreter lock).
Each test then compares one case, two rounds each.

Data: 3,001 rows (W = 2 leaves one pad row on rank 1), 10 features with
column 7 a copy of column 2, so two features tie at every split and the
tie must go to the lower id on every path; ``F9`` drops column 9, so the
reduce-scatter windows (F = 9 over 2 ranks) and the feature slices carry
a pad feature. Standards:

- L2 regression, f32: the JAX package's model text string for string
  (each rank sums its block in XLA's CPU order before the all-reduce, as
  the JAX psum of per-shard sums; a two-rank sum is one addition either
  way), for data parallel in both reductions, voting (``top_k=2``) in
  both, and feature parallel;
- quantized, deterministic and stochastic rounding (each rank's noise
  from ``split(fold_in(tree_key, rank))``): bit for bit, and the
  deterministic data-parallel model equals the port's serial one (exact
  int32 sums); full scheduling quantized too;
- binary and multiclass: the binary standard (ROADMAP C1(a));
- EFB under all three learners (feature parallel over the rank's
  groups), multi-value storage under data and voting, the intermediate
  monotone method under data (the JAX package's
  ``tests/test_constraints.py:250``) and feature, the advanced one under
  voting (``tests/test_feature_combos.py``): string for string,
  quantized where the JAX package's own combination tests are;
- the ranks' texts are equal, the learner and the histogram reduction
  are attributed, a collective delay inside the deadline changes
  nothing, the digest agreement passes and a bit-flipped digest raises
  ``GangDivergence`` on both ranks, ``pre_partition`` trains (sharded
  ingestion, each rank's rows its own), ``allgather_bytes`` returns every rank's blob, each rank writes
  its own heartbeat, and ``rank_kill:rank=1`` kills rank 1 alone.
"""
import contextlib
import json
import os
import sys
import threading

import numpy as np

N, F = 3001, 10
ROUNDS = 2
WORLD = 2
JAX_THREADS = 4
BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1}


def _dense(seed=0, f=F):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F))
    X[rng.uniform(size=N) < 0.05, 3] = np.nan
    X[:, 7] = X[:, 2]
    y = (2 * X[:, 0] + X[:, 1] ** 2 - np.nan_to_num(X[:, 3])
         + 0.5 * X[:, 2] + 0.1 * rng.normal(size=N))
    return X[:, :f], y


def _binary():
    X, y = _dense(1)
    return X, (y > np.median(y)).astype(np.float64)


def _multiclass():
    X, y = _dense(2)
    return X, np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(
        np.float64)


def _onehot():
    """Mutually exclusive one-hot blocks beside two dense columns: EFB
    bundles the blocks."""
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 5, size=N) for _ in range(3)]
    X = np.zeros((N, 17))
    X[:, :2] = rng.normal(size=(N, 2))
    for b, pick in enumerate(blocks):
        X[np.arange(N), 2 + 5 * b + pick] = rng.uniform(0.5, 2.0, size=N)
    y = X[:, 0] + (blocks[0] % 2) - 0.5 * (blocks[1] == 3) + \
        0.1 * rng.normal(size=N)
    return X, y


def _sparse():
    """Four random entries a row of 64 columns: stored multi-value."""
    import scipy.sparse as sp
    rng = np.random.default_rng(4)
    K, Fs = 4, 64
    rows = np.repeat(np.arange(N), K)
    cols = np.argsort(rng.uniform(size=(N, Fs)), axis=1)[:, :K].reshape(-1)
    X = sp.csr_matrix((rng.uniform(1, 5, size=K * N), (rows, cols)),
                      shape=(N, Fs))
    y = (X[:, 3].toarray().ravel() - 0.7 * X[:, 40].toarray().ravel()
         + rng.normal(size=N))
    return X, y


DATA = {"F10": _dense, "F9": lambda: _dense(f=9), "binary": _binary,
        "multiclass": _multiclass, "onehot": _onehot, "sparse": _sparse}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}
MONO = [1, 0, 0, -1] + [0] * 6
# name -> (data, params); every case trains ROUNDS rounds in both packages
CASES = {
    "data": ("F10", {"objective": "regression", "tree_learner": "data"}),
    "data_reduce_scatter": ("F9", {"objective": "regression",
                                   "tree_learner": "data",
                                   "tpu_hist_reduce": "reduce_scatter"}),
    "voting": ("F10", {"objective": "regression", "tree_learner": "voting",
                       "top_k": 2}),
    "voting_reduce_scatter": ("F9", {"objective": "regression",
                                     "tree_learner": "voting", "top_k": 2,
                                     "tpu_hist_reduce": "reduce_scatter"}),
    "feature": ("F9", {"objective": "regression",
                       "tree_learner": "feature"}),
    "data_quantized": ("F10", {"objective": "regression",
                               "tree_learner": "data", **QUANT}),
    "data_stochastic": ("F10", {"objective": "regression",
                                "tree_learner": "data",
                                "use_quantized_grad": True}),
    "data_full_quantized": ("F10", {"objective": "regression",
                                    "tree_learner": "data",
                                    "tpu_row_scheduling": "full", **QUANT}),
    "binary": ("binary", {"objective": "binary", "tree_learner": "data"}),
    "multiclass": ("multiclass", {"objective": "multiclass", "num_class": 3,
                                  "tree_learner": "data"}),
    "data_efb": ("onehot", {"objective": "regression",
                            "tree_learner": "data", **QUANT}),
    "voting_efb": ("onehot", {"objective": "regression",
                              "tree_learner": "voting", "top_k": 3,
                              **QUANT}),
    "data_multival": ("sparse", {"objective": "regression",
                                 "tree_learner": "data", **QUANT}),
    "data_monotone_intermediate": (
        "F10", {"objective": "regression", "tree_learner": "data",
                "monotone_constraints": MONO,
                "monotone_constraints_method": "intermediate"}),
    "voting_monotone_advanced": (
        "F10", {"objective": "regression", "tree_learner": "voting",
                "top_k": 3, "monotone_constraints": MONO,
                "monotone_constraints_method": "advanced"}),
    "feature_monotone_intermediate": (
        "F9", {"objective": "regression", "tree_learner": "feature",
               "monotone_constraints": MONO[:9],
               "monotone_constraints_method": "intermediate"}),
    "voting_multival": ("sparse", {"objective": "regression",
                                   "tree_learner": "voting", "top_k": 5,
                                   **QUANT}),
    "feature_efb": ("onehot", {"objective": "regression",
                               "tree_learner": "feature", **QUANT}),
}
# port-only cases: the serial reference of the exact quantized sums
PORT_ONLY = {"serial_quantized": ("F10", {"objective": "regression",
                                          **QUANT})}


def _port_params(extra):
    return {**BASE, **extra, "device_type": "cpu",
            "tpu_num_devices": WORLD}


def _jax_params(extra):
    return {**BASE, **extra, "tpu_num_devices": WORLD}


# ---------------------------------------------------------------------------
# the worker (one rank of the gang)
# ---------------------------------------------------------------------------

def _worker(out_dir: str) -> None:
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed as dist
    from lightgbm_tpu_torch.robustness import faults, integrity

    # one intra-op thread a rank: the ranks' tensors are small, and the
    # test process compiles the JAX models beside them
    torch.set_num_threads(1)
    rank = dist.init_from_env()
    res = {"text": {}, "learner": {}, "hist_reduce": {}, "kinds": {}}
    path = os.path.join(out_dir, f"rank{rank}.json")

    def dump():
        with open(path, "w") as fh:
            json.dump(res, fh)

    def train(key, extra, rounds=ROUNDS):
        X, y = DATA[key]()
        return lgt.train(_port_params(extra), lgt.Dataset(X, label=y),
                         num_boost_round=rounds)

    for name, (key, extra) in {**CASES, **PORT_ONLY}.items():
        bst = train(key, extra)
        eng = bst._engine
        res["text"][name] = bst.model_to_string()
        res["learner"][name] = eng._tree_learner
        res["hist_reduce"][name] = eng._hist_reduce
        if eng._comm is not None:
            res["kinds"][name] = sorted(eng._comm.stats)
    data = CASES["data"][1]
    with faults.inject("collective_delay:sec=0.01:n=20"):
        res["text"]["delay"] = train("F10", data).model_to_string()
    res["text"]["digest"] = train(
        "F10", {**data, "tpu_integrity_digest_every": 1}).model_to_string()
    try:
        with (faults.inject("bitflip:where=digest") if rank == 1
              else contextlib.nullcontext()):
            train("F10", {**data, "tpu_integrity_digest_every": 1})
        res["bitflip"] = "trained"
    except integrity.GangDivergence as e:
        res["bitflip"] = str(e)
    try:
        # every rank passes the whole table: sharded ingestion trains on
        # the rank-order concatenation, each row twice
        shard = train("F10", {**data, "pre_partition": True},
                      rounds=1)._engine.train_set.shard
        res["pre_partition"] = "trained"
        res["pre_partition_rows"] = shard.row_counts.tolist()
    except Exception as e:  # noqa: BLE001 — a refusal is the result
        res["pre_partition"] = str(e)
    res["allgather"] = [b.decode() for b in dist.allgather_bytes(
        f"rank{rank};".encode() * (rank + 1))]
    dump()
    # rank_kill by rank: a serial run (no collective) under a plan that
    # names rank 1; rank 0 trains on
    with faults.inject("rank_kill:rank=1"):
        train("F10", {"objective": "regression"}, rounds=2)
    res["survived_rank_kill"] = True
    dump()
    dist.shutdown_distributed()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

from test_torch_model_io import _no_params  # noqa: E402
from test_torch_multiclass import assert_trees_to_binary_standard  # noqa


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Both ranks' results (and exit codes, outputs); the JAX package's
    models are trained while the gang runs."""
    from lightgbm_tpu_torch.distributed import launch_local
    from lightgbm_tpu_torch.robustness.heartbeat import ENV_HEARTBEAT
    out = tmp_path_factory.mktemp("gang")
    hb = str(out / "gang.hb")
    box = {}

    def run():
        box["runs"] = launch_local(
            [sys.executable, os.path.abspath(__file__), str(out)], WORLD,
            timeout=600, backend="gloo", env_extra={ENV_HEARTBEAT: hb})
    t = threading.Thread(target=run)
    t.start()
    box["jax"] = _jax_models()
    t.join()
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    return {"runs": box["runs"], "ranks": ranks, "jax": box["jax"],
            "hb": hb}


def _jax_models():
    """The JAX package's model of every case, trained on a few threads
    (XLA compiles without the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    import lightgbm_tpu as lgb

    def train(case):
        key, extra = case
        X, y = DATA[key]()
        return lgb.train(_jax_params(extra), lgb.Dataset(X, label=y),
                         num_boost_round=ROUNDS)
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        return dict(zip(CASES, pool.map(train, CASES.values())))


def _port(gang, name, rank=0):
    import lightgbm_tpu_torch as lgt
    return lgt.Booster(model_str=gang["ranks"][rank]["text"][name],
                       params={"device_type": "cpu"})


def _assert_text_equal(gang, name, other=None):
    want = (_no_params(gang["jax"][name].model_to_string()) if other is None
            else _no_params(gang["ranks"][0]["text"][other]))
    assert _no_params(gang["ranks"][0]["text"][name]) == want


STRING_CASES = ["data", "data_reduce_scatter", "voting",
                "voting_reduce_scatter", "feature", "data_quantized",
                "data_stochastic", "data_full_quantized", "data_efb",
                "voting_efb", "feature_efb", "data_multival",
                "voting_multival", "data_monotone_intermediate",
                "voting_monotone_advanced", "feature_monotone_intermediate"]


@pytest.mark.parametrize("name", STRING_CASES)
def test_learner_matches_jax_string_for_string(gang, name):
    _assert_text_equal(gang, name)


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_learner_matches_jax_to_the_binary_standard(gang, name):
    X, _ = DATA[name]()
    kw = ({"g_max": 1.0, "h_max": 0.25} if name == "binary"
          else {"objective": "multiclass"})
    assert_trees_to_binary_standard(gang["jax"][name], _port(gang, name), X,
                                    **kw)


def test_both_ranks_hold_the_same_models(gang):
    r0, r1 = (r["text"] for r in gang["ranks"])
    assert r0.keys() == r1.keys()
    for name in r0:
        assert r0[name] == r1[name], name


def test_exact_quantized_sums_equal_the_serial_model(gang):
    _assert_text_equal(gang, "data_quantized", other="serial_quantized")


def test_learner_and_reduction_are_attributed(gang):
    r0 = gang["ranks"][0]
    assert r0["learner"]["data"] == "data"
    assert r0["learner"]["feature"] == "feature"
    assert r0["learner"]["serial_quantized"] == "serial"
    assert r0["hist_reduce"]["data"] == "allreduce"
    assert r0["hist_reduce"]["voting_reduce_scatter"] == "reduce_scatter"
    assert r0["hist_reduce"]["data_efb"] == "allreduce"
    assert r0["hist_reduce"]["feature"] == "n/a"
    assert "hist_reduce_scatter" in r0["kinds"]["data_reduce_scatter"]
    assert "hist_allreduce" not in r0["kinds"]["data_reduce_scatter"]
    assert {"hist_allreduce", "root_sums", "leaf_id"} <= set(
        r0["kinds"]["data"])
    assert "owner_column" in r0["kinds"]["feature"]
    assert "votes" in r0["kinds"]["voting"]


def test_collective_delay_inside_the_deadline_changes_nothing(gang):
    _assert_text_equal(gang, "delay", other="data")


def test_digest_agreement_and_its_bitflip(gang):
    _assert_text_equal(gang, "digest", other="data")
    for r in gang["ranks"]:
        assert "diverged across 2 ranks" in r["bitflip"], r["bitflip"]


def test_sharded_ingestion_in_a_world_of_two_is_refused(gang):
    """No longer refused: ``pre_partition`` trains in the gang, each rank
    holding the rows it passed."""
    for r in gang["ranks"]:
        assert r["pre_partition"] == "trained", r["pre_partition"]
        assert r["pre_partition_rows"] == [N, N]


def test_allgather_bytes_and_rank_heartbeats(gang):
    from lightgbm_tpu_torch.robustness import heartbeat
    want = ["rank0;", "rank1;rank1;"]
    for r in range(WORLD):
        assert gang["ranks"][r]["allgather"] == want
    recs = [heartbeat.read(heartbeat.rank_path(gang["hb"], r))
            for r in range(WORLD)]
    assert None not in recs
    assert recs[0].pid != recs[1].pid


def test_rank_kill_kills_the_named_rank_only(gang):
    from lightgbm_tpu_torch.robustness.faults import EXIT_RANK_KILLED
    (rc0, out0), (rc1, _) = gang["runs"]
    assert rc0 == 0, out0[-3000:]
    assert rc1 == EXIT_RANK_KILLED
    assert gang["ranks"][0]["survived_rank_kill"]
    assert "survived_rank_kill" not in gang["ranks"][1]
