"""Sharded ingestion of the PyTorch port against the JAX package.

One gang a module: a module-scoped fixture runs this file as the worker
of a two-rank gloo world on the CPU (``distributed.launch_local``; the
``__main__`` block). Each rank keeps only its own rows of the table and
trains with ``pre_partition=true``, so bin finding runs distributed
(per-shard sample summaries, feature-sliced ``find_bin``, the mappers
all-gathered) and no rank holds the whole table. Meanwhile the test
process trains the JAX package's references on a few threads, then runs
the JAX package's own sharded construction in two threads over a
threaded all-gather (its ``distributed.allgather_bytes`` patched, as
``tests/test_sharded_ingest.py`` patches it).

Data: 3,001 rows, 10 features (the distributed tests' set). Shards
``EVEN`` (1,501 + 1,500) are cut as the row-sharded learners cut rows,
one pad row on rank 1; ``UNEQUAL`` (1,400 + 1,601) give each rank a
different region of rows. Standards:

- the wire bytes of the summaries and the mappers are the JAX package's,
  and each package reads the other's;
- the mappers at ``bin_construct_sample_cnt=1000`` (below N, so each
  rank's draw matters) equal the JAX package's sharded mappers, and the
  shard digests its digests; at the default sample they equal serial
  binning's;
- ``EVEN`` shards give the JAX data-parallel (``tpu_num_devices=2``) L2
  text string for string: f32 data in both reductions, voting, and
  quantized with stochastic rounding;
- ``UNEQUAL`` shards, quantized with deterministic rounding, give the
  JAX serial text string for string (also under full scheduling, and
  loaded through the file route: ``{rank}`` files and one shared file);
  f32 on the binary objective, and lambdarank over queries local to
  each shard, match it to the binary standard (lambdarank's ``log2`` and
  logistic function differ from the JAX package's in the last ulps,
  ROADMAP C1(a));
- quantized lambdarank on those shards gives the port's serial text
  string for string: the sharded sums are exact. The serial text is the
  JAX package's given the JAX gradients
  (``tests/test_torch_ranking.py``, ROADMAP C15);
- weights, query sizes and a 3-class ``init_score`` equal the
  replicated metadata exactly; each rank's binned table holds its rows
  only; both ranks' texts are equal;
- the feature learner, ``linear_tree``, a binary file, rollback and DART
  are refused with the JAX package's messages, and EFB is off with its
  log; so are a binary save, a subset and ``Sequence`` input, which
  would hold or load the wrong rows;
- a checkpoint at iteration 2 of 4 (with its gang manifest) resumes to
  the uninterrupted text.

Without the gang: the file route's slices, content guard, sidecars and
ragged rows against the JAX package's loader, and a parser plugin's file
giving the JAX package's L2 text.
"""
import json
import os
import sys
import threading

import numpy as np

N, F = 3001, 10
ROUNDS = 2
WORLD = 2
JAX_THREADS = 2
EVEN = (1501, 1500)
UNEQUAL = (1400, 1601)
SMALL_SAMPLE = 1000
BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}
SHARDED = {"pre_partition": True}


def _dense(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F))
    X[rng.uniform(size=N) < 0.05, 3] = np.nan
    X[:, 7] = X[:, 2]
    y = (2 * X[:, 0] + X[:, 1] ** 2 - np.nan_to_num(X[:, 3])
         + 0.5 * X[:, 2] + 0.1 * rng.normal(size=N))
    return X, y


def _binary():
    X, y = _dense(1)
    return X, (y > np.median(y)).astype(np.float64)


def _onehot():
    """Mutually exclusive one-hot blocks beside two dense columns: EFB
    would bundle the blocks."""
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 5, size=N) for _ in range(3)]
    X = np.zeros((N, 17))
    X[:, :2] = rng.normal(size=(N, 2))
    for b, pick in enumerate(blocks):
        X[np.arange(N), 2 + 5 * b + pick] = rng.uniform(0.5, 2.0, size=N)
    return X, X[:, 0] + (blocks[0] % 2) + 0.1 * rng.normal(size=N)


def _meta():
    """Weights, query sizes (each query inside one UNEQUAL shard) and a
    3-class class-major init_score over the N rows."""
    rng = np.random.default_rng(5)
    weight = rng.uniform(0.5, 2.0, size=N)
    group = np.concatenate([np.full(14, 100), np.full(16, 100), [1]])
    init_score = rng.normal(size=(3, N))
    return weight, group, init_score


def _ranking():
    """Relevance 0-3 of the dense rows, in the queries of ``_meta``."""
    X, y = _dense(4)
    return X, np.digitize(y, np.quantile(y, [0.5, 0.75, 0.9])).astype(
        np.float64)


def _shard_groups(rank):
    """Rank ``rank``'s query sizes under the UNEQUAL cut: the queries of
    ``_meta`` never straddle the two shards."""
    return [100] * 14 if rank == 0 else [100] * 16 + [1]


DATA = {"dense": _dense, "binary": _binary, "onehot": _onehot,
        "ranking": _ranking}
# name -> (data, shard sizes, params); every case trains ROUNDS rounds
CASES = {
    "even_data": ("dense", EVEN, {"objective": "regression",
                                  "tree_learner": "data"}),
    "even_data_reduce_scatter": ("dense", EVEN, {
        "objective": "regression", "tree_learner": "data",
        "tpu_hist_reduce": "reduce_scatter"}),
    "even_voting": ("dense", EVEN, {"objective": "regression",
                                    "tree_learner": "voting", "top_k": 2}),
    "even_stochastic": ("dense", EVEN, {"objective": "regression",
                                        "tree_learner": "data",
                                        "use_quantized_grad": True}),
    "unequal_quantized": ("dense", UNEQUAL, {"objective": "regression",
                                             "tree_learner": "data",
                                             **QUANT}),
    "unequal_full_quantized": ("dense", UNEQUAL, {
        "objective": "regression", "tree_learner": "data",
        "tpu_row_scheduling": "full", **QUANT}),
    "unequal_binary": ("binary", UNEQUAL, {"objective": "binary",
                                           "tree_learner": "data"}),
    "unequal_lambdarank": ("ranking", UNEQUAL, {"objective": "lambdarank",
                                                "tree_learner": "data"}),
    "unequal_lambdarank_quantized": ("ranking", UNEQUAL, {
        "objective": "lambdarank", "tree_learner": "data", **QUANT}),
}
# each case's JAX reference: the data-parallel model on the whole table,
# or the serial one
JAX_REF = {
    "even_data": "even_data", "even_data_reduce_scatter":
    "even_data_reduce_scatter", "even_voting": "even_voting",
    "even_stochastic": "even_stochastic",
    "unequal_quantized": "serial_quantized",
    "unequal_full_quantized": "serial_full_quantized",
    "unequal_binary": "serial_binary",
}
JAX_SERIAL = {
    "serial_quantized": ("dense", {"objective": "regression", **QUANT}),
    "serial_full_quantized": ("dense", {"objective": "regression",
                                        "tpu_row_scheduling": "full",
                                        **QUANT}),
    "serial_binary": ("binary", {"objective": "binary"}),
    "serial_lambdarank": ("ranking", {"objective": "lambdarank"}),

    "plugin": (None, {"objective": "regression"}),
}
# the file route's cases: each trains UNEQUAL_QUANTIZED's params
FILE_CASES = {"rank_files": "part{rank}.csv", "shared_file": "shared.csv"}
PLUGIN_HEAD = "#CUSTOMv1"


def _shard(a, sizes, rank):
    lo = sum(sizes[:rank])
    return a[lo:lo + sizes[rank]]


def _port_params(extra):
    return {**BASE, **extra, "device_type": "cpu"}


def _detect(path, sample):
    return bool(sample) and sample[0].startswith(PLUGIN_HEAD)


def _parse(lines):
    a = np.asarray([ln.split(";") for ln in lines[1:]], np.float64)
    return a[:, 1:], a[:, 0]


def _write_files(out):
    """The file route's inputs: each rank's UNEQUAL rows, the shared
    file of every row, and the parser plugin's file."""
    X, y = _dense()
    rows = np.column_stack([y, X])
    for r in range(WORLD):
        np.savetxt(os.path.join(out, f"part{r}.csv"),
                   _shard(rows, UNEQUAL, r), delimiter=",", fmt="%.17g")
    np.savetxt(os.path.join(out, "shared.csv"), rows, delimiter=",",
               fmt="%.17g")
    with open(os.path.join(out, "data.custom"), "w") as fh:
        fh.write(PLUGIN_HEAD + "\n")
        for row in rows:
            fh.write(";".join(repr(float(v)) for v in row) + "\n")


# ---------------------------------------------------------------------------
# the worker (one rank of the gang)
# ---------------------------------------------------------------------------

def _worker(out_dir: str) -> None:
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import distributed as dist
    from lightgbm_tpu_torch.io.binning import serialize_bin_mappers
    from lightgbm_tpu_torch.robustness import gang
    from lightgbm_tpu_torch.utils import log

    torch.set_num_threads(1)
    rank = dist.init_from_env()
    res = {"text": {}, "rows": {}, "refused": {}}

    def dataset(key, sizes, extra=None, **kw):
        X, y = DATA[key]()
        if key == "ranking":
            kw["group"] = _shard_groups(rank)
        return lgt.Dataset(_shard(X, sizes, rank),
                           label=_shard(y, sizes, rank),
                           params=_port_params({**SHARDED, **(extra or {})}),
                           **kw)

    def train(ds, extra, rounds=ROUNDS, **kw):
        bst = lgt.train(_port_params({**SHARDED, **extra}), ds,
                        num_boost_round=rounds, **kw)
        b = bst._engine.train_set
        res["rows"][len(res["rows"])] = [list(b.bins.shape),
                                         b.shard.local_num_data]
        return bst

    for name, (key, sizes, extra) in CASES.items():
        ds = dataset(key, sizes)
        res["text"][name] = train(ds, extra).model_to_string()
        if name == "even_data":
            res["mappers_default"] = serialize_bin_mappers(
                ds._binned.bin_mappers).hex()
    for name, path in FILE_CASES.items():
        ds = lgt.Dataset(os.path.join(out_dir, path),
                         params=_port_params(SHARDED))
        res["text"][name] = train(
            ds, CASES["unequal_quantized"][2]).model_to_string()

    small = dataset("dense", UNEQUAL,
                    {"bin_construct_sample_cnt": SMALL_SAMPLE}).construct()
    res["mappers_small"] = serialize_bin_mappers(
        small._binned.bin_mappers).hex()
    res["digests"] = list(small._binned.shard.digests)
    res["bins_small"] = list(small._binned.bins.shape)

    weight, group, isc = _meta()
    X, y = _dense()
    md = lgt.Dataset(
        _shard(X, UNEQUAL, rank), label=_shard(y, UNEQUAL, rank),
        weight=_shard(weight, UNEQUAL, rank),
        group=_shard_groups(rank),
        init_score=_shard(isc.T, UNEQUAL, rank).T.reshape(-1),
        params=_port_params(SHARDED)).construct()._binned.metadata
    res["meta"] = {"weight": md.weight.tolist(),
                   "init_score": md.init_score.tolist(),
                   "query_boundaries": md.query_boundaries.tolist(),
                   "label": md.label.tolist()}

    # resume: a checkpoint (and its manifest) at iteration 2 of 4
    ckpt = os.path.join(out_dir, "ckpt")
    quant = CASES["unequal_quantized"][2]
    res["text"]["uninterrupted"] = train(
        dataset("dense", UNEQUAL), quant, rounds=4).model_to_string()
    cbs = [lgt.checkpoint_callback(ckpt, every_n=1)] if rank == 0 else []
    train(dataset("dense", UNEQUAL), quant, rounds=2, callbacks=cbs)
    dist.allgather_bytes(b"")       # rank 0's last write lands first
    res["manifests"] = [it for it, _ in gang.list_manifests(ckpt)]
    res["text"]["resumed"] = train(dataset("dense", UNEQUAL), quant,
                                   rounds=4,
                                   resume_from=ckpt).model_to_string()

    def refused(name, fn):
        try:
            fn()
            res["refused"][name] = "ran"
        except lgt.basic.LightGBMError as e:
            res["refused"][name] = str(e)

    refused("feature", lambda: train(dataset("dense", UNEQUAL),
                                     {"objective": "regression",
                                      "tree_learner": "feature"}))
    refused("linear_tree", lambda: dataset(
        "dense", UNEQUAL, {"linear_tree": True}).construct())
    bin_path = os.path.join(out_dir, f"rank{rank}.bin")
    lgt.Dataset(_shard(X, UNEQUAL, rank), label=_shard(y, UNEQUAL, rank),
                params=_port_params({})).construct().save_binary(bin_path)
    refused("binary_file", lambda: lgt.Dataset(
        bin_path, params=_port_params(SHARDED)).construct())
    sharded = dataset("dense", UNEQUAL).construct()
    refused("save_binary", lambda: sharded.save_binary(bin_path + ".2"))
    refused("subset", lambda: sharded.binned.subset(np.arange(10)))

    class Rows(lgt.Sequence):
        batch_size = 256

        def __init__(self, a):
            self.a = a

        def __getitem__(self, i):
            return self.a[i]

        def __len__(self):
            return len(self.a)
    refused("sequence", lambda: lgt.Dataset(
        Rows(_shard(X, UNEQUAL, rank)), label=_shard(y, UNEQUAL, rank),
        params=_port_params(SHARDED)).construct())
    data_l2 = {"objective": "regression", "tree_learner": "data"}
    refused("rollback", lambda: train(dataset("dense", UNEQUAL), data_l2,
                                      rounds=1).rollback_one_iter())
    refused("dart", lambda: train(dataset("dense", UNEQUAL),
                                  {**data_l2, "boosting": "dart",
                                   "drop_rate": 1.0, "skip_drop": 0.0},
                                  rounds=3))
    logged = []
    log.register_logger(logged.append)
    try:
        bst = train(dataset("onehot", UNEQUAL, {"verbosity": 1}),
                    {**data_l2, **QUANT, "verbosity": 1})
    finally:
        log.register_logger(None)
        log.set_verbosity(-1)
    res["efb_bundle"] = bst._engine._bundle is not None
    res["efb_log"] = [m for m in logged if "EFB" in m]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
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


class _ThreadedAllgather:
    """``allgather_bytes`` for ranks that are threads of one process:
    each call is one round, in the same order on every thread."""

    def __init__(self, world):
        self.barrier = threading.Barrier(world)
        self.slots = [None] * world
        self.local = threading.local()

    def __call__(self, blob, what=""):
        self.barrier.wait()
        self.slots[self.local.rank] = bytes(blob)
        self.barrier.wait()
        return list(self.slots)


def _jax_sharded(params):
    """The JAX package's sharded construction of the UNEQUAL shards, its
    two ranks on two threads."""
    from lightgbm_tpu import distributed as jdist
    from lightgbm_tpu.config import Config
    from lightgbm_tpu.io.dataset_core import BinnedDataset, DenseColumns

    X, y = _dense()
    gather = _ThreadedAllgather(WORLD)
    out = [None] * WORLD

    def rank_main(r):
        gather.local.rank = r
        out[r] = BinnedDataset._from_columns_sharded(
            DenseColumns(_shard(X, UNEQUAL, r)), Config(params), r, WORLD,
            label=_shard(y, UNEQUAL, r))
    saved = jdist.allgather_bytes
    jdist.allgather_bytes = gather
    try:
        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(WORLD)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        jdist.allgather_bytes = saved
    return out


def _jax_models(out):
    """The JAX references, trained on a few threads (XLA compiles
    without the interpreter lock): each data-parallel case on the whole
    table with ``tpu_num_devices=2``, and the serial models."""
    from concurrent.futures import ThreadPoolExecutor

    import lightgbm_tpu as lgb

    jobs = {}
    for name, (key, _, extra) in CASES.items():
        if JAX_REF.get(name) == name:
            jobs[name] = (key, {**extra, "tpu_num_devices": WORLD})
    jobs.update(JAX_SERIAL)

    def train(job):
        key, extra = job
        if key is None:
            ds = lgb.Dataset(os.path.join(out, "data.custom"))
        else:
            X, y = DATA[key]()
            ds = lgb.Dataset(X, label=y, group=(
                _meta()[1] if key == "ranking" else None))
        return lgb.train({**BASE, **extra}, ds, num_boost_round=ROUNDS)
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        return dict(zip(jobs, pool.map(train, jobs.values())))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Both ranks' results (and exit codes, outputs), the JAX references
    and the JAX package's sharded construction."""
    from lightgbm_tpu.io import file_loader as jfl

    from lightgbm_tpu_torch.distributed import launch_local
    out = tmp_path_factory.mktemp("sharded")
    _write_files(str(out))
    box = {}

    def run():
        box["runs"] = launch_local(
            [sys.executable, os.path.abspath(__file__), str(out)], WORLD,
            timeout=600, backend="gloo")
    t = threading.Thread(target=run)
    t.start()
    jfl._PARSER_PLUGINS.clear()
    jfl.register_parser(_detect, _parse)
    try:
        box["jax"] = _jax_models(str(out))
    finally:
        jfl._PARSER_PLUGINS.clear()
    box["jax_sharded"] = _jax_sharded(
        {**BASE, **SHARDED, "bin_construct_sample_cnt": SMALL_SAMPLE})
    t.join()
    for r, (rc, text) in enumerate(box["runs"]):
        assert rc == 0, (r, text[-4000:])
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    return {"runs": box["runs"], "ranks": ranks, "jax": box["jax"],
            "jax_sharded": box["jax_sharded"], "out": str(out)}


def _port(gang, name, rank=0):
    import lightgbm_tpu_torch as lgt
    return lgt.Booster(model_str=gang["ranks"][rank]["text"][name],
                       params={"device_type": "cpu"})


# -- wire formats (no gang) --------------------------------------------------

def _messy_sample(rng, n=4000):
    v = rng.normal(size=n)
    v[rng.random(n) < 0.3] = 0.0
    v[rng.random(n) < 0.05] = np.nan
    v[rng.random(n) < 0.01] = -0.0
    return v


def _mapper_zoo(pkg, rng):
    """Mappers of every missing type and both bin types, and a trivial
    one, by ``pkg``'s ``find_bin`` over the same samples."""
    BM = pkg.BinMapper
    num = rng.normal(size=3000)
    num[rng.random(3000) < 0.2] = 0.0
    nan = num.copy()
    nan[rng.random(3000) < 0.1] = np.nan
    cat = rng.integers(0, 40, size=3000).astype(np.float64)
    cat[rng.random(3000) < 0.1] = np.nan
    return [BM.find_bin(num, 3000, 255, 3, 5),
            BM.find_bin(nan, 3000, 255, 3, 5),
            BM.find_bin(nan, 3000, 255, 3, 5, zero_as_missing=True),
            BM.find_bin(nan, 3000, 255, 3, 5, use_missing=False),
            BM.find_bin(cat, 3000, 63, 3, 5, bin_type="categorical"),
            BM.find_bin(np.zeros(100), 100, 255, 3, 5)]


def test_mapper_wire_bytes_are_the_jax_packages_both_ways():
    from lightgbm_tpu.io import binning as jb

    from lightgbm_tpu_torch.io import binning as tb
    port = _mapper_zoo(tb, np.random.default_rng(0))
    ref = _mapper_zoo(jb, np.random.default_rng(0))
    assert len({m.missing_type for m in port}) == 3
    blob = tb.serialize_bin_mappers(port)
    assert blob == jb.serialize_bin_mappers(ref)
    back = tb.deserialize_bin_mappers(jb.serialize_bin_mappers(ref))
    assert back == port
    assert jb.serialize_bin_mappers(jb.deserialize_bin_mappers(blob)) == blob
    probe = np.concatenate([_messy_sample(np.random.default_rng(3), 500),
                            np.arange(-5, 45, dtype=np.float64)])
    for a, b in zip(back, port):
        assert (a.default_bin, a.most_freq_bin, a.sparse_rate,
                a.categorical_2_bin, a.min_val, a.max_val) == \
            (b.default_bin, b.most_freq_bin, b.sparse_rate,
             b.categorical_2_bin, b.min_val, b.max_val)
        if not a.is_trivial:
            assert np.array_equal(a.value_to_bin(probe),
                                  b.value_to_bin(probe))
    with pytest.raises(ValueError):
        tb.deserialize_bin_mappers(b"nope" + b"\x00" * 16)


def test_summary_wire_bytes_merge_and_find_bin():
    from lightgbm_tpu.io import binning as jb

    from lightgbm_tpu_torch.io import binning as tb
    v = _messy_sample(np.random.default_rng(1), 6000)
    parts = np.array_split(v, 4)
    port = [tb.FeatureSampleSummary.from_sample(p) for p in parts]
    ref = [jb.FeatureSampleSummary.from_sample(p) for p in parts]
    blob = tb.serialize_summaries(port)
    assert blob == jb.serialize_summaries(ref)
    assert tb.deserialize_summaries(jb.serialize_summaries(ref)) == port
    merged = tb.FeatureSampleSummary.merge(port)
    assert merged == tb.FeatureSampleSummary.from_sample(v)
    assert np.array_equal(merged.sorted_non_na(),
                          jb.FeatureSampleSummary.merge(ref).sorted_non_na())
    assert tb.BinMapper.find_bin_from_summary(merged, len(v), 255, 3, 5) \
        == tb.BinMapper.find_bin(v, len(v), 255, 3, 5)
    with pytest.raises(ValueError):
        tb.deserialize_summaries(b"nope" + b"\x00" * 16)


# -- the gang ------------------------------------------------------------------

def test_sharded_mappers_below_the_sample_equal_the_jax_packages(gang):
    from lightgbm_tpu.io.binning import serialize_bin_mappers
    jax_ds = gang["jax_sharded"]
    want = serialize_bin_mappers(jax_ds[0].bin_mappers).hex()
    assert serialize_bin_mappers(jax_ds[1].bin_mappers).hex() == want
    for r, rk in enumerate(gang["ranks"]):
        assert rk["mappers_small"] == want
        assert rk["digests"] == list(jax_ds[r].shard.digests)
        assert rk["bins_small"] == [UNEQUAL[r], jax_ds[r].bins.shape[0]]


def test_sharded_mappers_at_the_full_sample_are_serial_binning(gang):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.io.binning import serialize_bin_mappers
    X, y = _dense()
    serial = lgt.Dataset(X, label=y, params=_port_params({})).construct()
    want = serialize_bin_mappers(serial._binned.bin_mappers).hex()
    assert gang["ranks"][0]["mappers_default"] == want
    assert gang["ranks"][1]["mappers_default"] == want


@pytest.mark.parametrize("name", ["even_data", "even_data_reduce_scatter",
                                  "even_voting", "even_stochastic",
                                  "unequal_quantized",
                                  "unequal_full_quantized"])
def test_sharded_learner_matches_jax_string_for_string(gang, name):
    want = _no_params(gang["jax"][JAX_REF[name]].model_to_string())
    assert _no_params(gang["ranks"][0]["text"][name]) == want


def test_sharded_lambdarank_equals_the_serial_text(gang):
    """Quantized lambdarank over the shards is the port's serial text:
    the quantized sums are exact, whatever rank holds a row. The serial
    text is the JAX package's given the JAX objective's gradients
    (``tests/test_torch_ranking.py``); on its own gradients the two
    differ by the ulps of ROADMAP C15."""
    import lightgbm_tpu_torch as lgt
    X, y = _ranking()
    params = _port_params({"objective": "lambdarank", **QUANT})
    want = lgt.train(params, lgt.Dataset(X, label=y, group=_meta()[1]),
                     num_boost_round=ROUNDS).model_to_string()
    got = gang["ranks"][0]["text"]["unequal_lambdarank_quantized"]
    assert _no_params(got) == _no_params(want)


def test_unequal_shards_f32_to_the_binary_standard(gang):
    X, _ = _binary()
    assert_trees_to_binary_standard(gang["jax"]["serial_binary"],
                                    _port(gang, "unequal_binary"), X,
                                    g_max=1.0, h_max=0.25)


def test_sharded_lambdarank_f32_to_the_binary_standard(gang):
    """Against the JAX serial model: the standard of
    ``tests/test_torch_ranking.py``, the gradients' bounds twice their
    largest at the zero score and at the JAX model's last score."""
    from test_torch_ranking import _grad_hess_bounds
    X, _ = _ranking()
    jb = gang["jax"]["serial_lambdarank"]
    g_max, h_max = _grad_hess_bounds(jb)
    assert_trees_to_binary_standard(jb, _port(gang, "unequal_lambdarank"),
                                    X, g_max=g_max, h_max=h_max,
                                    converted=False)


@pytest.mark.parametrize("name", sorted(FILE_CASES))
def test_file_route_matches_the_jax_serial_text(gang, name):
    want = _no_params(gang["jax"]["serial_quantized"].model_to_string())
    assert _no_params(gang["ranks"][0]["text"][name]) == want


def test_both_ranks_hold_the_same_models_and_their_rows_only(gang):
    r0, r1 = gang["ranks"]
    assert r0["text"].keys() == r1["text"].keys()
    for name in r0["text"]:
        assert r0["text"][name] == r1["text"][name], name
    for r, rk in enumerate(gang["ranks"]):
        for shape, local in rk["rows"].values():
            assert shape[0] == local
        sizes = {local for _, local in rk["rows"].values()}
        assert sizes == ({EVEN[r], UNEQUAL[r], 1500 + r}), sizes


def test_metadata_equals_the_replicated_metadata(gang):
    from lightgbm_tpu_torch.io.dataset_core import Metadata
    weight, group, isc = _meta()
    _, y = _dense()
    want = Metadata(N)
    want.set_label(y)
    want.set_weight(weight)
    want.set_query(group)
    want.set_init_score(isc.reshape(-1))
    for rk in gang["ranks"]:
        m = rk["meta"]
        assert np.array_equal(np.asarray(m["label"], np.float32), want.label)
        assert np.array_equal(np.asarray(m["weight"], np.float32),
                              want.weight)
        assert np.array_equal(m["init_score"], want.init_score)
        assert np.array_equal(m["query_boundaries"],
                              want.query_boundaries)


def test_refusals_carry_the_jax_messages(gang):
    for rk in gang["ranks"]:
        got = rk["refused"]
        assert "requires the row-sharded learners" in got["feature"]
        assert "tree_learner='feature'" in got["feature"]
        assert "linear_tree requires the full raw feature table" in \
            got["linear_tree"]
        assert "binary dataset files cannot be shard-ingested" in \
            got["binary_file"]
        for name in ("rollback", "dart"):
            assert "rollback/DART/refit over a sharded train set" in \
                got[name], name
        assert "cannot be saved as a binary dataset file" in \
            got["save_binary"]
        assert "of a sharded-ingest dataset are not supported" in \
            got["subset"]
        assert "Sequence input cannot be shard-ingested" in got["sequence"]


def test_efb_is_off_under_sharded_ingestion(gang):
    for rk in gang["ranks"]:
        assert not rk["efb_bundle"]
        assert any("EFB bundling is disabled under sharded ingestion" in m
                   for m in rk["efb_log"]), rk["efb_log"]


def test_checkpoint_at_two_resumes_to_the_uninterrupted_text(gang):
    for rk in gang["ranks"]:
        assert rk["manifests"] == [2, 1]
        assert rk["text"]["resumed"] == rk["text"]["uninterrupted"]


# -- the file route (no gang) ----------------------------------------------

def _loaders(monkeypatch, gathered=None):
    """The two packages' ``load_svm_or_csv``, each with its all-gather
    answering ``gathered(blob)`` (every rank's blob) in place of a
    world."""
    from lightgbm_tpu import distributed as jdist
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io import file_loader as jfl

    from lightgbm_tpu_torch import distributed as tdist
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import file_loader as tfl
    gathered = gathered or (lambda b: [b] * WORLD)
    for mod in (jdist, tdist):
        monkeypatch.setattr(mod, "allgather_bytes",
                            lambda b, what="": gathered(b))
    return ((lambda p, **kw: tfl.load_svm_or_csv(
        str(p), Config({"verbosity": -1}), **kw)),
            (lambda p, **kw: jfl.load_svm_or_csv(
                str(p), JConfig({"verbosity": -1}), **kw)))


def _same(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.nan_to_num(x, nan=-9.0),
                                          np.nan_to_num(y, nan=-9.0))


@pytest.mark.parametrize("kind", ["numbers", "missing"])
def test_csv_fields_parse_as_float_does(kind):
    """The parser's one ``float`` call a field (every field a number)
    and its field-by-field loop (anything else) give each number
    ``float(field)`` and each missing field NaN."""
    from lightgbm_tpu_torch.io.file_loader import _parse_rows
    fields = ["1.5", " -0.0 ", "1e-320", "nan", "inf", "3", "0",
              "2.5e+10"]
    rows = [fields, fields[::-1]]
    want = np.array([[float(t) for t in r] for r in rows])
    if kind == "missing":
        rows = [r[:] for r in rows]
        rows[0][2], rows[1][5] = "NA", ""
        want[0, 2] = want[1, 5] = np.nan
    got = _parse_rows(rows, len(fields))
    np.testing.assert_array_equal(got, want)
    assert np.signbit(got[0, 1]) == np.signbit(want[0, 1])


def test_rank_slices_and_placeholder_match_the_jax_loader(tmp_path,
                                                          monkeypatch):
    from lightgbm_tpu_torch.io.file_loader import resolve_rank_path
    port, jax = _loaders(monkeypatch)
    rng = np.random.default_rng(6)
    rows = np.column_stack([rng.integers(0, 2, 101), rng.normal(size=(101,
                                                                      4))])
    np.savetxt(tmp_path / "data.csv", rows, delimiter=",")
    got = []
    for r in range(3):
        a = port(tmp_path / "data.csv", rank=r, world=3)
        _same(a, jax(tmp_path / "data.csv", rank=r, world=3))
        got.append(a[0])
    np.testing.assert_allclose(np.concatenate(got), rows[:, 1:])
    for r in range(2):
        np.savetxt(tmp_path / f"part{r}.csv", rows[r * 50:(r + 1) * 50],
                   delimiter=",")
    placeholder = str(tmp_path / "part{rank}.csv")
    _same(port(placeholder, rank=1, world=2),
          jax(placeholder, rank=1, world=2))
    assert resolve_rank_path("a{rank}b", None) == ("a{rank}b", False)
    assert resolve_rank_path("a{rank}b", 3) == ("a3b", True)


def test_shared_file_content_guard(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.basic import LightGBMError
    rows = np.column_stack([np.arange(40) % 2,
                            np.random.default_rng(7).normal(size=(40, 3))])
    np.savetxt(tmp_path / "data.csv", rows, delimiter=",")
    port, _ = _loaders(monkeypatch)
    assert len(port(tmp_path / "data.csv", rank=0, world=2)[0]) == 20
    port, _ = _loaders(monkeypatch, lambda b: [b, b"\x00\x00\x00\x00"])
    with pytest.raises(LightGBMError, match="differ across ranks"):
        port(tmp_path / "data.csv", rank=0, world=2)


def test_sidecars_under_row_slicing(tmp_path, monkeypatch):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.basic import LightGBMError
    n = 60
    rows = np.column_stack([np.arange(n) % 2,
                            np.random.default_rng(8).normal(size=(n, 3))])
    path = tmp_path / "data.csv"
    np.savetxt(path, rows, delimiter=",")
    port, jax = _loaders(monkeypatch)
    np.savetxt(str(path) + ".weight", np.ones(n // 2))
    with pytest.raises(LightGBMError, match="sidecar"):
        port(path, rank=0, world=2)
    np.savetxt(str(path) + ".weight", np.arange(n, dtype=np.float64))
    parts = [port(path, rank=r, world=2) for r in range(2)]
    for r in range(2):
        _same(parts[r], jax(path, rank=r, world=2))
    np.testing.assert_array_equal(np.concatenate([p[2] for p in parts]),
                                  np.arange(n, dtype=np.float64))
    np.savetxt(str(path) + ".position", np.arange(n) % 5, fmt="%d")
    pos = [lgt.Dataset._load_position(str(path), r, 2, 30)
           for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(pos), np.arange(n) % 5)
    np.savetxt(str(path) + ".position", np.arange(n + 2) % 5, fmt="%d")
    with pytest.raises(LightGBMError, match="position sidecar"):
        lgt.Dataset._load_position(str(path), 1, 2, 30)


def test_ragged_rows_agree_the_column_count_over_the_file(tmp_path,
                                                         monkeypatch):
    lines = [f"{i % 2},1.0,2.0" for i in range(10)]
    lines[8] = "0,1.0,2.0,3.0,4.0"       # the widest row is in shard 1
    p = tmp_path / "ragged.csv"
    p.write_text("\n".join(lines) + "\n")
    port, jax = _loaders(monkeypatch)
    full = port(p)
    parts = [port(p, rank=r, world=2) for r in range(2)]
    for r in range(2):
        assert parts[r][0].shape[1] == full[0].shape[1]
        _same(parts[r], jax(p, rank=r, world=2))
    _same([np.concatenate([a[0] for a in parts])], [full[0]])


def test_parser_plugin_gives_the_jax_packages_text(gang, monkeypatch):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.basic import LightGBMError
    from lightgbm_tpu_torch.io import file_loader
    monkeypatch.setattr(file_loader, "_PARSER_PLUGINS", [])
    file_loader.register_parser(_detect, _parse)
    path = os.path.join(gang["out"], "data.custom")
    bst = lgt.train(_port_params(JAX_SERIAL["plugin"][1]),
                    lgt.Dataset(path), num_boost_round=ROUNDS)
    assert _no_params(bst.model_to_string()) == \
        _no_params(gang["jax"]["plugin"].model_to_string())
    from lightgbm_tpu_torch.config import Config
    with pytest.raises(LightGBMError, match="parser plugins do not "
                       "support row-slice sharding"):
        file_loader.load_svm_or_csv(path, Config({}), rank=0, world=2)
