"""Binned-dataset binary serialization.

Copy of ``lightgbm_tpu/io/binary_io.py`` (ref: Dataset::SaveBinaryFile,
include/LightGBM/dataset.h:710; DatasetLoader::LoadFromBinFile,
src/io/dataset_loader.cpp:425): a .npz archive holding the bin matrix,
the metadata and a JSON header with the bin mappers. The file stores the
bins feature-major ``[F, R]``, as the JAX package holds them; the port
holds them row-major ``[R, F]``, so it transposes on save and on load, and
a file written by either package loads in the other.
"""
from __future__ import annotations

import json
import math

import numpy as np

from ..utils import log
from .binning import BinMapper
from .dataset_core import BinnedDataset, Metadata

_MAGIC = "lightgbm_tpu.dataset.v1"
_META_FIELDS = ("label", "weight", "init_score", "query_boundaries",
                "position")


def _mapper_to_dict(m: BinMapper) -> dict:
    return {
        "num_bin": int(m.num_bin),
        "missing_type": m.missing_type,
        "is_trivial": bool(m.is_trivial),
        "sparse_rate": float(m.sparse_rate),
        "bin_type": m.bin_type,
        "bin_upper_bound": [
            ("inf" if math.isinf(v) else float(v)) for v in m.bin_upper_bound],
        "bin_2_categorical": [int(v) for v in m.bin_2_categorical],
        "min_val": float(m.min_val),
        "max_val": float(m.max_val),
        "default_bin": int(m.default_bin),
        "most_freq_bin": int(m.most_freq_bin),
    }


def _mapper_from_dict(d: dict) -> BinMapper:
    m = BinMapper()
    m.num_bin = int(d["num_bin"])
    m.missing_type = d["missing_type"]
    m.is_trivial = bool(d["is_trivial"])
    m.sparse_rate = float(d["sparse_rate"])
    m.bin_type = d["bin_type"]
    m.bin_upper_bound = np.asarray(
        [math.inf if v == "inf" else float(v) for v in d["bin_upper_bound"]],
        dtype=np.float64)
    m.bin_2_categorical = [int(v) for v in d["bin_2_categorical"]]
    m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
    m.min_val = float(d["min_val"])
    m.max_val = float(d["max_val"])
    m.default_bin = int(d["default_bin"])
    m.most_freq_bin = int(d["most_freq_bin"])
    return m


def save_binary(ds: BinnedDataset, path: str) -> None:
    """Write a constructed BinnedDataset to ``path``, bins feature-major
    (ref: dataset.h:710)."""
    if ds.bins is None:
        log.fatal("cannot save an unconstructed dataset")
    header = {
        "magic": _MAGIC,
        "num_data": int(ds.num_data),
        "num_total_features": int(ds.num_total_features),
        "max_bin": int(ds.max_bin),
        "feature_names": list(ds.feature_names),
        "mappers": [_mapper_to_dict(m) for m in ds.bin_mappers],
    }
    arrays = {
        "header": np.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=np.uint8),
        "bins": np.ascontiguousarray(ds.bins.T),
        "used_feature_map": ds.used_feature_map,
    }
    for name in _META_FIELDS:
        arr = getattr(ds.metadata, name)
        if arr is not None:
            arrays["meta_" + name] = arr
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_binary(path: str) -> BinnedDataset:
    """Load a dataset written by ``save_binary`` of either package, bins
    back to row-major (ref: dataset_loader.cpp:425 LoadFromBinFile)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["header"]).decode("utf-8"))
        if header.get("magic") != _MAGIC:
            log.fatal(f"{path} is not a lightgbm_tpu binary dataset")
        ds = BinnedDataset()
        ds.bins = np.ascontiguousarray(z["bins"].T)
        ds.used_feature_map = z["used_feature_map"]
        ds.num_data = int(header["num_data"])
        ds.num_total_features = int(header["num_total_features"])
        ds.max_bin = int(header["max_bin"])
        ds.feature_names = list(header["feature_names"])
        ds.bin_mappers = [_mapper_from_dict(d) for d in header["mappers"]]
        meta = Metadata(ds.num_data)
        for name in _META_FIELDS:
            key = "meta_" + name
            if key in z:
                setattr(meta, name, z[key])
        ds.metadata = meta
    return ds


def is_binary_dataset_file(path: str) -> bool:
    """Cheap sniff: .npz zip magic + our header entry."""
    try:
        with open(path, "rb") as f:
            if f.read(2) != b"PK":
                return False
        with np.load(path, allow_pickle=False) as z:
            return "header" in z.files
    except Exception:
        return False
