"""The port's public surface against the JAX package's.

Every module of ``lightgbm_tpu`` (``pkgutil.walk_packages``) but the
few with no counterpart in the port (ROADMAP A) has its namesake in
``lightgbm_tpu_torch``, and for every public function or class defined
there, every public method and property of such a class and every named
parameter of each, the port's module has the counterpart: the same name,
taking a parameter of the same name. Every key and alias of the JAX
``Config`` registry is registered in the port with the same type and
default. What the port deliberately lacks stands in ``ALLOWLIST``, one
reason a group; an entry the port has by now fails as stale, so the list
cannot rot. Nothing is trained: beyond the imports the walk takes well
under a second.
"""
import importlib
import inspect
import pkgutil
import types

import pytest

import lightgbm_tpu
from lightgbm_tpu import config as jax_config
from lightgbm_tpu_torch import config as port_config

# the JAX package's modules without a counterpart (ROADMAP A, "No
# counterpart in the port"): JAX retrace and transfer audits, compiled-
# HLO bytes, the Pallas kernels (each has its CUDA kernel in csrc/), the
# TPU autotuner cache and XLA's compile cache
NO_COUNTERPART_MODULES = {
    "analysis.guards", "analysis.hlo", "analysis.jaxlint", "analysis.rules",
    "ops.hist_pallas", "ops.hist_level_pallas", "tuned", "utils.jit_cache"}

XLA_FORM = ("an XLA histogram form or lowering choice: the port's hand "
            "kernels pick their path by shape")
TUNED = ("reads the TPU autotuner cache (tuned.py), which has no "
         "counterpart")
MESH = ("a jax Mesh, axis name or shard_map hook: the port's learners "
        "run one process a device over torch.distributed (parallel/mesh."
        "Comm)")
JIT = ("jit and pytree plumbing: a static flag, padding or bucket that "
       "fixes a traced shape; the port's host loop needs none")
EFB = ("the EFB bundle handed to a jitted grower as a dict: the port's "
       "growers read the columns through core/layout.Layout")
FORM = ("the port's argument carries the same data in its own form, "
        "under its own name (row-major bins_rm, a pack, a tuple, "
        "quant_bins for the grower config, the feature-major training "
        "bins of GBDT._train_bins_fm)")
PRNG = ("jax PRNG key plumbing: the port draws the JAX package's threefry "
        "bits first (utils/prng.py) and passes them on")
UNREAD = ("an optional input that no caller of the port passes: a cache "
          "of split decisions that the port's walk computes itself, or "
          "gradients that the bagging draw does not read")
FALLBACK = ("a fallback that hides the device: the port keeps none, a "
            "missing card raises")

ALLOWLIST = {
    # XLA_FORM
    "core.grower.GrowerConfig.__init__(hist_backend)": XLA_FORM,
    "core.grower.GrowerConfig.__init__(block_rows)": XLA_FORM,
    "core.grower.GrowerConfig.__init__(hist_rm_backend)": XLA_FORM,
    "core.grower.GrowerConfig.__init__(level_hist_backend)": XLA_FORM,
    "core.grower.GrowerConfig.__init__(partition_mode)": XLA_FORM,
    "core.grower.GrowerConfig.__init__(min_bucket)": XLA_FORM,
    "core.grower.GrowerConfig.__init__(packed_cols)": XLA_FORM,
    "core.level_grower.effective_level_backend": XLA_FORM,
    "core.level_grower.hist_level_scatter": XLA_FORM,
    "core.level_grower.hist_level_blocks": XLA_FORM,
    "ops.histogram.hist_xla": XLA_FORM,
    "ops.histogram.hist_scatter": XLA_FORM,
    "ops.histogram.make_hist_fn": XLA_FORM,
    "ops.histogram.hist_rowmajor(block_rows)": XLA_FORM,
    "ops.histogram.hist_rowmajor(dtype)": XLA_FORM,
    "ops.histogram.hist_rowmajor(backend)": XLA_FORM,
    "ops.hist_multival.make_fetch_bin_column": XLA_FORM,
    "ops.hist_multival.make_local_default_bin_fix": XLA_FORM,
    "ops.hist_multival.take_rows": XLA_FORM,
    # TUNED
    "models.gbdt.resolve_hist_kernel": TUNED,
    "models.gbdt.resolve_level_hist_kernel": TUNED,
    "models.gbdt.resolve_hist_reduce(num_data)": TUNED,
    "models.gbdt.resolve_hist_reduce(platform)": TUNED,
    # MESH
    "core.grower.make_tree_grower(reduce_hist)": MESH,
    "core.grower.make_tree_grower(reduce_sums)": MESH,
    "core.grower.make_tree_grower(prepare_split_hist)": MESH,
    "core.grower.make_tree_grower(select_best)": MESH,
    "core.grower.make_tree_grower(scan_window)": MESH,
    "core.grower.make_tree_grower(fetch_bin_column)": MESH,
    "core.grower.make_tree_grower(partition_meta)": MESH,
    "core.grower.make_tree_grower(reduce_max)": MESH,
    "core.grower.make_tree_grower(prepare_is_pure)": MESH,
    "core.grower.make_tree_grower(local_pool)": MESH,
    "core.grower.make_tree_grower(mc_rescan_hooks_ok)": MESH,
    "core.grower.make_tree_grower(reduce_box)": MESH,
    "core.grower.make_tree_grower(localize_feature)": MESH,
    "ops.split.best_split_for_leaf(feature_ids)": MESH,
    "parallel.data_parallel.make_global_best_combine(axis)": MESH,
    "parallel.data_parallel.make_feature_window(num_shards)": MESH,
    "parallel.data_parallel.make_feature_window(axis)": MESH,
    "parallel.data_parallel.make_data_parallel_grower(mesh)": MESH,
    "parallel.data_parallel.make_data_parallel_grower(data_axis)": MESH,
    "parallel.data_parallel.make_data_parallel_grower(fetch_bin_column)":
        MESH,
    "parallel.data_parallel.make_data_parallel_grower(prepare_split_hist)":
        MESH,
    "parallel.data_parallel.make_data_parallel_grower(prepare_is_pure)":
        MESH,
    "parallel.data_parallel.make_data_parallel_grower(bins_spec)": MESH,
    "parallel.data_parallel.make_distributed_train_step(mesh)": MESH,
    "parallel.data_parallel.make_distributed_train_step(data_axis)": MESH,
    "parallel.feature_parallel.shard_bundle(num_shards)": MESH,
    "parallel.feature_parallel.shard_bundle(B)": MESH,
    "parallel.feature_parallel.make_feature_parallel_grower(mesh)": MESH,
    "parallel.feature_parallel.make_feature_parallel_grower(feature_axis)":
        MESH,
    "parallel.mesh.build_mesh": MESH,
    "parallel.mesh.row_sharding": MESH,
    "parallel.mesh.replicated": MESH,
    "parallel.voting_parallel.make_voting_parallel_grower(mesh)": MESH,
    "parallel.voting_parallel.make_voting_parallel_grower(data_axis)": MESH,
    "parallel.voting_parallel.make_voting_parallel_grower(fetch_bin_column)":
        MESH,
    "parallel.voting_parallel.make_voting_parallel_grower(bins_spec)": MESH,
    "parallel.voting_parallel.make_voting_parallel_grower(pre_fix)": MESH,
    # JIT
    "core.grower.GrowerConfig.__init__(bynode_mask)": JIT,
    "ops.forest.PackedTree": JIT,
    "ops.forest.DeviceBinner.bins(rows)": JIT,
    "ops.forest.pack_window_binned(cat_width)": JIT,
    "ops.forest.ServingEngine.__init__(bucket)": JIT,
    "ops.hist_multival.SparseBins.shape": JIT,
    "ops.hist_multival.SparseBins.tree_flatten": JIT,
    "ops.hist_multival.SparseBins.tree_unflatten": JIT,
    "ops.hist_multival.pack_csr_bins(num_features)": JIT,
    "ops.split.pack_record_rows(has_cat)": JIT,
    "ops.split.best_split_for_leaf(want_row)": JIT,
    "core.tree.TreeArrays.empty": JIT,
    "ops.split.SplitRecord.invalid": JIT,
    # EFB
    "core.grower.make_tree_grower(bundle)": EFB,
    "core.hybrid_grower.make_hybrid_grower(bundle)": EFB,
    "core.level_grower.make_level_phase(bundle)": EFB,
    "core.level_grower.make_level_grower(bundle)": EFB,
    "io.bundling.make_expand_hist(bundle)": EFB,
    "parallel.data_parallel.make_data_parallel_grower(bundle)": EFB,
    "parallel.feature_parallel.shard_bundle(bundle)": EFB,
    "parallel.feature_parallel.shard_bundle(meta)": EFB,
    "parallel.voting_parallel.make_voting_parallel_grower(bundle)": EFB,
    # FORM
    "core.level_grower.rank_and_slots(e_h)": FORM,
    "core.level_grower.rank_and_slots(cut_mask)": FORM,
    "io.bundling.most_frequent_bins(bins)": FORM,
    "io.bundling.find_bundles(bins)": FORM,
    "io.bundling.pack_bins(bins)": FORM,
    "ops.forest.pad_window(stacked_np)": FORM,
    "ops.forest.window_cat_width(window_np)": FORM,
    "ops.predict.forest_leaf_bins(special)": FORM,
    "ops.predict.forest_leaf_bins(flip)": FORM,
    "ops.predict.fleet_leaf_bins(special)": FORM,
    "ops.predict.fleet_leaf_bins(flip)": FORM,
    "ops.predict.fleet_leaf_raw(X)": FORM,
    "ops.split.forced_split_record(meta)": FORM,
    "robustness.integrity.corrupt_pack(host)": FORM,
    "core.grower.quantize_gradients(cfg)": FORM,
    "core.tree.host_tree_to_arrays": FORM,
    "models.gbdt.GBDT.bins_dev": FORM,
    # PRNG
    "core.grower.quantize_gradients(rng_key)": PRNG,
    "core.grower.quantize_gradients(localize_key)": PRNG,
    "core.grower.make_tree_grower(localize_key)": PRNG,
    # UNREAD
    "core.shap.predict_contrib(decisions)": UNREAD,
    "core.shap.shap_tree_batch(goes_left)": UNREAD,
    "models.sample_strategy.BaggingStrategy.sample_dev(grad)": UNREAD,
    "models.sample_strategy.BaggingStrategy.sample_dev(hess)": UNREAD,
    # FALLBACK
    "robustness.retry.ensure_device_or_fallback": FALLBACK,
}

# registry keys whose default differs by design
CONFIG_ALLOWLIST = {
    "device_type": "the port's device is cuda (cpu when asked), the JAX "
                   "package's tpu",
}


def _modules():
    out = []
    for info in pkgutil.walk_packages(lightgbm_tpu.__path__,
                                      "lightgbm_tpu."):
        rel = info.name[len("lightgbm_tpu."):]
        if rel.split(".")[-1].startswith("_") or \
                rel in NO_COUNTERPART_MODULES:
            continue
        out.append(rel)
    return sorted(out)


def _params(fn):
    """The named parameters of ``fn`` and whether it takes ``**kwargs``;
    None when it has no signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    ps = sig.parameters.values()
    return ([p.name for p in ps
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)],
            any(p.kind == p.VAR_KEYWORD for p in ps))


def _missing_params(qual, ref_fn, port_fn):
    ref, port = _params(ref_fn), _params(port_fn)
    if ref is None or port is None or port[1]:
        return []
    return [f"{qual}({name})" for name in ref[0] if name not in port[0]]


def _unwrap(member):
    return (member.__func__
            if isinstance(member, (staticmethod, classmethod)) else member)


def surface_gaps(rel, ref_mod, port_mod):
    """The qualified names of ``ref_mod``'s public surface that
    ``port_mod`` lacks: ``rel.name``, ``rel.Class.method`` and
    ``rel.function(parameter)``."""
    gaps = []
    for name, obj in vars(ref_mod).items():
        if name.startswith("_") or \
                not (inspect.isfunction(obj) or inspect.isclass(obj)) or \
                getattr(obj, "__module__", None) != ref_mod.__name__:
            continue
        qual = f"{rel}.{name}"
        if not hasattr(port_mod, name):
            gaps.append(qual)
            continue
        port_obj = getattr(port_mod, name)
        if inspect.isfunction(obj):
            gaps += _missing_params(qual, obj, port_obj)
            continue
        for mname, member in vars(obj).items():
            if mname.startswith("_") and mname != "__init__":
                continue
            fn = _unwrap(member)
            if not (isinstance(member, property) or inspect.isfunction(fn)):
                continue
            mqual = f"{qual}.{mname}"
            if not hasattr(port_obj, mname):
                gaps.append(mqual)
                continue
            if inspect.isfunction(fn):
                port_fn = _unwrap(inspect.getattr_static(port_obj, mname))
                if callable(port_fn):
                    gaps += _missing_params(mqual, fn, port_fn)
    return gaps


def _module_gaps(rel):
    ref_mod = importlib.import_module("lightgbm_tpu." + rel)
    try:
        port_mod = importlib.import_module("lightgbm_tpu_torch." + rel)
    except ImportError:
        return [rel]
    return surface_gaps(rel, ref_mod, port_mod)


MODULES = _modules()


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_the_jax_surface(rel):
    gaps = [g for g in _module_gaps(rel) if g not in ALLOWLIST]
    assert not gaps, f"the port lacks: {gaps}"


def test_allowlist_holds_no_stale_entry():
    """Every allowlisted name is one the port still lacks, in a module the
    walk visits, with a reason."""
    assert MODULES and not set(MODULES) & NO_COUNTERPART_MODULES
    found = {g for rel in MODULES for g in _module_gaps(rel)}
    stale = sorted(set(ALLOWLIST) - found)
    assert not stale, f"the port has these now; drop them: {stale}"
    assert all(ALLOWLIST.values())


def test_config_registry_matches_the_jax_package():
    for name, (typ, default, aliases, _check) in jax_config._P.items():
        assert name in port_config._P, name
        ptyp, pdefault, _, _ = port_config._P[name]
        assert ptyp == typ, name
        if name not in CONFIG_ALLOWLIST:
            assert pdefault == default, name
        for alias in aliases:
            assert port_config._ALIAS_TO_NAME.get(alias) == name, alias
    assert set(CONFIG_ALLOWLIST) <= set(jax_config._P)
    assert port_config._P["device_type"][1] in ("cuda", "cpu")


def test_the_walk_reports_missing_names_and_parameters():
    """The checker itself: a removed function, method, property and
    parameter each show up under its qualified name."""
    ref = types.ModuleType("ref")
    port = types.ModuleType("port")

    def f(a, b=1):
        pass

    def g(a):
        pass

    class C:
        def m(self, x, y=0):
            pass

        @property
        def p(self):
            return 0

        def n(self):
            pass

    class D:
        def m(self, x):
            pass

    for fn in (f, g, C):
        fn.__module__ = "ref"
        setattr(ref, fn.__name__, fn)
    port.f = lambda a: None
    port.C = D
    assert sorted(surface_gaps("ref", ref, port)) == [
        "ref.C.m(y)", "ref.C.n", "ref.C.p", "ref.f(b)", "ref.g"]
    port.f = lambda a, **kw: None
    assert "ref.f(b)" not in surface_gaps("ref", ref, port)

