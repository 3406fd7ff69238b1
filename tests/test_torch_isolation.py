"""The PyTorch port stands apart from the JAX package: no file of
``lightgbm_tpu_torch/`` and not ``chip_smoke.py`` imports jax, jaxlib or
``lightgbm_tpu`` (a static scan), and importing the port loads none of
them (a fresh interpreter)."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for base, dirs, files in os.walk(os.path.join(REPO,
                                                  "lightgbm_tpu_torch")):
        dirs.sort()
        out += [os.path.join(base, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


# modules copied from the JAX package that need nothing but numpy, the
# port's config and its log: each may import only these
LEAF_MODULES = {
    # checkpoint_callback writes through the port's robustness package
    "lightgbm_tpu_torch/callback.py": {"__future__", "collections",
                                       "typing", ".utils", ".robustness"},
    # the rank slice of a shared file agrees on a CRC32 of its lines over
    # the world's all-gather
    "lightgbm_tpu_torch/io/file_loader.py": {"__future__", "os", "typing",
                                             "numpy", "..config",
                                             "..utils", "zlib",
                                             "..distributed"},
}


# modules copied from the JAX package for the user surface, and the only
# imports each may have: the host TreeSHAP without the JAX package's
# native kernel, the binary dataset format, and the estimators with their
# stand-ins for a machine without scikit-learn
COPIED_MODULES = {
    "lightgbm_tpu_torch/core/shap.py": {"__future__", "numpy", ".tree"},
    "lightgbm_tpu_torch/io/binary_io.py": {"__future__", "json", "math",
                                           "numpy", "..utils", ".binning",
                                           ".dataset_core"},
    "lightgbm_tpu_torch/sklearn.py": {"__future__", "inspect", "typing",
                                      "numpy", "sklearn.base",
                                      "sklearn.preprocessing", ".basic",
                                      ".callback", ".config", ".engine",
                                      ".utils.log"},
}


# the wide sparse data modules, ported from the JAX package's (bundling,
# multi-value storage, Sequence input): the only imports each may have
SPARSE_MODULES = {
    "lightgbm_tpu_torch/io/bundling.py": {"__future__", "dataclasses",
                                          "typing", "numpy", "torch",
                                          "..ops.split"},
    "lightgbm_tpu_torch/ops/hist_multival.py": {"__future__", "typing",
                                                "numpy", "torch",
                                                "..io.bundling"},
    "lightgbm_tpu_torch/io/sequence.py": {"__future__", "abc", "typing",
                                          "numpy", "..config", "..utils",
                                          ".dataset_core"},
}
COPIED_MODULES.update(SPARSE_MODULES)


# the training-side robustness modules, copied from the JAX package's
# robustness/ (jax-free there): the only imports each may have. None
# imports torch at module level; retry.probe_device imports it when it
# is called
ROBUSTNESS_MODULES = {
    "lightgbm_tpu_torch/robustness/__init__.py": {
        ".checkpoint", ".faults", ".heartbeat", ".integrity", ".retry",
        ".supervisor", ".gang"},
    # the supervised gang spawns its ranks through distributed.spawn_local
    # (imported when it launches, and torch-free at module level)
    "lightgbm_tpu_torch/robustness/gang.py": {
        "__future__", "json", "os", "re", "shutil", "subprocess",
        "tempfile", "threading", "time", "typing", "..utils", ".",
        ".heartbeat", ".retry", "..distributed"},
    "lightgbm_tpu_torch/robustness/faults.py": {
        "__future__", "os", "random", "threading", "typing", "..utils",
        "errno", "time", "sys"},
    "lightgbm_tpu_torch/robustness/checkpoint.py": {
        "__future__", "errno", "json", "os", "re", "zlib", "typing",
        "..utils", "."},
    "lightgbm_tpu_torch/robustness/retry.py": {
        "__future__", "dataclasses", "random", "time", "typing", "..utils",
        ".", "torch"},
    "lightgbm_tpu_torch/robustness/heartbeat.py": {
        "__future__", "dataclasses", "json", "os", "threading", "time",
        "typing", "..utils", ".", "_thread"},
    "lightgbm_tpu_torch/robustness/supervisor.py": {
        "__future__", "os", "subprocess", "time", "typing", "..utils",
        ".heartbeat"},
    # the serving half's background canary probe runs on a thread and
    # logs what it catches
    "lightgbm_tpu_torch/robustness/integrity.py": {
        "__future__", "typing", "numpy", ".", "zlib", "threading",
        "..utils"},
}
COPIED_MODULES.update(ROBUSTNESS_MODULES)


# the serving tier's modules copied from the JAX package's serving/
# (jax-free there): the only imports each may have
SERVING_MODULES = {
    "lightgbm_tpu_torch/serving/metrics.py": {
        "__future__", "math", "threading", "typing"},
    "lightgbm_tpu_torch/serving/batcher.py": {
        "__future__", "queue", "threading", "time", "typing", "numpy",
        ".metrics", "..utils"},
}
COPIED_MODULES.update(SERVING_MODULES)


# the continual service's modules copied from the JAX package's
# native/__init__.py (its numpy parsers), io/stream_loader.py and
# service/ (jax-free there): the only imports each may have. The front
# door reaches the serving tier only through its exceptions and its
# latency recorder; the trainer trains through the port's own API
SERVICE_MODULES = {
    "lightgbm_tpu_torch/native/__init__.py": {
        "__future__", "typing", "numpy"},
    "lightgbm_tpu_torch/io/stream_loader.py": {
        "__future__", "os", "time", "typing", "numpy", "scipy.sparse",
        "..config", "..native", "..utils", "..ops.hist_multival",
        ".dataset_core", ".file_loader"},
    "lightgbm_tpu_torch/service/trainer.py": {
        "__future__", "dataclasses", "json", "os", "subprocess", "sys",
        "threading", "time", "typing", "numpy", "..utils", "..basic",
        "..engine", "..io.stream_loader", "..robustness",
        "..robustness.heartbeat", "..robustness.retry",
        "..robustness.supervisor"},
    "lightgbm_tpu_torch/service/frontdoor.py": {
        "__future__", "io", "json", "threading", "time", "typing",
        "http.server", "numpy", "..serving.batcher", "..serving.metrics",
        "..utils"},
    "lightgbm_tpu_torch/service/__init__.py": {
        "__future__", "os", "threading", "time", "typing", "numpy",
        ".frontdoor", ".trainer", "..basic", "..config", "..serving",
        "..serving.metrics", "..robustness.checkpoint", "..utils"},
}
COPIED_MODULES.update(SERVICE_MODULES)


def test_service_modules_import_no_torch_at_module_level():
    """The parsers, the stream loader, the trainer loop and the front door
    are host code: none imports torch at its top level."""
    for rel in SERVICE_MODULES:
        with open(os.path.join(REPO, rel)) as fh:
            tree = ast.parse(fh.read(), filename=rel)
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert "torch" not in names, rel


def test_robustness_imports_no_torch_at_module_level():
    """A supervisor imports the robustness package and must not touch
    the device it supervises: no module of it imports torch at its top
    level."""
    for rel in ROBUSTNESS_MODULES:
        with open(os.path.join(REPO, rel)) as fh:
            tree = ast.parse(fh.read(), filename=rel)
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert "torch" not in names, rel


def test_sources_exist():
    sources = _port_sources()
    assert os.path.isfile(sources[0])
    assert len(sources) > 10
    rel = {os.path.relpath(p, REPO) for p in sources}
    assert {"lightgbm_tpu_torch/io/model_io.py",
            "lightgbm_tpu_torch/engine.py",
            "lightgbm_tpu_torch/io/dataset_core.py",
            "lightgbm_tpu_torch/core/objective.py",
            "lightgbm_tpu_torch/core/metrics.py",
            "lightgbm_tpu_torch/utils/prng.py"} | set(LEAF_MODULES) | \
        set(COPIED_MODULES) <= rel


@pytest.mark.parametrize("rel", sorted(LEAF_MODULES))
def test_copied_leaf_module_imports_only_numpy_config_and_log(rel):
    with open(os.path.join(REPO, rel)) as fh:
        tree = ast.parse(fh.read(), filename=rel)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            found.add("." * node.level + (node.module or ""))
            if node.module == "utils" and node.level:
                assert [a.name for a in node.names] == ["log"], rel
    assert found <= LEAF_MODULES[rel], found - LEAF_MODULES[rel]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = str(mod).split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_import_loads_no_jax():
    code = ("import sys; import lightgbm_tpu_torch; "
            "import lightgbm_tpu_torch.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("rel", sorted(COPIED_MODULES))
def test_copied_module_imports_only_what_it_needs(rel):
    with open(os.path.join(REPO, rel)) as fh:
        tree = ast.parse(fh.read(), filename=rel)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            found.add("." * node.level + (node.module or ""))
    assert found <= COPIED_MODULES[rel], found - COPIED_MODULES[rel]
