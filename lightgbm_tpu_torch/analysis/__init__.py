"""Static and runtime concurrency analysis of the port's threaded modules.

The port's counterpart of ``lightgbm_tpu/analysis/``, for what has one:

- :mod:`.astcore` — the AST machinery (per-file context, suppression
  comments, findings, baseline helpers) the JAX package keeps in
  ``jaxlint.py`` and ``rules.py``;
- :mod:`.concurrency` — conlint, rules CL001-CL005 over the port's
  lock-bearing modules (serving, service, heartbeat, gang, faults, the
  native build lock), with its own reasoned baseline
  (``concurrency_baseline.json`` here). CLI:
  ``python -m lightgbm_tpu_torch.analysis``;
- :mod:`.lockorder` — the opt-in runtime lock-order tracker
  (``LGBM_TPU_GUARDS=lockorder``).

JAX's lint rules (JL001-JL005), its dispatch guards (compile budgets,
transfer guards) and the compiled-HLO byte counter have no counterpart
here: torch compiles nothing the port runs, and a CUDA tensor cannot be
read to the host implicitly. Pure stdlib; importing this package imports
no torch.
"""
import os

from .concurrency import (  # noqa: F401
    CONCURRENCY_RULE_IDS,
    CONCURRENCY_RULES,
    LockGraph,
    TARGET_MODULES,
)

# LGBM_TPU_GUARDS tokens of the JAX package (lightgbm_tpu/analysis/
# guards.py) that select its compile budget and transfer guard
_NO_COUNTERPART = ("1", "log", "strict", "disallow")
_OFF = ("0", "false", "off", "no")


def _guard_tokens(env=None):
    """The tokens of ``LGBM_TPU_GUARDS`` (alias ``LIGHTGBM_TPU_GUARDS``),
    lower-cased, comma-separated."""
    e = env if env is not None else os.environ
    val = (e.get("LGBM_TPU_GUARDS") or
           e.get("LIGHTGBM_TPU_GUARDS") or "").strip().lower()
    return [t.strip() for t in val.split(",") if t.strip()]


def install_guards_from_env(env=None) -> bool:
    """Process-wide guards from ``LGBM_TPU_GUARDS``; True when the
    lock-order tracker was installed.

    ``lockorder`` installs :mod:`.lockorder` over the instrumented
    modules; call this before they create their locks (the package's
    ``__init__`` does, ahead of every submodule import). The JAX
    package's other tokens (``1``/``log``, ``strict``/``disallow``)
    select its compile budget and transfer guard, which have no
    counterpart in the port: torch compiles nothing the port runs, so
    there is no retrace to count, and a CUDA tensor's ``__array__``
    raises, so an implicit device-to-host read cannot happen (every read
    is an explicit ``.cpu()`` / ``.item()``). They are accepted and
    logged once."""
    tokens = _guard_tokens(env)
    other = [t for t in tokens if t != "lockorder" and t not in _OFF]
    if other:
        from ..utils import log
        known = [t for t in other if t in _NO_COUNTERPART]
        log.warning_once(
            f"LGBM_TPU_GUARDS={','.join(other)}: the JAX package's "
            "compile budget and transfer guard have no counterpart in the "
            "port (torch compiles nothing it runs; a CUDA tensor cannot "
            "be read to the host implicitly)"
            + ("" if len(known) == len(other) else
               "; unknown tokens ignored"))
    if "lockorder" not in tokens:
        return False
    from . import lockorder
    lockorder.install()
    return True
