"""Silent-corruption defense, training half: numeric health.

Port of the training half of ``lightgbm_tpu/robustness/integrity.py``
for the PyTorch/CUDA port. A process that KEEPS RUNNING and commits
wrong bits (a NaN-poisoned boosting iteration) is worse than one that
dies; the contract is detect, refuse to commit, and let the caller roll
back — never silently commit a model that scores NaN.

:class:`NumericHealthGuard` checks grad/hess sums, leaf outputs and a
loss series every iteration and raises :class:`NumericHealthError`
(classified ``DATA_CORRUPTION`` by ``retry.classify_error``; NOT
transient — retrying the same poisoned iteration is futile). The fault
sites ``nan_grad`` and ``loss_spike`` (``faults.py``) inject exactly
these signatures.

The gang digests (``iteration_digest``, ``digest_reduction``,
``check_digest_reduction``): every rank of a distributed learner
all-reduces a CRC of the iteration's trees, encoded so the sum alone
decides agreement, and a disagreement raises :class:`GangDivergence`
(``models/gbdt.py`` ``_gang_digest_check``).

The serving half: :func:`canary_batch` (fixed canary rows a publish
scores as its golden), :func:`crc32_fingerprint` over a pack's arrays
(device tensors are read back to the host for it), :func:`corrupt_pack`
(the ``bitflip:where=dev`` payload: slot-0 leaf outputs sign-flipped on
a device copy), :class:`IntegrityProbe` (the background canary replay)
and :func:`parity_equal` (the bit-for-bit acceptance predicate);
``serving/server.py`` quarantines, repairs and accounts.
"""
from __future__ import annotations

import threading
import zlib
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..utils import log

#: substring every integrity exception carries — retry.classify_error
#: files anything with this marker under the DATA_CORRUPTION class.
CORRUPTION_MARKER = "DATA_CORRUPTION"


class IntegrityError(RuntimeError):
    """Base of the corruption family; the message always carries the
    DATA_CORRUPTION marker so string-level classification (the same
    convention FaultInjected/OOMInjected use) works across process
    boundaries."""

    def __init__(self, msg: str):
        if CORRUPTION_MARKER not in msg:
            msg = f"{CORRUPTION_MARKER}: {msg}"
        super().__init__(msg)


class NumericHealthError(IntegrityError):
    """A boosting iteration produced non-finite or wildly spiked
    numerics (NaN/Inf grad/hess/leaf outputs, loss spike). Retrying the
    same iteration is futile; the caller must roll back."""


class CanaryMismatch(IntegrityError):
    """A device route returned canary scores that differ bit-wise from
    the publish-time golden (or disagree with the host-walk anchor at
    publish) — the pack is corrupt."""


# ---------------------------------------------------------------------------
# Fingerprints + canaries (the serving half)
# ---------------------------------------------------------------------------

def _is_tensor(obj) -> bool:
    # duck-typed: this module never imports torch
    return hasattr(obj, "detach") and hasattr(obj, "cpu")


def _walk_arrays(obj):
    """Yield every array of a pack as host numpy: tuples (NamedTuples
    included), lists, dicts, scalars, numpy arrays, and torch tensors on
    any device (read back to the host)."""
    if obj is None:
        return
    if isinstance(obj, np.ndarray):
        yield obj
        return
    if _is_tensor(obj):
        yield obj.detach().cpu().numpy()
        return
    if isinstance(obj, dict):
        for k in sorted(obj):
            yield from _walk_arrays(obj[k])
        return
    if isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _walk_arrays(v)
        return
    if isinstance(obj, (int, float, bool, np.generic)):
        yield np.asarray(obj)


def crc32_fingerprint(tree) -> int:
    """CRC32 over every array's dtype, shape and bytes in ``tree``.

    Structure-sensitive (an array moved between leaves changes the
    digest) and cheap: one pass over host memory (a device pack is read
    back once). Two packs with the same fingerprint hold the same bits."""
    crc = 0
    for a in _walk_arrays(tree):
        crc = zlib.crc32(str((a.dtype.str, a.shape)).encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc & 0xFFFFFFFF


def canary_batch(n_features: int, rows: int = 16,
                 seed: int = 0) -> np.ndarray:
    """Deterministic canary rows for one feature width: f64 values that
    are exactly f32-representable (the raw device route demands it),
    derived from ``(seed, n_features)`` alone so every process —
    publisher, prober, a test — regenerates identical bits (the JAX
    package's robustness/integrity.py:121-133, the same draw)."""
    rng = np.random.default_rng(1_000_003 * (seed + 1) + n_features)
    x = rng.standard_normal((int(rows), int(n_features)))
    return x.astype(np.float32).astype(np.float64)


def _negated_slot0(a):
    """A copy of ``a`` (numpy or a tensor, on its own device) with the
    sign of every element of slot 0 flipped."""
    out = a.clone() if _is_tensor(a) else np.array(a, copy=True)
    out[0] = -out[0]
    return out


def corrupt_pack(win):
    """A copy of a serving window with the sign bit of every leaf output
    of the FIRST tree slot flipped — the ``bitflip`` fault's payload.
    Slot 0 is always a real tree, so the corruption is deterministic and
    a canary replay is guaranteed to see it. Device tensors are corrupted
    on a copy on their own device; a tuple of replicas (a serving mesh)
    has each copy corrupted. Works on the binned and the raw window
    (``leaf_value`` at the top level, or under ``.tree``)."""
    if hasattr(win, "leaf_value"):
        return win._replace(leaf_value=_negated_slot0(win.leaf_value))
    inner = getattr(win, "tree", None)
    if inner is not None:
        return win._replace(tree=corrupt_pack(inner))
    return type(win)(corrupt_pack(w) for w in win)


def parity_equal(a, b) -> bool:
    """Bit-for-bit score comparison (NaN-safe, shape-strict) — the
    canary acceptance predicate."""
    a = np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and bool(
        np.array_equal(a, b, equal_nan=True))


class IntegrityProbe:
    """Always-on background canary prober (the steady-state sibling of
    the server's degraded-mode recovery probe, which only runs while
    degraded).

    Runs ``fn()`` every ``interval_s`` seconds until closed; ``fn`` owns
    detection, quarantine and repair. An escaped exception is logged and
    the cadence continues: a broken prober must not take serving down."""

    def __init__(self, fn: Callable[[], None], interval_s: float,
                 what: str = "serving"):
        self._fn = fn
        self._interval = float(interval_s)
        self._close_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._what = what
        if self._interval > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"lgbm-{what}-integrity-probe")
            self._thread.start()

    def _loop(self) -> None:
        while not self._close_evt.wait(self._interval):
            try:
                self._fn()
            except Exception as e:  # noqa: BLE001 — keep probing
                log.warning(f"{self._what} integrity probe error "
                            f"(probing continues): {e!r}")

    def close(self) -> None:
        self._close_evt.set()
        t = self._thread
        if t is not None:
            t.join(2.0)


class NumericHealthGuard:
    """Per-iteration numeric watchdog for the boosting loop.

    Three checks, all host-side floats (the caller reduces on the
    device and hands three scalars over in one copy an iteration, no
    [K, N] read):

    - :meth:`check_gradients`: NaN/Inf in the grad/hess sums poisons
      every histogram downstream; fail the iteration immediately.
    - :meth:`check_leaves`: NaN/Inf leaf outputs would be committed
      into the model text and served forever.
    - :meth:`observe_loss`: a rolling-window spike detector over the
      train/eval loss series — ``spike_factor`` × the rolling median
      (plus an absolute epsilon floor so near-zero converged losses
      don't false-positive) flags corruption that stays finite. The
      ``loss_spike`` fault site injects exactly this signature.

    All raises are :class:`NumericHealthError` → ``DATA_CORRUPTION``:
    not transient (the same window re-poisons), not fatal (the caller
    rolls back to the newest CRC-valid checkpoint and continues).
    """

    def __init__(self, window: int = 8, spike_factor: float = 100.0,
                 what: str = "training"):
        self.window = max(int(window), 2)
        self.spike_factor = float(spike_factor)
        self.what = what
        self._losses: List[float] = []

    def check_gradients(self, grad_sum: float, hess_sum: float,
                        iteration: int) -> None:
        if not (np.isfinite(grad_sum) and np.isfinite(hess_sum)):
            raise NumericHealthError(
                f"{self.what} iteration {iteration}: non-finite "
                f"gradient/hessian sums (grad_sum={grad_sum!r}, "
                f"hess_sum={hess_sum!r}) — the objective saw corrupt "
                "scores or labels; this iteration must not be "
                "committed")

    def check_leaves(self, leaf_values: np.ndarray,
                     iteration: int) -> None:
        if not np.isfinite(leaf_values).all():
            bad = int(np.count_nonzero(~np.isfinite(leaf_values)))
            raise NumericHealthError(
                f"{self.what} iteration {iteration}: {bad} non-finite "
                "leaf output(s) in the freshly grown tree — refusing "
                "to commit a model that scores NaN")

    def observe_loss(self, loss: float, iteration: int,
                     what: str = "loss") -> None:
        from . import faults
        if faults.check("loss_spike"):
            loss = (abs(loss) + 1.0) * self.spike_factor * 10.0
        if not np.isfinite(loss):
            raise NumericHealthError(
                f"{self.what} iteration {iteration}: non-finite {what} "
                f"({loss!r})")
        hist = self._losses
        if len(hist) >= self.window:
            med = float(np.median(hist[-self.window:]))
            if abs(loss) > self.spike_factor * max(abs(med), 1e-6):
                spiked = loss
                self._losses = []     # re-seed after the rollback
                raise NumericHealthError(
                    f"{self.what} iteration {iteration}: {what} spiked "
                    f"to {spiked!r} (> {self.spike_factor}× the rolling "
                    f"median {med!r} over the last {self.window} "
                    "observations) — numeric poisoning, roll back")
        hist.append(float(loss))
        if len(hist) > 4 * self.window:
            del hist[:-self.window]


class GangDivergence(IntegrityError):
    """Ranks disagree on the post-reduce tree digest: at least one rank
    reduced different bits. Relaunch from the manifest; do not commit."""


def iteration_digest(host_trees) -> int:
    """CRC32 of one iteration's trees: split features, thresholds, bins,
    children and leaf outputs, pure functions of the reduced histograms,
    so ranks whose reductions diverged differ here one iteration before
    the committed models fork (the JAX package's
    robustness/integrity.py:243-261)."""
    crc = 0
    for t in host_trees:
        n = int(t.num_leaves)
        for name in ("split_feature", "threshold", "threshold_bin",
                     "left_child", "right_child", "leaf_value"):
            a = getattr(t, name, None)
            if a is None:
                continue
            a = np.ascontiguousarray(np.asarray(a)[:max(n - 1, 0)]
                                     if name != "leaf_value"
                                     else np.asarray(a)[:n])
            crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def check_gang_digests(digests: Sequence[int], iteration: int,
                       rank: Optional[int] = None,
                       what: str = "gang") -> None:
    """Every rank must report the same digest; :class:`GangDivergence`
    (listing each rank's) otherwise."""
    vals = [int(d) & 0xFFFFFFFF for d in digests]
    if len(set(vals)) <= 1:
        return
    who = f" (this rank: {rank})" if rank is not None else ""
    listing = ", ".join(f"r{i}={v:08x}" for i, v in enumerate(vals))
    raise GangDivergence(
        f"{what} iteration {iteration}: post-reduce tree digests "
        f"diverged across ranks{who}: {listing} — at least one rank "
        "reduced different bits; refusing to commit a forked model "
        "(relaunch from the newest committed manifest)")


def digest_reduction(digest: int) -> np.ndarray:
    """One rank's digest encoded for an all-reduce SUM: the two 16-bit
    halves and their squares ``[hi, lo, hi^2, lo^2]`` f64, exact in any
    real world's sum."""
    d = int(digest) & 0xFFFFFFFF
    hi, lo = float(d >> 16), float(d & 0xFFFF)
    return np.asarray([hi, lo, hi * hi, lo * lo], np.float64)


def check_digest_reduction(total: np.ndarray, world: int, digest: int,
                           iteration: int, rank: Optional[int] = None,
                           what: str = "gang") -> None:
    """Agreement from the summed :func:`digest_reduction`: per half,
    ``world * sum(d^2) == sum(d)^2`` holds iff every rank sent the same
    value (Cauchy-Schwarz equality); :class:`GangDivergence` otherwise,
    the same verdict on every rank."""
    t = np.asarray(total, np.float64).reshape(-1)
    w = max(int(world), 1)
    if w * t[2] == t[0] * t[0] and w * t[3] == t[1] * t[1]:
        return
    who = (f" (this rank: {rank}, digest {int(digest):08x})"
           if rank is not None else "")
    raise GangDivergence(
        f"{what} iteration {iteration}: post-reduce tree digests "
        f"diverged across {w} ranks{who} — at least one rank reduced "
        "different bits; refusing to commit a forked model (relaunch "
        "from the newest committed manifest)")
