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
(``models/gbdt.py`` ``_gang_digest_check``). The serving canaries and
the host pack fingerprints of the JAX module wait for the serving tier
(ROADMAP A14).
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

import numpy as np

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
