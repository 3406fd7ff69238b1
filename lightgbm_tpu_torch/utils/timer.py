"""Named-section wall-clock timing table.

The port's copy of ``lightgbm_tpu/utils/timer.py``, the counterpart of
the reference's USE_TIMETAG tracing (ref:
include/LightGBM/utils/common.h:980 Common::Timer global_timer, :1044
FunctionTimer; the table printed by Timer::Print). Enabled with the
``LIGHTGBM_TPU_TIMETAG`` env var (read at import) or
``global_timer.enabled = True``; sections nest freely.

Device-async caveat: a CUDA launch returns before the card finishes, so
a section that should charge device time passes ``sync=`` the tensors
(or a callable returning them) it produced; on exit the section calls
``torch.cuda.synchronize`` on each distinct card those tensors live on,
and does nothing for CPU tensors. That is one device sync per section
per call, paid only while the timer is on: disabled, a section costs a
flag test and ``sync=`` is never evaluated.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

from . import log


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (a tensor, or a list,
    tuple or dict of them, nested)."""
    if isinstance(obj, (list, tuple)):
        for o in obj:
            _cuda_devices(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, out)
    else:
        dev = getattr(obj, "device", None)
        if getattr(dev, "type", None) == "cuda":
            out.add(dev)
    return out


def sync_devices(obj) -> None:
    """Wait for every card that a tensor in ``obj`` lives on."""
    devs = _cuda_devices(obj, set())
    if devs:
        import torch
        for dev in devs:
            torch.cuda.synchronize(dev)


class Timer:
    """Aggregating section timer (ref: Common::Timer, utils/common.h:980)."""

    def __init__(self):
        self.enabled = bool(os.environ.get("LIGHTGBM_TPU_TIMETAG"))
        self._total = defaultdict(float)
        self._count = defaultdict(int)
        self._start = {}

    def start(self, name: str) -> None:
        if self.enabled:
            self._start[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        if self.enabled and name in self._start:
            self._total[name] += time.perf_counter() - self._start.pop(name)
            self._count[name] += 1

    @contextmanager
    def section(self, name: str, sync=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                try:
                    sync_devices(sync() if callable(sync) else sync)
                except Exception:
                    pass  # never mask the body's exception from the sync hook
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()
        self._start.clear()

    def totals(self) -> dict:
        """``{section: (total seconds, count)}``."""
        return {k: (self._total[k], self._count[k]) for k in self._total}

    def table(self) -> str:
        """Render the aggregate table (ref: Timer::Print, common.h:1013)."""
        if not self._total:
            return "(no timing sections recorded)"
        width = max(len(k) for k in self._total)
        lines = [f"{'section'.ljust(width)}   total(s)      count    mean(ms)"]
        for name in sorted(self._total, key=self._total.get, reverse=True):
            t, c = self._total[name], self._count[name]
            lines.append(f"{name.ljust(width)} {t:10.3f} {c:10d} "
                         f"{1e3 * t / max(c, 1):11.3f}")
        return "\n".join(lines)

    def print(self) -> None:
        if self.enabled and self._total:
            log.info("time table:\n" + self.table())


global_timer = Timer()
