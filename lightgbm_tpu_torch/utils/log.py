"""Leveled logger with pluggable callback.

Copy of ``lightgbm_tpu/utils/log.py`` for the PyTorch/CUDA port; the
reference logging layer
(ref: include/LightGBM/utils/log.h:45, c_api.h:82 LGBM_RegisterLogCallback,
python-package/lightgbm/basic.py:215 register_logger).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

# Levels match the reference: Fatal < Warning < Info < Debug
FATAL = -1
WARNING = 0
INFO = 1
DEBUG = 2

_level = INFO
_custom_logger: Optional[Callable[[str], None]] = None


class LightGBMError(Exception):
    """Error raised by the framework (ref: Log::Fatal throwing std::runtime_error)."""


def register_logger(func: Callable[[str], None]) -> None:
    """Redirect all log output through ``func`` (ref: basic.py:215)."""
    global _custom_logger
    if func is not None and not callable(func):
        raise TypeError("logger function must be callable")
    _custom_logger = func


def set_verbosity(verbosity: int) -> None:
    """Map the ``verbosity`` param onto a log level (ref: config 'verbosity')."""
    global _level
    _level = verbosity


def _emit(msg: str) -> None:
    if _custom_logger is not None:
        _custom_logger(msg)
    else:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str) -> None:
    if _level >= DEBUG:
        _emit(f"[LightGBM-TPU-Torch] [Debug] {msg}")


def info(msg: str) -> None:
    if _level >= INFO:
        _emit(f"[LightGBM-TPU-Torch] [Info] {msg}")


def warning(msg: str) -> None:
    if _level >= WARNING:
        _emit(f"[LightGBM-TPU-Torch] [Warning] {msg}")


# once-only resolution notices (the PR6 rule: silent backend/learner
# remaps made A/B numbers unattributable, so every remap announces
# itself — once per process, not per call). One shared set so growers
# don't each carry a drifting copy; tests reset via logged_once.clear().
logged_once: set = set()


def info_once(msg: str) -> None:
    """INFO-log a resolution decision exactly once per process."""
    if msg not in logged_once:
        logged_once.add(msg)
        info(msg)


def warning_once(msg: str) -> None:
    """WARNING-log ``msg`` once per process."""
    if msg not in logged_once:
        logged_once.add(msg)
        warning(msg)


def fatal(msg: str) -> None:
    raise LightGBMError(msg)
