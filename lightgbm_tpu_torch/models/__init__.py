"""Boosting engines: ``gbdt`` (with bagging or GOSS row sampling),
``dart`` and ``rf``."""
from __future__ import annotations

from ..config import Config
from ..utils import log


def create_boosting(config: Config, train_set, objective):
    """The engine ``config.boosting`` names (ref: boosting.cpp
    CreateBoosting; the JAX package's models/__init__.py)."""
    from .dart import DART
    from .gbdt import GBDT
    from .rf import RF
    name = str(config.boosting).lower()
    if name in ("gbdt", "gbrt", "gradient_boosting",
                "gradient_boosted_trees", "goss"):
        return GBDT(config, train_set, objective)
    if name == "dart":
        return DART(config, train_set, objective)
    if name in ("rf", "random_forest"):
        return RF(config, train_set, objective)
    log.fatal(f"Unknown boosting type {config.boosting}")
