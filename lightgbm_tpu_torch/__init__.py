"""PyTorch/CUDA port of LightGBM-TPU.

The same ``Dataset`` / ``Booster`` / ``train`` surface, callbacks and
model text as ``lightgbm_tpu``, on PyTorch, with the TPU's Pallas kernels
rewritten by hand for NVIDIA Hopper (``csrc/``). It imports neither jax
nor ``lightgbm_tpu``. Entry points run on ``cuda`` unless the parameters
say ``device_type="cpu"``; on the CPU each kernel's plain PyTorch version
runs instead. A model loaded from a file or string predicts on the
device its ``params`` name, by the same rule.
"""
from . import callback
from .basic import Booster, Dataset
from .callback import (early_stopping, log_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import train

__all__ = ["Booster", "Config", "Dataset", "callback", "early_stopping",
           "log_evaluation", "record_evaluation", "reset_parameter",
           "train"]
