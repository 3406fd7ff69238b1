"""PyTorch/CUDA port of LightGBM-TPU.

The same ``Dataset`` / ``Booster`` / ``train`` / ``cv`` surface, the
scikit-learn estimators, callbacks and model text as ``lightgbm_tpu``, on
PyTorch, with the TPU's Pallas kernels rewritten by hand for NVIDIA
Hopper (``csrc/``). It imports neither jax nor ``lightgbm_tpu``. Entry
points run on ``cuda`` unless the parameters say ``device_type="cpu"``;
on the CPU each kernel's plain PyTorch version runs instead. A model
loaded from a file or string, or unpickled, predicts on the device its
``params`` name, by the same rule.
"""
from . import callback
from .basic import Booster, Dataset
from .callback import (early_stopping, log_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .io.sequence import Sequence
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "LGBMClassifier",
           "LGBMModel", "LGBMRanker", "LGBMRegressor", "callback", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "Sequence", "train"]
