"""PyTorch/CUDA port of LightGBM-TPU.

The same ``Dataset`` / ``Booster`` / ``train`` / ``cv`` surface, the
scikit-learn estimators, callbacks and model text as ``lightgbm_tpu``, on
PyTorch, with the TPU's Pallas kernels rewritten by hand for NVIDIA
Hopper (``csrc/``). It imports neither jax nor ``lightgbm_tpu``. Entry
points run on ``cuda`` unless the parameters say ``device_type="cpu"``;
on the CPU each kernel's plain PyTorch version runs instead. A model
loaded from a file or string, or unpickled, predicts on the device its
``params`` name, by the same rule.

``Booster.serve()`` starts a model server (``serving/``, loaded on first
use; ``lightgbm_tpu_torch.ModelServer``), ``serve_fleet({name: booster})``
a multi-tenant ``FleetServer`` (``Booster.serve(fleet=, tenant=)`` adds a
tenant to one), and
``predict(pred_contrib=True, device=True)`` explains on the device
(``ops/shap_pack.py``). ``serve_continual(params, stream_path, ckpt_dir)``
boots the continual service (``service/``, loaded on first use): a
resident trainer on a growing CSV, a publish pump into a live server and
an HTTP front door (``FrontDoor`` / ``ServerGateway`` mount any server or
fleet behind one).

``python -m lightgbm_tpu_torch config=train.conf`` is the command-line
application (``cli.py``); ``native/`` builds the C++ parser, TreeSHAP and
the C ABIs with ``g++`` at first use (``native.get_lib()``).
``LIGHTGBM_TPU_PLATFORM=cpu`` at import makes the CPU the default device.

``LGBM_TPU_FAULTS`` installs its fault plan at import, as in the JAX
package (``robustness/faults.py``); ``LGBM_TPU_HEARTBEAT`` is read when a
Booster sets up training (``robustness/heartbeat.py``).

``LGBM_TPU_GUARDS=lockorder`` (alias ``LIGHTGBM_TPU_GUARDS``) installs the
runtime lock-order tracker over the threaded modules
(``analysis/lockorder.py``) before any of them creates a lock; the JAX
package's other guard tokens have no counterpart and are logged.
``python -m lightgbm_tpu_torch.analysis`` runs conlint over those
modules. ``LIGHTGBM_TPU_TIMETAG`` turns on the section timer
(``utils/timer.py``), and the ``tpu_profile_dir`` parameter records a
``torch.profiler`` trace of ``train``'s boosting loop.
"""
# opt-in guards, read before any submodule below creates its locks, so
# that module-level locks (native._lock) are tracked too
from .analysis import install_guards_from_env as _install_guards

_install_guards()

from . import callback, robustness  # noqa: E402
from .basic import Booster, Dataset
from .callback import (EarlyStopException, checkpoint_callback,
                       early_stopping, log_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .io.sequence import Sequence
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError, register_logger

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "LGBMClassifier", "LGBMModel", "LGBMRanker", "LGBMRegressor",
           "LightGBMError", "callback", "checkpoint_callback", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "register_logger", "reset_parameter", "robustness", "Sequence",
           "train"]

# opt-in fault injection for any importing process (children that
# inherit the variable included)
robustness.faults.install_from_env()


def __getattr__(name):
    # the serving tier loads on first use (ref: the JAX package's
    # __init__.py:77-80)
    if name in ("FleetServer", "ModelServer", "TenantHandle",
                "serve_fleet"):
        from . import serving
        return getattr(serving, name)
    # the continual service (ref: the JAX package's __init__.py:81-82)
    if name in ("ContinualService", "FrontDoor", "ServerGateway",
                "serve_continual"):
        from . import service
        return getattr(service, name)
    # plotting (ref: the JAX package's __init__.py:85-87); matplotlib and
    # graphviz are imported when a chart is drawn
    if name in ("plot_importance", "plot_metric", "plot_tree",
                "create_tree_digraph", "plot_split_value_histogram"):
        from . import plotting
        return getattr(plotting, name)
    raise AttributeError(
        f"module 'lightgbm_tpu_torch' has no attribute {name!r}")
