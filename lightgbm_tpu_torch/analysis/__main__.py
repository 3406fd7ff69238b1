"""``python -m lightgbm_tpu_torch.analysis [paths ...] [--list]
[--update-baseline] [--no-baseline] [--baseline FILE]``: conlint over
the port's lock-bearing modules against
``lightgbm_tpu_torch/analysis/concurrency_baseline.json``.

Exit codes as ``scripts/jaxlint.py --pass concurrency``: 0 no new
finding and every baseline entry reasoned; 1 new findings, a syntax
error or a reasonless baseline entry; 2 a bad argument, a path that does
not exist, or paths that hold no ``.py`` file.
"""
import os
import sys

from . import concurrency

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

if __name__ == "__main__":
    sys.exit(concurrency.main(sys.argv[1:], root=REPO_ROOT))
