"""`python -m lightgbm_tpu_torch` — the CLI entry point (ref:
src/main.cpp)."""
from .cli import main

main()
