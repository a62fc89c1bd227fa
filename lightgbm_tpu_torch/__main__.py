"""``python -m lightgbm_tpu_torch``: the command-line application
(src/main.cpp of the reference)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
