"""``python -m lightgbm_tpu_torch.serving input_model=model.txt [key=value ...]``

The main command line's ``key=value`` convention with the task forced to
``serve``.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..cli import main as cli_main
    argv = sys.argv[1:] if argv is None else argv
    return cli_main(["task=serve"] + list(argv))


if __name__ == "__main__":
    sys.exit(main())
