"""``python -m lightgbm_tpu_torch config=train.conf [key=value ...]``."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
