"""python -m machineboss_tpu_torch: the boss-compatible command line."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
