"""`python -m nubomedia_vca_tpu_torch <filter> ...` — see cli.py."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
