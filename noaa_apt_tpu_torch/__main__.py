"""``python -m noaa_apt_tpu_torch``: the port's command line."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
