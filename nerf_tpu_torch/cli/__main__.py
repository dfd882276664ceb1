"""``python -m nerf_tpu_torch.cli ...``: the port's command line (``main.py``)."""

import sys

from nerf_tpu_torch.cli.main import main

sys.exit(main())
