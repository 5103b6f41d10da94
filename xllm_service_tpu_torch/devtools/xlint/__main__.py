"""CLI: ``python -m xllm_service_tpu_torch.devtools.xlint [paths...]``."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
