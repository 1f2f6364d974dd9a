"""Entry point: ``python -m crdt_tpu_torch.analysis`` (see `cli`)."""

import sys

from .cli import main

sys.exit(main())
