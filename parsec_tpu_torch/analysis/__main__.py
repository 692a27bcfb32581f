"""``python -m parsec_tpu_torch.analysis [--strict]``: lint the port's
specs and lock-lint its source (see :mod:`.lint`)."""
import sys

from .lint import main

sys.exit(main())
