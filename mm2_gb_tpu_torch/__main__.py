import sys

from mm2_gb_tpu_torch.cli import main

sys.exit(main())
