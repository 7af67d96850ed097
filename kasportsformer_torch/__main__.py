import sys

from kasportsformer_torch.cli import main

sys.exit(main())
