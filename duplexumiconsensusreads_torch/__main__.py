import sys

from duplexumiconsensusreads_torch.cli.main import main

sys.exit(main())
