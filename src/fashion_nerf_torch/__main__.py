"""`python -m fashion_nerf_torch` runs the command line (cli.main)."""

import sys

from fashion_nerf_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
