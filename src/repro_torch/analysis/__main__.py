"""Entry point: ``python -m repro_torch.analysis``. Importing this module
runs nothing (the package's import walks reach it)."""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
