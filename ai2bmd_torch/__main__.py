import sys

from ai2bmd_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
