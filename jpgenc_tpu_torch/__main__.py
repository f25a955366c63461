"""`python -m jpgenc_tpu_torch ...`: the command line of jpgenc_tpu_torch.cli."""
from jpgenc_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
