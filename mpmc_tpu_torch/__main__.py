"""CLI entry point: ``python -m mpmc_tpu_torch <input-file> [--cpu]``
(mpmc_tpu_torch/cli.py)."""
from mpmc_tpu_torch.cli import main

if __name__ == "__main__":
    main()
