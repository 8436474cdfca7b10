"""CLI entry point: ``python -m mpmc_tpu_torch <input-file> [--cpu]``.

Runs on the CUDA device by default and fails when there is none; ``--cpu``
is the only way onto the CPU (parity and float64 runs).
"""
from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mpmc_tpu_torch",
        description="Molecular Monte Carlo (MPMC rebuild), PyTorch/CUDA")
    ap.add_argument("input", help="input script (MPMC option-value grammar)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (parity/float64 runs)")
    ap.add_argument("--jsonl", default=None,
                    help="write per-corrtime observables as JSONL")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())

    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run as run_mod

    job = input_script.parse_file(args.input)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"mpmc_tpu_torch: job '{job.cfg.job_name}' "
          f"ensemble={job.cfg.ensemble} device={device} ({name})")
    if job.unknown_options:
        print(f"WARNING: unknown options: {job.unknown_options}",
              file=sys.stderr)
    run_mod.run(job, device=device,
                **({"jsonl_path": args.jsonl}
                   if job.cfg.ensemble in ("nvt", "nve", "uvt") else {}))


if __name__ == "__main__":
    main()
