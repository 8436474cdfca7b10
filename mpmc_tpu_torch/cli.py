"""The command line, ``python -m mpmc_tpu_torch <input-file> [--cpu]``
(``__main__.py`` calls ``main``; the ranks a multi-device deck spawns
import this module by name).

Runs on the CUDA device by default and fails when there is none; ``--cpu``
is the only way onto the CPU (parity and float64 runs).

Multi-device decks (``spatial_devices D`` or ``chain_devices D``,
run.ranks_wanted) run on D ranks of a ``torch.distributed`` group:

- by default this process starts them itself (start method ``spawn``),
  one per visible GPU (more than the GPUs is refused), or D CPU ranks
  under ``--cpu``;
- with ``--distributed`` this process is one rank of a job started
  elsewhere: ``--coordinator host:port --num-processes P --process-id r``
  (or torchrun's environment when given alone), and D must equal P.
  Rank r takes GPU ``LOCAL_RANK % device_count``.

The backend is NCCL when every rank has a GPU of its own and gloo on the
CPU; ``--dist-backend gloo`` asks for gloo on GPUs (several ranks sharing
one card).  Rank 0 writes the log and every output; the other ranks
write nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

# the output options a rank other than 0 drops
_OUTPUTS = ("pqr_restart", "pqr_output", "frozen_output", "traj_output",
            "energy_output", "dipole_output", "field_output",
            "histogram_output", "checkpoint_output", "tmmc_output",
            "surf_output")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mpmc_tpu_torch",
        description="Molecular Monte Carlo (MPMC rebuild), PyTorch/CUDA")
    ap.add_argument("input", help="input script (MPMC option-value grammar)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (parity/float64 runs)")
    ap.add_argument("--jsonl", default=None,
                    help="write per-corrtime observables as JSONL")
    ap.add_argument("--distributed", action="store_true",
                    help="this process is one rank of a multi-process job "
                    "(the reference's multi-node run)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's address host:port (--distributed)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None, help="the process group's backend "
                    "(default: nccl on GPUs, gloo on the CPU)")
    args = ap.parse_args(argv)

    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run as run_mod
    from mpmc_tpu_torch.parallel import multihost

    job = input_script.parse_file(args.input)
    D, what = run_mod.ranks_wanted(job)
    if args.distributed:
        device = multihost.initialize(args.coordinator, args.num_processes,
                                      args.process_id,
                                      backend=args.dist_backend,
                                      cpu=args.cpu)
        try:
            if D != multihost.world():
                raise ValueError(
                    f"--distributed over {multihost.world()} processes, but "
                    f"the deck asks for {D} devices ({what or 'neither '
                    'spatial_devices nor chain_devices'})")
            _run_rank(device, args)
        finally:
            multihost.teardown()
        return
    if D > 1:
        multihost.check_devices(D, what, args.cpu)
        multihost.spawn(_run_rank, D, args=(args,), cpu=args.cpu,
                        backend=args.dist_backend)
        return
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    _run(device, args, job)


def _run_rank(device, args):
    """One rank of a multi-device job: rank 0 runs the deck as the single
    process does; the others run it with every output dropped and the
    log discarded."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.parallel import multihost
    job = input_script.parse_file(args.input)
    if multihost.is_root():
        _run(device, args, job)
        return
    job = dataclasses.replace(job, parallel_restarts=False,
                              **{k: None for k in _OUTPUTS})
    with open(os.devnull, "w") as log:
        _run(device, argparse.Namespace(**{**vars(args), "jsonl": None}),
             job, log=log)


def _run(device, args, job, log=None):
    from mpmc_tpu_torch.mc import run as run_mod
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"mpmc_tpu_torch: job '{job.cfg.job_name}' "
          f"ensemble={job.cfg.ensemble} device={device} ({name})",
          file=log or sys.stdout)
    if job.unknown_options:
        print(f"WARNING: unknown options: {job.unknown_options}",
              file=log or sys.stderr)
    kw = {"log": log} if log is not None else {}
    if job.cfg.ensemble in ("nvt", "nve", "uvt"):
        kw["jsonl_path"] = args.jsonl
    run_mod.run(job, device=device, **kw)
