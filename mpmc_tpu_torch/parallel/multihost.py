"""Process groups and collectives of the multi-device port (ROADMAP A13),
and multi-host parallel tempering (port of mpmc_tpu/parallel/multihost.py).

The reference runs one controller over a ``jax.sharding.Mesh``; PyTorch's
idiom is one process per device.  So a mesh slot is a rank of a
``torch.distributed`` process group, and each rank works on an explicit
``torch.device``.

- **Two collectives only**: ``all_reduce`` and ``broadcast``, which the
  gloo backend carries for CUDA tensors too.  The same code then runs on
  NCCL, on gloo with CUDA tensors (several ranks sharing one card) and on
  gloo on the CPU.
- **The plane** (``plane``): a reference ``psum`` / ``pmin`` is one
  collective.  Each rank writes its partials into its own row of a zero
  [D, k] plane, one ``all_reduce(SUM)`` fills it (every element has one
  nonzero addend, so the transport's order cannot change a bit), and
  every rank reduces the rows itself in rank order (``psum``,
  ``pmin``): every rank holds the same bits.  A field whose rows are
  computed by one rank each ([N, 3], zeros elsewhere) meets the others in
  one ``all_reduce`` of the field itself (``sum_disjoint``), exact for the
  same reason.
- **The backend is chosen explicitly** (``pick_backend``): NCCL when every
  rank has a GPU of its own, gloo on the CPU or when asked
  (``--dist-backend gloo``: several ranks on one card).  Nothing falls
  back from one to the other.
- **Starting ranks**: ``spawn`` starts D processes with the ``spawn``
  start method (never ``fork``), each joining one group at a free local
  port; ``initialize`` joins an existing job (``--distributed``:
  ``--coordinator host:port --num-processes P --process-id r``, or
  torchrun's environment).  A rank that fails fails the caller with its
  traceback; a rank that waits in a collective longer than the group's
  timeout raises there.

``counts`` tallies the collectives this process made, their bytes and the
host seconds spent in them (each call returns when its data has arrived
on this rank: gloo stages CUDA tensors through the host and waits; NCCL
queues on the stream, so its seconds are the enqueue only); the spatial
MC loop logs them a step; ``reset_counts`` zeroes it.

Multi-host PT (``run_parallel_tempering``): every process runs the same
function with the same inputs; ``distribute`` keeps each rank's rows of
the replica stack, and history and logging happen on rank 0.
"""
from __future__ import annotations

import datetime
import os
import socket
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600          # a rank waiting longer in a collective raises
counts = {"collectives": 0, "bytes": 0, "seconds": 0.0}


def reset_counts():
    counts.update(collectives=0, bytes=0, seconds=0.0)


def pick_backend(device_type: str, requested: Optional[str] = None) -> str:
    """The group's backend: ``requested`` ("nccl" or "gloo") when given,
    else gloo on the CPU and NCCL on GPUs.  NCCL on the CPU raises."""
    if requested is not None:
        if requested not in ("nccl", "gloo"):
            raise ValueError(f"--dist-backend {requested}: nccl or gloo")
        if requested == "nccl" and device_type == "cpu":
            raise ValueError("--dist-backend nccl needs a GPU per rank "
                             "(the CPU runs gloo)")
        return requested
    return "gloo" if device_type == "cpu" else "nccl"


def rank_device(local_rank: int, cpu: bool) -> torch.device:
    """The device of a rank: the CPU under ``cpu``, else GPU ``local_rank
    % device_count`` (several ranks share a card when they outnumber
    the cards).  A rank that finds no GPU without ``cpu`` raises."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the ranks on "
                           "the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend=None, cpu=False,
               timeout=TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device (the
    reference's ``initialize``, mpmc_tpu/parallel/multihost.py:32).  With
    a ``coordinator`` "host:port" the world size and this process's rank
    are ``num_processes`` and ``process_id``; without one they come from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK).  Prints the backend on the log (stdout)."""
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init, world_size, rnk = (f"tcp://{coordinator}", int(num_processes),
                                 int(process_id))
        local = int(os.environ.get("LOCAL_RANK", rnk))
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if k not in os.environ]
        if missing:
            raise ValueError("--distributed without --coordinator needs "
                             "torchrun's environment (missing "
                             + ", ".join(missing) + ")")
        init, world_size, rnk = ("env://", int(os.environ["WORLD_SIZE"]),
                                 int(os.environ["RANK"]))
        local = int(os.environ.get("LOCAL_RANK", rnk))
    device = rank_device(local, cpu)
    be = pick_backend(device.type, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=be, init_method=init,
                            world_size=world_size, rank=rnk,
                            timeout=datetime.timedelta(seconds=timeout))
    if rnk == 0:
        print(f"process group: {world_size} ranks, backend {be}, rank 0 on "
              f"{device}", flush=True)
    return device


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_root() -> bool:
    return rank() == 0


def teardown():
    """Leave the process group (a no-op outside one)."""
    if active():
        dist.destroy_process_group()


def _all_reduce(t):
    t0 = time.perf_counter()
    dist.all_reduce(t)
    counts["collectives"] += 1
    counts["bytes"] += t.numel() * t.element_size()
    counts["seconds"] += time.perf_counter() - t0
    return t


def plane(row):
    """[D, *row.shape]: every rank's ``row`` at its rank's index, after
    one all_reduce (rank 0's row alone outside a group).  Bool rows
    travel as uint8 and come back bool."""
    is_bool = row.dtype == torch.bool
    r = row.to(torch.uint8) if is_bool else row
    out = torch.zeros((world(),) + tuple(r.shape), dtype=r.dtype,
                      device=r.device)
    out[rank()] = r
    if active() and world() > 1:
        _all_reduce(out)
    return out.bool() if is_bool else out


def psum_rows(p):
    """The rows of a plane added in rank order (the same bits on every
    rank)."""
    acc = p[0]
    for r in range(1, p.shape[0]):
        acc = acc + p[r]
    return acc


def pmin_rows(p):
    return torch.amin(p, dim=0)


def psum(row):
    """The reference's psum of ``row`` over the ranks: one plane."""
    return psum_rows(plane(row))


def sum_disjoint(t):
    """``t`` summed over the ranks in place, where each element is
    nonzero on at most one rank (a field whose rows the ranks split):
    one all_reduce, exact whatever the transport's order."""
    if active() and world() > 1:
        _all_reduce(t)
    return t


def broadcast(t, src=0):
    """``t`` as rank ``src`` holds it, on every rank (a new tensor; bool
    tensors travel as uint8)."""
    if not (active() and world() > 1):
        return t
    out = (t.to(torch.uint8) if t.dtype == torch.bool else t).clone()
    t0 = time.perf_counter()
    dist.broadcast(out, src)
    counts["collectives"] += 1
    counts["bytes"] += out.numel() * out.element_size()
    counts["seconds"] += time.perf_counter() - t0
    return out.bool() if t.dtype == torch.bool else out


def gather_rows(t, lo, hi, total):
    """The [total, ...] stack whose rows [lo, hi) are this rank's ``t``
    and whose other rows come from the other ranks (each rank holds a
    contiguous block): one all_reduce of a zero-padded stack."""
    is_bool = t.dtype == torch.bool
    src = t.to(torch.uint8) if is_bool else t
    out = torch.zeros((total,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    out[lo:hi] = src
    if active() and world() > 1:
        _all_reduce(out)
    return out.bool() if is_bool else out


def block(total: int, d: int = None, D: int = None):
    """(lo, hi): rank ``d``'s contiguous rows of ``total`` split over
    ``D`` ranks (the caller checks divisibility)."""
    d = rank() if d is None else d
    D = world() if D is None else D
    per = total // D
    return d * per, (d + 1) * per


def global_replica_mesh(n_replicas: Optional[int] = None):
    """(rank, world) of the replica axis — the reference's
    global_replica_mesh (mpmc_tpu/parallel/multihost.py:48) with its
    guard: more replicas than the job's ranks can hold one each is
    allowed only as whole blocks (``distribute``), never more ranks
    than replicas."""
    D = world()
    if n_replicas is not None and n_replicas < D:
        raise ValueError(f"{n_replicas} replicas < {D} ranks: every rank "
                         "needs at least one")
    if n_replicas is not None and n_replicas % D:
        raise ValueError(f"{n_replicas} replicas not divisible by {D} "
                         "ranks")
    return rank(), D


def distribute(stack, R: int):
    """This rank's rows of a FULL replica stack (leading [R] on every
    tensor field, identical on every rank — build it deterministically):
    rows [d R/D, (d + 1) R/D).  Passing the full stack on as if it were
    the rank's share would double the replica axis (each rank would then
    run the wrong rungs: the trap of mpmc_tpu/parallel/multihost.py:61-95,
    which tests/test_torch_multihost.py pins)."""
    import dataclasses
    rnk, D = global_replica_mesh(R)
    lo, hi = block(R, rnk, D)
    kw = {}
    for f in dataclasses.fields(stack):
        v = getattr(stack, f.name)
        if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == R:
            kw[f.name] = v[lo:hi]
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            kw[f.name] = distribute(v, R) if _stacked(v, R) else v
    return dataclasses.replace(stack, **kw)


def _stacked(obj, R):
    import dataclasses
    return any(isinstance(getattr(obj, f.name), torch.Tensor)
               and getattr(obj, f.name).ndim
               and getattr(obj, f.name).shape[0] == R
               for f in dataclasses.fields(obj))


def run_parallel_tempering(*args, **kw):
    """Multi-host PT drive (mpmc_tpu/parallel/multihost.py:98): every
    process calls it with the same inputs; replica.run_parallel_tempering
    (each rank its block of the ladder, rank 0 logging to ``log=``)."""
    from mpmc_tpu_torch.parallel import replica
    return replica.run_parallel_tempering(*args, **kw)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on the loopback interface."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(i, fn, nprocs, port, cpu, backend, timeout, args):
    if cpu:         # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    device = initialize(f"127.0.0.1:{port}", nprocs, i, backend=backend,
                        cpu=cpu, timeout=timeout)
    try:
        fn(device, *args)
    finally:
        sys.stdout.flush()
        teardown()


def spawn(fn, nprocs: int, args=(), cpu=False, backend=None,
          timeout=TIMEOUT_S):
    """Run ``fn(device, *args)`` on ``nprocs`` new ranks (start method
    ``spawn``), each in one group on a free local port; returns when all
    have ended and raises with a failed rank's traceback.  ``fn`` must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    if not cpu:
        # the parent builds the kernels before the ranks start: one build
        from mpmc_tpu_torch.ops.cuda import _build
        _build.build()
    mp.start_processes(_rank_main, args=(fn, nprocs, free_port(), cpu,
                                         backend, timeout, tuple(args)),
                       nprocs=nprocs, join=True, start_method="spawn")


def check_devices(D: int, what: str, cpu: bool):
    """The reference's refusal of more devices than the job has
    (mpmc_tpu/mc/run.py:544-547, :1536-1539): D GPUs for D spawned ranks
    (the CPU takes any D)."""
    if cpu:
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if D > have:
        # the reference's words: "visible" in chain_mesh, "available" in
        # the spatial branches
        word = "visible" if what == "chain_devices" else "available"
        raise ValueError(f"{what} {D} but only {have} devices {word}")


def digest(*tensors):
    """An int64 fingerprint of the bits of ``tensors`` (positions,
    aliveness, energies): equal on two ranks iff (up to a hash collision)
    their tensors are bit-identical."""
    acc = []
    for t in tensors:
        t = t.contiguous().reshape(-1)
        if t.dtype == torch.bool:
            bits = t.to(torch.int64)
        elif t.element_size() == 8:
            bits = t.view(torch.int64)
        elif t.element_size() == 4:
            bits = t.view(torch.int32).to(torch.int64)
        else:
            bits = t.to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, dtype=torch.int64,
                         device=bits.device) * 2654435761
        acc.append(torch.sum(bits * w))
    return torch.stack(acc)


def check_lockstep(what, *tensors):
    """Raise unless every rank holds the same bits of ``tensors`` (one
    plane of their digests): a rank that computed something alone that
    another computed differently breaks the replicated state silently,
    so the run stops here."""
    if not (active() and world() > 1):
        return
    p = plane(digest(*tensors)).cpu().numpy()
    if not (p == p[0]).all():
        raise RuntimeError(f"{what}: the ranks' replicated state differs "
                           f"(digests {p.tolist()}): lockstep lost")
