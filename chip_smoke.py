"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises, so the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build  — the CUDA kernels from mpmc_tpu_torch/csrc (one nvcc per
   source, all at once), with build seconds;
3. kernels — B2 (pair_terms, one launch over its tile work list) at
   row_start 0 and F and B4 (mol_pair) against their plain PyTorch
   versions on the 10.8k-atom bench system (MOF lattice n_side=21 + 512
   H2 slots), float32 and float64, with CUDA-event timings per call and
   on the card alone (time_device), and the launch floor (an empty kernel
   timed the same way);
4. B1 — the fused µVT kernel (run_steps_uvt, one thread-block cluster of
   G CTAs per chain) against its plain version on the same system, at
   every cluster size G whose slice fits: one numpy-seeded [C=2, K=256,
   16] uniform table in float64 and float32 (the same decisions,
   positions and sums within the stated tolerances), each chain of the
   C = 2 launch against a C = 1 launch on its own block at the same G,
   and CUDA-event timings of 1000-step launches at C = 1 and C = 32, at
   each G and at the G the wrapper picks;
4b. B3 — the fused NVT kernel (run_steps) against its plain version on
   the 10.0k MOF + H2 NVT system and the 10k LJ fluid, each after 2,000
   steps off its lattice: a numpy-seeded [2, 256, 16] table in float64 and
   float32 at every G (B1's checks and tolerances), NVE on the LJ fluid,
   and CUDA-event timings of 1000-step launches (MOF at C = 1 and 16, LJ
   at C = 1) beside the bound;
5. energy — total_energy on the card (float32, kernels) against the port
   on the CPU (float64, plain), term by term;
6. scan path — the 10.8k system written to PQR and run as a GCMC deck
   through mpmc_tpu_torch.mc.run.run (3000 steps): B2 and B4 must have
   been launched by it, and the carried energy of a further chunk must
   match a fresh recompute; a profiled chunk shows where a step's time
   goes; then examples/h2_sorption.inp (5000 steps);
7. fused path — the same deck with ``fused_mc on`` (20,000 steps): B1 and
   B2 must have been launched, the carried energy of a further chunk
   must match a fresh recompute, the kernel alone is timed and a chunk
   profiled; then ``chains 32`` (the reference's headline width), with
   the bookkeeping of chain 0 and of the last chain and a profiled chunk;
8. fused NVT — the MOF + H2 deck under ``ensemble nvt`` with ``fused_mc
   on`` (20,000 steps, one chain and ``chains 16``), the LJ fluid deck
   under nvt (20,000 steps) and nve (5,000 steps, total_energy from an
   ``ensemble te`` run): B3 launched once per corrtime, bookkeeping after
   a further chunk, the NVE reservoir positive; profiled MOF chunks at
   C = 1 and 16 with B3's share of the device time;
9. polar — the 10.8k system with polarizable framework sites through
   run.run (phase_polar): plain Metropolis, the scan-path delayed
   acceptance and the rc 14 A tile-culled CG, 300 steps each, B5 in
   every CG iteration, with bookkeeping of the polar term, B5 launches
   against CG iterations, host syncs and a profile per step;
9b. fused polar DA — the same system with ``polar_delayed on`` and
   ``fused_mc on`` (phase_pda_decks): the direct field, ``polar_wolf on``
   and ``cutoff 14``, 300 steps each through run.run — B6 per segment,
   the exact SCF per survivor — with the same checks, B6 launches per
   step and B6's share of a profiled chunk.

Phase 4c (phase_thole_kernel) holds B5, both modes, against its plain
version on that polar system, dense and culled (culled == dense bit for
bit; each check's share of its tolerance logged), phase 4d
(phase_pda_kernel) holds B6, one thread-block cluster of G CTAs,
against its plain version there at every G whose slice fits and at the
wrapper's own (direct, wolf, ewald fields and nvt; float64 and float32),
and phase 5 adds its polar term.

The second-to-last line is a JSON object with each kernel's launches on
its main path, error against its plain version, times (``ms`` per call
around its wrapper, ``device_ms`` on the card alone: back-to-back launches
between one pair of events) and bound; the last
line is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"pair_terms": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "mol_pair": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "run_steps_uvt": "mpmc_tpu_torch/csrc/uvt_kernel.cu",
           "run_steps": "mpmc_tpu_torch/csrc/nvt_kernel.cu",
           "dipole_field": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           "charge_field": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           "run_steps_uvt_pda": "mpmc_tpu_torch/csrc/pda_kernel.cu"}
REPLACES = {"pair_terms": "mpmc_tpu/ops/pallas/pair_kernel.py:79",
            "mol_pair": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "run_steps_uvt": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps": "mpmc_tpu/ops/pallas/mc_kernel.py:220",
            "dipole_field": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "charge_field": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "run_steps_uvt_pda": "mpmc_tpu/ops/pallas/mc_kernel.py:2089"}
# NVIDIA H100 SXM peaks (data sheet, at the 700 W limit): f32 outside the
# tensor cores, and device memory
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# floating-point operations per evaluated pair (a square root, division,
# erfc/erf or rounding counted as one), as the sources' notes count them:
# B2/B4 general-box minimum image 36, r^2 and guard 6, LJ 13, LJ tail 11,
# Coulomb and exclusion 9, sums 4.  B1 and B3 (csrc/mc_common.cuh
# pair_values and column_pass), for every pair: displacement 3,
# orthorhombic minimum image 12, r^2 5, cutoff test 1, sums 3; for a pair
# within rc only: the r^2 guard 1, LJ 13 (rd lj), the real-space Ewald
# term 6 (coulomb on); per k-vector phase 13, per reciprocal term 9
OPS_PAIR_B2B4 = 79
OPS_PAIR_FUSED, OPS_GUARD, OPS_LJ, OPS_COULOMB = 24, 1, 13, 6
OPS_PHASE_FUSED, OPS_K_FUSED = 13, 9
# B5 (csrc/thole_kernel.cu), for every pair it evaluates: displacement 3,
# orthorhombic minimum image 12, r^2 5, cutoff test 1; for a pair inside
# rc: guard 1, reciprocal square root 1, exponential damping 15, and the
# dipole-mode field 24 (1/r^3 2, mu.dr 5, coefficients 5, three components
# 12) or the charge-mode field 9 (coefficient 3, three components 6)
OPS_B5_PAIR = 21
OPS_B5_IN = {"dipole": 1 + 1 + 15 + 24, "charge": 1 + 1 + 15 + 9}
# B6 (csrc/pda_kernel.cu), beyond B1's per-pair and per-phase counts: for
# a pair inside rc the field coefficient — guard 1, square root 1, the
# exponential d1 8, then direct d1/r^3 2 or the screened kernel 17 (erfc,
# exp, the shift and the near field) — and the source's share of dE_j 7
# (q c 1, three multiply-adds); the field at the trial row 7 per new pair
# inside rc (and at the old row under polar_ewald); per surrogate column
# alpha_j (2 E0.dE + |dE|^2) 14
OPS_B6_FIELD = {"direct": 1 + 1 + 8 + 2 + 7, "screened": 1 + 1 + 8 + 17 + 7}
OPS_B6_ROW, OPS_B6_COL = 7, 14
EPS32 = float(np.finfo(np.float32).eps)
# the explicit cutoff of the culled polar cell (the reference's rc14 row)
RC_CULL = 14.0
# the polar decks: steps each, and a corrtime short enough that a deck
# makes several per-corrtime refreshes (a full SCF solve each)
POLAR_STEPS, POLAR_CORRTIME = 300, 100
# the bench system: mof_h2_gcmc(n_side=21, spacing=4.0, n_h2=256,
# capacity=512) -> 9,261 framework atoms + 512 x 3 H2 sites
N_SIDE, N_H2, CAPACITY = 21, 256, 512
# the 10k LJ fluid of the reference's NVT benchmark: argon, 0.0212 A^-3,
# box 77.8 A, 120 K; the NVE reservoir per atom of the reference's test
N_LJ = 10000
NVE_K_PER_ATOM = 180.0
# a reservoir whose effective temperature (2/3 of it per atom: 400 K) is
# far from the fluid's 120 K, where NVE and NVT decisions must differ
NVE_K_FAR = 600.0
SLOTS = ("rd", "es_real", "es_excl", "lrc", "rd_ff", "es_real_ff",
         "es_excl_ff", "lrc_ff", "min_r2")
MOL_SLOTS = ("rd", "es_real", "lrc", "min_r2")


def log(*a):
    print(*a, flush=True)


def time_calls(fn, device, n=20):
    """Median ms of ``n`` CUDA-event-timed calls (after one warm-up), or
    of host-clock calls on the CPU."""
    fn()
    ts = []
    for _ in range(n):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def time_device(fn, device, n=100):
    """ms per call of ``n`` back-to-back calls between one pair of CUDA
    events, queued behind a spin kernel (torch.cuda._sleep) long enough
    that the host has queued every call before the card starts them: the
    card's own time per call, with no host gap between launches.  Retries
    with a longer spin if the card caught up with the host."""
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    spin = max(0.02, 3.0 * n * (time.perf_counter() - t0))
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * 2e9))      # cycles at up to 2 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        ahead = not a.query()      # the spin still ran when all were queued
        torch.cuda.synchronize(device)
        if ahead:
            return a.elapsed_time(b) / n
        spin *= 4.0
    raise AssertionError("time_device: the host did not queue ahead of the "
                         "card")


def null_launch_ms(device, n=200):
    """The launch floor: time_device of an empty kernel (a spin of 0
    cycles)."""
    return time_device(lambda: torch.cuda._sleep(0), device, n)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this smoke run needs a CUDA device")
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    return dev, smi


def phase_build():
    from mpmc_tpu_torch.ops.cuda import _build
    t0 = time.time()
    paths = _build.build(force=True)
    secs = time.time() - t0
    for name in paths:
        _build.library(name)
    log(f"build: {secs:.1f} s (one nvcc per source, in parallel) -> "
        + ", ".join(os.path.relpath(p, REPO) for p in paths.values()))
    for path in paths.values():
        for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                log("  ptxas: " + line.strip())
    return secs


def _bound_ms(ops, nbytes):
    """(bound ms, bound_by): the larger of ops at the f32 peak and bytes
    at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _fused_ops(trace, cfg, nk):
    """Floating-point operations of chain 0's steps in a plain B1 or B3
    trace: what this run's data needs (pairs beyond rc stop after the
    cutoff test; no LJ or Coulomb operations where the term is off)."""
    in_rc = (OPS_GUARD + OPS_LJ * (cfg.rd_potential == "lj")
             + OPS_COULOMB * (cfg.coulomb != "none"))
    return sum(int(t["pairs"][0]) * OPS_PAIR_FUSED
               + int(t["pairs_in"][0]) * in_rc
               + int(t["phases"][0]) * OPS_PHASE_FUSED
               + (int(t["phases"][0]) > 0) * nk * OPS_K_FUSED for t in trace)


def bench_system(dtype, device, n_side=N_SIDE, n_h2=N_H2,
                 capacity=CAPACITY, polarization=False):
    from mpmc_tpu_torch.models import systems
    return systems.mof_h2_gcmc(n_side=n_side, n_h2=n_h2, capacity=capacity,
                               polarization=polarization, dtype=dtype,
                               device=device)


def _tol(dtype, ref, p32=None):
    """Allowed |kernel - plain|.  float64: rel 1e-12 or abs 1e-6 K (the
    sums cancel across ~1e7 terms of either sign, so an absolute floor
    at float64 rounding of the summed magnitudes is needed).  float32:
    rel 2e-5, or 4x the distance of the plain float32 result from the
    float64 one (float32 rounding of a cancelling sum), or abs 1e-3."""
    if dtype == torch.float64:
        return np.maximum(1e-12 * np.abs(ref), 1e-6)
    return np.maximum.reduce([2e-5 * np.abs(ref), 4.0 * np.abs(p32 - ref),
                              np.full_like(ref, 1e-3)])


def phase_kernels(device, n_side=N_SIDE, n_h2=N_H2, capacity=CAPACITY):
    """Each kernel against its plain version on the same card tensors."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    report = {"pair_terms": {"max_abs_err": 0.0},
              "mol_pair": {"max_abs_err": 0.0}}
    ref64 = {}
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = bench_system(dtype, device, n_side,
                                                  n_h2, capacity)
        F = metropolis.frozen_refresh_rows(params, cfg)
        alive = state.atom_alive(params)
        frozen = params.mol_frozen[params.mol_id]
        scal = pairs.pair_scalars(state.box, cfg)
        args = (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, alive, frozen, scal, cfg)
        for rs in (0, F):
            k = pk.pair_terms(*args, row_start=rs)
            p = pk.pair_terms_plain(*args, row_start=rs)
            k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
            key = ("pair_terms", rs)
            if dtype == "float64":
                ref64[key] = p
                tol = _tol(torch.float64, p)
            else:
                tol = _tol(torch.float32, ref64[key], p)
                p = ref64[key]
            err = np.abs(k - p)
            fin = np.isfinite(p)
            ms = time_calls(lambda: pk.pair_terms(*args, row_start=rs),
                            device)
            dms = time_device(lambda: pk.pair_terms(*args, row_start=rs),
                              device, n=50)
            pms = time_calls(lambda: pk.pair_terms_plain(
                *args, row_start=rs), device, n=5)
            log(f"B2 pair_terms {dtype} row_start={rs}: kernel {ms:.3f} ms "
                f"per call, {dms:.4f} ms on the card alone; plain {pms:.3f} "
                "ms")
            for s, name in enumerate(SLOTS):
                log(f"    {name:11s} kernel {k[s]: .10e} ref {p[s]: .10e} "
                    f"|d| {err[s]:.3e} tol {tol[s]:.3e}")
            if not (np.all(err[fin] <= tol[fin])
                    and np.array_equal(np.isfinite(k), fin)):
                raise AssertionError(f"B2 {dtype} row_start={rs} disagrees "
                                     "with its plain version")
            report["pair_terms"]["max_abs_err"] = max(
                report["pair_terms"]["max_abs_err"], float(err[fin].max()))
            if dtype == "float32":
                # pairs this (row-restricted) pass counts: every alive row
                # >= rs against the alive columns above it and below rs
                idx = np.flatnonzero(alive.cpu().numpy())
                n_f = int(np.sum(idx < rs))
                pos_in = np.arange(len(idx))
                n_pairs = int(np.sum((len(idx) - pos_in - 1 + n_f)
                                     [idx >= rs]))
                bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4,
                                      _nbytes(*args[:8]) + 9 * 4)
                entry = dict(ms=ms, device_ms=dms, plain_ms=pms,
                             bound_ms=bound, bound_by=by, pairs=n_pairs,
                             tiles=pk.work_list(len(alive), rs,
                                                device).numel())
                if rs == F:
                    report["pair_terms"].update(entry)
                else:
                    report["pair_terms"]["full"] = entry
                log(f"    bound {bound:.5f} ms ({by}; {n_pairs} pairs, "
                    f"{entry['tiles']} tiles listed)")
        # B4: an alive H2 (current rows) and a trial next to the framework
        h2 = int(np.flatnonzero(
            (params.mol_species >= 0).cpu().numpy()
            & state.mol_alive.cpu().numpy())[0])
        # off the lattice's symmetry planes: no pair sits exactly at rc,
        # where the kernel's fused multiply-adds and the plain version's
        # separate roundings may count a tie differently
        near = state.pos[0] + torch.tensor([2.0, 0.31, 0.17],
                                           dtype=cfg.tdtype, device=device)
        trial = near + params.species_pos[0]
        for label, mol, rows in (("H2", h2, None),
                                 ("framework-adjacent", h2, trial)):
            m = torch.tensor(mol, device=device)
            margs = (state.pos, params.charge, params.eps, params.sig,
                     params.mol_id32, alive, params.mol_atoms,
                     params.mol_natoms, m, rows, scal, cfg)
            k = pk.mol_pair(*margs).double().cpu().numpy()
            p = pk.mol_pair_plain(*margs).double().cpu().numpy()
            key = ("mol_pair", label)
            if dtype == "float64":
                ref64[key] = p
                tol = _tol(torch.float64, p)
            else:
                tol = _tol(torch.float32, ref64[key], p)
                p = ref64[key]
            err = np.abs(k - p)
            ms = time_calls(lambda: pk.mol_pair(*margs), device)
            dms = time_device(lambda: pk.mol_pair(*margs), device, n=200)
            pms = time_calls(lambda: pk.mol_pair_plain(*margs), device)
            log(f"B4 mol_pair {dtype} {label}: kernel {ms:.4f} ms per call, "
                f"{dms:.4f} ms on the card alone; plain {pms:.4f} ms")
            for s, name in enumerate(MOL_SLOTS):
                log(f"    {name:11s} kernel {k[s]: .10e} ref {p[s]: .10e} "
                    f"|d| {err[s]:.3e} tol {tol[s]:.3e}")
            if not np.all(err <= tol):
                raise AssertionError(f"B4 {dtype} {label} disagrees with "
                                     "its plain version")
            report["mol_pair"]["max_abs_err"] = max(
                report["mol_pair"]["max_abs_err"], float(err.max()))
            if dtype == "float32" and label == "H2":
                own = (params.mol_id == h2).cpu().numpy()
                n_pairs = int(params.mol_natoms[h2]) * int(np.sum(
                    alive.cpu().numpy() & ~own))
                bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4,
                                      _nbytes(*margs[:11]) + 4 * 4)
                null = null_launch_ms(device)
                report["mol_pair"].update(ms=ms, device_ms=dms, plain_ms=pms,
                                          bound_ms=bound, bound_by=by,
                                          null_device_ms=null)
                log(f"    bound {bound:.5f} ms ({by}; {n_pairs} pairs); the "
                    f"launch floor (an empty kernel, back to back) {null:.4f}"
                    " ms")
    return report


def _first_divergence(counts_of, trace, K):
    """(step, chain, |ln u - ln acc| there) of the first step whose
    decision differs between the kernel and the plain trace, by bisection
    over launches on the leading steps of the table; ``counts_of(k)`` is
    the kernel's [C] accepted-move counts over the first k steps."""
    cum = torch.cumsum(torch.stack([t["accept"] for t in trace]).long(), 0)

    def agrees(k):
        return torch.equal(counts_of(k), cum[k - 1].cpu())

    lo, hi = 0, K              # agrees on lo steps, disagrees on hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if agrees(mid):
            lo = mid
        else:
            hi = mid
    step = hi - 1
    chain = int(torch.nonzero(counts_of(hi) != cum[step].cpu())[0])
    return step, chain, float(abs(trace[step]["margin"][chain]))


def _time_steps(launch, device, K, n=5):
    """Kernel ms per step of a K-step launch (CUDA events around each
    launch, median of n; a launch of K = 1000 steps lasts milliseconds, so
    the wrapper's host time is a small part of it)."""
    return time_calls(launch, device, n=n) / K


def _resident(entry, sfx):
    """{shape: {G: clusters resident at once}} of one B1/B3 entry, from
    the wrapper's occupancy queries."""
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    out = {}
    for key, n in sorted(mk.occupancy.items()):
        if key[:2] == (entry, sfx):
            out.setdefault(str(key[2:-1]), {})[key[-1]] = n
    return out


def phase_uvt_kernel(device, C=2, K=256, seed=2024, k_time=1000):
    """B1 against its plain version on one numpy-seeded [C, K, 16] table,
    at every cluster size G whose slice fits (16, 8, 4 and 2 in float32;
    16, 8 and 4 in float64).

    float64: identical move counts and aliveness, positions within 1e-9 A,
    sums within rel 1e-10 (abs 1e-8 K where a sum cancels to ~0).
    float32: the same decisions, positions within 1e-4 A, and each energy
    sum within 2e-5 of its size plus 2e-3 K x sqrt(accepted moves + 1):
    the phases k.r reach ~44 rad, whose float32 spacing (3.8e-6 rad) moves
    each accepted move's reciprocal delta by up to ~1e-3 K, and the kernel
    contracts multiply-adds into FMAs where the plain version rounds
    twice.  At each G, every chain of the C = 2 launch must equal, bit for
    bit, a C = 1 launch on its own block at the same G.  Times (float32,
    CUDA events, launches of ``k_time`` steps, per step): one chain and 32
    chains, at each G and at the G the wrapper picks, beside the plain
    version's time and the bound.  Returns the kernel's report entry."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    u_np = np.random.default_rng(seed).random((C, K, 16))
    rep = {"max_abs_err": 0.0, "checked_G": {}}
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = bench_system(dtype, device)
        state = metropolis.initialize(state, params, cfg, thermo)
        tables = metropolis.uvt_fused_tables(params, cfg)
        u = torch.as_tensor(u_np, dtype=cfg.tdtype, device=device)
        args, kw = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, C), params, cfg, thermo, u,
            tables)
        trace = []
        p = mk.run_steps_uvt_plain(*args, **kw, trace=trace)
        ps = p[2].cpu().numpy()
        f64 = dtype == "float64"
        n_acc = ps[:, 6:9].sum(1, keepdims=True)
        tol = (np.maximum(1e-10 * np.abs(ps[:, :6]), 1e-8) if f64 else
               2e-5 * np.abs(ps[:, :6]) + 2e-3 * np.sqrt(n_acc + 1.0))
        sk_tol = 1e-9 if f64 else 1e-4 * (1.0 + float(p[3].abs().max()))
        n_all, nk, n_slots = (state.pos.shape[0], kw["kvecs"].shape[0],
                              args[6].shape[0])
        # every G that fits, largest first: the main paths use 16 for one
        # chain and, as the card's resident clusters allow, fewer for more
        sizes = mk.fitting_cluster_sizes(n_all, cfg.tdtype, nk,
                                         n_slots)[::-1]
        rep["checked_G"][dtype] = sizes
        for G in sizes:
            k = mk.run_steps_uvt(*args, **kw, cluster=G)
            torch.cuda.synchronize(device)
            ks = k[2].cpu().numpy()
            log(f"B1 {dtype} G={G} C={C} K={K}: kernel counts "
                f"{ks[:, 6:12].tolist()} plain {ps[:, 6:12].tolist()}")
            if not (np.array_equal(ks[:, 6:12], ps[:, 6:12])
                    and torch.equal(k[1], p[1])):
                step, chain, margin = _first_divergence(
                    lambda n: mk.run_steps_uvt(
                        *args[:24], args[24][:, :n].contiguous(), args[25],
                        **kw, cluster=G)[2][:, 6:9].sum(1).long().cpu(),
                    trace, K)
                raise AssertionError(
                    f"B1 {dtype} G={G}: decisions differ from the plain "
                    f"version; first at step {step} of chain {chain}, "
                    f"|ln u - ln acc| = {margin:.3e}")
            d_sums = np.abs(ks[:, :6] - ps[:, :6])
            d_pos = float((k[0] - p[0]).abs().max())
            d_sk = max(float((a - b).abs().max())
                       for a, b in zip(k[3:], p[3:]))
            for c in range(C):
                log("    sums kernel "
                    + " ".join(f"{x: .8e}" for x in ks[c, :6])
                    + "\n    sums plain  "
                    + " ".join(f"{x: .8e}" for x in ps[c, :6]))
            log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
                f"{tol.max():.3e}), pos {d_pos:.3e} A, S(k) {d_sk:.3e}")
            if not (np.all(d_sums <= tol)
                    and d_pos <= (1e-9 if f64 else 1e-4) and d_sk <= sk_tol):
                raise AssertionError(f"B1 {dtype} G={G} disagrees with its "
                                     "plain version")
            rep["max_abs_err"] = max(rep["max_abs_err"], float(d_sums.max()),
                                     d_pos, d_sk)
            # chain c of the C-chain launch == a C = 1 launch on its block,
            # both at this G
            for c in range(C):
                a1, kw1 = metropolis.fused_uvt_launch_args(
                    multichain.stack_states(state, 1), params, cfg, thermo,
                    u[c:c + 1], tables)
                one = mk.run_steps_uvt(*a1, **kw1, cluster=G)
                if not all(torch.equal(x[0], y[c]) for x, y in zip(one, k)):
                    raise AssertionError(
                        f"B1 {dtype} G={G}: chain {c} of the C={C} launch "
                        "differs from its C=1 launch")
            log(f"    G={G}: every chain equals its C=1 launch bit for bit")
        if f64:
            continue
        a1, kw1 = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, 1), params, cfg, thermo, u[:1],
            tables)
        one = mk.run_steps_uvt(*a1, **kw1)
        pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1),
                         device, n=2) / K
        ops = _fused_ops(trace, cfg, nk)
        # each input read once; out: pos, atom alive, slot alive, S(k)
        # and the sums written once
        n_in = _nbytes(*a1[:25], *kw1.values())
        n_out = _nbytes(one[0], a1[1], one[1], one[2], *one[3:])
        bound, by = _bound_ms(ops, n_in + n_out)
        rep.update(plain_ms=pms, bound_ms=bound / K, bound_by=by)
        for chains in (1, 32):
            ut = torch.as_tensor(np.random.default_rng(seed + chains).random(
                (chains, k_time, 16)), dtype=cfg.tdtype, device=device)
            at, kwt = metropolis.fused_uvt_launch_args(
                multichain.stack_states(state, chains), params, cfg, thermo,
                ut, tables)
            by_g = {G: _time_steps(
                lambda: mk.run_steps_uvt(*at, **kwt, cluster=G), device,
                k_time) for G in sizes}
            ms_step = _time_steps(lambda: mk.run_steps_uvt(*at, **kwt),
                                  device, k_time)
            dms_step = time_device(lambda: mk.run_steps_uvt(*at, **kwt),
                                   device, n=5) / k_time
            G = mk.run_steps_uvt.last_cluster
            rep[f"c{chains}"] = {"G": G, "ms": ms_step, "device_ms": dms_step,
                                 "by_G": by_g}
            log(f"B1 f32 C={chains}: kernel {ms_step * 1e3:.3f} us per step"
                f" at its G={G} ({k_time}-step launches; "
                f"{dms_step * 1e3:.3f} back to back); by G: "
                + ", ".join(f"{g} {t * 1e3:.3f}" for g, t in by_g.items()))
        rep.update(ms=rep["c1"]["ms"], device_ms=rep["c1"]["device_ms"],
                   cluster=f"G={rep['c1']['G']} (C=1), "
                   f"G={rep['c32']['G']} (C=32)")
        log("B1 f32 resident clusters by G (cudaOccupancyMaxActiveClusters):"
            f" {_resident('uvt_occupancy', 'f32')}")
        log(f"B1 f32 C=1: kernel {rep['ms'] * 1e3:.3f} us/step, plain "
            f"{pms * 1e3:.1f} us/step, bound {bound / K * 1e3:.4f} us/step "
            f"({by}; {ops / K:.3e} ops/step)")
    return rep


def nvt_system(kind, dtype, device, seed=31, warm_steps=2000):
    """(params, state, cfg, thermo) of a full-width B3 system on the card,
    after it has run: jittered off its lattice, then ``warm_steps`` fused
    steps (one B3 launch) and a fresh energy.  ``kind``: "mof" — the
    10.0k MOF + H2 system (mof_h2_gcmc(n_side=21, n_h2=256, capacity=256),
    nvt, N = 10,029) — or "lj" — the 10k LJ fluid (lj_fluid(n=10000))."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    if kind == "mof":
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=N_SIDE, n_h2=N_H2, capacity=N_H2, dtype=dtype,
            device=device)
    else:
        params, state, cfg, thermo = systems.lj_fluid(n=N_LJ, dtype=dtype,
                                                      device=device)
    cfg = dataclasses.replace(cfg, ensemble="nvt", fused_mc=True)
    state = metropolis.initialize(systems.jittered(params, state, seed),
                                  params, cfg, thermo)
    u = torch.as_tensor(np.random.default_rng(seed).random((warm_steps, 16)),
                        dtype=cfg.tdtype, device=device)
    state, _ = metropolis.run_chunk_fused(state, params, cfg, thermo,
                                          warm_steps, uniforms=u)
    return (params, metropolis.initialize(state, params, cfg, thermo), cfg,
            thermo)


def _nvt_check(label, system, u_np, device, rep, trace_out=None,
               sizes=None):
    """B3 against its plain version on the table ``u_np`` [C, K, 16] for
    the stacked copies of ``system``'s state, at each cluster size G of
    ``sizes`` (None: every G whose slice fits); at each G every chain
    against a C = 1 launch on its own block at the same G, bit for bit.
    Tolerances as for B1.  Returns {G: (the C = 1 launch arguments of
    chain 0, its outputs)}."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    C, K = u_np.shape[0], u_np.shape[1]
    f64 = cfg.tdtype == torch.float64
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    u = torch.as_tensor(u_np, dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u, tables)
    trace = [] if trace_out is None else trace_out
    p = mk.run_steps_plain(*args, **kw, trace=trace)
    ps = p[1].cpu().numpy()
    ew = cfg.coulomb == "ewald"
    nk = kw["kvecs"].shape[0] if ew else 0
    n_acc = ps[:, 3:4]
    tol = (np.maximum(1e-10 * np.abs(ps[:, :3]), 1e-8) if f64 else
           2e-5 * np.abs(ps[:, :3]) + 2e-3 * np.sqrt(n_acc + 1.0))
    sk_tol = ((1e-9 if f64 else 1e-4 * (1.0 + float(p[2].abs().max())))
              if ew else 0.0)
    if sizes is None:
        sizes = mk.fitting_cluster_sizes(state.pos.shape[0], cfg.tdtype,
                                         nk)[::-1]
    firsts = {}
    for G in sizes:
        k = mk.run_steps(*args, **kw, cluster=G)
        torch.cuda.synchronize(device)
        ks = k[1].cpu().numpy()
        log(f"B3 {label} G={G} C={C} K={K}: kernel accepts "
            f"{ks[:, 3].tolist()} plain {ps[:, 3].tolist()}")
        if not np.array_equal(ks[:, 3], ps[:, 3]):
            step, chain, margin = _first_divergence(
                lambda n: mk.run_steps(
                    *args[:15], args[15][:, :n].contiguous(), args[16],
                    **kw, cluster=G)[1][:, 3].long().cpu(), trace, K)
            raise AssertionError(
                f"B3 {label} G={G}: decisions differ from the plain "
                f"version; first at step {step} of chain {chain}, |ln u - "
                f"ln acc| = {margin:.3e}")
        d_sums = np.abs(ks[:, :3] - ps[:, :3])
        d_pos = float((k[0] - p[0]).abs().max())
        d_sk = (max(float((a - b).abs().max())
                    for a, b in zip(k[2:], p[2:])) if ew else 0.0)
        for c in range(C):
            log("    sums kernel " + " ".join(f"{x: .8e}" for x in ks[c, :3])
                + "\n    sums plain  "
                + " ".join(f"{x: .8e}" for x in ps[c, :3]))
        log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
            f"{tol.max():.3e}), pos {d_pos:.3e} A, S(k) {d_sk:.3e}")
        if not (np.all(d_sums <= tol) and d_pos <= (1e-9 if f64 else 1e-4)
                and d_sk <= sk_tol):
            raise AssertionError(f"B3 {label} G={G} disagrees with its "
                                 "plain version")
        rep["max_abs_err"] = max(rep["max_abs_err"], float(d_sums.max()),
                                 d_pos, d_sk)
        for c in range(C):
            a1, kw1 = metropolis.fused_nvt_launch_args(
                multichain.stack_states(state, 1), params, cfg, thermo,
                u[c:c + 1], tables)
            one = mk.run_steps(*a1, **kw1, cluster=G)
            if not all(x is None or torch.equal(x[0], y[c])
                       for x, y in zip(one, k)):
                raise AssertionError(f"B3 {label} G={G}: chain {c} of the "
                                     f"C={C} launch differs from its C=1 "
                                     "launch")
            if c == 0:
                firsts[G] = (a1, kw1, one)
        if C > 1:
            log(f"    G={G}: every chain equals its C=1 launch bit for bit")
    return firsts


def phase_nvt_kernel(device, C=2, K=256, seed=2025, k_time=1000):
    """B3 against its plain version on both full-width systems, after
    they have run (nvt_system), in float64 and float32, on one
    numpy-seeded [C, K, 16] table, at every cluster size G whose slice
    fits: identical decisions, sums within the B1 tolerances, each chain
    of the C = 2 launch equal to its C = 1 launch at the same G bit for
    bit; NVE on the LJ fluid (C = 1, at one chain's G) at the reference's
    reservoir of 180 K per atom, whose effective temperature (2/3 of it)
    is the thermo's 120 K, and at NVE_K_FAR per atom, where Ray's rule
    must decide apart from Metropolis (its accept count differs from the
    NVT launch's on the same rows); and the kernel's time (CUDA events,
    median of 5 launches of ``k_time`` steps, per step): the MOF system
    at one chain and 16 chains, the LJ fluid at one chain, at each G and
    at the G the wrapper picks, beside the bound and the plain version's
    time.  Returns the kernel's report entry (times of the MOF system at
    C = 1)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    u_np = np.random.default_rng(seed).random((C, K, 16))
    rep = {"max_abs_err": 0.0}
    for kind in ("mof", "lj"):
        for dtype in ("float64", "float32"):
            system = nvt_system(kind, dtype, device)
            params, state, cfg, thermo = system
            trace = []
            firsts = _nvt_check(f"{kind} {dtype}", system, u_np, device,
                                rep, trace_out=trace)
            # the G the wrapper picks for one chain, from a default launch
            a1, kw1, _ = next(iter(firsts.values()))
            nk = 0 if kw1["kvecs"] is None else kw1["kvecs"].shape[0]
            mk.run_steps(*a1, **kw1)
            G1 = mk.run_steps.last_cluster
            a1, kw1, one = firsts[G1]
            if kind == "lj":
                e = state.reported_energy().total
                nve_cfg = dataclasses.replace(cfg, ensemble="nve")
                for per_atom in (NVE_K_PER_ATOM, NVE_K_FAR):
                    nve = (params, state, nve_cfg, thermo.replace(
                        nve_energy=e + per_atom * N_LJ))
                    acc = float(_nvt_check(
                        f"lj nve {per_atom:g} K/atom {dtype}", nve,
                        u_np[:1], device, rep, sizes=[G1])[G1][2][1][0, 3])
                    log(f"    accepts: nve {acc:g}, nvt "
                        f"{float(one[1][0, 3]):g} on the same rows")
                    if per_atom == NVE_K_FAR and acc == float(one[1][0, 3]):
                        raise AssertionError(
                            "B3 nve: the same accept count as nvt at an "
                            "effective temperature far from the thermo's")
            if dtype == "float64":
                continue
            pms = time_calls(lambda: mk.run_steps_plain(*a1, **kw1), device,
                             n=2) / K
            ops = _fused_ops(trace, cfg, nk)
            # each input read once; out: positions, S(k) and the sums
            bound, by = _bound_ms(ops, _nbytes(*a1[:16], *kw1.values())
                                  + _nbytes(*one))
            tables = metropolis.nvt_fused_tables(params, state.mol_alive)
            out = {"plain_ms": pms, "bound_ms": bound / K, "bound_by": by}
            for chains in ((1, 16) if kind == "mof" else (1,)):
                ut = torch.as_tensor(
                    np.random.default_rng(seed + chains).random(
                        (chains, k_time, 16)), dtype=cfg.tdtype,
                    device=device)
                at, kwt = metropolis.fused_nvt_launch_args(
                    multichain.stack_states(state, chains), params, cfg,
                    thermo, ut, tables)
                by_g = {G: _time_steps(
                    lambda: mk.run_steps(*at, **kwt, cluster=G), device,
                    k_time) for G in firsts}
                ms_step = _time_steps(lambda: mk.run_steps(*at, **kwt),
                                      device, k_time)
                dms_step = time_device(lambda: mk.run_steps(*at, **kwt),
                                       device, n=5) / k_time
                G = mk.run_steps.last_cluster
                out[f"c{chains}"] = {"G": G, "ms": ms_step,
                                     "device_ms": dms_step, "by_G": by_g}
                log(f"B3 {kind} f32 C={chains}: kernel {ms_step * 1e3:.3f} "
                    f"us per step at its G={G} ({k_time}-step launches; "
                    f"{dms_step * 1e3:.3f} back to back); by G: "
                    + ", ".join(f"{g} {t * 1e3:.3f}"
                                for g, t in by_g.items()))
            out["ms"] = out["c1"]["ms"]
            out["device_ms"] = out["c1"]["device_ms"]
            log(f"B3 {kind} f32 C=1: kernel {out['ms'] * 1e3:.3f} us/step, "
                f"plain {pms * 1e3:.1f} us/step, bound "
                f"{bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} "
                "ops/step)")
            rep[kind] = out
    rep.update({k: rep["mof"][k] for k in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")})
    rep["cluster"] = (f"G={rep['mof']['c1']['G']} (C=1), "
                      f"G={rep['mof']['c16']['G']} (C=16)")
    log("B3 f32 resident clusters by G (cudaOccupancyMaxActiveClusters):"
        f" {_resident('nvt_occupancy', 'f32')}")
    return rep


def polar_system(dtype, device, seed=37):
    """(params, state, cfg, thermo) of the polar bench system on the card
    (mof_h2_gcmc(n_side=21, n_h2=256, capacity=512, polarization=True):
    N = 10,797, framework sites 0.35 A^3), jittered off its lattice, with
    its energies, static field and converged dipoles from initialize."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    params, state, cfg, thermo = bench_system(dtype, device,
                                              polarization=True)
    state = metropolis.initialize(systems.jittered(params, state, seed),
                                  params, cfg, thermo)
    return params, state, cfg, thermo


def _b5_pairs(mode, pos, box, ok, mol, rc, visit=None, rows=256):
    """(pairs B5 evaluates, of them inside rc) for one call: ok rows
    against ok columns, i != j, another molecule in charge mode, visited
    tiles only — counted on the card in row chunks."""
    from mpmc_tpu_torch.ops import pbc
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    n = pos.shape[0]
    cols = torch.arange(n, device=pos.device)
    box_inv = torch.linalg.inv(box)
    n_eval = n_in = 0
    for i0 in range(0, n, rows):
        r = cols[i0:i0 + rows]
        m = ok[r][:, None] & ok[None, :] & (r[:, None] != cols[None, :])
        if mode == "charge":
            m &= mol[r][:, None] != mol[None, :]
        if visit is not None:
            m &= visit[(r // tk.TI)[:, None], (cols // tk.TJ)[None, :]] != 0
        dr = pbc.min_image(pos[r][:, None, :] - pos[None, :, :], box,
                           box_inv)
        inside = m & (torch.sum(dr * dr, -1) < rc * rc)
        n_eval += int(m.sum())
        n_in += int(inside.sum())
    return n_eval, n_in


def phase_thole_kernel(device):
    """B5 against its plain version on the polar bench system (N =
    10,797), float64 and float32, in both modes: dense at the derived rc
    (42 A), and at rc = RC_CULL on the cell-sorted sites (thole.cull_perm)
    with the tile-visit table (thole.cull_visit), where the culled launch
    must equal the dense launch on the same sorted input bit for bit.

    float64: max |kernel - plain| <= 1e-10 x the largest |E_i|.  float32:
    the plain version in float64 on the same float32 inputs is the
    reference; the kernel (double sums) may be at most 4x as far from it
    as the plain float32 version (float32 sums) is, or 2e-6 x the largest
    |E_i| (a few float32 roundings of one pair's contribution, ~1e-7 each,
    where the field nearly cancels).  Each check logs the share of its
    tolerance used.  Times (float32): per call (CUDA events around the
    wrapper, median of 20) with the call's plan built once, as solve_scf
    calls it, and without, and on the card alone (time_device), beside
    the bound and the plain version's time.  Returns {name: report
    entry}."""
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    rep = {"dipole_field": {"max_abs_err": 0.0, "tol_share": 0.0},
           "charge_field": {"max_abs_err": 0.0, "tol_share": 0.0}}
    funcs = {"dipole_field": (tk.dipole_field, tk.dipole_field_plain),
             "charge_field": (tk.charge_field, tk.charge_field_plain)}
    for dtype in ("float64", "float32"):
        params, state, cfg, _ = polar_system(dtype, device)
        alive = state.atom_alive(params)
        pol_ok = alive & (params.polar > 0)
        box, lam, kind = state.box, cfg.polar_damp, cfg.polar_damp_type
        mu = torch.where(pol_ok[:, None], state.mu, 0.0)
        rc = pairs.derived_cutoff(box, cfg)
        rc14 = torch.as_tensor(RC_CULL, dtype=box.dtype, device=device)
        for name, (kern, plain) in funcs.items():
            mode = name.split("_")[0]
            ok, src = (pol_ok, mu) if mode == "dipole" else (alive,
                                                            params.charge)
            perm, _ = thole.cull_perm(state.pos, box, ok, rc14)
            pos_s, ok_s = state.pos[perm], ok[perm]
            src_s, mol_s = src[perm].contiguous(), params.mol_id32[perm]
            visit = thole.cull_visit(pos_s, ok_s, box, rc14)
            cases = {
                "dense": ((state.pos, box, ok, src, params.mol_id32, rc,
                           lam, kind), None),
                f"rc{RC_CULL:g} culled": ((pos_s.contiguous(), box, ok_s,
                                           src_s, mol_s, rc14, lam, kind),
                                          visit)}
            for label, (args, vis) in cases.items():
                fplan = tk.plan(box, args[5], lam, args[0].shape[0], vis)
                k = kern(*args, ortho=True, visit=vis, plan=fplan)
                torch.cuda.synchronize(device)
                if not torch.equal(k, kern(*args, ortho=True, visit=vis)):
                    raise AssertionError(f"B5 {name} {dtype} {label}: the "
                                         "launch with a plan differs from "
                                         "the launch without")
                if vis is not None:
                    dense = kern(*args, ortho=True)
                    if not torch.equal(k, dense):
                        raise AssertionError(
                            f"B5 {name} {dtype}: the culled launch differs "
                            "from the dense launch on the same input")
                a64 = tuple(x.double() if torch.is_tensor(x)
                            and x.is_floating_point() else x for x in args)
                p64 = plain(*a64).cpu()
                scale = float(p64.abs().max())
                err = float((k.double().cpu() - p64).abs().max())
                if dtype == "float64":
                    tol = 1e-10 * scale
                else:
                    p32 = plain(*args).double().cpu()
                    tol = max(4.0 * float((p32 - p64).abs().max()),
                              2e-6 * scale)
                log(f"B5 {name} {dtype} {label}: max |E| {scale:.6e}, "
                    f"|kernel - plain| {err:.3e} (tol {tol:.3e}, "
                    f"{err / tol:.3f} of it)"
                    + (f", visit {float(vis.float().mean()):.3f} of "
                       f"{vis.numel()} tiles, culled == dense bit for bit"
                       if vis is not None else ""))
                if not err <= tol:
                    raise AssertionError(f"B5 {name} {dtype} {label} "
                                         "disagrees with its plain version")
                rep[name]["max_abs_err"] = max(rep[name]["max_abs_err"],
                                               err)
                rep[name]["tol_share"] = max(rep[name]["tol_share"],
                                             err / tol)
                if dtype == "float64":
                    continue

                def call(p=fplan):
                    return kern(*args, ortho=True, visit=vis, plan=p)

                ms = time_calls(call, device)
                ms_unplanned = time_calls(lambda: call(None), device)
                dms = time_device(call, device, n=50)
                pms = time_calls(lambda: plain(*args, visit=vis), device,
                                 n=3)
                n_eval, n_in = _b5_pairs(mode, args[0], box, args[2],
                                         args[4], args[5], vis)
                ops = n_eval * OPS_B5_PAIR + n_in * OPS_B5_IN[mode]
                # each input read once, the field written once
                nbytes = _nbytes(*args[:5], fplan.scal, vis, k)
                bound, by = _bound_ms(ops, nbytes)
                log(f"    f32 kernel {ms:.4f} ms per call ({ms_unplanned:.4f}"
                    f" building its plan), {dms:.4f} ms on the card alone; "
                    f"plain {pms:.3f} ms, bound {bound:.5f} ms ({by}; "
                    f"{n_eval} pairs evaluated, {n_in} inside rc)")
                entry = {"ms": ms, "device_ms": dms,
                         "unplanned_ms": ms_unplanned, "plain_ms": pms,
                         "bound_ms": bound, "bound_by": by, "pairs": n_eval,
                         "pairs_in": n_in}
                if label == "dense":
                    rep[name].update(entry)
                else:
                    rep[name]["culled"] = entry
    from mpmc_tpu_torch.ops.cuda import _build
    log("B5 f32 CTAs on the card (dipole, charge): "
        f"{tk.card_config(device, torch.float32, 'dipole')}, "
        f"{tk.card_config(device, torch.float32, 'charge')}; tiles "
        f"{tk.TI} x {tk.TJ}; " + "; ".join(
            ln.strip() for ln in _build.target("thole_kernel").with_suffix(
                ".ptxas.txt").read_text().splitlines()
            if "registers" in ln or "spill" in ln))
    return rep


PDA_VARIANTS = (("direct", {}), ("wolf", {"polar_wolf": True}),
                ("ewald", {"polar_ewald": True}), ("nvt", {"ensemble": "nvt"}))


def _pda_survivor_free(launch, u, rng):
    """``u`` [K,16] with every stage-1 coin 1 - 1e-7 and each row that
    still survives (a move with ln(acceptance) > ln u) drawn anew until
    the kernel runs all K rows: B6 never changes the state, so each row
    decides alone.  ``launch(u)`` returns B6's record."""
    u = u.clone()
    u[:, 4] = 1.0 - 1e-7
    for _ in range(400):
        rec = launch(u)
        if float(rec[0, 1]) < 0.5:
            return u
        k = int(rec[0, 0]) - 1
        u[k] = torch.as_tensor(rng.random(16), dtype=u.dtype)
        u[k, 4] = 1.0 - 1e-7
    raise AssertionError("B6: no survivor-free table found")


def _pda_ops(trace, field, nk):
    """Floating-point operations of the steps in a plain B6 trace: B1's
    per-pair and per-phase counts plus the field and surrogate work."""
    f = OPS_B6_FIELD["direct" if field == "direct" else "screened"]
    in_rc = OPS_GUARD + OPS_LJ + OPS_COULOMB + f
    return sum(t["pairs"] * OPS_PAIR_FUSED
               + (t["in_old"] + t["in_new"]) * in_rc
               + (t["in_new"] + (field == "ewald") * t["in_old"]) * OPS_B6_ROW
               + t["cols"] * OPS_B6_COL + t["phases"] * OPS_PHASE_FUSED
               + (t["phases"] > 0) * nk * OPS_K_FUSED for t in trace)


def phase_pda_kernel(device, seed=43):
    """B6 (run_steps_uvt_pda) against its plain version on the polar bench
    system (polar_system: N = 10,797, jittered, initialized under each
    field variant), float64 and float32, for the direct, polar_wolf and
    polar_ewald fields and ensemble nvt (insert_probability 0): on
    numpy-seeded [PDA_SEG, 16] tables — per move type one whose step 0
    survives (lane 4 = 1e-30; under nvt all three displace), one of
    natural coins, and a survivor-free one (every coin 1 - 1e-7, rows
    that still survive drawn anew: all 16 steps run).  Equal: n_done, hit,
    mtype, slot, species and attempts.  float64: the rows within 1e-9 A,
    the six deltas, d* and lnb within rel 1e-10 + 1e-8 K.  float32: rows
    within 1e-4 A; each value within 2e-5 of its size + 1e-3 K + 8 float32
    epsilons x the root sum of squares of its terms (the plain trace's
    rss): each pair's, column's or k-vector's term is rounded to float32
    once or twice in either version (the kernel contracts multiply-adds,
    the plain version rounds each product), so the two sums drift apart
    as a random walk of that scale.  Each table runs at every cluster
    size G whose slice (with the polar planes) fits, then at the G the
    wrapper picks.  Times (float32, direct, the survivor-free table, the
    wrapper's G): CUDA events, median of 20 launches, per launch and per
    step, beside the bound (operations from the plain trace, _pda_ops)
    and the plain version's time.  Returns the kernel's report entry (per
    step, with its G)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    rng = np.random.default_rng(seed)
    rep = {"max_abs_err": 0.0}
    K = mk.PDA_SEG
    for dtype in ("float64", "float32"):
        f64 = dtype == "float64"
        params, state0, cfg0, thermo0 = polar_system(dtype, device)
        for label, extra in PDA_VARIANTS:
            cfg = dataclasses.replace(cfg0, polar_delayed=True,
                                      fused_mc=True, **extra)
            state, thermo = state0, thermo0
            if label in ("wolf", "ewald"):     # this variant's static field
                state = metropolis.initialize(state0, params, cfg, thermo)
            if label == "nvt":
                thermo = thermo.replace(insert_probability=torch.zeros_like(
                    thermo.insert_probability))
            cfg_eff = mk.pda_effective_cfg(cfg, params)
            tables = metropolis.uvt_fused_tables(params, cfg_eff)
            consts = metropolis._uvt_chunk_consts(
                state.pos, state.box, params, thermo, cfg_eff, tables[5],
                tables[6])

            def args_of(u):
                return metropolis.pda_launch_args(state, params, cfg_eff,
                                                  thermo, u, tables, consts)

            def launch(u):
                a, kw = args_of(u)
                return mk.run_steps_uvt_pda(*a, **kw)

            def table(x):
                return torch.as_tensor(x, dtype=cfg.tdtype, device=device)

            us = {}
            for mt, lane8 in ((0, 0.9), (1, 0.1), (2, 0.4)):
                x = rng.random((K, 16))
                x[0, 4], x[0, 8] = 1e-30, lane8
                us[f"step 0 survives ({'disp ins del'.split()[mt]})"] = (
                    table(x))
            us["natural"] = table(rng.random((K, 16)))
            us["survivor-free"] = _pda_survivor_free(
                launch, table(rng.random((K, 16))), rng)
            hits = 0
            a0, kw0 = args_of(us["natural"])
            fits = mk.fitting_cluster_sizes(
                a0[0].shape[0], a0[0].dtype,
                kw0["kvecs"].shape[0] if kw0["kvecs"] is not None else 0,
                a0[8].shape[0], polar=True)
            for name, u in us.items():
                a, kw = args_of(u)
                trace = []
                p = mk.run_steps_uvt_pda_plain(*a, **kw,
                                               trace=trace).cpu().numpy()
                rss = np.zeros(8)
                if trace[-1].get("rss"):
                    rss[[0, 1, 2, 6]] = trace[-1]["rss"]
                want = np.concatenate([p[1, :6], p[0, 9:11]])
                tol = (1e-10 * np.abs(want) + 1e-8 if f64
                       else 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss)
                # every G whose slice fits, then the wrapper's own G
                for G in fits + [None]:
                    k = mk.run_steps_uvt_pda(*a, **kw,
                                             cluster=G).cpu().numpy()
                    torch.cuda.synchronize(device)
                    G_run = mk.run_steps_uvt_pda.last_cluster
                    same = np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                          p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
                    vals = np.concatenate([k[1, :6], k[0, 9:11]])
                    d_vals = np.abs(vals - want)
                    d_rows = float(np.abs(k[2:5] - p[2:5]).max())
                    which = "" if G else " (the wrapper's G)"
                    log(f"B6 {dtype} {label} {name} G={G_run}{which}: n_done "
                        f"{k[0, 0]:g} hit {k[0, 1]:g} mtype {k[0, 2]:g} "
                        f"(plain: {p[0, 0]:g} {p[0, 1]:g} {p[0, 2]:g}); "
                        f"|d| deltas/d*/lnb {d_vals.max():.3e} (worst "
                        f"|d|/tol {float(np.max(d_vals / tol)):.3f}), rows "
                        f"{d_rows:.3e} A; d* {k[0, 9]:.6f} K")
                    if not (same and np.all(d_vals <= tol)
                            and d_rows <= (1e-9 if f64 else 1e-4)):
                        margins = [f"{t['margin']:.3e}" for t in trace]
                        raise AssertionError(
                            f"B6 {dtype} {label} {name} G={G_run} disagrees "
                            f"with its plain version: kernel "
                            f"{k[:2].tolist()} plain {p[:2].tolist()}; "
                            f"plain margins {margins}")
                    rep["max_abs_err"] = max(rep["max_abs_err"],
                                             float(d_vals.max()), d_rows)
                hits += int(k[0, 1])
                if f64 or label != "direct" or name != "survivor-free":
                    continue
                if k[0, 0] != K or k[0, 1] != 0:
                    raise AssertionError("B6: the survivor-free table froze")
                ms = time_calls(lambda: mk.run_steps_uvt_pda(*a, **kw),
                                device)
                dms = time_device(lambda: mk.run_steps_uvt_pda(*a, **kw),
                                  device, n=20)
                pms = time_calls(lambda: mk.run_steps_uvt_pda_plain(*a, **kw),
                                 device, n=3)
                nk = kw["kvecs"].shape[0]
                ops = _pda_ops(trace, label, nk)
                # each input read once, the record written once
                bound, by = _bound_ms(ops, _nbytes(*a, *kw.values())
                                      + 8 * 16 * 8)
                rep.update(ms=ms / K, device_ms=dms / K, plain_ms=pms / K,
                           bound_ms=bound / K, bound_by=by, launch_ms=ms,
                           plain_launch_ms=pms,
                           cluster=mk.run_steps_uvt_pda.last_cluster,
                           fitting_clusters=fits)
                log(f"B6 f32 direct, survivor-free table, G="
                    f"{rep['cluster']} (fitting: {fits}): kernel {ms:.4f} ms "
                    f"per launch of {K} steps ({ms / K * 1e3:.2f} us/step; "
                    f"{dms:.4f} ms back to back, {dms / K * 1e3:.2f} "
                    f"us/step), plain {pms:.3f} ms, bound "
                    f"{bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} "
                    "ops/step)")
            if hits < 3:
                raise AssertionError(f"B6 {dtype} {label}: only {hits} "
                                     "survivors on the forced tables")
    return rep


def phase_energy(device, n_side=N_SIDE, n_h2=N_H2, capacity=CAPACITY):
    """Card float32 (kernels) against CPU float64 (plain), per term; then
    the polar term of the polar bench system (B5 in both modes)."""
    from mpmc_tpu_torch.ops import energy
    cpu = torch.device("cpu")
    out = {}
    for tag, dtype, dev in (("card f32", "float32", device),
                            ("cpu f64", "float64", cpu),
                            ("cpu f32", "float32", cpu)):
        params, state, cfg, thermo = bench_system(dtype, dev, n_side, n_h2,
                                                  capacity)
        t0 = time.time()
        e, _ = energy.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo)
        out[tag] = {k: float(v) for k, v in e.as_dict().items()}
        log(f"energy {tag}: {time.time() - t0:.2f} s")
    for k in out["cpu f64"]:
        ref, got, p32 = out["cpu f64"][k], out["card f32"][k], \
            out["cpu f32"][k]
        # rel 1e-5 or abs 1e-2 K, or 4x the plain f32 rounding distance
        tol = max(1e-5 * abs(ref), 1e-2, 4.0 * abs(p32 - ref))
        log(f"    {k:9s} card {got: .8e} cpu-f64 {ref: .8e} "
            f"|d| {abs(got - ref):.3e} tol {tol:.3e}")
        if not abs(got - ref) <= tol:
            raise AssertionError(f"energy term {k} disagrees")
    # the polar term on the same system with polarizable framework sites:
    # every other term is the one above; the polar energies differ by the
    # two solves' stopping residuals (_polar_tol) and float32 rounding
    pol = {}
    for tag, dtype, dev in (("card f32", "float32", device),
                            ("cpu f64", "float64", cpu)):
        params, state, cfg, thermo = bench_system(dtype, dev, n_side, n_h2,
                                                  capacity, polarization=True)
        t0 = time.time()
        e, aux = energy.total_energy(state.pos, state.box, state.mol_alive,
                                     params, cfg, thermo)
        pol[tag] = (float(e.polar), aux["polar_iters"],
                    _polar_tol(state.replace(mu=aux["mu"], energy=e), params,
                               cfg))
        log(f"energy polar {tag}: {pol[tag][0]:.8e} K, {pol[tag][1]} CG "
            f"iterations from mu = 0, {time.time() - t0:.2f} s")
    # each _polar_tol covers two solves of its own |mu|: average them
    (got, _, tol_a), (ref, _, tol_b) = pol["card f32"], pol["cpu f64"]
    tol = 0.5 * (tol_a + tol_b)
    log(f"    polar     card {got: .8e} cpu-f64 {ref: .8e} "
        f"|d| {abs(got - ref):.3e} tol {tol:.3e}")
    if not (ref < 0 and abs(got - ref) <= tol):
        raise AssertionError("energy term polar disagrees")


DECK = """job_name bench10k
ensemble uvt
numsteps {numsteps}
corrtime 1000
seed 7
temperature 77
pressure 1.0
h2_fugacity on
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
insert_probability 0.5
move_factor 1.0
rot_factor 3.14159
cavity_autoreject_absolute 1.0
max_molecules 256
allow_charged_cell on
pqr_input bench10k.pqr
pqr_restart restart.pqr
"""


LJ_DECK = """job_name lj10k
ensemble nvt
numsteps {numsteps}
corrtime 1000
seed 7
temperature 120
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
move_factor 0.5
rot_factor 0
coulomb off
pqr_input lj10k.pqr
pqr_restart restart.pqr
"""


def _run_deck(device, extra="", numsteps=3000, kind="mof"):
    """A full-size system written to PQR and run as a deck through run.run,
    every launch count set to 0 just before and read just after: ``kind``
    "mof" — the 10.8k system as DECK (plus ``extra`` lines) —, "polar" —
    the same system with polarizable framework sites (0.35 A^3), as DECK
    with ``polarization on`` and corrtime POLAR_CORRTIME — or "lj" — the
    10k LJ fluid as LJ_DECK.  An ``ensemble nve`` LJ deck gets
    total_energy = U0 + NVE_K_PER_ATOM x N, U0 from an ``ensemble te`` run
    of the same deck.  Returns (Setup, averages, log text, launches)."""
    from mpmc_tpu_torch.io import input_script, pqr
    from mpmc_tpu_torch.mc import run
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    if kind == "mof":
        params, state, cfg, _ = bench_system("float32", "cpu")
        name, template, species = "bench10k", DECK, ["H2"]
    elif kind == "polar":
        params, state, cfg, _ = bench_system("float32", "cpu",
                                             polarization=True)
        name, species = "bench10k", ["H2"]
        template = (DECK.replace("corrtime 1000",
                                 f"corrtime {POLAR_CORRTIME}")
                    + "polarization on\n")
    else:
        params, state, cfg, _ = systems.lj_fluid(n=N_LJ, device="cpu")
        name, template, species = "lj10k", LJ_DECK, ["AR"]
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            pqr.write_state(f"{name}.pqr", params, state, species)
            text = template.format(numsteps=numsteps,
                                   L=float(state.box[0, 0]))
            if "ensemble nve" in extra:
                with open(f"{name}_te.inp", "w") as f:
                    f.write(text + "ensemble te\n")
                e0 = run.run(input_script.parse_file(f"{name}_te.inp"),
                             log=io.StringIO(), device=device)
                total = float(e0.total) + NVE_K_PER_ATOM * N_LJ
                log(f"NVE deck: U0 {float(e0.total):.6f} K (ensemble te), "
                    f"total_energy {total:.6f} K")
                extra += f"total_energy {total!r}\n"
            with open(f"{name}.inp", "w") as f:
                f.write(text + extra)
            job = input_script.parse_file(f"{name}.inp")
            buf = io.StringIO()
            pk.reset_counts()
            mk.reset_counts()
            tk.reset_counts()
            su, avgs = run.run(job, log=buf, device=device)
            torch.cuda.synchronize(device)
            launches = {"pair_terms": pk.pair_terms.launches,
                        "mol_pair": pk.mol_pair.launches,
                        "run_steps_uvt": mk.run_steps_uvt.launches,
                        "run_steps": mk.run_steps.launches,
                        "charge_field": tk.charge_field.launches,
                        "dipole_field": tk.dipole_field.launches,
                        "run_steps_uvt_pda": mk.run_steps_uvt_pda.launches}
        finally:
            os.chdir(old)
    text = buf.getvalue()
    log(text.rstrip())
    log(f"launches: {launches}")
    for k in ("N", "energy_total"):
        if not np.isfinite(avgs.mean(k)):
            raise AssertionError(f"non-finite average {k}")
    return su, avgs, text, launches


def _check_bookkeeping(label, st, su, polar=False):
    """Carried energy after a further chunk against a fresh recompute
    (rel 1e-4); with ``polar`` also the polar term, within
    _polar_tol(fresh state)."""
    from mpmc_tpu_torch.mc import metropolis
    fresh = metropolis.initialize(st, su.params, su.cfg, su.thermo)
    carried, full = float(st.energy.total), float(fresh.energy.total)
    log(f"bookkeeping {label}: carried {carried:.6f} fresh {full:.6f}")
    if not abs(carried - full) <= 1e-4 * max(abs(full), 1.0):
        raise AssertionError(f"{label}: carried energy drifted from a "
                             "fresh recompute beyond rel 1e-4")
    if polar:
        c_pol, f_pol = float(st.energy.polar), float(fresh.energy.polar)
        tol = _polar_tol(fresh, su.params, su.cfg)
        log(f"    polar carried {c_pol:.6f} fresh {f_pol:.6f} |d| "
            f"{abs(c_pol - f_pol):.3e} tol {tol:.3e}")
        if not abs(c_pol - f_pol) <= tol:
            raise AssertionError(f"{label}: carried polar energy drifted "
                                 "from a fresh solve")


def _polar_tol(state, params, cfg):
    """Allowed difference of two polar energies of one configuration, each
    from a CG solve stopped at an rms residual r <= polar_precision per
    component: at the fixed point the energy error of a residual r is
    (ke/2) mu.r, so two solves differ by at most ke |mu| |r| <= ke |mu|
    polar_precision sqrt(3 n_pol) (Cauchy-Schwarz), plus float32 rounding
    of the field and the energy sum, rel 1e-4."""
    from mpmc_tpu_torch.constants import KE
    pol = state.atom_alive(params) & (params.polar > 0)
    n_pol = int(pol.sum())
    mu_norm = float(torch.sqrt(torch.sum(
        torch.where(pol[:, None], state.mu, 0.0) ** 2)))
    return (KE * mu_norm * cfg.polar_precision * (3 * n_pol) ** 0.5
            + 1e-4 * abs(float(state.energy.polar)))


def phase_main(device, numsteps=3000):
    """The port's scan path at full size through run.run."""
    from mpmc_tpu_torch.mc import metropolis
    su, avgs, text, launches = _run_deck(device, numsteps=numsteps)
    if not (launches["pair_terms"] > 0 and launches["mol_pair"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k scan path: {rate:.2f} steps/s, <N> "
        f"{avgs.mean('N'):.3f}, acceptance displace/insert/delete "
        f"{avgs.mean('acc_displace'):.4f}/{avgs.mean('acc_insert'):.4f}/"
        f"{avgs.mean('acc_delete'):.4f}")
    # bookkeeping: carry one more chunk and recompute from scratch
    g = torch.Generator(device=device).manual_seed(11)
    st, stats = metropolis.run_chunk(su.state, su.params, su.cfg, su.thermo,
                                     1000, generator=g)
    log(f"scan chunk accepts {stats.host().accepts.tolist()}")
    _check_bookkeeping("scan path, 1000 steps", st, su)
    return launches, rate, dataclasses.replace(su, state=st)


def phase_fused(device, numsteps=20000):
    """The fused µVT path at full size: the bench deck with fused_mc on."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.state import stack_chains
    su, avgs, text, launches = _run_deck(device, "fused_mc on\n",
                                         numsteps=numsteps)
    if "fused_mc: single-chain fused" not in text:
        raise AssertionError("the fused deck did not take the fused path")
    if not (launches["run_steps_uvt"] > 0 and launches["pair_terms"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k fused single chain: {rate:.2f} steps/s (run_mc), <N>"
        f" {avgs.mean('N'):.3f}, acceptance displace/insert/delete "
        f"{avgs.mean('acc_displace'):.4f}/{avgs.mean('acc_insert'):.4f}/"
        f"{avgs.mean('acc_delete'):.4f}")
    tables = metropolis.uvt_fused_tables(su.params, su.cfg)
    g = torch.Generator(device=device).manual_seed(13)
    st, stats = metropolis.run_chunk_fused_uvt(
        su.state, su.params, su.cfg, su.thermo, 1000, generator=g,
        tables=tables)
    log(f"fused chunk accepts {stats.host().accepts.tolist()}")
    _check_bookkeeping("fused single chain, 1000 steps", st, su)
    # the kernel alone: CUDA events around one 1000-step launch
    u = torch.rand((1, 1000, 16), generator=g, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        stack_chains([st]), su.params, su.cfg, su.thermo, u, tables)
    ms = time_calls(lambda: mk.run_steps_uvt(*args, **kw), device, n=5)
    log(f"B1 kernel alone, single chain: {ms / 1000 * 1e3:.2f} us/step "
        f"({ms:.2f} ms per 1000-step launch)")
    _block_breakdown(device, su, "fused single chain")
    return launches, rate, dataclasses.replace(su, state=st), ms / 1000


def phase_fused_nvt(device, chains=16, nvt_steps=20000, nve_steps=5000):
    """The fused NVT/NVE path (B3) at full width through run_mc and
    run_mc_chains: the MOF + H2 deck under nvt, one chain and ``chains``
    chains (``nvt_steps`` each), the 10k LJ fluid under nvt (``nvt_steps``)
    and under nve (``nve_steps``).  Each deck must launch B3 once per
    corrtime and keep its carried energy equal to a fresh recompute after
    a further 1000 fused steps (chain 0 and the last chain when stacked);
    under nve the kinetic reservoir must stay positive; each deck's block
    breakdown (refresh, observables, restart write) is logged.  Returns
    ({deck: launches}, {deck: steps/s}, {deck: Setup})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.state import slice_chain
    decks = (("mof_nvt", "mof", "ensemble nvt\nfused_mc on\n", nvt_steps),
             (f"mof_nvt_c{chains}", "mof",
              f"ensemble nvt\nfused_mc on\nchains {chains}\n", nvt_steps),
             ("lj_nvt", "lj", "fused_mc on\n", nvt_steps),
             ("lj_nve", "lj", "ensemble nve\nfused_mc on\n", nve_steps))
    launches, rates, sus = {}, {}, {}
    for i, (label, kind, extra, numsteps) in enumerate(decks):
        su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                       kind=kind)
        want = ("chain-interleaved multi-chain" if "chains" in extra
                else "single-chain fused NVT")
        if f"fused_mc: {want}" not in text or "WARNING" in text:
            raise AssertionError(f"{label} did not take the fused NVT path")
        if ln["run_steps"] != numsteps // 1000:
            raise AssertionError(f"{label}: B3 launched {ln['run_steps']} "
                                 f"times, not numsteps / corrtime = "
                                 f"{numsteps // 1000}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        log(f"{label}: {rate:.2f} steps/s"
            + (" aggregate" if "chains" in extra else "")
            + f", <U> {avgs.mean('energy_total'):.4f} K, acceptance "
            f"{avgs.mean('acc_displace'):.4f}")
        g = torch.Generator(device=device).manual_seed(19 + i)
        if su.states is not None:
            sts, _ = metropolis.run_chunk_fused_multi(
                su.states, su.params, su.cfg, su.thermo, 1000, generator=g)
            for c in (0, chains - 1):
                _check_bookkeeping(f"{label} chain {c}, 1000 steps",
                                   slice_chain(sts, c), su)
        else:
            st, stats = metropolis.run_chunk_fused(
                su.state, su.params, su.cfg, su.thermo, 1000, generator=g)
            log(f"{label} chunk accepts {stats.host().accepts.tolist()}")
            _check_bookkeeping(f"{label}, 1000 steps", st, su)
            if su.cfg.ensemble == "nve":
                k = float(su.thermo.nve_energy
                          - st.reported_energy().total)
                log(f"{label}: kinetic reservoir after the run and a "
                    f"further chunk {k:.4f} K")
                if not k > 0:
                    raise AssertionError(f"{label}: the reservoir left > 0")
        _block_breakdown(device, su, label, states=su.states)
        launches[label], rates[label], sus[label] = ln, rate, su
    return launches, rates, sus


def _count_syncs(fn):
    """(fn's result, host syncs it made): torch's sync debug mode warns
    once per synchronizing call."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _polar_step_layers(device, su, n=20, seed=23):
    """The polar step's layers on ``n`` trial displacements of alive H2
    from ``su``'s state: host-clock ms of thole.move_deltas (the O(A N)
    field and residual update) and of the warm-started solve_scf (it
    syncs once per CG iteration), its iterations and the ms per
    iteration."""
    from mpmc_tpu_torch.ops import thole
    from mpmc_tpu_torch.state import mol_rows, mol_rows_update
    st, params, cfg = su.state, su.params, su.cfg
    alive = st.atom_alive(params)
    mols = np.flatnonzero((st.mol_alive & ~params.mol_frozen
                           & (params.mol_species >= 0)).cpu().numpy())
    rng = np.random.default_rng(seed)
    md_ms, solve_ms, iters = [], [], []
    for mol in rng.choice(mols, size=min(n, len(mols)), replace=False):
        mol = int(mol)
        rows = mol_rows(st.pos, params, mol) + torch.as_tensor(
            rng.uniform(-0.5, 0.5, 3), dtype=st.pos.dtype, device=device)

        def deltas():
            return thole.move_deltas(
                st.pos, st.box, alive, params, cfg, mol, st.e0, st.mu,
                st.r_pol, new_rows=rows,
                with_residual=thole.residual_supported(cfg),
                sk=(st.sk_re, st.sk_im))

        # host clock: the function is a few hundred small launches
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        e0_new, r0 = deltas()
        torch.cuda.synchronize(device)
        md_ms.append((time.perf_counter() - t0) * 1e3)
        pos_c = mol_rows_update(st.pos.clone(), params, mol, rows)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _, it, _ = thole.solve_scf(pos_c, st.box, alive, params, cfg, e0_new,
                                   mu0=st.mu, r0=r0)
        torch.cuda.synchronize(device)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(it)
    out = {"move_deltas_ms": statistics.median(md_ms),
           "solve_ms": statistics.median(solve_ms),
           "solve_iters_mean": float(np.mean(iters)),
           "ms_per_cg_iter": float(np.sum(solve_ms)
                                   / max(int(np.sum(iters)), 1))}
    log(f"polar step layers ({len(iters)} trial displacements): " +
        json.dumps(out))
    return out


def phase_polar(device, numsteps=POLAR_STEPS):
    """The polar scan path at full width (the 10.8k system with 9,261
    polarizable framework sites) through run.run, in three decks: (a)
    ``polarization on`` — B4 per move, move_deltas, and solve_scf with B5
    in every CG iteration; (b) with ``polar_delayed on`` — the scan-path
    delayed acceptance, the SCF only for stage-1 survivors; (c) with
    ``cutoff 14`` — the tile-culled CG through B5's visit table.  Each
    deck must take the scan path (no WARNING) and launch B2, B4 and both
    B5 modes; after a further 100-step chunk the carried energy and its
    polar term must match a fresh recompute.  On a 50-step chunk of each:
    B5 dipole launches against the CG iterations (equal: the move's
    initial residual comes from move_deltas), host syncs per step, and a
    profile with B5's share of the device time; for (a) the step's layers.
    Returns ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    decks = (("polar", ""), ("polar_da", "polar_delayed on\n"),
             (f"polar_rc{RC_CULL:g}", f"cutoff {RC_CULL:g}\n"))
    launches, reps = {}, {}
    for i, (label, extra) in enumerate(decks):
        su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                       kind="polar")
        if "WARNING" in text:
            raise AssertionError(f"{label}: a WARNING in the run's log")
        if not all(ln[k] > 0 for k in ("pair_terms", "mol_pair",
                                        "charge_field", "dipole_field")):
            raise AssertionError(f"{label}: a kernel was not launched: {ln}")
        if thole.cull_supported(su.cfg) != ("cutoff" in extra):
            raise AssertionError(f"{label}: the culled CG gate is wrong")
        rate = float(text.split("steps/sec:")[1].split()[0])
        rep = {"steps_per_sec": rate,
               "cg_iters_per_step": avgs.mean("polar_iters_per_step"),
               "b5_launches_per_step": ln["dipole_field"] / numsteps,
               "polar_K": avgs.mean("energy_polar"),
               "polar_rrms_debye": avgs.mean("polar_rrms_debye"),
               "N": avgs.mean("N")}
        g = torch.Generator(device=device).manual_seed(29 + i)
        st, stats = metropolis.run_chunk(su.state, su.params, su.cfg,
                                         su.thermo, 100, generator=g)
        _check_bookkeeping(f"{label}, 100 steps", st, su, polar=True)
        su = dataclasses.replace(su, state=st)
        u = metropolis.draw_uniforms(g, 50, su.cfg.tdtype)
        tk.reset_counts()
        (_, stats), syncs = _count_syncs(lambda: metropolis.run_chunk(
            su.state, su.params, su.cfg, su.thermo, 50, uniforms=u))
        stats = stats.host()
        if tk.dipole_field.launches != stats.polar_iters:
            raise AssertionError(
                f"{label}: {tk.dipole_field.launches} B5 dipole launches "
                f"for {stats.polar_iters} CG iterations")
        rep.update(chunk_cg_iters_per_step=stats.polar_iters / 50,
                   host_syncs_per_step=syncs / 50)
        prof = _profile(label, lambda: metropolis.run_chunk(
            su.state, su.params, su.cfg, su.thermo, 50, generator=g),
            50, device, kernel="thole_field")
        rep.update(device_busy_share=prof["device_busy_share"],
                   b5_share=prof.get("kernel_share"),
                   ms_per_step=prof["ms_per_step"])
        if label == "polar":
            rep["layers"] = _polar_step_layers(device, su)
            rep["block"] = _block_breakdown(device, su, label)
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


def phase_pda_decks(device, numsteps=POLAR_STEPS, chunk=100):
    """The fused polar delayed acceptance at full width through run.run:
    DECK + ``polarization on`` + ``polar_delayed on`` + ``fused_mc on`` on
    the 10.8k polar system, (a) the direct field (the reference's
    fused_stage1_delayed_acceptance row), (b) ``polar_wolf on``
    (bench_polar_wolf_gcmc), (c) ``cutoff 14`` (the culled CG in stage 2,
    bench_polar_rc14_gcmc).  Each deck must log the PDA route and no
    WARNING and launch B6, B2 and B5's dipole mode, and B5's charge mode
    where the static field is the direct one (not under polar_wolf,
    whose field is plain torch, as in the reference); after a further
    ``chunk``-step chunk the carried energy and its polar term must match a
    fresh recompute.  On a second chunk: B6 launches, host syncs and CG
    iterations per step, B5 dipole launches equal to the CG iterations;
    and a profile of a third with B6's share of the device time.  Returns
    ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    decks = (("pda", ""), ("pda_wolf", "polar_wolf on\n"),
             (f"pda_rc{RC_CULL:g}", f"cutoff {RC_CULL:g}\n"))
    launches, reps = {}, {}
    for i, (label, extra) in enumerate(decks):
        su, avgs, text, ln = _run_deck(
            device, "polar_delayed on\nfused_mc on\n" + extra,
            numsteps=numsteps, kind="polar")
        if ("fused_mc: polar delayed-acceptance stage-1 kernel (exact SCF "
                "stage 2 per survivor)") not in text or "WARNING" in text:
            raise AssertionError(f"{label} did not take the fused PDA path")
        # the wolf-shifted static field is plain torch (as in the
        # reference): B5's charge mode runs for the direct field only
        need = ("run_steps_uvt_pda", "pair_terms", "dipole_field") + (
            () if "polar_wolf" in extra else ("charge_field",))
        if not all(ln[k] > 0 for k in need):
            raise AssertionError(f"{label}: a kernel was not launched: {ln}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        rep = {"steps_per_sec": rate,
               "cg_iters_per_step": avgs.mean("polar_iters_per_step"),
               "b6_launches_per_step": ln["run_steps_uvt_pda"] / numsteps,
               "polar_K": avgs.mean("energy_polar"), "N": avgs.mean("N"),
               "acc_displace": avgs.mean("acc_displace"),
               "acc_insert": avgs.mean("acc_insert"),
               "acc_delete": avgs.mean("acc_delete")}
        tables = metropolis.uvt_fused_tables(
            su.params, mk.pda_effective_cfg(su.cfg, su.params))
        g = torch.Generator(device=device).manual_seed(47 + i)

        def run_chunk(st, n=chunk):
            return metropolis.run_chunk_fused_uvt_polar_da(
                st, su.params, su.cfg, su.thermo, n, generator=g,
                tables=tables)

        st, _ = run_chunk(su.state)
        _check_bookkeeping(f"{label}, {chunk} steps", st, su, polar=True)
        su = dataclasses.replace(su, state=st)
        mk.reset_counts()
        tk.reset_counts()
        (_, stats), syncs = _count_syncs(lambda: run_chunk(su.state))
        stats = stats.host()
        steps = int(stats.attempts.sum())
        if tk.dipole_field.launches != stats.polar_iters:
            raise AssertionError(
                f"{label}: {tk.dipole_field.launches} B5 dipole launches "
                f"for {stats.polar_iters} CG iterations")
        rep.update(chunk_steps=steps,
                   chunk_cg_iters_per_step=stats.polar_iters / steps,
                   chunk_b6_launches_per_step=(mk.run_steps_uvt_pda.launches
                                               / steps),
                   chunk_accepts_per_step=int(stats.accepts.sum()) / steps,
                   host_syncs_per_step=syncs / steps)
        prof = _profile(label, lambda: run_chunk(su.state), chunk, device,
                        kernel="pda_kernel")
        rep.update(device_busy_share=prof["device_busy_share"],
                   b6_share=prof.get("kernel_share"),
                   ms_per_step=prof["ms_per_step"])
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


def _block_breakdown(device, su, label, states=None):
    """Host-clock seconds of the per-corrtime work of a run_mc block
    besides the chunk: the refresh, the observables and the restart
    write (the part of a block that the kernel's time does not cover)."""
    from mpmc_tpu_torch.io import pqr
    from mpmc_tpu_torch.mc import metropolis, run
    from mpmc_tpu_torch.parallel import multichain
    F = metropolis.frozen_refresh_rows(su.params, su.cfg)

    def clock(fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    if states is None:
        refresh = clock(lambda: metropolis.initialize(
            su.state, su.params, su.cfg, su.thermo, frozen_rows=F))
        obs = clock(lambda: run.observables(su, su.state))
    else:
        refresh = clock(lambda: multichain.initialize_batched(
            states, su.params, su.cfg, su.thermo, frozen_rows=F))
        obs = clock(lambda: run.observables_batched(
            su, states, states.pos.shape[0]))
    with tempfile.TemporaryDirectory() as tmp:
        restart = clock(lambda: pqr.write_state(
            os.path.join(tmp, "r.pqr"), su.params, su.state,
            su.species_names, wrap=True))
    log(f"block breakdown {label}: refresh {refresh * 1e3:.2f} ms, "
        f"observables {obs * 1e3:.2f} ms, restart write "
        f"{restart * 1e3:.2f} ms (host clock)")
    return {"refresh_ms": refresh * 1e3, "observables_ms": obs * 1e3,
            "restart_ms": restart * 1e3}


def phase_fused_chains(device, chains=32, numsteps=20000):
    """The fused µVT path at the reference's headline width: the bench
    deck with fused_mc on and chains 32; bookkeeping of chain 0 and of
    the last chain after a further chunk."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.state import slice_chain
    su, avgs, text, launches = _run_deck(
        device, f"fused_mc on\nchains {chains}\n", numsteps=numsteps)
    if not launches["run_steps_uvt"] > 0:
        raise AssertionError(f"B1 was not launched: {launches}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k fused c{chains}: {rate:.2f} steps/s aggregate, <N> "
        f"{avgs.mean('N'):.3f}")
    g = torch.Generator(device=device).manual_seed(17)
    sts, _ = metropolis.run_chunk_fused_uvt_multi(
        su.states, su.params, su.cfg, su.thermo, 1000, generator=g)
    for c in (0, chains - 1):
        _check_bookkeeping(f"fused c{chains} chain {c}, 1000 steps",
                           slice_chain(sts, c), su)
    _block_breakdown(device, su, f"fused c{chains}", states=su.states)
    return launches, rate, su


def _profile(label, chunk, n_steps, device, kernel=None):
    """One untraced run of ``chunk`` for the rate, then a torch.profiler
    run for device busy time by kernel; ``kernel``: a substring of a
    kernel's name whose share of the device time is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed():
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    timed()
    wall = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_traced = timed()
    # device-side events only (kernels, memcpy, memset): CPU ops also
    # carry the device time of the kernels they launched
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for _, _, t in dev)
    launches = sum(c for _, c, _ in dev)
    out = {"path": label, "steps": n_steps,
           "ms_per_step": 1e3 * wall / n_steps,
           "ms_per_step_traced": 1e3 * wall_traced / n_steps,
           "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
           "device_busy_share": busy_us / 1e6 / wall,
           "device_busy_share_traced": busy_us / 1e6 / wall_traced,
           "device_ops_per_step": launches / n_steps,
           "device_ops_per_chunk": launches,
           "top": [{"kernel": k[:90], "count": c, "ms": t / 1e3}
                   for k, c, t in sorted(dev, key=lambda x: -x[2])[:10]]}
    if kernel is not None:
        out["kernel_share"] = (sum(t for k, _, t in dev if kernel in k)
                               / max(busy_us, 1e-30))
    log("profile " + json.dumps(out))
    if busy_us <= 0:
        log("profile: the profiler recorded no device time")
    return out


def phase_profile(device, su, n_steps=500):
    """Where a scan-path GCMC step's time goes, and the check that a step
    makes no host sync."""
    from mpmc_tpu_torch.mc import metropolis
    g = torch.Generator(device=device).manual_seed(5)
    out = _profile("scan", lambda: metropolis.run_chunk(
        su.state, su.params, su.cfg, su.thermo, n_steps, generator=g),
        n_steps, device)
    # a step makes no host sync: torch raises on any synchronizing call
    step, carry, c, branch, stats = metropolis.chunk_setup(
        su.state, su.params, su.cfg, su.thermo,
        metropolis.draw_uniforms(g, 200, su.cfg.tdtype))
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(200):
            step(carry, carry["u"][k], int(branch[k]), su.thermo, c, stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"no host sync in 200 steps (branches {np.bincount(branch)})")
    return out


def phase_profile_fused(device, su, n_steps=1000, states=None):
    """Where a fused chunk's time goes: one launch of the fused kernel (B3
    for an nvt/nve Setup, else B1) plus the per-corrtime refresh, as
    run_mc runs them for one chain, or as run_mc_chains runs them for the
    stacked ``states``; with the kernel's share of the device time."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    g = torch.Generator(device=device).manual_seed(6)
    F = metropolis.frozen_refresh_rows(su.params, su.cfg)
    nvt = su.cfg.ensemble in ("nvt", "nve")
    if nvt:
        tables = metropolis.nvt_fused_tables(su.params, su.state.mol_alive)
        single, multi = (metropolis.run_chunk_fused,
                         metropolis.run_chunk_fused_multi)
    else:
        tables = metropolis.uvt_fused_tables(su.params, su.cfg)
        single, multi = (metropolis.run_chunk_fused_uvt,
                         metropolis.run_chunk_fused_uvt_multi)

    def chunk():
        if states is None:
            st, _ = single(su.state, su.params, su.cfg, su.thermo, n_steps,
                           generator=g, tables=tables)
            metropolis.initialize(st, su.params, su.cfg, su.thermo,
                                  frozen_rows=F)
        else:
            sts, _ = multi(states, su.params, su.cfg, su.thermo, n_steps,
                           generator=g, tables=tables)
            multichain.initialize_batched(sts, su.params, su.cfg,
                                          su.thermo, frozen_rows=F)

    label = ("fused_nvt" if nvt else "fused") + (
        "" if states is None else f"_c{states.pos.shape[0]}")
    return _profile(label, chunk, n_steps, device,
                    kernel="nvt_kernel" if nvt else "uvt_kernel")


def phase_example(device, numsteps=5000):
    """examples/h2_sorption.inp with numsteps overridden, in a temp dir."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run
    job = input_script.parse_file(os.path.join(REPO, "examples",
                                               "h2_sorption.inp"))
    job = dataclasses.replace(
        job, cfg=dataclasses.replace(job.cfg, numsteps=numsteps),
        pqr_input=os.path.join(REPO, job.pqr_input))
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            buf = io.StringIO()
            _, avgs = run.run(job, log=buf, device=device)
            made = sorted(os.listdir("."))
        finally:
            os.chdir(old)
    text = buf.getvalue()
    log("\n".join(text.splitlines()[-4:]))
    for f in ("restart.pqr", "traj.pqr", "h2_density.dx"):
        if f not in made:
            raise AssertionError(f"h2_sorption.inp did not write {f}")
    if "=== averages ===" not in text or not np.isfinite(avgs.mean("N")):
        raise AssertionError("h2_sorption.inp averages missing")
    log(f"h2_sorption.inp: {numsteps} steps, <N> {avgs.mean('N'):.3f}")


def main():
    dev, smi = phase_device()
    sys.path.insert(0, REPO)
    t0 = time.time()
    build_s = phase_build()
    report = phase_kernels(dev)
    report["run_steps_uvt"] = phase_uvt_kernel(dev)
    report["run_steps"] = phase_nvt_kernel(dev)
    report.update(phase_thole_kernel(dev))
    report["run_steps_uvt_pda"] = phase_pda_kernel(dev)
    phase_energy(dev)
    scan_launches, rate, su = phase_main(dev)
    prof_scan = phase_profile(dev, su)
    phase_example(dev)
    fused_launches, fused_rate, su_f, kernel_us = phase_fused(dev)
    prof_fused = phase_profile_fused(dev, su_f)
    chain_launches, chains_rate, su_c = phase_fused_chains(dev)
    prof_chains = phase_profile_fused(dev, su_c, states=su_c.states)
    nvt_launches, nvt_rates, nvt_sus = phase_fused_nvt(dev)
    prof_nvt = phase_profile_fused(dev, nvt_sus["mof_nvt"])
    su16 = nvt_sus["mof_nvt_c16"]
    prof_nvt16 = phase_profile_fused(dev, su16, states=su16.states)
    polar_launches, polar_reps = phase_polar(dev)
    pda_launches, pda_reps = phase_pda_decks(dev)
    # each kernel's launches on its own main path: B2 and B4 on the scan
    # path, B1 on the fused single-chain µVT path, B3 on the single-chain
    # MOF NVT deck, B5 (both modes) on the polar scan-path deck, B6 on the
    # direct fused PDA deck
    launches = {"pair_terms": scan_launches["pair_terms"],
                "mol_pair": scan_launches["mol_pair"],
                "run_steps_uvt": fused_launches["run_steps_uvt"],
                "run_steps": nvt_launches["mof_nvt"]["run_steps"],
                "dipole_field": polar_launches["polar"]["dipole_field"],
                "charge_field": polar_launches["polar"]["charge_field"],
                "run_steps_uvt_pda": pda_launches["pda"]["run_steps_uvt_pda"]}
    names = ("pair_terms", "mol_pair", "run_steps_uvt", "run_steps",
             "dipole_field", "charge_field", "run_steps_uvt_pda")
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"],
                "device_ms": report[name]["device_ms"],
                "plain_ms": report[name]["plain_ms"],
                "bound_ms": report[name]["bound_ms"],
                "bound_by": report[name]["bound_by"],
                "library_ms": None}
               for name in names]
    for kern in kernels:       # B1 and B3: the cluster size of each timing
        if "cluster" in report[kern["name"]]:
            kern["cluster"] = report[kern["name"]]["cluster"]
    log(f"launches per path: scan {scan_launches}, fused {fused_launches}, "
        f"fused chains {chain_launches}, fused nvt {nvt_launches}")
    log(f"build_seconds {build_s:.1f}  scan_steps_per_sec {rate:.2f}  "
        f"fused_steps_per_sec {fused_rate:.2f}  "
        f"fused_c32_steps_per_sec {chains_rate:.2f}  "
        f"b1_kernel_us_per_step {kernel_us * 1e3:.2f}  "
        f"b1_c32_kernel_us_per_step "
        f"{report['run_steps_uvt']['c32']['ms'] * 1e3:.2f}  "
        f"fused_device_busy {prof_fused['device_busy_share']:.4f}  "
        f"fused_c32_device_busy {prof_chains['device_busy_share']:.4f}  "
        f"scan_device_busy {prof_scan['device_busy_share']:.4f}")
    b3 = report["run_steps"]
    log("  ".join(f"{k}_steps_per_sec {v:.2f}" for k, v in nvt_rates.items())
        + f"  b3_kernel_us_per_step mof {b3['mof']['ms'] * 1e3:.2f}"
        f" lj {b3['lj']['ms'] * 1e3:.2f}"
        f" c16 {b3['mof']['c16']['ms'] * 1e3:.2f}"
        f"  fused_nvt_device_busy {prof_nvt['device_busy_share']:.4f}"
        f" (b3 share {prof_nvt['kernel_share']:.4f})"
        f"  fused_nvt_c16_device_busy {prof_nvt16['device_busy_share']:.4f}"
        f" (b3 share {prof_nvt16['kernel_share']:.4f})"
        f"  wall_seconds {time.time() - t0:.1f}")
    log("  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_cg_iters_"
                  f"per_step {r['cg_iters_per_step']:.3f}  {k}_device_busy "
                  f"{r['device_busy_share']:.4f}" for k, r in
                  polar_reps.items())
        + f"  polar_launches {polar_launches}"
        + f"  wall_seconds {time.time() - t0:.1f}")
    b6 = report["run_steps_uvt_pda"]
    log("  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_cg_iters_"
                  f"per_step {r['cg_iters_per_step']:.3f}  {k}_b6_launches_"
                  f"per_step {r['b6_launches_per_step']:.3f}  {k}_device_busy "
                  f"{r['device_busy_share']:.4f}  {k}_b6_share "
                  f"{r['b6_share']:.4f}" for k, r in pda_reps.items())
        + f"  b6_kernel_us_per_step {b6['ms'] * 1e3:.2f}"
        + f"  b6_device_us_per_step {b6['device_ms'] * 1e3:.2f}"
        + f"  b6_cluster {b6['cluster']}"
        + f"  b6_kernel_ms_per_launch {b6['launch_ms']:.4f}"
        + f"  pda_launches {pda_launches}"
        + f"  wall_seconds {time.time() - t0:.1f}")
    b2 = report["pair_terms"]
    log(f"b2_ms_row_start_F {b2['ms']:.4f}  b2_device_ms_row_start_F "
        f"{b2['device_ms']:.4f}  b2_ms_full {b2['full']['ms']:.4f}  "
        f"b2_device_ms_full {b2['full']['device_ms']:.4f}  b2_tiles "
        f"{b2['tiles']} / {b2['full']['tiles']}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
