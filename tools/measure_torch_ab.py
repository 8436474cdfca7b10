"""Two checkouts of the PyTorch/CUDA port on one card, each through its own
chip_smoke.py: B1's outputs bit for bit with its time per step, and where
a block of the fused µVT ``chains 32`` deck spends its time.

    python tools/measure_torch_ab.py <checkout> <out.pt>
    python tools/measure_torch_ab.py --compare <a.pt> <b.pt> [...]

The first form puts <checkout> first on sys.path and imports its
``chip_smoke`` and ``mpmc_tpu_torch`` (the kernels build into
<checkout>/build/).  It then

- runs B1 (run_steps_uvt) on the injected table of chip_smoke's
  phase_uvt_kernel (its 10.8k bench system and numpy-seeded [C, K, 16]
  table, float64 and float32), keeps the outputs, and times B1 with
  chip_smoke.time_calls: 10 launches of K steps at C = 1, f32, per step;
- runs chip_smoke's c32 deck (DECK with ``fused_mc on`` and ``chains
  32``, C32_STEPS steps) as it is, for run_mc_chains' own steps/sec, with
  chip_smoke's block breakdown measured apart; then once more with every
  call of the block loop (the chunk, the refresh, the observables, the
  statistics' copy to the host, the log line, the restart and trajectory
  writes) timed on the host clock between device synchronizations.  The
  block's time less the sum of those calls is what the loop spends
  elsewhere.

The second form checks that B1's outputs in every file equal the first
file's bit for bit, and prints each file's numbers in the order given
(run parent, change, change, parent in one call to compare two versions
on one card).  Needs a CUDA device.

    python tools/measure_torch_ab.py --phases <checkout> <out.json>
    python tools/measure_torch_ab.py --compare-phases <a.json> [...]

The third form builds <checkout>'s kernels with its own
``chip_smoke.phase_build`` (ptxas's register, shared-memory and spill
lines kept) and runs its ``phase_uvt_kernel`` and ``phase_nvt_kernel``,
which check B1 and B3 against their plain versions and time them (B1
at C = 1, B3 on the MOF + H2 system and the LJ fluid, f32, per step);
the fourth prints those times and ptxas lines side by side.

    python tools/measure_torch_ab.py --times <checkout> <out.json>

The fifth times <checkout>'s B1 and B3 the same way in any checkout,
through its own wrappers at their default launch shape (CUDA events,
median of 5 launches of 1000 steps, float32, per step): B1 on the 10.8k
bench system at C = 1 and 32 chains, B3 on the 10.0k MOF + H2 system at
C = 1 and 16 chains and on the 10k LJ fluid at C = 1 (the systems of its
chip_smoke.py), keeping each launch's outputs in <out.json>.b13.pt and
the classical B1, B3, B6 and pair libraries' ptxas lines in <out.json>;
the classical B2's outputs (row_start F and 0) and B4's (phase 3's rows),
float64 and float32, in <out.json>.b24.pt, with B2's ms per call and on
the card alone; ``--compare-phases`` prints these files too and fails
unless the B1 and B3 outputs are equal bit for bit (B3's sums on the
columns both checkouts return), B2's and B4's too, and the ptxas lines of
every library all the files keep are identical.  It then
runs the checkout's ``phase_pda_kernel`` and keeps every output of B6
(run_steps_uvt_pda) in launch order, but for its timing launches, in
<out.json>.b6.pt;
``--compare-phases`` fails unless all files' B6 outputs are equal bit for
bit.

    python tools/measure_torch_ab.py --kernels <checkout> <out.json> [--decks]
        [--scan-decks] [--polar-chains]
    python tools/measure_torch_ab.py --compare-kernels <a.json> [...]

The sixth form times <checkout>'s B4 and B5 through its own wrappers on
its chip_smoke.py's inputs (float32): B4 on phase 3's rows (an H2's
current rows and a trial beside the framework), B5 in both modes on phase
4c's polar system, dense and at rc 14 A culled.  Each call is timed
around the wrapper (chip_smoke.time_calls: CUDA events, median of 20;
for a wrapper that takes a plan, with the plan built once as solve_scf
does, and without) and on the card alone (n back-to-back calls between
one pair of events, queued behind a spin kernel so that the card runs
them with no host gap), beside an empty kernel timed the same way (the
launch floor).  B4's outputs (float64 and float32) are kept in
<out.json>.b4.pt, B5's (float32, both modes, dense and culled) in
<out.json>.b5.pt.  With --decks it also runs the checkout's polar decks
(phase_polar) and fused polar DA decks (phase_pda_decks) and keeps their
steps/s, CG iterations per step and kernel shares; with --scan-decks it
runs SCAN_DECKS (chip_smoke's scan-path GCMC deck, fused single-chain µVT
deck and LJ NVT deck, through its _run_deck) and keeps their steps/s and
launches; with --polar-chains it runs the checkout's polar ``chains 8``
decks (phase_polar_chains) and keeps their steps/s, CG rounds and
iterations, host syncs and B5 share.  Each call is also
timed on the host alone (n calls with no device sync between them), and
one cold SCF solve (thole.solve_scf from zero, dense and with the culled
CG at rc 14 A) on the host clock with a device sync.  The seventh form
prints the files side by side and fails unless B4's outputs, and B5's
where every file has them, are equal bit for bit in all of them.

    python tools/measure_torch_ab.py --scan-decks <checkout> <out.json>

The eighth form runs only SCAN_DECKS in <checkout> and prints their
steps/s, for many runs in turns.

    python tools/measure_torch_ab.py --same-sass <lib_a.so> <lib_b.so> [...]

The ninth form holds two builds of a kernel library to the same machine
code (cuobjdump -sass, line by line; the source's name and the anonymous
namespace's per-build hash in the function names left out): a header
edited in comments only (csrc/thole_common.cuh for B6's pda_kernel)
leaves the kernel as it was.

    python tools/measure_torch_ab.py --b6-b2 <checkout> <out.json> [--decks]
    python tools/measure_torch_ab.py --compare-b6-b2 <a.json> [...]

The tenth form times <checkout>'s B6 and B2 through its own wrappers on
its chip_smoke.py's inputs (float32), per call (chip_smoke.time_calls:
CUDA events, median of 20) and on the card alone (back-to-back calls
behind a spin kernel): B6 per step of a 16-step launch on phase 4d's
polar system under the direct field, on a survivor-free table found with
the plain version (the same table in any checkout), with the cluster
size its wrapper ran; B2 at row_start F and at 0 on phase 3's bench
system.  It keeps ptxas's register and spill lines of the pair, B6, B1
and B3 libraries and B4's outputs on phase 3's rows (float64 and
float32, <out.json>.b4.pt).  With --decks it also runs the checkout's
fused polar DA decks (phase_pda_decks: (d) direct, (e) polar_wolf, (f)
cutoff 14) and its scan-path GCMC deck (SCAN_DECKS' first) for their
steps/s.  The eleventh form prints the files side by side and fails
unless B4's outputs are equal bit for bit in all of them; B1 and B3 are
held to the same machine code with --same-sass.

    python tools/measure_torch_ab.py --pda-small <checkout> <out.pt>
    python tools/measure_torch_ab.py --compare-pda-small <a.pt> [...]

The twelfth form runs <checkout>'s B6 in float32 on the 56-site polar
MOF + H2 system of tests/test_torch_cuda.py (a 12 A cell; at G = 16 its
last two ranks hold no column) for the direct, polar_wolf and
polar_ewald fields and nvt, on PDA_SMALL_TABLES tables per field whose
step 0 survives (numpy-seeded, the same in any checkout), at the
wrapper's own G and, where the wrapper takes cluster=, at each G of
2, 4, 8, 16; it keeps each record and the plain version's.  The
thirteenth form holds every file's tables and plain records equal to
the first's, prints, for each stage-1 survivor, the kernel's and the
plain version's d_rec, the float32 rule's tolerance (_pda_agree in
tests/test_torch_cuda.py), the largest difference of their trial rows
in float32 ulps, and d_rec recomputed from each record's own trial rows
(the plain version's reciprocal term, in float32 and in float64); and
says which records equal the first file's bit for bit.
"""
from __future__ import annotations

import inspect
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C32_STEPS = 20000
# (label, extra deck lines, steps, system) of --scan-decks: chip_smoke's
# scan-path GCMC deck, its fused single-chain µVT deck and the LJ NVT deck
SCAN_DECKS = (("scan", "", 3000, "mof"),
              ("fused_uvt", "fused_mc on\n", 20000, "mof"),
              ("lj_nvt", "fused_mc on\n", 20000, "lj"))
# --pda-small: tables per field, and the fields (tests/test_torch_cuda.py's
# PDA_FIELDS and nvt)
PDA_SMALL_TABLES = 12
PDA_SMALL_FIELDS = {"direct": {}, "wolf": {"polar_wolf": True},
                    "ewald": {"polar_ewald": True}, "nvt": {"ensemble": "nvt"}}
# (owner, attribute) of each call of run_mc_chains' block loop
STAGES = (("metropolis", "run_chunk_fused_uvt_multi"),
          ("multichain", "initialize_batched"),
          ("run", "observables_batched"),
          ("MCStats", "host"),
          ("RunWriter", "log_block"),
          ("RunWriter", "write_restart"),
          ("RunWriter", "write_parallel_restarts"),
          ("RunWriter", "append_trajectory"),
          ("RunWriter", "append_parallel_trajectories"))


def _b1(cs, dev, saved):
    import torch

    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    table = inspect.signature(cs.phase_uvt_kernel).parameters
    C, K, seed = (table[k].default for k in ("C", "K", "seed"))
    u_np = np.random.default_rng(seed).random((C, K, 16))
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = cs.bench_system(dtype, dev)
        state = metropolis.initialize(state, params, cfg, thermo)
        tables = metropolis.uvt_fused_tables(params, cfg)
        u = torch.as_tensor(u_np, dtype=cfg.tdtype, device=dev)
        args, kw = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, C), params, cfg, thermo, u,
            tables)
        for i, x in enumerate(mk.run_steps_uvt(*args, **kw)):
            saved[f"b1/{dtype}/{i}"] = x.cpu()
    a1, kw1 = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, 1), params, cfg, thermo, u[:1],
        tables)
    saved["b1_us_per_step"] = cs.time_calls(
        lambda: mk.run_steps_uvt(*a1, **kw1), dev, n=10) / K * 1e3


def _timed(fn, key, spent, dev):
    import torch

    def wrapped(*a, **k):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize(dev)
        n, t = spent.get(key, (0, 0.0))
        spent[key] = (n + 1, t + time.perf_counter() - t0)
        return out
    return wrapped


def _c32(cs, dev, saved):
    from mpmc_tpu_torch.io import output
    from mpmc_tpu_torch.mc import metropolis, run
    from mpmc_tpu_torch.parallel import multichain
    extra = "fused_mc on\nchains 32\n"
    n_blocks = C32_STEPS // 1000

    def deck():
        su, _, text, _ = cs._run_deck(dev, extra, numsteps=C32_STEPS)
        rate = float(text.split("steps/sec:")[1].split()[0])
        wall = float(re.search(r"steps in ([0-9.]+)s\)", text).group(1))
        return su, rate, wall / n_blocks * 1e3

    su, saved["c32_steps_per_sec"], saved["c32_block_ms"] = deck()
    saved["c32_apart_ms"] = cs._block_breakdown(dev, su, "c32",
                                                states=su.states)
    owners = {"metropolis": metropolis, "multichain": multichain,
              "run": run, "MCStats": metropolis.MCStats,
              "RunWriter": output.RunWriter}
    spent, originals = {}, []
    for owner, name in STAGES:
        fn = getattr(owners[owner], name)
        originals.append((owners[owner], name, fn))
        setattr(owners[owner], name,
                _timed(fn, f"{owner}.{name}", spent, dev))
    try:
        _, saved["c32_timed_steps_per_sec"], block = deck()
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    stages = {k: (n, t / n_blocks * 1e3) for k, (n, t) in spent.items()}
    saved["c32_timed_block_ms"] = block
    saved["c32_stages_ms"] = stages
    saved["c32_rest_ms"] = block - sum(t for _, t in stages.values())


def measure(checkout, out):
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    import torch
    dev, smi = cs.phase_device()
    saved = {"card": smi}
    _b1(cs, dev, saved)
    _c32(cs, dev, saved)
    torch.save(saved, out)
    _report(checkout, saved)


def measure_phases(checkout, out):
    import json
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from mpmc_tpu_torch.ops.cuda import _build
    dev, smi = cs.phase_device()
    cs.phase_build()
    ptxas = {}
    for name in ("uvt_kernel", "nvt_kernel"):
        text = _build.target(name).with_suffix(".ptxas.txt").read_text()
        ptxas[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
    b1, b3 = cs.phase_uvt_kernel(dev), cs.phase_nvt_kernel(dev)
    r = {"card": smi, "b1_us": b1["ms"] * 1e3,
         "b3_mof_us": b3["mof"]["ms"] * 1e3, "b3_lj_us": b3["lj"]["ms"] * 1e3,
         "ptxas": ptxas}
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    _report_phases(checkout, r)


def measure_times(checkout, out):
    import json

    import torch
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    dev, smi = cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng
    r = {"card": smi, "us": {}}

    outs = {}

    def time(label, launch, args, kw):
        # the launch's outputs (the classical instances' bits), then ms per
        # 1000-step launch = us per step
        outs[label] = [x.cpu() for x in launch(*args, **kw)
                       if x is not None]
        r["us"][label] = cs.time_calls(lambda: launch(*args, **kw), dev,
                                       n=5)
        print(f"{label}: {r['us'][label]:.3f} us per step", flush=True)

    params, state, cfg, thermo = cs.bench_system("float32", dev)
    state = metropolis.initialize(state, params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    for C in (1, 32):
        u = torch.as_tensor(rng(7 + C).random((C, 1000, 16)),
                            dtype=cfg.tdtype, device=dev)
        args, kw = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, C), params, cfg, thermo, u,
            tables)
        time(f"B1 C={C}", mk.run_steps_uvt, args, kw)
    for kind, chains in (("mof", (1, 16)), ("lj", (1,))):
        params, state, cfg, thermo = cs.nvt_system(kind, "float32", dev)
        tables = metropolis.nvt_fused_tables(params, state.mol_alive)
        for C in chains:
            u = torch.as_tensor(rng(7 + C).random((C, 1000, 16)),
                                dtype=cfg.tdtype, device=dev)
            args, kw = metropolis.fused_nvt_launch_args(
                multichain.stack_states(state, C), params, cfg, thermo, u,
                tables)
            time(f"B3 {kind} C={C}", mk.run_steps, args, kw)
    # the classical B2 (row_start F and 0) and B4 (phase 3's rows): outputs
    # in float64 and float32, B2's ms per call and on the card alone
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    b24 = _b4_outputs(cs, dev)
    r["b2_ms"] = {}
    for dtype in ("float64", "float32"):
        params, state, cfg, _ = cs.bench_system(dtype, dev)
        args = (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, state.atom_alive(params),
                params.mol_frozen[params.mol_id],
                pairs.pair_scalars(state.box, cfg), cfg)
        F = metropolis.frozen_refresh_rows(params, cfg)
        for label, rs in (("row_start F", F), ("full", 0)):
            b24[f"b2/{dtype}/{label}"] = pk.pair_terms(
                *args, row_start=rs).cpu()
            if dtype == "float32":
                r["b2_ms"][label] = {
                    "ms": cs.time_calls(lambda: pk.pair_terms(
                        *args, row_start=rs), dev),
                    "device_ms": _time_device(lambda: pk.pair_terms(
                        *args, row_start=rs), dev, 50)}
    from mpmc_tpu_torch.ops.cuda import _build
    r["ptxas"] = {}
    for name in ("uvt_kernel", "nvt_kernel", "pda_kernel", "pair_kernel"):
        text = _build.target(name).with_suffix(".ptxas.txt").read_text()
        r["ptxas"][name] = [ln.strip() for ln in text.splitlines()
                            if "registers" in ln or "spill" in ln]
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    torch.save(outs, out + ".b13.pt")
    torch.save(b24, out + ".b24.pt")
    # B6's outputs on phase 4d's tables, in launch order, leaving out the
    # launches its timings make (their number differs between checkouts,
    # and a back-to-back timing must not wait for a copy to the host)
    recs, b6, timing = [], mk.run_steps_uvt_pda, [False]

    def recording(*a, **kw):
        rec = b6(*a, **kw)
        if not timing[0]:
            recs.append(rec.cpu())
        return rec

    def untimed(fn):
        def wrapped(*a, **kw):
            timing[0] = True
            try:
                return fn(*a, **kw)
            finally:
                timing[0] = False
        return wrapped

    timers = {k: getattr(cs, k) for k in ("time_calls", "time_device")
              if hasattr(cs, k)}
    # the wrapper counts its launches on the name it is bound to
    recording.launches = b6.launches
    mk.run_steps_uvt_pda = recording
    for k, fn in timers.items():
        setattr(cs, k, untimed(fn))
    try:
        cs.phase_pda_kernel(dev)
    finally:
        mk.run_steps_uvt_pda = b6
        for k, fn in timers.items():
            setattr(cs, k, fn)
    torch.save(recs, out + ".b6.pt")


def _time_device(fn, dev, n):
    """ms per call of n back-to-back calls between one pair of CUDA events,
    queued behind a spin kernel so that the card runs them without a host
    gap (a longer spin if the card caught up with the host): chip_smoke's
    time_device, kept here for checkouts whose chip_smoke lacks it."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    spin = max(0.02, 3.0 * n * (time.perf_counter() - t0))
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * 2e9))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        ahead = not a.query()
        torch.cuda.synchronize(dev)
        if ahead:
            return a.elapsed_time(b) / n
        spin *= 4.0
    raise RuntimeError("the host did not queue ahead of the card")


def _host_ms(fn, dev, n=100):
    """Host ms per call of n calls made without a device sync between
    them (the wrapper's own time while the card keeps up)."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize(dev)
    return t * 1e3


def _scan_decks(cs, dev):
    """{deck: steps/s and launches} of SCAN_DECKS through chip_smoke's
    _run_deck (run.run's own steps/sec)."""
    r = {}
    for label, extra, steps, kind in SCAN_DECKS:
        _, _, text, launches = cs._run_deck(dev, extra, numsteps=steps,
                                            kind=kind)
        r[label] = {"steps_per_sec": float(
            text.split("steps/sec:")[1].split()[0]), "launches": launches}
    return r


def measure_scan_decks(checkout, out):
    import json

    sys.path.insert(0, checkout)
    import chip_smoke as cs
    dev, smi = cs.phase_device()
    cs.phase_build()
    r = {"card": smi, "decks": _scan_decks(cs, dev)}
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    print(f"{checkout} ({smi}): " + ", ".join(
        f"{k} {e['steps_per_sec']:.2f}" for k, e in r["decks"].items())
        + " steps/s")


def measure_kernels(checkout, out, decks, scan_decks, polar_chains=False):
    import dataclasses
    import json
    import statistics

    import torch
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.ops.cuda import _build
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    dev, smi = cs.phase_device()
    for name in _build.build():
        _build.library(name)
    r = {"card": smi, "b4": {}, "b5": {}, "ptxas": {}}
    for name in ("pair_kernel", "thole_kernel"):
        text = _build.target(name).with_suffix(".ptxas.txt").read_text()
        r["ptxas"][name] = [ln.strip() for ln in text.splitlines()
                            if "registers" in ln or "spill" in ln]
    r["null_device_ms"] = _time_device(lambda: torch.cuda._sleep(0), dev,
                                       200)
    saved = {}
    for dtype in ("float64", "float32"):
        params, state, cfg, _ = cs.bench_system(dtype, dev)
        alive = state.atom_alive(params)
        scal = pairs.pair_scalars(state.box, cfg)
        h2 = int(np.flatnonzero(
            (params.mol_species >= 0).cpu().numpy()
            & state.mol_alive.cpu().numpy())[0])
        near = state.pos[0] + torch.tensor([2.0, 0.31, 0.17],
                                           dtype=cfg.tdtype, device=dev)
        m = torch.tensor(h2, device=dev)
        for label, rows in (("H2", None),
                            ("trial", near + params.species_pos[0])):
            args = (state.pos, params.charge, params.eps, params.sig,
                    params.mol_id32, alive, params.mol_atoms,
                    params.mol_natoms, m, rows, scal, cfg)
            saved[f"b4/{dtype}/{label}"] = pk.mol_pair(*args).cpu()
            if dtype == "float32":
                r["b4"][label] = {
                    "ms": cs.time_calls(lambda: pk.mol_pair(*args), dev),
                    "device_ms": _time_device(lambda: pk.mol_pair(*args),
                                              dev, 200),
                    "host_ms": _host_ms(lambda: pk.mol_pair(*args), dev,
                                        400)}
    torch.save(saved, out + ".b4.pt")
    params, state, cfg, _ = cs.polar_system("float32", dev)
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    box, lam, kind = state.box, cfg.polar_damp, cfg.polar_damp_type
    mu = torch.where(pol_ok[:, None], state.mu, 0.0)
    rc = pairs.derived_cutoff(box, cfg)
    rc14 = torch.as_tensor(cs.RC_CULL, dtype=box.dtype, device=dev)
    planned = "plan" in inspect.signature(tk.dipole_field).parameters
    for mode, kern in (("dipole", tk.dipole_field),
                       ("charge", tk.charge_field)):
        ok, src = (pol_ok, mu) if mode == "dipole" else (alive,
                                                        params.charge)
        perm, _ = thole.cull_perm(state.pos, box, ok, rc14)
        pos_s = state.pos[perm].contiguous()
        vis = thole.cull_visit(pos_s, ok[perm], box, rc14)
        for label, args, v in (
                ("dense", (state.pos, box, ok, src, params.mol_id32, rc,
                           lam, kind), None),
                ("culled", (pos_s, box, ok[perm], src[perm].contiguous(),
                            params.mol_id32[perm], rc14, lam, kind), vis)):
            kw = {"ortho": True, "visit": v}
            saved[f"b5/{mode}/{label}"] = kern(*args, **kw).cpu()
            e = {"ms_unplanned": cs.time_calls(lambda: kern(*args, **kw),
                                               dev)}
            if planned:
                kw["plan"] = tk.plan(box, args[5], lam, args[0].shape[0], v)
            e["ms"] = cs.time_calls(lambda: kern(*args, **kw), dev)
            e["device_ms"] = _time_device(lambda: kern(*args, **kw), dev, 50)
            e["host_ms"] = _host_ms(lambda: kern(*args, **kw), dev)
            r["b5"][f"{mode} {label}"] = e
    torch.save({k: v for k, v in saved.items() if k.startswith("b5/")},
               out + ".b5.pt")
    # one cold SCF solve (CG from zero to the deck's precision), host
    # clock around it with a device sync, median of 10: dense at the
    # derived rc, and the culled CG at rc 14 A
    r["solve"] = {}
    for label, c in (("dense", cfg),
                     ("culled", dataclasses.replace(cfg,
                                                    cutoff=cs.RC_CULL))):
        def solve():
            return thole.solve_scf(state.pos, box, alive, params, c,
                                   state.e0)

        solve()
        ts = []
        for _ in range(10):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, iters, _ = solve()
            torch.cuda.synchronize(dev)
            ts.append((time.perf_counter() - t0) * 1e3)
        r["solve"][label] = {"ms": statistics.median(ts), "iters": iters}
    if decks:
        for what, phase in (("polar", cs.phase_polar),
                            ("pda", cs.phase_pda_decks)):
            launches, reps = phase(dev)
            r[what] = {k: {x: v.get(x) for x in (
                "steps_per_sec", "cg_iters_per_step",
                "chunk_cg_iters_per_step", "b5_launches_per_step",
                "b6_launches_per_step", "device_busy_share", "b5_share",
                "b6_share", "ms_per_step")} for k, v in reps.items()}
            r[what + "_launches"] = launches
    if scan_decks:
        r["decks"] = _scan_decks(cs, dev)
    if polar_chains:
        launches, reps = cs.phase_polar_chains(dev)
        r["polar_chains"] = {k: {x: v.get(x) for x in (
            "steps_per_sec", "cg_iters_per_chain_step",
            "chunk_cg_rounds_per_step", "host_syncs_per_step",
            "device_busy_share", "b5_share", "ms_per_step")}
            for k, v in reps.items()}
        r["polar_chains_launches"] = launches
    r["card_after"] = cs.phase_device()[1]
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    _report_kernels(checkout, r)


def _b4_outputs(cs, dev):
    """B4's outputs on phase 3's rows (an H2's current rows, a trial
    beside the framework), float64 and float32."""
    import torch

    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    saved = {}
    for dtype in ("float64", "float32"):
        params, state, cfg, _ = cs.bench_system(dtype, dev)
        alive = state.atom_alive(params)
        scal = pairs.pair_scalars(state.box, cfg)
        h2 = int(np.flatnonzero(
            (params.mol_species >= 0).cpu().numpy()
            & state.mol_alive.cpu().numpy())[0])
        near = state.pos[0] + torch.tensor([2.0, 0.31, 0.17],
                                           dtype=cfg.tdtype, device=dev)
        m = torch.tensor(h2, device=dev)
        for label, rows in (("H2", None),
                            ("trial", near + params.species_pos[0])):
            saved[f"b4/{dtype}/{label}"] = pk.mol_pair(
                state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, alive, params.mol_atoms, params.mol_natoms,
                m, rows, scal, cfg).cpu()
    return saved


def measure_b6_b2(checkout, out, decks):
    import dataclasses
    import json

    import torch
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import _build
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    dev, smi = cs.phase_device()
    for name in _build.build():
        _build.library(name)
    r = {"card": smi, "ptxas": {}, "b2": {}}
    for name in ("pair_kernel", "pda_kernel", "uvt_kernel", "nvt_kernel"):
        text = _build.target(name).with_suffix(".ptxas.txt").read_text()
        r["ptxas"][name] = [ln.strip() for ln in text.splitlines()
                            if "registers" in ln or "spill" in ln]
    torch.save(_b4_outputs(cs, dev), out + ".b4.pt")
    # B2 on phase 3's bench system, row_start F and the full pass
    params, state, cfg, _ = cs.bench_system("float32", dev)
    args = (state.pos, params.charge, params.eps, params.sig,
            params.mol_id32, state.atom_alive(params),
            params.mol_frozen[params.mol_id],
            pairs.pair_scalars(state.box, cfg), cfg)
    F = metropolis.frozen_refresh_rows(params, cfg)
    for label, rs in (("row_start F", F), ("full", 0)):
        r["b2"][label] = {
            "ms": cs.time_calls(lambda: pk.pair_terms(*args, row_start=rs),
                                dev),
            "device_ms": _time_device(
                lambda: pk.pair_terms(*args, row_start=rs), dev, 50)}
    # B6 on phase 4d's polar system, direct field, a survivor-free table
    params, state, cfg0, thermo = cs.polar_system("float32", dev)
    cfg = mk.pda_effective_cfg(dataclasses.replace(
        cfg0, polar_delayed=True, fused_mc=True), params)
    tables = metropolis.uvt_fused_tables(params, cfg)
    consts = metropolis._uvt_chunk_consts(state.pos, state.box, params,
                                          thermo, cfg, tables[5], tables[6])

    def args_of(u):
        return metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                          tables, consts)

    rng = np.random.default_rng(43)
    K = mk.PDA_SEG
    u = torch.as_tensor(rng.random((K, 16)), dtype=cfg.tdtype, device=dev)
    u = cs._pda_survivor_free(
        lambda uu: mk.run_steps_uvt_pda_plain(*args_of(uu)[0],
                                              **args_of(uu)[1]), u, rng)
    a, kw = args_of(u)
    rec = mk.run_steps_uvt_pda(*a, **kw)
    if float(rec[0, 0]) != K or float(rec[0, 1]) != 0.0:
        raise AssertionError(f"B6: the survivor-free table froze: {rec[0]}")
    r["b6"] = {
        "us_per_step": cs.time_calls(lambda: mk.run_steps_uvt_pda(*a, **kw),
                                     dev) / K * 1e3,
        "device_us_per_step": _time_device(
            lambda: mk.run_steps_uvt_pda(*a, **kw), dev, 20) / K * 1e3,
        "cluster": getattr(mk.run_steps_uvt_pda, "last_cluster", None)}
    if decks:
        launches, reps = cs.phase_pda_decks(dev)
        r["pda"] = {k: {x: v.get(x) for x in (
            "steps_per_sec", "cg_iters_per_step", "b6_launches_per_step",
            "device_busy_share", "b6_share")} for k, v in reps.items()}
        r["pda_launches"] = launches
        label, extra, steps, kind = SCAN_DECKS[0]
        _, _, text, launches = cs._run_deck(dev, extra, numsteps=steps,
                                            kind=kind)
        r["decks"] = {label: {"steps_per_sec": float(
            text.split("steps/sec:")[1].split()[0]), "launches": launches}}
    r["card_after"] = cs.phase_device()[1]
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    _report_b6_b2(checkout, r)


def _report_b6_b2(label, r):
    b6 = r["b6"]
    print(f"{label} ({r['card']}): B6 {b6['us_per_step']:.3f} us/step per "
          f"call, {b6['device_us_per_step']:.3f} on the card alone (G "
          f"{b6['cluster']}); B2 " + ", ".join(
              f"{k} {e['ms']:.4f} / {e['device_ms']:.4f} ms"
              for k, e in r["b2"].items()))
    for k, e in r.get("pda", {}).items():
        print(f"    {k}: " + ", ".join(f"{x} {v:.4f}" for x, v in e.items()
                                       if v is not None))
    for k, e in r.get("decks", {}).items():
        print(f"    {k}: {e['steps_per_sec']:.2f} steps/s")
    for name, lines in r["ptxas"].items():
        for ln in lines:
            print(f"    {name}: {ln}")


def _compare_outputs(paths):
    """Fail unless B4's kept outputs, and B5's where every file has
    them, are equal bit for bit in all of ``paths``."""
    import torch
    ok = True
    for name in ("b4", "b5"):
        if name == "b5" and not all(os.path.exists(p + ".b5.pt")
                                    for p in paths):
            continue
        outs = [torch.load(p + f".{name}.pt") for p in paths]
        same = all(b.keys() == outs[0].keys()
                   and all(torch.equal(b[k], outs[0][k]) for k in b)
                   for b in outs)
        print(f"{name.upper()}: {len(outs[0])} outputs per file, "
              + ("equal bit for bit" if same else "DIFFER"))
        ok = ok and same
    if not ok:
        raise SystemExit(1)


def compare_b6_b2(paths):
    import json

    import torch
    for p in paths:
        with open(p) as f:
            _report_b6_b2(p, json.load(f))
    _compare_outputs(paths)

def _drec_on_rows(sysd, rec, dt):
    """d_rec of the move in B6's record ``rec`` [8, 16] recomputed from
    the record's own trial rows (rows 2-4) with this tree's plain
    reciprocal term (mc_kernel.pda_rec_terms) in ``dt``, summed in
    float64; ``sysd``: the system's saved tensors."""
    import torch
    sys.path.insert(0, REPO)
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    mt, slot, spf = (int(rec[0, i]) for i in (2, 3, 4))
    start, na = int(sysd["slot_start"][slot]), int(sysd["natoms"][spf])
    new = torch.as_tensor(rec[2:5, :na].T)
    return float(mk.pda_rec_terms(
        sysd["pos"][start:start + na].to(dt), new.to(dt),
        sysd["charge"][start:start + na].to(dt), mt != 1, mt != 2,
        *(sysd[k].to(dt) for k in ("kvecs", "kcoef", "sk_re", "sk_im")))
        .double().sum())


def measure_pda_small(checkout, out):
    import dataclasses
    import inspect as _inspect

    import torch
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    dev, smi = cs.phase_device()
    forced = "cluster" in _inspect.signature(mk.run_steps_uvt_pda).parameters
    res = {"card": smi, "checkout": checkout, "systems": {}, "cases": []}
    for field, extra in PDA_SMALL_FIELDS.items():
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=3, n_h2=6, capacity=8, polarization=True,
            dtype="float32", device=dev)
        cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True,
                                  **extra)
        state = metropolis.initialize(systems.jittered(params, state, 5),
                                      params, cfg, thermo)
        if field == "nvt":
            thermo = thermo.replace(insert_probability=torch.zeros_like(
                thermo.insert_probability))
        cfg = mk.pda_effective_cfg(cfg, params)
        tables = metropolis.uvt_fused_tables(params, cfg)
        rng = np.random.default_rng(5)
        for i in range(PDA_SMALL_TABLES):
            x = rng.random((mk.PDA_SEG, 16))
            x[0, 4], x[0, 8] = 1e-30, (0.9, 0.1, 0.4)[i % 3]
            u = torch.as_tensor(x, dtype=cfg.tdtype, device=dev)
            a, kw = metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                               tables)
            trace = []
            plain = mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)
            if i == 0:
                res["systems"][field] = {
                    "pos": a[0].cpu(), "charge": a[4].cpu(),
                    "slot_start": a[8].cpu(), "natoms": a[12].cpu(),
                    **{k: kw[k].cpu() for k in ("kvecs", "kcoef", "sk_re",
                                                "sk_im")}}
            case = {"field": field, "table": i, "u": u.cpu(),
                    "plain": plain.cpu(), "rss": trace[-1].get("rss"),
                    "kernel": {}}
            for G in ((None, 2, 4, 8, 16) if forced else (None,)):
                rec = (mk.run_steps_uvt_pda(*a, **kw, cluster=G) if forced
                       else mk.run_steps_uvt_pda(*a, **kw)).cpu()
                key = str(getattr(mk.run_steps_uvt_pda, "last_cluster", 1)
                          if G is None else G) + ("*" if G is None else "")
                case["kernel"][key] = rec
            res["cases"].append(case)
    torch.save(res, out)


def compare_pda_small(paths):
    import torch
    runs = [torch.load(p) for p in paths]
    first = runs[0]
    for p, r in zip(paths, runs):
        same_in = len(r["cases"]) == len(first["cases"]) and all(
            torch.equal(c["u"], f["u"]) and torch.equal(c["plain"], f["plain"])
            for c, f in zip(r["cases"], first["cases"]))
        print(f"{p} ({r['card']}): tables and plain records "
              + ("equal to" if same_in else "DIFFER from") + f" {paths[0]}")
        if not same_in:
            raise SystemExit(1)
    eps = float(np.finfo(np.float32).eps)
    for ci, f in enumerate(first["cases"]):
        p = f["plain"].numpy()
        if p[0, 1] < 0.5:
            continue
        rss = np.asarray(f["rss"] or [0.0, 0.0, 0.0, 0.0])[2]
        want = p[1, 2]
        tol = 2e-5 * abs(want) + 1e-3 + 8 * eps * rss
        sysd = first["systems"][f["field"]]
        na = int(sysd["natoms"][int(p[0, 4])])
        pr32, pr64 = (_drec_on_rows(sysd, p, t)
                      for t in (torch.float32, torch.float64))
        print(f"{f['field']} table {f['table']} (move {int(p[0, 2])}): plain "
              f"d_rec {want:.6f}, tolerance {tol:.2e}; on its rows f32 "
              f"{pr32:.6f} f64 {pr64:.6f} (plain off {want - pr64:+.2e})")
        for p_, r in zip(paths, runs):
            for key, rec in r["cases"][ci]["kernel"].items():
                k = rec.numpy()
                if k[0, 1] < 0.5 or k[0, 0] != p[0, 0]:
                    print(f"    {p_} G {key}: stopped at {k[0, 0]} (plain "
                          f"{p[0, 0]}), hit {k[0, 1]}")
                    continue
                kr = k[2:5, :na].astype(np.float32)
                pr = p[2:5, :na].astype(np.float32)
                ulps = int(np.max(np.abs(kr.view(np.int32).astype(np.int64)
                                         - pr.view(np.int32)))) if na else 0
                k32, k64 = (_drec_on_rows(sysd, k, t)
                            for t in (torch.float32, torch.float64))
                bits = torch.equal(rec, first["cases"][ci]["kernel"].get(
                    key, torch.empty(0)))
                print(f"    {p_} G {key}: d_rec {k[1, 2]:.6f} (off "
                      f"{k[1, 2] - want:+.2e}, {abs(k[1, 2] - want) / tol:.2f}"
                      f" of the tolerance); rows off {ulps} ulp; on its rows "
                      f"f32 {k32:.6f} f64 {k64:.6f} (kernel off "
                      f"{k[1, 2] - k64:+.2e}; rows move f64 d_rec by "
                      f"{k64 - pr64:+.2e})"
                      + ("; same bits as the first file" if bits else ""))


def _report_kernels(label, r):
    print(f"{label} ({r['card']}): launch floor "
          f"{r['null_device_ms'] * 1e3:.2f} us")
    for k, e in list(r["b4"].items()) + list(r["b5"].items()):
        print(f"    {k}: " + ", ".join(f"{x} {v:.4f}" for x, v in e.items())
              + " ms")
    for k, e in r.get("solve", {}).items():
        print(f"    solve {k}: {e['ms']:.3f} ms, {e['iters']} iterations")
    for what in ("polar", "pda", "polar_chains"):
        for k, e in r.get(what, {}).items():
            print(f"    {k}: " + ", ".join(f"{x} {v:.4f}" for x, v in
                                           e.items() if v is not None))
    for k, e in r.get("decks", {}).items():
        print(f"    {k}: {e['steps_per_sec']:.2f} steps/s, launches "
              f"{e['launches']}")


def compare_kernels(paths):
    import json

    import torch
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
        _report_kernels(p, runs[-1])
    _compare_outputs(paths)


def same_sass(paths):
    """The machine code of kernel libraries (cuobjdump -sass) compared
    line by line, leaving out the source's name and the anonymous
    namespace's per-build hash in the function names."""
    import subprocess
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from mpmc_tpu_torch.ops.cuda import _build
    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))

    def sass(path):
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", ln)
                for ln in text.splitlines() if "identifier" not in ln]

    first = sass(paths[0])
    for p in paths[1:]:
        other = sass(p)
        print(f"{p}: {len(other)} SASS lines, "
              + ("identical to" if other == first else "DIFFER from")
              + f" {paths[0]} ({len(first)})")
        if other != first:
            raise SystemExit(1)


def _report_phases(label, r):
    if "us" in r:
        print(f"{label} ({r['card']}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["us"].items()) + " us/step"
            + "".join(f"; B2 {k} {e['ms']:.4f} / {e['device_ms']:.4f} ms"
                      for k, e in r.get("b2_ms", {}).items()))
        for name, lines in r.get("ptxas", {}).items():
            for ln in lines:
                print(f"    {name}: {ln}")
        return
    print(f"{label} ({r['card']}): B1 {r['b1_us']:.3f} us/step, B3 MOF "
          f"{r['b3_mof_us']:.3f}, LJ {r['b3_lj_us']:.3f}")
    for name, lines in r["ptxas"].items():
        for ln in lines:
            print(f"    {name}: {ln}")


def _report(label, r):
    print(f"{label} ({r['card']}): B1 {r['b1_us_per_step']:.3f} us/step; "
          f"c32 {r['c32_steps_per_sec']:.2f} chain-steps/s, block "
          f"{r['c32_block_ms']:.2f} ms, measured apart "
          + ", ".join(f"{k} {v:.2f}" for k, v in r["c32_apart_ms"].items()))
    print(f"    timed run: {r['c32_timed_steps_per_sec']:.2f} chain-steps/s,"
          f" block {r['c32_timed_block_ms']:.2f} ms = "
          + " + ".join(f"{k} {t:.2f} ({n} calls)"
                       for k, (n, t) in r["c32_stages_ms"].items())
          + f" + elsewhere {r['c32_rest_ms']:.2f}")


def compare(paths):
    import torch
    runs = [torch.load(p) for p in paths]
    keys = [k for k in runs[0] if k.startswith("b1/")]
    for p, r in zip(paths[1:], runs[1:]):
        same = all(torch.equal(runs[0][k], r[k]) for k in keys)
        print(f"{p}: B1 outputs {'equal' if same else 'DIFFER'} to "
              f"{paths[0]}")
        if not same:
            raise SystemExit(1)
    for p, r in zip(paths, runs):
        _report(p, r)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2:])
    elif sys.argv[1] == "--phases":
        measure_phases(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--times":
        measure_times(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--kernels":
        measure_kernels(sys.argv[2], sys.argv[3], "--decks" in sys.argv[4:],
                        "--scan-decks" in sys.argv[4:],
                        "--polar-chains" in sys.argv[4:])
    elif sys.argv[1] == "--scan-decks":
        measure_scan_decks(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--compare-kernels":
        compare_kernels(sys.argv[2:])
    elif sys.argv[1] == "--b6-b2":
        measure_b6_b2(sys.argv[2], sys.argv[3], "--decks" in sys.argv[4:])
    elif sys.argv[1] == "--compare-b6-b2":
        compare_b6_b2(sys.argv[2:])
    elif sys.argv[1] == "--pda-small":
        measure_pda_small(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--compare-pda-small":
        compare_pda_small(sys.argv[2:])
    elif sys.argv[1] == "--same-sass":
        same_sass(sys.argv[2:])
    elif sys.argv[1] == "--compare-phases":
        import json
        import os

        import torch
        b6 = {p: torch.load(p + ".b6.pt") for p in sys.argv[2:]
              if os.path.exists(p + ".b6.pt")}
        for p in sys.argv[2:]:
            with open(p) as f:
                _report_phases(p, json.load(f))
        b13 = {p: torch.load(p + ".b13.pt") for p in sys.argv[2:]
               if os.path.exists(p + ".b13.pt")}
        if b13:
            # B1's and B3's outputs on the timing tables; a checkout whose
            # B3 returns more sums columns is held on the columns both have
            first = next(iter(b13.values()))

            def same_out(a, b):
                if a.shape != b.shape and a.ndim == 2 and a.shape[0] == \
                        b.shape[0]:
                    n = min(a.shape[1], b.shape[1])
                    return torch.equal(a[:, :n], b[:, :n])
                return torch.equal(a, b)

            same = all(r.keys() == first.keys() and all(
                len(r[k]) == len(first[k]) and all(
                    same_out(a, b) for a, b in zip(r[k], first[k]))
                for k in first) for r in b13.values())
            print(f"B1 and B3: {len(first)} launches' outputs per file, "
                  + ("equal bit for bit" if same else "DIFFER"))
            if not same:
                raise SystemExit(1)
        if b6:
            first = next(iter(b6.values()))
            same = all(len(r) == len(first)
                       and all(torch.equal(a, b) for a, b in zip(r, first))
                       for r in b6.values())
            print(f"B6: {len(first)} outputs per file, "
                  + ("equal bit for bit" if same else "DIFFER"))
            if not same:
                raise SystemExit(1)
        b24 = [torch.load(p + ".b24.pt") for p in sys.argv[2:]
               if os.path.exists(p + ".b24.pt")]
        if b24:
            same = all(r.keys() == b24[0].keys() and all(
                torch.equal(r[k], b24[0][k]) for k in r) for r in b24)
            print(f"B2 and B4: {len(b24[0])} outputs per file, "
                  + ("equal bit for bit" if same else "DIFFER"))
            if not same:
                raise SystemExit(1)
        ptx = []
        for p in sys.argv[2:]:
            with open(p) as f:
                ptx.append(json.load(f).get("ptxas", {}))
        names = set.intersection(*(set(x) for x in ptx))
        same = all(x[n] == ptx[0][n] for x in ptx for n in names)
        print(f"ptxas lines of {sorted(names)}: "
              + ("identical in every file" if same else "DIFFER"))
        if not same:
            raise SystemExit(1)
    else:
        measure(sys.argv[1], sys.argv[2])
