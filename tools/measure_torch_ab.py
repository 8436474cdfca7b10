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
chip_smoke.py); ``--compare-phases`` prints these files too.  It then
runs the checkout's ``phase_pda_kernel`` and keeps every output of B6
(run_steps_uvt_pda) in launch order in <out.json>.b6.pt;
``--compare-phases`` fails unless all files' B6 outputs are equal bit for
bit.
"""
from __future__ import annotations

import inspect
import re
import sys
import time

import numpy as np

C32_STEPS = 20000
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

    def time(label, launch, args, kw):
        # ms per 1000-step launch = us per step
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
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
    # B6's outputs on phase 4d's tables, in launch order
    recs, b6 = [], mk.run_steps_uvt_pda

    def recording(*a, **kw):
        rec = b6(*a, **kw)
        recs.append(rec.cpu())
        return rec

    # the wrapper counts its launches on the name it is bound to
    recording.launches = b6.launches
    mk.run_steps_uvt_pda = recording
    try:
        cs.phase_pda_kernel(dev)
    finally:
        mk.run_steps_uvt_pda = b6
    torch.save(recs, out + ".b6.pt")


def _report_phases(label, r):
    if "us" in r:
        print(f"{label} ({r['card']}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["us"].items()) + " us/step")
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
    elif sys.argv[1] == "--compare-phases":
        import json
        import os

        import torch
        b6 = {p: torch.load(p + ".b6.pt") for p in sys.argv[2:]
              if os.path.exists(p + ".b6.pt")}
        for p in sys.argv[2:]:
            with open(p) as f:
                _report_phases(p, json.load(f))
        if b6:
            first = next(iter(b6.values()))
            same = all(len(r) == len(first)
                       and all(torch.equal(a, b) for a, b in zip(r, first))
                       for r in b6.values())
            print(f"B6: {len(first)} outputs per file, "
                  + ("equal bit for bit" if same else "DIFFER"))
            if not same:
                raise SystemExit(1)
    else:
        measure(sys.argv[1], sys.argv[2])
