"""Where a B1/B3 step's time goes on one card: the fused step loops built
with MC_PHASE_CLOCK=1 (csrc/mc_cluster.cuh), which adds up the clock64
cycles of each phase of a step on thread 0 of chain 0's first CTA.

    python tools/measure_step_phases.py <out.json>

Both libraries (uvt_kernel, nvt_kernel) build at once with the clock, one
nvcc each, beside the port's own build.  The systems are made once with
the port's own libraries: chip_smoke's 10.8k bench system (B1) and its
two NVT systems after their 2,000 warm-up steps (B3).  Then the port's
build, the clocked build and the port's build again are loaded in turn
(the first and last show the card's drift), and for each

- B1 on phase_uvt_kernel's [2, 256, 16] table and B3 on phase_nvt_kernel's
  (MOF + H2 and LJ fluid), float64 and float32, at G = 16 and at the
  smallest G that fits, against the plain version: the same decisions,
  and chip_smoke's tolerances (float64 sums rel 1e-10 or 1e-8 K,
  positions 1e-9 A; float32 sums 2e-5 rel + 2e-3 K sqrt(accepts + 1),
  positions 1e-4 A), and whether the outputs equal the port's build's
  bit for bit;
- times, float32, CUDA events, median of 5 launches of 1000 steps, per
  step: B1 at C = 1 and C = 32, B3 MOF at C = 1 and C = 16, B3 LJ at
  C = 1, each at the G the wrapper picks;
- ptxas's registers and spills of the two kernels;
- for the clocked build, the cycles per step of each phase of the timed
  launches.

Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("uvt_kernel", "nvt_kernel")
PHASES = ("uniforms", "pick", "barrier B wait", "row read", "trial",
          "pass+k-space+reduce", "exchange+barrier A", "acceptance",
          "commit+arrive")


def _build_clocked():
    """{name: library} of the port's build and of the clocked build."""
    from mpmc_tpu_torch.ops.cuda import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
        out = _build.BUILD_DIR / f"lib{name}_phase_clock.so"
        log = open(out.with_suffix(".ptxas.txt"), "w")
        procs[name] = (subprocess.Popen(
            _build.command(name, out, ["MC_PHASE_CLOCK=1"]), stdout=log,
            stderr=log), log, out)
    port = _build.build()           # the port's own libraries, meanwhile
    clocked = {}
    for name, (proc, log, out) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"{name} with MC_PHASE_CLOCK=1: nvcc failed\n"
                               + out.with_suffix(".ptxas.txt").read_text())
        clocked[name] = out
    return {name: port[name] for name in NAMES}, clocked


def _ptxas(path):
    """[(kernel, registers, spill stores)] from a ptxas -v report."""
    rows, name, spill = [], None, 0
    for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
        m = re.search(r"Function properties for (\S*(uvt|nvt)_kernelI([df]))",
                      line)
        if m:
            name = f"{m.group(2)}_{'f64' if m.group(3) == 'd' else 'f32'}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def _close(ks, ps, kpos, ppos, n_acc, f64):
    """The largest |kernel - plain| of the sums over its tolerance, and of
    the positions over theirs (<= 1 passes)."""
    tol = (np.maximum(1e-10 * np.abs(ps), 1e-8) if f64 else
           2e-5 * np.abs(ps) + 2e-3 * np.sqrt(n_acc + 1.0))
    d_pos = float((kpos - ppos).abs().max())
    return max(float(np.max(np.abs(ks - ps) / tol)),
               d_pos / (1e-9 if f64 else 1e-4))


def main():
    out_path = sys.argv[1]
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import _build
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    dev, smi = cs.phase_device()
    port, clocked = _build_clocked()
    rng = np.random.default_rng

    # the systems and plain results, once, with the port's own libraries
    b1, b3 = {}, {}
    u1 = rng(2024).random((2, 256, 16))
    u3 = rng(2025).random((2, 256, 16))
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = cs.bench_system(dtype, dev)
        state = metropolis.initialize(state, params, cfg, thermo)
        tables = metropolis.uvt_fused_tables(params, cfg)

        def uvt_args(C, u, params=params, state=state, cfg=cfg,
                     thermo=thermo, tables=tables):
            return metropolis.fused_uvt_launch_args(
                multichain.stack_states(state, C), params, cfg, thermo,
                torch.as_tensor(u, dtype=cfg.tdtype, device=dev), tables)

        args, kw = uvt_args(2, u1)
        b1[dtype] = (args, kw, mk.run_steps_uvt_plain(*args, **kw), uvt_args)
        for kind in ("mof", "lj"):
            params, state, cfg, thermo = cs.nvt_system(kind, dtype, dev)
            tables = metropolis.nvt_fused_tables(params, state.mol_alive)

            def nvt_args(C, u, params=params, state=state, cfg=cfg,
                         thermo=thermo, tables=tables):
                return metropolis.fused_nvt_launch_args(
                    multichain.stack_states(state, C), params, cfg, thermo,
                    torch.as_tensor(u, dtype=cfg.tdtype, device=dev),
                    tables)

            args, kw = nvt_args(2, u3)
            b3[(kind, dtype)] = (args, kw, mk.run_steps_plain(*args, **kw),
                                 nvt_args)

    results, outputs0 = [], {}
    for build, paths in (("port", port), ("clocked", clocked),
                         ("port", port)):
        for name in NAMES:
            _build.load(name, paths[name])
        mk.occupancy.clear()
        r = {"build": build, "ptxas": [_ptxas(paths[nm]) for nm in NAMES],
             "checks": {}, "us": {}, "phase_cycles": {}}
        outputs = {}
        for dtype, (args, kw, p, _) in b1.items():
            f64 = dtype == "float64"
            n, nk, ms = args[0].shape[1], kw["kvecs"].shape[0], \
                args[6].shape[0]
            for G in (16, mk.fitting_cluster_sizes(n, args[0].dtype, nk,
                                                   ms)[0]):
                k = mk.run_steps_uvt(*args, **kw, cluster=G)
                outputs[f"B1 {dtype} G={G}"] = [x.cpu() for x in k]
                ks, ps = k[2].cpu().numpy(), p[2].cpu().numpy()
                same = (np.array_equal(ks[:, 6:12], ps[:, 6:12])
                        and torch.equal(k[1], p[1]))
                r["checks"][f"B1 {dtype} G={G}"] = (same, _close(
                    ks[:, :6], ps[:, :6], k[0], p[0],
                    ps[:, 6:9].sum(1, keepdims=True), f64))
        for (kind, dtype), (args, kw, p, _) in b3.items():
            f64 = dtype == "float64"
            nk = kw["kvecs"].shape[0] if kw["kvecs"] is not None else 0
            for G in (16, mk.fitting_cluster_sizes(args[0].shape[1],
                                                   args[0].dtype, nk)[0]):
                k = mk.run_steps(*args, **kw, cluster=G)
                outputs[f"B3 {kind} {dtype} G={G}"] = [
                    x.cpu() for x in k if x is not None]
                ks, ps = k[1].cpu().numpy(), p[1].cpu().numpy()
                r["checks"][f"B3 {kind} {dtype} G={G}"] = (
                    bool(np.array_equal(ks[:, 3], ps[:, 3])),
                    _close(ks[:, :3], ps[:, :3], k[0], p[0], ps[:, 3:4],
                           f64))
        for label, make, launch, C in (
                ("B1 C=1", b1["float32"][3], mk.run_steps_uvt, 1),
                ("B1 C=32", b1["float32"][3], mk.run_steps_uvt, 32),
                ("B3 MOF C=1", b3[("mof", "float32")][3], mk.run_steps, 1),
                ("B3 MOF C=16", b3[("mof", "float32")][3], mk.run_steps, 16),
                ("B3 LJ C=1", b3[("lj", "float32")][3], mk.run_steps, 1)):
            args, kw = make(C, rng(7 + C).random((C, 1000, 16)))
            # ms per 1000-step launch = us per step
            us = cs.time_calls(lambda: launch(*args, **kw), dev, n=5)
            r["us"][label] = (us, launch.last_cluster)
            if build == "clocked":
                cyc = (ctypes.c_double * 9)()
                lib = _build.library(NAMES[launch is mk.run_steps])
                if lib.mc_phase_cycles_read(cyc) != 0:
                    raise RuntimeError("mc_phase_cycles_read failed")
                r["phase_cycles"][label] = list(cyc)
        if not outputs0:
            outputs0.update(outputs)
        r["same_bits_as_port"] = all(
            all(torch.equal(a, b) for a, b in zip(outputs[k], outputs0[k]))
            for k in outputs)
        ok = all(same and err <= 1.0 for same, err in r["checks"].values())
        r["ok"] = ok
        results.append(r)
        print(f"{build} build: " + ", ".join(
            f"{k} {us:.3f} us (G={g})" for k, (us, g) in r["us"].items())
            + f"; checks {'pass' if ok else 'FAIL'} (worst "
            f"{max(e for _, e in r['checks'].values()):.3f} of tolerance); "
            + "; ".join(f"{nm} {reg} regs {sp} B spill" for rows in
                        r["ptxas"] for nm, reg, sp in rows)
            + "; outputs " + ("equal" if r["same_bits_as_port"]
                              else "differ from") + " the port build's",
            flush=True)
        for label, cyc in r["phase_cycles"].items():
            print(f"    {label} cycles per step: " + ", ".join(
                f"{nm} {c:.0f}" for nm, c in zip(PHASES, cyc))
                + f" (total {sum(cyc):.0f})", flush=True)
        if not ok:
            print("    " + json.dumps(r["checks"]), flush=True)
    with open(out_path, "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)
    print(smi)
    if not all(r["ok"] and r["same_bits_as_port"] for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
