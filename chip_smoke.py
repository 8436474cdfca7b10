"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises, so the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build  — the CUDA kernels from mpmc_tpu_torch/csrc, with build seconds;
3. kernels — B2 (pair_terms) and B4 (mol_pair) against their plain
   PyTorch versions on the 10.8k-atom bench system (MOF lattice n_side=21
   + 512 H2 slots), float32 and float64, with CUDA-event timings;
4. energy — total_energy on the card (float32, kernels) against the port
   on the CPU (float64, plain), term by term;
5. main path — the 10.8k system written to PQR and run as a GCMC deck
   through mpmc_tpu_torch.mc.run.run (3000 steps): both kernels must have
   been launched by it, and the carried energy of a further chunk must
   match a fresh recompute; a profiled chunk shows where a step's time
   goes; then examples/h2_sorption.inp (5000 steps).

The second-to-last line is a JSON object with each kernel's launches,
error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
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
SOURCE = "mpmc_tpu_torch/csrc/pair_kernel.cu"
REPLACES = {"pair_terms": "mpmc_tpu/ops/pallas/pair_kernel.py:79",
            "mol_pair": "mpmc_tpu/ops/pallas/pair_kernel.py:336"}
# the bench system: mof_h2_gcmc(n_side=21, spacing=4.0, n_h2=256,
# capacity=512) -> 9,261 framework atoms + 512 x 3 H2 sites
N_SIDE, N_H2, CAPACITY = 21, 256, 512
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
    path = _build.build(force=True)
    secs = time.time() - t0
    _build.library()
    log(f"build: {secs:.1f} s -> {os.path.relpath(path, REPO)}")
    for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            log("  ptxas: " + line.strip())
    return secs


def bench_system(dtype, device, n_side=N_SIDE, n_h2=N_H2,
                 capacity=CAPACITY):
    from mpmc_tpu_torch.models import systems
    return systems.mof_h2_gcmc(n_side=n_side, n_h2=n_h2, capacity=capacity,
                               dtype=dtype, device=device)


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
            pms = time_calls(lambda: pk.pair_terms_plain(
                *args, row_start=rs), device, n=5)
            log(f"B2 pair_terms {dtype} row_start={rs}: kernel {ms:.3f} ms,"
                f" plain {pms:.3f} ms")
            for s, name in enumerate(SLOTS):
                log(f"    {name:11s} kernel {k[s]: .10e} ref {p[s]: .10e} "
                    f"|d| {err[s]:.3e} tol {tol[s]:.3e}")
            if not (np.all(err[fin] <= tol[fin])
                    and np.array_equal(np.isfinite(k), fin)):
                raise AssertionError(f"B2 {dtype} row_start={rs} disagrees "
                                     "with its plain version")
            report["pair_terms"]["max_abs_err"] = max(
                report["pair_terms"]["max_abs_err"], float(err[fin].max()))
            if dtype == "float32" and rs == F:
                report["pair_terms"].update(ms=ms, plain_ms=pms)
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
            pms = time_calls(lambda: pk.mol_pair_plain(*margs), device)
            log(f"B4 mol_pair {dtype} {label}: kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms")
            for s, name in enumerate(MOL_SLOTS):
                log(f"    {name:11s} kernel {k[s]: .10e} ref {p[s]: .10e} "
                    f"|d| {err[s]:.3e} tol {tol[s]:.3e}")
            if not np.all(err <= tol):
                raise AssertionError(f"B4 {dtype} {label} disagrees with "
                                     "its plain version")
            report["mol_pair"]["max_abs_err"] = max(
                report["mol_pair"]["max_abs_err"], float(err.max()))
            if dtype == "float32" and label == "H2":
                report["mol_pair"].update(ms=ms, plain_ms=pms)
    return report


def phase_energy(device, n_side=N_SIDE, n_h2=N_H2, capacity=CAPACITY):
    """Card float32 (kernels) against CPU float64 (plain), per term."""
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


def phase_main(device, n_side=N_SIDE, n_h2=N_H2, capacity=CAPACITY,
               numsteps=3000):
    """The port's main path at full size through run.run."""
    from mpmc_tpu_torch.io import input_script, pqr
    from mpmc_tpu_torch.mc import metropolis, run
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    params, state, cfg, _ = bench_system("float32", "cpu", n_side, n_h2,
                                         capacity)
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            pqr.write_state("bench10k.pqr", params, state, ["H2"])
            with open("bench10k.inp", "w") as f:
                f.write(DECK.format(numsteps=numsteps,
                                    L=float(state.box[0, 0])))
            job = input_script.parse_file("bench10k.inp")
            buf = io.StringIO()
            pk.reset_counts()
            su, avgs = run.run(job, log=buf, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launches = {"pair_terms": pk.pair_terms.launches,
                        "mol_pair": pk.mol_pair.launches}
        finally:
            os.chdir(old)
    text = buf.getvalue()
    log(text.rstrip())
    log(f"main-path launches: {launches}")
    if device.type == "cuda" and not all(v > 0 for v in launches.values()):
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
    fresh = metropolis.initialize(st, su.params, su.cfg, su.thermo)
    carried, full = float(st.energy.total), float(fresh.energy.total)
    log(f"bookkeeping after 1000 steps: carried {carried:.6f} fresh "
        f"{full:.6f} accepts {stats.host().accepts.tolist()}")
    if not abs(carried - full) <= 1e-4 * max(abs(full), 1.0):
        raise AssertionError("carried energy drifted from a fresh "
                             "recompute beyond rel 1e-4")
    for k in ("N", "energy_total"):
        if not np.isfinite(avgs.mean(k)):
            raise AssertionError(f"non-finite average {k}")
    return launches, rate, dataclasses.replace(su, state=st)


def phase_profile(device, su, n_steps=500):
    """Where a GCMC step's time goes: one untraced chunk for the rate,
    then a torch.profiler chunk for device busy time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpmc_tpu_torch.mc import metropolis
    g = torch.Generator(device=device).manual_seed(5)

    def chunk():
        t0 = time.perf_counter()
        metropolis.run_chunk(su.state, su.params, su.cfg, su.thermo,
                             n_steps, generator=g)
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    chunk()
    wall = chunk()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_traced = chunk()
    # device-side events only (kernels, memcpy, memset): CPU ops also
    # carry the device time of the kernels they launched
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for _, _, t in dev)
    launches = sum(c for _, c, _ in dev)
    out = {"steps": n_steps, "ms_per_step": 1e3 * wall / n_steps,
           "ms_per_step_traced": 1e3 * wall_traced / n_steps,
           "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
           "device_busy_share_traced": busy_us / 1e6 / wall_traced,
           "device_ops_per_step": launches / n_steps,
           "top": [{"kernel": k[:90], "count": c, "ms": t / 1e3}
                   for k, c, t in sorted(dev, key=lambda x: -x[2])[:10]]}
    log("profile " + json.dumps(out))
    if busy_us <= 0:
        log("profile: the profiler recorded no device time")
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
    build_s = phase_build()
    report = phase_kernels(dev)
    phase_energy(dev)
    launches, rate, su = phase_main(dev)
    phase_profile(dev, su)
    phase_example(dev)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"]}
               for name in ("pair_terms", "mol_pair")]
    log(f"build_seconds {build_s:.1f}  gcmc_steps_per_sec {rate:.2f}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
