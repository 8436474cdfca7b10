"""B4's kernel variants timed on the card: the classical pair library built
again with constants of csrc/pair_kernel.cuh changed, each against the
library as it is.

    python tools/measure_b4_variants.py [out.json]

Each variant copies csrc/ to build/b4_variants/<n>/, replaces text in the
copy of pair_kernel.cuh (VARIANTS), builds pair_kernel.cu there with the
port's nvcc command, loads it in place of the classical library and
times B4 in float32 on chip_smoke.py's inputs: an H2's current rows (C =
1), 128 chains with their own positions (chip_smoke._chain_inputs), 16
of them with a header per chain (as chip_smoke._mol_pair_header) and a
64-rotor grid launch at position stride 0 (C = 32,768), each per call
(chip_smoke.time_calls) and on the card alone (chip_smoke.time_device);
every output must equal the unchanged library's bit for bit.  ptxas's B4
lines of each build are kept.  Needs a CUDA device and nvcc.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# name -> {text in pair_kernel.cuh: its replacement}
VARIANTS = {
    "as built": {},
    "regime 2: 1 CTA an SM": {"__launch_bounds__(NT2C, 2)":
                              "__launch_bounds__(NT2C, 1)"},
    "regime 2: CTAs of 256 threads": {"constexpr int NT2C = 512;":
                                      "constexpr int NT2C = 256;"},
    "regime 2: G <= 8": {"constexpr int G4_MAX = 16;":
                         "constexpr int G4_MAX = 8;"},
    "regime 2: teams of 2 warps": {"constexpr int P2 = 4;":
                                   "constexpr int P2 = 2;"},
    "regime 1: no LJ mixing": {"constexpr bool B4_LJ_MIX = true;":
                               "constexpr bool B4_LJ_MIX = false;"},
    "rows in a loop, no LJ mixing": {"constexpr int NR_FIXED = 3;":
                                     "constexpr int NR_FIXED = 0;"},
    "regime 1: 2 CTAs an SM": {"sizeof(T) == 4 && RD != RD_DISP ? 3":
                               "sizeof(T) == 4 && RD != RD_DISP ? 2"},
    "regime 1: 4 CTAs an SM, 2 chains a warp": {
        "sizeof(T) == 4 && RD != RD_DISP ? 3":
            "sizeof(T) == 4 && RD != RD_DISP ? 4",
        "constexpr int CPW_MAX = 4;": "constexpr int CPW_MAX = 2;"},
}


def _start_variant(k, edits):
    """(library, its ptxas report, the nvcc process or None) of variant k:
    pair_kernel.cu built from a copy of csrc/ with ``edits`` made to
    pair_kernel.cuh; no edits: the port's own build."""
    from mpmc_tpu_torch.ops.cuda import _build
    if not edits:
        lib = _build.target("pair_kernel")
        return lib, lib.with_suffix(".ptxas.txt"), None
    d = REPO / "build" / "b4_variants" / str(k)
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    h = d / "pair_kernel.cuh"
    text = h.read_text()
    for a, b in edits.items():
        if a not in text:
            raise ValueError(f"variant {k}: {a!r} not in pair_kernel.cuh")
        text = text.replace(a, b)
    h.write_text(text)
    out = d / "libpair_kernel.so"
    cmd = [str(x).replace(str(_build.CSRC), str(d))
           for x in _build.command("pair_kernel", out)]
    f = open(d / "ptxas.txt", "w")
    return out, d / "ptxas.txt", (subprocess.Popen(cmd, stdout=f, stderr=f),
                                  f)


def _ptxas(path):
    """ptxas's lines of B4's kernels in a build's report."""
    import re
    out, cur = {}, None
    for ln in Path(path).read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"mol_pair_(grid|cluster)_kernelI([fd])", ln)
            cur = f"{m.group(1)} {m.group(2)}" if m else None
        elif cur and ("registers" in ln or "spill" in ln):
            out[cur] = (out.get(cur, "") + "; " + ln.split(":", 1)[-1]
                        .strip()).strip("; ")
    return out


def main(out=None):
    import torch
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from mpmc_tpu_torch.mc import moves
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs, qrot
    from mpmc_tpu_torch.ops.cuda import _build
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    dev, smi = cs.phase_device()
    for name in _build.build():
        _build.library(name)
    params, state, cfg, _ = cs.bench_system("float32", dev)
    alive = state.atom_alive(params)
    scal = pairs.pair_scalars(state.box, cfg)
    common = (params.charge, params.eps, params.sig, params.mol_id32)
    h2 = int(np.flatnonzero((params.mol_species >= 0).cpu().numpy()
                            & state.mol_alive.cpu().numpy())[0])
    inputs = cs._chain_inputs(dev, 128)
    args, rows, _, _ = inputs["float32"]
    a64, _, _, p64 = inputs["float64"]
    d_lnv = torch.linspace(-0.06, 0.06, 16, dtype=torch.float64, device=dev)
    pos16, box16 = moves.scale_volume(a64[0][:16].contiguous(),
                                      a64[10][2:11].reshape(3, 3)
                                      .expand(16, 3, 3), p64, d_lnv)
    mols = qrot.rotor_slots(state.mol_alive, params,
                            [systems.h2_bss3()])[0][:64]
    axes = torch.as_tensor(qrot._basis(4, qrot.N_THETA, qrot.N_PHI)[3],
                           dtype=torch.float32, device=dev)
    mt = torch.as_tensor(mols, device=dev)
    gr = qrot.grid_rows(state.pos, params, mt, axes)
    # every argument made here: a call that builds one may wait for the
    # card, and the calls on the card alone must queue ahead of it
    one = (state.pos, *common, alive, params.mol_atoms, params.mol_natoms,
           torch.tensor(h2, device=dev), None, scal, cfg)
    c128 = (*args[:9], rows, *args[10:])
    c16 = (pos16.float(), *args[1:5], args[5][:16].contiguous(), *args[6:8],
           args[8][:16].contiguous(), rows[:16].contiguous(),
           pairs.pair_scalars(box16.float(), cfg), cfg)
    grid = (state.pos, *common, alive, params.mol_atoms, params.mol_natoms,
            mt.repeat_interleave(axes.shape[0]),
            gr.reshape(-1, gr.shape[2], 3).contiguous(), scal, cfg)
    cases = {
        "one_H2": (lambda: pk.mol_pair(*one), 200),
        "c128": (lambda: pk.mol_pair_chains(*c128), 100),
        "c16_header": (lambda: pk.mol_pair_chains(*c16), 100),
        "grid64": (lambda: pk.mol_pair_chains(*grid), 10),
    }
    ref = {k: f().clone() for k, (f, _) in cases.items()}
    rep = {"card": smi, "variants": {}}
    builds = [_start_variant(k, edits)
              for k, edits in enumerate(VARIANTS.values())]
    failed = set()
    for name, (_, report, job) in zip(VARIANTS, builds):
        if job is not None:
            if job[0].wait() != 0:
                failed.add(name)
                print(f"{name}: nvcc failed\n"
                      + Path(report).read_text()[-1500:], flush=True)
            job[1].close()
    for name, (path, report, _) in zip(VARIANTS, builds):
        if name in failed:
            continue
        _build.load("pair_kernel", path)
        e = {"ptxas": _ptxas(report), "times": {}}
        for label, (f, n) in cases.items():
            got = f()
            torch.cuda.synchronize(dev)
            e["times"][label] = {
                "same_bits": bool(torch.equal(got, ref[label])),
                "ms": cs.time_calls(f, dev),
                "device_ms": cs.time_device(f, dev, n=n)}
        rep["variants"][name] = e
        print(f"{name}: " + "; ".join(
            f"{lb} {t['device_ms'] * 1e3:.1f} us"
            + ("" if t["same_bits"] else " (BITS DIFFER)")
            for lb, t in e["times"].items()), flush=True)
        for kk, v in e["ptxas"].items():
            print(f"    {kk}: {v[:150]}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
