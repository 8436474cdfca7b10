"""B4 (mol_pair) of one checkout against another's, on the card: the raw
sums of fixed launches — the 10.8k bench system's first alive H2 (its
current rows and a trial beside the framework) at C = 1 in float32 and
float64, every RD instance at C = 1 in float32, 128 chains with positions
per chain, and the stride-0 rotor grid (4,224 placements: regime 1) —
written by each checkout's package, then compared bit for bit, with the
ms per call of the float32 C = 1 launch beside (200 calls back to back
between two CUDA events: bound by the host's launches).  The launches
take no column range, so the same script drives a checkout from before
the range existed.

    python3 tools/measure_b4_ab.py --root <checkout> --out <file.pt>
    python3 tools/measure_b4_ab.py --compare <a.pt> <b.pt>

``--root`` puts that checkout's mpmc_tpu_torch first on the path (the
parent commit unpacked with ``git archive``, say).  Needs a CUDA device;
builds only the pair libraries (one nvcc each, together) into the
checkout's build directory.
"""
import argparse
import subprocess
import sys

PAIR_LIBS = ("pair_kernel", "pair_sg_kernel", "pair_dreiding_kernel",
             "pair_b14_7_kernel", "pair_disp_kernel")


def _build_pair_libs():
    """Compile and load the pair libraries alone (the other kernels are
    not launched here)."""
    from mpmc_tpu_torch.ops.cuda import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PAIR_LIBS:
        out = _build.target(name)
        if not out.exists():
            procs[name] = subprocess.Popen(
                _build.command(name, out), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {err}")
    for name in PAIR_LIBS:
        _build.load(name, _build.target(name))


def _timed(fn, n=200):
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _measure(root, out):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    _build_pair_libs()
    dev = torch.device("cuda", 0)
    res, ms = {}, {}
    for dtype in ("float32", "float64"):
        params, state, cfg, _ = systems.mof_h2_gcmc(
            n_side=21, n_h2=256, capacity=512, dtype=dtype, device=dev)
        alive = state.atom_alive(params)
        h2 = int(np.flatnonzero((params.mol_species >= 0).cpu().numpy()
                                & state.mol_alive.cpu().numpy())[0])
        mol = torch.tensor(h2, device=dev)
        trial = state.pos[0] + params.species_pos[0] + torch.tensor(
            [2.0, 0.31, 0.17], dtype=state.pos.dtype, device=dev)
        forms = [None] + (["sg", "dreiding", "b14_7", "disp_expansion"]
                          if dtype == "float32" else [])
        for form in forms:
            p, c = params, cfg
            if form is not None:
                p, c = systems.with_rd_form(params, cfg, form, rd_lrc=True,
                                            damp_dispersion=True)
            disp, _ = pairs.site_columns(p, c)
            scal = pairs.pair_scalars(state.box, c)
            for label, rows in (("current", None), ("trial", trial)):
                args = (state.pos, p.charge, p.eps, p.sig, p.mol_id32, alive,
                        p.mol_atoms, p.mol_natoms, mol, rows, scal, c)
                key = f"{dtype} {form or 'classical'} C=1 {label}"
                res[key] = pk.mol_pair(*args, disp=disp).cpu()
                if form is None and dtype == "float32" and rows is None:
                    ms[key] = _timed(lambda: pk.mol_pair(*args, disp=disp))
        if dtype != "float32":
            continue
        # 128 chains, positions per chain (regime 2); the rotor grid at
        # stride 0 past grid_min (regime 1)
        scal = pairs.pair_scalars(state.box, cfg)
        g = torch.Generator(device=dev).manual_seed(3)
        C = 128
        pos_c = (state.pos[None] + 0.05 * torch.randn(
            (C,) + tuple(state.pos.shape), generator=g,
            device=dev)).contiguous()
        alive_c = alive[None].expand(C, -1).contiguous()
        mols = torch.full((C,), h2, device=dev)
        res["float32 classical C=128"] = pk.mol_pair_chains(
            pos_c, params.charge, params.eps, params.sig, params.mol_id32,
            alive_c, params.mol_atoms, params.mol_natoms, mols, None, scal,
            cfg).cpu()
        G = 4224
        rows_g = ((state.pos[0] + params.species_pos[0])[None]
                  + 3.0 * torch.rand((G, 1, 3), generator=g, device=dev,
                                     dtype=state.pos.dtype))
        res["float32 classical stride0 grid"] = pk.mol_pair_chains(
            state.pos, params.charge, params.eps, params.sig,
            params.mol_id32, alive, params.mol_atoms, params.mol_natoms,
            torch.full((G,), h2, device=dev), rows_g.contiguous(), scal,
            cfg).cpu()
    torch.save({"res": res, "ms": ms}, out)
    for k, v in ms.items():
        print(f"{root}: {k}: {v:.5f} ms per call (200 back to back)")


def _compare(a, b):
    import torch
    A, B = torch.load(a), torch.load(b)
    bad = [k for k in A["res"] if not torch.equal(A["res"][k], B["res"][k])]
    for k in A["res"]:
        print(f"{k}: {'equal' if k not in bad else 'DIFFERS'}")
    for k in A["ms"]:
        print(f"{k}: {A['ms'][k]:.5f} ms ({a}) / {B['ms'][k]:.5f} ms ({b})")
    if bad or set(A["res"]) != set(B["res"]):
        raise SystemExit(f"B4 outputs differ: {bad}")
    print(f"every B4 output ({len(A['res'])}) equal bit for bit")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        _compare(*args.compare)
    else:
        _measure(args.root, args.out)


if __name__ == "__main__":
    main()
