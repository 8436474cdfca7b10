"""B2 (pair_terms) of one checkout against another's, on the card: the
raw sums of one launch on fixed inputs — the 10.8k bench system at
row_start 0 and F, float32 and float64, every RD instance at F in float32
— written by each checkout's package, then compared bit for bit, with the
card-alone ms per call of the classical float32 launches beside.

    python3 tools/measure_b2_ab.py --root <checkout> --out <file.pt>
    python3 tools/measure_b2_ab.py --compare <a.pt> <b.pt>

``--root`` puts that checkout's mpmc_tpu_torch first on the path (the
parent commit unpacked with ``git archive``, say), so one script measures
both.  Needs a CUDA device; builds the pair libraries it launches.
"""
import argparse
import sys
import time


def _measure(root, out):
    sys.path.insert(0, root)
    import torch
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    dev = torch.device("cuda", 0)
    res, ms = {}, {}
    for dtype in ("float32", "float64"):
        params, state, cfg, _ = systems.mof_h2_gcmc(
            n_side=21, n_h2=256, capacity=512, dtype=dtype, device=dev)
        forms = [None] + (["sg", "dreiding", "b14_7", "disp_expansion"]
                          if dtype == "float32" else [])
        for form in forms:
            p, c = params, cfg
            if form is not None:
                p, c = systems.with_rd_form(params, cfg, form, rd_lrc=True,
                                            damp_dispersion=True)
            disp, _ = pairs.site_columns(p, c)
            args = (state.pos, p.charge, p.eps, p.sig, p.mol_id32,
                    state.atom_alive(p), p.mol_frozen[p.mol_id],
                    pairs.pair_scalars(state.box, c), c)
            rows = [metropolis.frozen_refresh_rows(p, c)]
            if form is None:
                rows.append(0)
            for rs in rows:
                key = f"{dtype} {form or 'classical'} row_start {rs}"
                res[key] = pk.pair_terms(*args, row_start=rs,
                                         disp=disp).cpu()
                if form is None and dtype == "float32":
                    fn = (lambda: pk.pair_terms(*args, row_start=rs,
                                                disp=disp))
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize(dev)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(200):
                        fn()
                    b.record()
                    torch.cuda.synchronize(dev)
                    ms[key] = a.elapsed_time(b) / 200
    torch.save({"raw": res, "ms": ms, "root": root,
                "device": torch.cuda.get_device_name(0)}, out)
    print(f"{root}: {len(res)} launches saved to {out}; ms per call "
          f"(200 back to back): {ms}")


def _compare(a_path, b_path):
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    same = all(torch.equal(a["raw"][k], b["raw"][k]) for k in a["raw"])
    for k in a["raw"]:
        print(f"{k}: {'equal' if torch.equal(a['raw'][k], b['raw'][k]) else 'DIFFERENT'}")
    for k in a["ms"]:
        print(f"{k}: {a['root']} {a['ms'][k]:.4f} ms, {b['root']} "
              f"{b['ms'][k]:.4f} ms ({a['device']})")
    print("all equal bit for bit" if same else "outputs differ")
    return 0 if same else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    ns = ap.parse_args()
    if ns.compare:
        return _compare(*ns.compare)
    t0 = time.time()
    _measure(ns.root, ns.out)
    print(f"seconds {time.time() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
