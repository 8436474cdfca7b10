"""Analysis of a run's outputs (port of the TMMC part of
mpmc_tpu/analyze.py; the rest of that module is ROADMAP A12b).

Transition-matrix Monte Carlo (``tmmc on``) writes a collection matrix
(io/output.py::write_tmmc): per macrostate N, the insert species' alive
count before an insert or delete attempt, the attempts and the sum of
their acceptance probabilities.  ``tmmc_lnpi`` turns it into lnΠ(N),
``tmmc_reweight`` / ``tmmc_isotherm`` into ⟨N⟩ at other fugacities,
``tmmc_eta`` into the flat-histogram bias of ``tmmc_bias``.  numpy only.

Command line: ``python -m mpmc_tpu_torch.analyze tmmc run.tmmc.json
[--fugacities f1,f2,...] [--out iso.csv] [--lnpi-out lnpi.csv]``.
"""
from __future__ import annotations

import argparse
import json
import sys
import warnings

import numpy as np


def tmmc_lnpi(c):
    """Macrostate log-probabilities lnΠ(N) from a TMMC collection matrix
    ``c`` [K, 4] (n_ins, Σa_ins, n_del, Σa_del per N).

    Detailed balance gives lnΠ(N+1) - lnΠ(N) = ln ā_ins(N) - ln
    ā_del(N+1), ā the mean acceptance probability of the attempts from
    N (insert and delete are proposed with equal probability, so the
    selection cancels).  On the ideal gas the links are exact after any
    number of steps.  Under the polar delayed acceptance an entry is the
    estimator 1{stage-1 accept} min(1, a2), exact only in expectation.
    The links are followed over one contiguous window where both have
    data; outside it lnΠ is NaN.  Of several disconnected windows (summed
    matrices of independent runs) the one with the most attempts is
    followed, with a warning.  Returns lnΠ normalized to max 0; raises
    ValueError without any link."""
    c = np.asarray(c, np.float64)
    a_up = np.where(c[:, 0] > 0, c[:, 1] / np.maximum(c[:, 0], 1.0), 0.0)
    a_dn = np.where(c[:, 2] > 0, c[:, 3] / np.maximum(c[:, 2], 1.0), 0.0)
    K = c.shape[0]
    lnpi = np.full(K, np.nan)
    linked = [a_up[i] > 0 and a_dn[i + 1] > 0 for i in range(K - 1)]
    if not any(linked):
        raise ValueError("collection matrix has no connected N→N+1 link "
                         "(no insert/delete statistics yet)")
    frags, i = [], 0              # maximal runs of links: rows i..j
    while i < K - 1:
        if linked[i]:
            j = i
            while j < K - 1 and linked[j]:
                j += 1
            frags.append((i, j))
            i = j
        i += 1
    if len(frags) > 1:
        warnings.warn(
            f"TMMC collection has {len(frags)} disconnected N-windows "
            f"({', '.join(f'{a}..{b}' for a, b in frags)}); following the "
            "best-sampled one — extend runs to bridge the gaps",
            stacklevel=2)
    i0, i1 = max(frags, key=lambda ab: c[ab[0]:ab[1] + 1, [0, 2]].sum())
    lnpi[i0] = 0.0
    for i in range(i0, i1):
        lnpi[i + 1] = lnpi[i] + np.log(a_up[i]) - np.log(a_dn[i + 1])
    return lnpi - np.nanmax(lnpi)


def tmmc_eta(c):
    """Flat-histogram bias η(N) = -lnΠ(N) of ``tmmc_bias``, the rows
    outside the resolved window set to the nearest resolved value; None
    while no link is resolved."""
    try:
        lnpi = tmmc_lnpi(c)
    except ValueError:
        return None
    eta = -lnpi
    idx = np.flatnonzero(np.isfinite(eta))
    eta[:idx[0]] = eta[idx[0]]
    eta[idx[-1] + 1:] = eta[idx[-1]]
    return np.nan_to_num(eta, nan=float(np.nanmax(eta)))


def tmmc_reweight(lnpi, f_sim, f_target):
    """(⟨N⟩, var N, edge mass) of the macrostate distribution reweighted
    from the sampled fugacity ``f_sim`` to ``f_target``: lnΠ'(N) = lnΠ(N)
    + N ln(f_target / f_sim).  The edge mass is the probability on the two
    outermost resolved macrostates (large: the target leaks out of the
    sampled window)."""
    lnpi = np.asarray(lnpi, np.float64)
    ok = np.isfinite(lnpi)
    n = np.flatnonzero(ok).astype(np.float64)
    w = lnpi[ok] + n * (np.log(f_target) - np.log(f_sim))
    w -= w.max()
    p = np.exp(w)
    p /= p.sum()
    mean = float((n * p).sum())
    var = float((((n - mean) ** 2) * p).sum())
    return mean, var, float(p[0] + p[-1])


def tmmc_load(paths):
    """(summed matrix, the first file's metadata) of same-state TMMC files
    (write_tmmc); files at another temperature, fugacity or volume, or of
    another size, raise ValueError."""
    metas, cs = [], []
    for p in paths:
        with open(p) as f:
            rec = json.load(f)
        if rec.get("format") != "mpmc_tpu.tmmc.v1":
            raise ValueError(f"{p}: not a mpmc_tpu tmmc file")
        metas.append(rec)
        cs.append(np.asarray(rec["c"], np.float64))
    m0 = metas[0]
    for p, m in zip(paths[1:], metas[1:]):
        for k in ("temperature", "fugacities_atm", "volume_a3",
                  "f_sim_atm"):
            if k not in m0:
                continue
            if not np.allclose(m.get(k, m0[k]), m0[k], rtol=1e-10):
                raise ValueError(
                    f"{p}: {k}={m[k]} differs from {paths[0]}'s "
                    f"{m0[k]} — collection matrices only sum at the "
                    "same thermodynamic state")
        if m["c"] and len(m["c"]) != len(m0["c"]):
            raise ValueError(f"{p}: matrix size mismatch")
    return sum(cs), m0


def tmmc_isotherm(c, f_sim, f_targets):
    """[(f, ⟨N⟩, var N, edge mass)] at each target fugacity, from one
    collection matrix."""
    lnpi = tmmc_lnpi(c)
    return [(float(f),) + tmmc_reweight(lnpi, f_sim, f)
            for f in f_targets]


def _write_csv(path, header, rows):
    out = sys.stdout if path == "-" else open(path, "w")
    try:
        out.write(header + "\n")
        for row in rows:
            out.write(",".join(str(v) for v in row) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()


def _tmmc_main(args):
    c, meta = tmmc_load(args.files)
    # only the insert species' fugacity reweights N; files without the
    # field fall back to the sum of the fugacities
    if "f_sim_atm" in meta:
        f_sim = float(meta["f_sim_atm"])
    else:
        f_sim = float(sum(meta["fugacities_atm"]))
        if len([f for f in meta["fugacities_atm"] if f > 0]) > 1:
            print("WARNING: tmmc file without f_sim_atm and several "
                  "positive fugacities — using their sum")
    if f_sim <= 0:
        raise SystemExit("run metadata has no positive fugacity")
    if args.fugacities:
        targets = [float(v) for v in args.fugacities.split(",")]
    else:
        targets = np.geomspace(args.fmin_ratio * f_sim,
                               args.fmax_ratio * f_sim, args.nf)
    lnpi = tmmc_lnpi(c)
    ok = np.isfinite(lnpi)
    n_att = int(c[:, 0].sum() + c[:, 2].sum())
    print(f"collection: {n_att:d} insert/delete attempts, resolved window "
          f"N = {np.flatnonzero(ok).min()}..{np.flatnonzero(ok).max()} of "
          f"0..{len(lnpi) - 1}  (T={meta['temperature']:g} K, "
          f"f_sim={f_sim:g} atm)")
    rows = tmmc_isotherm(c, f_sim, targets)
    for f, n, v, edge in rows:
        if edge > 1e-6:
            print(f"WARNING: f={f:g} atm puts {edge:.2e} probability mass "
                  "at the window edge — extend the run or sample nearer "
                  "this fugacity")
    _write_csv(args.out, "f_atm,n_mean,var_n,edge_mass",
               ((f"{f:.6g}", f"{n:.8g}", f"{v:.8g}", f"{e:.3g}")
                for f, n, v, e in rows))
    if args.lnpi_out:
        _write_csv(args.lnpi_out, "n,lnpi",
                   ((i, f"{lnpi[i]:.8g}") for i in np.flatnonzero(ok)))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpmc_tpu_torch.analyze",
                                 description="analysis of a run's outputs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ptm = sub.add_parser("tmmc",
                         help="transition-matrix lnΠ(N) + reweighted "
                              "continuous-fugacity isotherm from one "
                              "GCMC run (tmmc on)")
    ptm.add_argument("files", nargs="+",
                     help="tmmc.json collection files (tmmc_output; "
                          "same-state files are summed)")
    ptm.add_argument("--fugacities", default="",
                     help="comma list of target fugacities (atm); "
                          "default: geometric grid spanning "
                          "fmin x..fmax x the run fugacity")
    ptm.add_argument("--nf", type=int, default=21,
                     help="grid points for the default geometric grid")
    ptm.add_argument("--fmin-ratio", type=float, default=0.1)
    ptm.add_argument("--fmax-ratio", type=float, default=10.0)
    ptm.add_argument("--out", default="-",
                     help="isotherm CSV path (default stdout)")
    ptm.add_argument("--lnpi-out", default=None,
                     help="also write the lnΠ(N) curve as CSV")
    args = ap.parse_args(argv)
    if args.cmd == "tmmc":
        _tmmc_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
