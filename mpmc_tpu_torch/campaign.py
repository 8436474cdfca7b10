"""Isotherm campaigns: restart-aware pressure sweeps with
uncertainty-targeted stopping (port of mpmc_tpu/campaign.py).

The production loop of a sorption study, one program instead of one job
per pressure:

- each pressure point runs C batched GCMC chains on one card
  (parallel/multichain.run_chunk_batched: every step one launch of B4
  over the chains, every corrtime a refresh of each chain through B2);
- the point stops when the cross-chain standard error of <N> falls under
  ``target_rel_sem`` (the chain spread's SEM needs no autocorrelation
  analysis) and ``min_steps`` are done, or at ``max_steps``.  The batched
  chains share the move *type* of each step, so a common fluctuation is
  invisible to the chain spread and the true error can exceed the SEM at
  short runs: tighten ``target_rel_sem`` rather than trust 1x SEM;
- successive points warm-start from the previous pressure's chains;
- after every point the campaign writes ``manifest.json`` (the finished
  rows) and ``states`` (io/checkpoint.py: the stacked chains and the
  generator's state) into ``checkpoint_dir``, so a killed campaign
  resumes at the first unfinished pressure and produces the rows an
  uninterrupted one would have.

Every chain draws its rows of the [C, K, 16] uniform table from one
``torch.Generator`` seeded with the deck's ``seed`` (the reference gives
each stacked chain its own PRNG key instead).  Pressure enters through
``Thermo``, so the sweep changes no shape between points.

    python -m mpmc_tpu_torch.campaign examples/h2_sorption.inp \\
        --pressures 0.1 0.5 1 5 10 --chains 32 --target-rel-sem 0.02 \\
        --checkpoint-dir iso_ckpt -o iso.csv       # on the CUDA device
    python -m mpmc_tpu_torch.campaign deck.inp --pressures 1 2 --cpu
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from mpmc_tpu_torch.io import checkpoint, input_script
from mpmc_tpu_torch.mc import metropolis
from mpmc_tpu_torch.mc import run as run_mod
from mpmc_tpu_torch.parallel import multichain
from mpmc_tpu_torch.utils.averages import Averages


@dataclasses.dataclass
class PointResult:
    pressure_atm: float
    fugacity_atm: float
    n_mean: float
    n_sem: float
    wt_pct: float
    qst_kj_mol: float
    steps: int
    #: multi-sorbate extras, flattened into row(): per-species loadings
    #: ``n_<name>`` (+``_sem``), fugacities ``f_<name>``, and pairwise
    #: adsorption selectivities ``S_<i>_<j>`` = (x_i/x_j)/(y_i/y_j)
    extra: dict = dataclasses.field(default_factory=dict)

    def row(self):
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    @classmethod
    def from_row(cls, r):
        """Inverse of row(): unknown keys go back into ``extra`` (also
        reads manifests written before ``extra`` existed)."""
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        return cls(**{k: v for k, v in r.items() if k in names},
                   extra={k: v for k, v in r.items() if k not in names})


def _species_stats(su, per_species, fugacities):
    """Flattened per-species extras of a mixture point: chain-mean
    loadings with their cross-chain SEM, fugacities, and pairwise
    adsorption selectivities S_ij = (x_i/x_j)/(y_i/y_j)."""
    names = su.species_names
    if len(names) < 2:
        return {}
    out = {}
    means = {}
    for i, nm in enumerate(names):
        per_chain = np.array([np.mean(v) for v in per_species[nm]])
        means[nm] = float(per_chain.mean())
        out[f"n_{nm}"] = means[nm]
        out[f"n_{nm}_sem"] = (float(per_chain.std(ddof=1)
                                    / np.sqrt(len(per_chain)))
                              if len(per_chain) > 1 else float("inf"))
        out[f"f_{nm}"] = float(fugacities[i])
    for i, ni in enumerate(names):
        for j, nj in enumerate(names):
            if j <= i:
                continue
            fi, fj = float(fugacities[i]), float(fugacities[j])
            if means[nj] > 0 and fi > 0 and fj > 0:
                out[f"S_{ni}_{nj}"] = (means[ni] / means[nj]) / (fi / fj)
            else:
                out[f"S_{ni}_{nj}"] = float("nan")
    return out


def run_point(su, states, thermo, chains, corrtime, min_steps, max_steps,
              target_rel_sem, equil_blocks, generator, log=None,
              fugacities=None, sample_sink=None) -> tuple:
    """Run one pressure point to its uncertainty target, drawing from
    ``generator``.  Returns (states, stats dict).  ``sample_sink``: an
    open text file that gets one JSON record per (block, chain) sample —
    the instantaneous U and per-species N that analyze.gcmc_mbar reads."""
    avgs = Averages()
    chain_n: List[List[float]] = [[] for _ in range(chains)]
    per_species = {nm: [[] for _ in range(chains)]
                   for nm in su.species_names}
    corr = max(corrtime, 1)
    steps = 0
    block = 0
    refresh_rows = metropolis.frozen_refresh_rows(su.params, su.cfg)
    while True:
        states, _ = multichain.run_chunk_batched(
            states, su.params, su.cfg, thermo, corr, generator=generator)
        states = multichain.initialize_batched(
            states, su.params, su.cfg, thermo, frozen_rows=refresh_rows)
        steps += corr
        block += 1
        if block <= equil_blocks:
            continue
        per_chain = run_mod.observables_batched(su, states, chains)
        for c, o in enumerate(per_chain):
            chain_n[c].append(o["N"])
            for nm in su.species_names:
                per_species[nm][c].append(o[f"N_{nm}"])
            avgs.add(o)
            if sample_sink is not None:
                rec = {"step": steps, "chain": c,
                       "energy_total": o["energy_total"], "N": o["N"]}
                rec.update({f"N_{nm}": o[f"N_{nm}"]
                            for nm in su.species_names})
                sample_sink.write(json.dumps(rec) + "\n")
        means = np.array([np.mean(v) for v in chain_n])
        n_mean = float(means.mean())
        n_sem = (float(means.std(ddof=1) / np.sqrt(chains)) if chains > 1
                 else float("inf"))
        done_unc = (chains > 1 and n_mean > 0
                    and n_sem / n_mean <= target_rel_sem
                    and steps >= min_steps)
        if log is not None:
            print(f"  block {block}: <N>={n_mean:.3f} sem={n_sem:.4f} "
                  f"({steps} steps)", file=log, flush=True)
        if done_unc or steps >= max_steps:
            return states, {
                "n_mean": n_mean, "n_sem": n_sem, "steps": steps,
                "wt_pct": avgs.mean("wt_pct"),
                "qst_kj_mol": avgs.qst(float(thermo.temperature)),
                "extra": _species_stats(
                    su, per_species,
                    fugacities if fugacities is not None
                    else [float("nan")] * len(su.species_names)),
            }


CAMPAIGN_SPIN_TRAP = (
    "quantum_rotation in an isotherm campaign: the reference's campaign "
    "(mpmc_tpu/campaign.py:169-266) stacks its chains with no spins or "
    "rotor table, and its batched step's spinflip reads them "
    "(mpmc_tpu/mc/metropolis.py:608: TypeError on a small deck), so "
    "there is no campaign with spinflip to port; run the points as "
    "'chains N' decks")


def run_isotherm(job, pressures, chains=16, target_rel_sem=0.02,
                 min_steps=2000, max_steps=50000, equil_blocks=2,
                 checkpoint_dir: Optional[str] = None, log=None,
                 warm_start=True, samples_dir: Optional[str] = None,
                 device=None) -> List[PointResult]:
    """Sweep ``pressures`` (atm) on ``device`` (default: the current CUDA
    device) and return one PointResult per point.

    With ``checkpoint_dir``, finished points are recorded in
    ``manifest.json`` and the chains with the generator's state in
    ``states``; rerunning the same campaign resumes after the last
    finished pressure.  Without ``warm_start`` every point starts from the
    deck's state with the generator seeded anew.

    With ``samples_dir``, every point writes ``point_NNN.jsonl`` — a
    run_meta header and one record per (block, chain) sample — for
    ``analyze.py gcmc-mbar`` to reweight the whole campaign into a
    continuous-fugacity isotherm.

    ``quantum_rotation`` (outside nve) is refused with a ValueError
    (CAMPAIGN_SPIN_TRAP): the reference's campaign sets no spins or rotor
    table, so its spinflip move fails there."""
    if job.cfg.quantum_rotation and job.cfg.ensemble != "nve":
        raise ValueError(CAMPAIGN_SPIN_TRAP)
    su = run_mod.setup(job, device=device)
    device = su.state.pos.device
    state = metropolis.initialize(su.state, su.params, su.cfg, su.thermo)
    states = multichain.stack_states(state, chains)
    generator = torch.Generator(device=device).manual_seed(su.cfg.seed)

    results: List[PointResult] = []
    done_pressures: List[float] = []
    manifest_path = states_path = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        manifest_path = os.path.join(checkpoint_dir, "manifest.json")
        states_path = os.path.join(checkpoint_dir, "states")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                saved = json.load(f)
            results = [PointResult.from_row(r) for r in saved["rows"]]
            done_pressures = [r.pressure_atm for r in results]
            if os.path.exists(states_path) and done_pressures:
                states = checkpoint.load(states_path, states,
                                         generator=generator)[0]
                if log is not None:
                    print(f"resuming: {len(results)} points done",
                          file=log, flush=True)

    if samples_dir:
        os.makedirs(samples_dir, exist_ok=True)
    for p_i, p_atm in enumerate(pressures):
        if any(abs(p_atm - d) < 1e-12 for d in done_pressures):
            continue
        jb = dataclasses.replace(job, pressure=p_atm)
        fug = run_mod.compute_fugacities(jb, su.species_names,
                                         len(su.species))
        thermo = su.thermo.replace(
            pressure=torch.full_like(su.thermo.pressure, p_atm),
            fugacity=torch.as_tensor(
                np.resize(np.asarray(fug, np.float64),
                          tuple(su.thermo.fugacity.shape)),
                dtype=su.cfg.tdtype, device=device))
        if log is not None:
            print(f"pressure {p_atm} atm (fugacity {fug[0]:.5g} atm)",
                  file=log, flush=True)
        if not warm_start:
            states = multichain.stack_states(state, chains)
            generator.manual_seed(su.cfg.seed)
        sink = None
        if samples_dir:
            sink = open(os.path.join(samples_dir,
                                     f"point_{p_i:03d}.jsonl"), "w")
            sink.write(json.dumps({"run_meta": {
                "species": list(su.species_names),
                "ensemble": str(su.cfg.ensemble),
                "temperature": float(jb.temperature),
                "pressure": float(p_atm),
                "fugacities": [float(v) for v in fug],
                "volume": float(torch.abs(torch.linalg.det(
                    su.state.box.double()))),
                "n_chains": int(chains)}}) + "\n")
        t0 = time.time()
        try:
            states, stats = run_point(
                su, states, thermo, chains, su.cfg.corrtime, min_steps,
                max_steps, target_rel_sem, equil_blocks, generator,
                log=log, fugacities=fug, sample_sink=sink)
        finally:
            if sink is not None:
                sink.close()
        wall = time.time() - t0
        if log is not None:
            print(f"  point done: {stats['steps']} steps, <N>="
                  f"{stats['n_mean']:.3f} +- {stats['n_sem']:.4f} in "
                  f"{wall:.2f} s ({chains * stats['steps'] / wall:.2f} "
                  "chain-steps/s)", file=log, flush=True)
        results.append(PointResult(
            pressure_atm=p_atm, fugacity_atm=float(fug[0]),
            n_mean=stats["n_mean"], n_sem=stats["n_sem"],
            wt_pct=stats["wt_pct"], qst_kj_mol=stats["qst_kj_mol"],
            steps=stats["steps"], extra=stats["extra"]))
        done_pressures.append(p_atm)
        if checkpoint_dir:
            checkpoint.save(states_path, states, generator=generator)
            with open(manifest_path, "w") as f:
                json.dump({"rows": [r.row() for r in results]}, f,
                          indent=1)
    return results


def write_csv(results: List[PointResult], path: str) -> None:
    rows = [r.row() for r in results]
    # the union of the keys, the first row's order first: rows can differ
    # (a campaign resumed from an older manifest mixes plain and
    # per-species rows)
    fields = list(rows[0])
    for r in rows[1:]:
        fields.extend(k for k in r if k not in fields)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    """The campaign CLI (the options of examples/isotherm.py)."""
    ap = argparse.ArgumentParser(
        prog="python -m mpmc_tpu_torch.campaign",
        description="Sorption-isotherm campaign: restart-aware pressure "
                    "sweeps with uncertainty-targeted stopping.")
    ap.add_argument("input", help="base input script (.inp)")
    ap.add_argument("--pressures", type=float, nargs="+", required=True)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--target-rel-sem", type=float, default=0.02,
                    help="stop a point when SEM(<N>)/<N> falls below this")
    ap.add_argument("--min-steps", type=int, default=5000)
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--equil-blocks", type=int, default=2,
                    help="corrtime blocks discarded as equilibration")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for resumable campaign state")
    ap.add_argument("--samples-dir", default=None,
                    help="directory for the per-point sample streams "
                         "(point_NNN.jsonl)")
    ap.add_argument("--cold-start", action="store_true",
                    help="fresh chains per pressure (no warm start)")
    ap.add_argument("-o", "--output", default="isotherm.csv")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    job = input_script.parse_file(args.input)
    rows = run_isotherm(
        job, pressures=args.pressures, chains=args.chains,
        target_rel_sem=args.target_rel_sem, min_steps=args.min_steps,
        max_steps=args.max_steps, equil_blocks=args.equil_blocks,
        checkpoint_dir=args.checkpoint_dir, log=sys.stdout,
        warm_start=not args.cold_start, samples_dir=args.samples_dir,
        device="cpu" if args.cpu else None)
    write_csv(rows, args.output)
    print(f"isotherm written to {args.output}")
    return rows


if __name__ == "__main__":
    main()
