"""Run output: stdout log, per-term energy CSV, trajectory/restart PQR,
dipole/field files, and the final averages block.

Rebuild of the reference's output writer (SURVEY.md §2 "Output writer",
src/io/output.c [M]; §5 metrics table): same physical observables, plus a
structured JSONL stream (one object per corrtime) for machine consumption
— the SURVEY §5 "rebuild note".
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Optional, TextIO

import numpy as np

from mpmc_tpu_torch.constants import DEBYE_PER_EA
from mpmc_tpu_torch.io import pqr as pqr_io
from mpmc_tpu_torch.utils.averages import Averages


class RunWriter:
    def __init__(self, job, species_names, log: Optional[TextIO] = None,
                 jsonl_path: Optional[str] = None):
        self.job = job
        self.species_names = species_names
        self.log = log or sys.stdout
        self.energy_f = open(job.energy_output, "w") if job.energy_output \
            else None
        if self.energy_f:
            self.energy_f.write(
                "step,rd,lrc,es_real,es_recip,es_self,es_excl,polar,vdw,"
                "total,n_molecules,volume\n")
        self.jsonl_f = open(jsonl_path, "w") if jsonl_path else None
        self._wrote_traj_header = False
        self._wrote_ptraj_header = False

    def log_block(self, step: int, obs: Dict[str, float], stats=None):
        e = obs
        if getattr(self.job, "long_output", False):
            # reference's long_output: more decimals (SURVEY §2.9 "I/O")
            line = (f"step {step:>10d}  E {e['energy_total']:20.10f} K  "
                    f"rd {e['energy_rd']:18.10f}  "
                    f"es {e['energy_es']:18.10f}  "
                    f"polar {e['energy_polar']:16.10f}  "
                    f"N {e['N']:7.1f}  "
                    f"rho {e.get('density_g_cm3', 0.0):12.9f}")
        else:
            line = (f"step {step:>10d}  E {e['energy_total']:14.4f} K  "
                    f"rd {e['energy_rd']:12.4f}  es {e['energy_es']:12.4f}  "
                    f"polar {e['energy_polar']:10.4f}  "
                    f"N {e['N']:7.1f}  rho {e.get('density_g_cm3', 0.0):8.5f}")
        if stats is not None:
            att = np.maximum(np.asarray(stats.attempts), 1)
            acc = np.asarray(stats.accepts) / att
            line += (f"  acc d/i/d/v "
                     f"{acc[0]:4.2f}/{acc[1]:4.2f}/{acc[2]:4.2f}/{acc[3]:4.2f}")
        print(line, file=self.log, flush=True)
        if self.energy_f:
            self.energy_f.write(
                f"{step},{e['energy_rd']},{e['energy_lrc']},"
                f"{e['energy_es_real']},{e['energy_es_recip']},"
                f"{e['energy_es_self']},{e['energy_es_excl']},"
                f"{e['energy_polar']},{e['energy_vdw']},{e['energy_total']},"
                f"{e['N']},{e['volume']}\n")
            self.energy_f.flush()
        if self.jsonl_f:
            self.jsonl_f.write(json.dumps({"step": step, **obs}) + "\n")
            self.jsonl_f.flush()

    def log_meta(self, *, ensemble=None, temperature=None, pressure=None,
                 fugacities=None, volume=None, n_chains=None):
        """Self-describing run header: ONE ``run_meta`` JSONL record
        written before any observable blocks, carrying the state
        definition (ensemble, T [K], P [atm], per-species fugacities
        [atm], cell volume [A^3]).  The reweighting analyzers
        (analyze.gcmc_mbar) read the thermodynamic state of each run
        from its own stream instead of requiring it on the command
        line.  No-op without a JSONL stream."""
        if not self.jsonl_f:
            return
        meta = {"species": list(self.species_names)}
        if ensemble is not None:
            meta["ensemble"] = str(ensemble)
        if temperature is not None:
            meta["temperature"] = float(temperature)
        if pressure is not None:
            meta["pressure"] = float(pressure)
        if fugacities is not None:
            meta["fugacities"] = [float(f) for f in np.asarray(fugacities)
                                  .ravel()]
        if volume is not None:
            meta["volume"] = float(volume)
        if n_chains is not None:
            meta["n_chains"] = int(n_chains)
        self.jsonl_f.write(json.dumps({"run_meta": meta}) + "\n")
        self.jsonl_f.flush()

    def log_ladder(self, step: int, temps, obs_list, fugacities=None):
        """One JSONL record per PT block with the FULL ladder state —
        per-replica temperature, potential energy, and loading — the
        input the MBAR reweighting analyzers (analyze.py::pt_mbar,
        pt_gcmc_mbar) consume to turn one PT run into continuous-T (or,
        with ``fugacities`` [R] from a fixed-T fugacity ladder,
        continuous-pressure) observable curves.  No-op without a JSONL
        stream."""
        if not self.jsonl_f:
            return
        rec = {"step": step,
               "pt_temps": [float(t) for t in temps],
               "pt_energy": [o["energy_total"] for o in obs_list],
               "pt_N": [o["N"] for o in obs_list]}
        if fugacities is not None:
            rec["pt_fug"] = [float(f) for f in fugacities]
        self.jsonl_f.write(json.dumps(rec) + "\n")
        self.jsonl_f.flush()

    def write_restart(self, params, state):
        if self.job.pqr_restart:
            pqr_io.write_state(self.job.pqr_restart, params, state,
                               self.species_names,
                               remark=f"restart step {int(state.step)}",
                               wrap=self.job.cfg.wrapall)

    def write_parallel_restarts(self, params, states, n: int):
        """One restart PQR per chain: <pqr_restart>-rK (the reference's
        per-MPI-rank parallel_restarts, SURVEY §2)."""
        if not (self.job.pqr_restart and self.job.parallel_restarts):
            return
        from mpmc_tpu_torch.state import slice_chain
        base = self.job.pqr_restart
        for k in range(n):
            st = slice_chain(states, k)
            pqr_io.write_state(f"{base}-r{k}", params, st,
                               self.species_names,
                               remark=f"restart replica {k} step "
                                      f"{int(st.step)}",
                               wrap=self.job.cfg.wrapall)

    def append_trajectory(self, params, state):
        if self.job.traj_output:
            mode = "w" if not self._wrote_traj_header else "a"
            pqr_io.write_state(self.job.traj_output, params, state,
                               self.species_names, mode=mode,
                               remark=f"frame step {int(state.step)}",
                               wrap=self.job.cfg.wrapall)
            self._wrote_traj_header = True

    def append_parallel_trajectories(self, params, states, n: int):
        """One trajectory PQR per chain beyond chain 0: <traj_output>-rK
        (gated on ``parallel_restarts``, the same per-rank-files switch as
        the restarts — the reference keeps one output stream per MPI
        rank, SURVEY §2 "MPI layer")."""
        if not (self.job.traj_output and self.job.parallel_restarts):
            return
        from mpmc_tpu_torch.state import slice_chain
        mode = "w" if not self._wrote_ptraj_header else "a"
        for k in range(1, n):
            st = slice_chain(states, k)
            pqr_io.write_state(f"{self.job.traj_output}-r{k}", params,
                               st, self.species_names, mode=mode,
                               remark=f"frame replica {k} step "
                                      f"{int(st.step)}",
                               wrap=self.job.cfg.wrapall)
        self._wrote_ptraj_header = True

    def write_dipoles(self, params, state):
        """dipole_output / field_output: induced dipoles [Debye] and static
        fields per polarizable site (SURVEY.md §2 "Output writer")."""
        if not (self.job.dipole_output or self.job.field_output):
            return
        if state.mu is None:
            return
        mu = state.mu.cpu().numpy()
        alive = state.atom_alive(params).cpu().numpy()
        pol = params.polar.cpu().numpy() > 0
        sel = alive & pol
        if self.job.dipole_output:
            with open(self.job.dipole_output, "w") as f:
                f.write("# site mu_x mu_y mu_z (Debye)\n")
                for i in np.nonzero(sel)[0]:
                    d = mu[i] * DEBYE_PER_EA
                    f.write(f"{i} {d[0]:.6f} {d[1]:.6f} {d[2]:.6f}\n")
        if self.job.field_output and state.e0 is not None:
            e0 = state.e0.cpu().numpy()
            with open(self.job.field_output, "w") as f:
                f.write("# site e0_x e0_y e0_z (e/A^2)\n")
                for i in np.nonzero(sel)[0]:
                    f.write(f"{i} {e0[i][0]:.6f} {e0[i][1]:.6f} "
                            f"{e0[i][2]:.6f}\n")

    def final_averages(self, avgs: Averages, temperature: float,
                       species_names=None, fugacities=None):
        p = self.log
        print("\n=== averages ===", file=p)
        # binary-mixture adsorption selectivity S_ij = (x_i/x_j)/(y_i/y_j)
        # with gas-phase composition from the fugacity ratio — the
        # separation observable MPMC users compute from sorbateInfo stats
        if fugacities is not None and len(self.species_names) > 1:
            f = np.asarray(fugacities, np.float64)
            for i in range(len(self.species_names)):
                for j in range(i + 1, len(self.species_names)):
                    ni = avgs.mean(f"N_{self.species_names[i]}")
                    nj = avgs.mean(f"N_{self.species_names[j]}")
                    if (np.isfinite(ni) and np.isfinite(nj) and nj > 0
                            and f[i] > 0 and f[j] > 0):
                        s_ij = (ni / nj) / (f[i] / f[j])
                        nm = (f"S_{self.species_names[i]}/"
                              f"{self.species_names[j]}")
                        print(f"  {nm:>20s} = {s_ij:14.6f}", file=p)
        for key in sorted(avgs.samples):
            print(f"  {key:>20s} = {avgs.mean(key):14.6f} "
                  f"+/- {avgs.sem(key):12.6f}", file=p)
        qst = avgs.qst(temperature)
        if np.isfinite(qst):
            print(f"  {'Qst (kJ/mol)':>20s} = {qst:14.6f}", file=p)
        if len(self.species_names) > 1:
            # multi-sorbate per-species isosteric heats (the reference's
            # sorbateInfo_t stats, SURVEY.md §2 "Averages / observables")
            for nm in self.species_names:
                q_s = avgs.qst(temperature, n_key=f"N_{nm}")
                if np.isfinite(q_s):
                    print(f"  {f'Qst_{nm} (kJ/mol)':>20s} = {q_s:14.6f}",
                          file=p)
        cv = avgs.heat_capacity(temperature)
        if np.isfinite(cv):
            print(f"  {'Cv (kJ/mol/K)':>20s} = {cv:14.6f}", file=p)
        if "volume" in avgs.samples and len(set(
                avgs.samples["volume"])) > 1:
            print(f"  {'kappa_T (1/atm)':>20s} = "
                  f"{avgs.compressibility(temperature):14.6e}", file=p)
        p.flush()

    def close(self):
        for f in (self.energy_f, self.jsonl_f):
            if f:
                f.close()


def write_tmmc(path: str, c: np.ndarray, *, temperature: float,
               fugacities, volume: float, species,
               insert_species: int) -> str:
    """Write a TMMC collection matrix + the run metadata ``analyze tmmc``
    needs to reweight it (RunConfig.tmmc; our documented extension to the
    reference's µVT loop — SURVEY §2 "MC main loop").

    ``c`` is [cap+1, 4]: per-macrostate (n_ins_attempts, Σ a_ins,
    n_del_attempts, Σ a_del) acceptance-probability statistics.
    Same-state matrices from independent runs may be summed before
    analysis.

    ``insert_species`` is the species index the µVT insert/delete channel
    acts on (the TMMC gate admits exactly one); ``f_sim_atm`` records its
    fugacity alone — a second movable non-insert species may carry its
    own fugacity, which must NOT enter the N-reweighting activity ratio.
    """
    rec = {
        "format": "mpmc_tpu.tmmc.v1",
        "temperature": float(temperature),
        "fugacities_atm": [float(f) for f in fugacities],
        "insert_species": int(insert_species),
        "f_sim_atm": float(fugacities[insert_species]),
        "volume_a3": float(volume),
        "species": list(species),
        "columns": ["n_insert_attempts", "sum_acc_insert",
                    "n_delete_attempts", "sum_acc_delete"],
        "c": np.asarray(c, np.float64).tolist(),
    }
    with open(path, "w") as f:
        json.dump(rec, f)
    return path


def print_energy_report(e, file: Optional[TextIO] = None):
    """Single-point (ensemble te) per-term breakdown — the parity workhorse
    (SURVEY.md §2 "Single point")."""
    p = file or sys.stdout
    print("=== single-point energy (K) ===", file=p)
    for slot in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
                 "polar", "vdw"):
        print(f"  {slot:>10s} = {float(getattr(e, slot)):18.8f}", file=p)
    print(f"  {'es_total':>10s} = {float(e.es):18.8f}", file=p)
    print(f"  {'total':>10s} = {float(e.total):18.8f}", file=p)
    p.flush()
