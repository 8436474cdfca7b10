"""High-level run entry: input files -> system -> MC loop -> outputs
(port of the single-chain scan path — with polarization and its delayed
acceptance —, the fused NVT/NVE, µVT and polar delayed-acceptance paths
and the fused multi-chain path of mpmc_tpu/mc/run.py).

The corrtime structure is the reference's: ``corrtime`` steps per chunk
(mc/metropolis.run_chunk on the scan path; under ``fused_mc``
run_chunk_fused / run_chunk_fused_multi in one launch of kernel B3 for
NVT and NVE, run_chunk_fused_uvt / run_chunk_fused_uvt_multi in one launch
of kernel B1 for µVT, and with polarization and ``polar_delayed``
run_chunk_fused_uvt_polar_da — kernel B6 per segment, the exact SCF per
survivor), then a refresh of the cached energies (full recompute on the
frozen-reuse fast path — B2 restricted to the sorbate rows), observables,
restart/trajectory output, and annealing/adaptation.

The entry points run on the current CUDA device unless the caller names
another (``device="cpu"``), and raise when there is none.  Options outside
this port's slice are refused with NotImplementedError naming the ROADMAP
item that ports them — a refusal, never a fallback.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo, resolve_device
from mpmc_tpu_torch.constants import DEBYE_PER_EA
from mpmc_tpu_torch.io import input_script, output as output_io, pqr as pqr_io
from mpmc_tpu_torch.mc import fugacity as fug_mod
from mpmc_tpu_torch.mc import metropolis
from mpmc_tpu_torch.ops import energy as energy_mod
from mpmc_tpu_torch.ops import pairs as pairs_mod
from mpmc_tpu_torch.ops import thole
from mpmc_tpu_torch.ops.cuda import mc_kernel
from mpmc_tpu_torch.parallel import multichain
from mpmc_tpu_torch.state import (Params, SimState, Species,
                                  all_molecule_coms, build_system,
                                  slice_chain)
from mpmc_tpu_torch.utils.averages import Averages, sorbed_mass_obs


@dataclasses.dataclass
class Setup:
    params: Params
    state: SimState
    cfg: RunConfig
    thermo: Thermo
    species: Tuple[Species, ...]
    species_names: List[str]
    frozen_mass: float
    # the stacked chains at the end of a ``chains N`` run (``state`` is
    # chain 0)
    states: Optional[SimState] = None


def _species_from_atoms(atoms) -> Species:
    atoms = sorted(atoms, key=lambda a: a.serial)
    return Species(
        name=atoms[0].mol_name,
        atom_names=tuple(a.name for a in atoms),
        pos=np.stack([a.xyz for a in atoms]),
        mass=np.array([a.mass for a in atoms]),
        charge=np.array([a.charge for a in atoms]),
        polar=np.array([a.polar for a in atoms]),
        eps=np.array([a.eps for a in atoms]),
        sig=np.array([a.sig for a in atoms]),
        omega=np.array([a.omega for a in atoms]),
        c6=np.array([a.c6 for a in atoms]),
        c8=np.array([a.c8 for a in atoms]),
        c10=np.array([a.c10 for a in atoms]),
        gwp_alpha=np.array([a.gwp_alpha for a in atoms]))


def compute_fugacities(job: input_script.Job, names, nsp=None):
    """Per-species fugacities [atm] for the job's (T, P): explicit
    ``fugacities`` list > per-species EoS fits > ideal f = P."""
    nsp = nsp if nsp is not None else max(len(names), 1)
    if job.fugacities is not None:
        return list(job.fugacities) + [0.0] * (nsp - len(job.fugacities))
    fug = []
    for n in names:
        key = fug_mod.guess_species_key(n)
        if job.fugacity_eos.get(key, False):
            fug.append(fug_mod.fugacity(key, job.temperature,
                                        job.pressure))
        else:
            fug.append(job.pressure)
    return fug or [job.pressure]


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not yet ported — ROADMAP {item}")


def check_supported(job: input_script.Job):
    """Refuse every option outside the port's slice (NotImplementedError
    naming the ROADMAP item)."""
    cfg = job.cfg
    if cfg.ensemble == "npt":
        _refuse("ensemble npt (the hybrid fused NPT and the scan-path "
                "volume move)", "A8b")
    if cfg.ensemble not in ("uvt", "nvt", "nve", "te"):
        _refuse(f"ensemble {cfg.ensemble}", "A12")
    for flag, what, item in (
            (job.chains > 1 and not cfg.fused_mc,
             "chains > 1 without fused_mc (batched scan chains)", "A7"),
            (job.chains > 1 and cfg.ensemble == "nve",
             "chains > 1 with ensemble nve (batched scan chains)", "A7"),
            (job.chains > 1 and cfg.polarization,
             "chains > 1 with polarization (batched scan chains)", "A7"),
            (job.parallel_tempering or job.pt_fugacity,
             "parallel tempering", "A9"),
            (cfg.cavity_bias, "cavity_bias", "A11"),
            (cfg.tmmc, "tmmc", "A11"),
            (cfg.quantum_rotation, "quantum_rotation", "A11"),
            (cfg.cdvdw, "cdvdw", "A12"),
            (cfg.cdvdw_repulsion != "none", "cdvdw repulsion", "A12"),
            (cfg.feynman_hibbs or cfg.feynman_kleinert,
             "feynman_hibbs / feynman_kleinert", "A12"),
            (cfg.quantum_vibration, "quantum_vibration", "A12"),
            (cfg.mol_cache, "mol_cache", "A12"),
            (cfg.cell_list, "cell_list", "A12"),
            (cfg.rd_crystal, "rd_crystal", "A12"),
            (cfg.spectre, "spectre", "A12"),
            (cfg.rd_potential not in ("lj", "none"),
             f"rd_potential {cfg.rd_potential}", "A12"),
            (cfg.coulomb == "gwp", "coulomb gwp", "A12"),
            (job.spatial_devices > 1, "spatial_devices", "A13"),
            (job.chain_devices > 1, "chain_devices", "A13"),
            (bool(job.checkpoint_input or job.checkpoint_output),
             "checkpoint_input/checkpoint_output", "A6")):
        if flag:
            _refuse(what, item)


def _promote_polar_cull(cfg, n_atoms: int):
    """Large derived-rc polar systems (>= 49,152 sites) force the
    tile-culled SCF matvec, as the reference does from its measurement at
    54k sites; an explicit ``polar_cull on/off`` always wins."""
    if (cfg.polarization and cfg.polar_cull == "auto"
            and cfg.cutoff is None and cfg.ortho_box
            and n_atoms >= 49152):
        return dataclasses.replace(cfg, polar_cull="on")
    return cfg


def setup(job: input_script.Job, device=None,
          frame: Optional[pqr_io.PqrFrame] = None) -> Setup:
    """Build (params, state, cfg, thermo) on ``device`` (default: the
    current CUDA device) from a parsed Job."""
    check_supported(job)
    device = resolve_device(device)
    if frame is None:
        if not job.pqr_input:
            raise ValueError("pqr_input is required")
        frame = pqr_io.read(job.pqr_input)
    basis = job.basis
    if job.read_pqr_box and frame.box is not None:
        basis = frame.box
    if basis is None:
        raise ValueError("no cell: provide basis1/2/3, abcbasis, or "
                         "read_pqr_box with a CRYST1 record")
    job = dataclasses.replace(job, basis=basis)

    frozen = sorted(frame.frozen, key=lambda a: a.serial)
    frozen_pos = np.stack([a.xyz for a in frozen]) if frozen else None
    fp = None
    if frozen:
        fp = {k: np.array([getattr(a, k) for a in frozen])
              for k in ("charge", "mass", "polar", "eps", "sig", "omega",
                        "c6", "c8", "c10", "gwp_alpha")}

    # group movable molecules into species by mol_name
    species: List[Species] = []
    names: List[str] = []
    instances: Dict[str, List] = {}
    for mol_id, atoms in sorted(frame.movable_molecules().items()):
        nm = atoms[0].mol_name
        if nm not in names:
            names.append(nm)
            species.append(_species_from_atoms(atoms))
            instances[nm] = []
        sp = species[names.index(nm)]
        if len(atoms) != sp.natoms:
            raise ValueError(
                f"molecule {mol_id} ({nm}) has {len(atoms)} atoms; species "
                f"template has {sp.natoms}")
        instances[nm].append(
            np.stack([a.xyz for a in sorted(atoms, key=lambda x: x.serial)]))

    insert_names: List[str] = []
    if job.insert_input:
        tf = pqr_io.read(job.insert_input)
        mols = tf.movable_molecules() or {0: tf.atoms}
        for _, atoms in sorted(mols.items()):
            nm = atoms[0].mol_name
            if nm not in names:
                names.append(nm)
                species.append(_species_from_atoms(atoms))
                instances[nm] = []
            insert_names.append(nm)
    elif job.cfg.ensemble == "uvt":
        insert_names = list(names)    # clone existing sorbates

    insert_species = tuple(names.index(n) for n in insert_names)
    counts = [len(instances[n]) for n in names]
    capacity = [c + (job.max_molecules if i in insert_species else 0)
                for i, c in enumerate(counts)]
    capacity = [max(c, 1) for c in capacity]
    initial_pos = {i: np.stack(instances[n])
                   for i, n in enumerate(names) if instances[n]}

    b = np.asarray(basis, np.float64)
    cfg = dataclasses.replace(
        job.cfg, insert_species=insert_species,
        ortho_box=bool(np.all(b == np.diag(np.diag(b)))))
    params, state = build_system(
        job.basis, frozen_pos=frozen_pos, frozen_params=fp,
        species=tuple(species), capacity=tuple(capacity),
        initial_counts=tuple(counts), initial_pos=initial_pos,
        dtype=cfg.tdtype, seed=cfg.seed, device=device)
    if job.scale_charge != 1.0:
        params = params.replace(charge=params.charge * job.scale_charge)
    cfg = _promote_polar_cull(cfg, int(params.n_atoms_max))
    if cfg.extrapolate_disp_coeffs:
        c6 = params.c6.cpu().numpy()
        c8 = params.c8.cpu().numpy()
        c10 = np.array(params.c10.cpu().numpy(), np.float64, copy=True)
        m = (c10 == 0) & (c6 > 0) & (c8 > 0)
        c10[m] = 49.0 / 40.0 * c8[m] ** 2 / c6[m]
        params = params.replace(c10=torch.as_tensor(
            c10, dtype=cfg.tdtype, device=device))

    if cfg.coulomb == "ewald":
        # non-neutral cells carry the jellium correction, but only on
        # explicit request (a net charge is usually an input mistake)
        q = params.charge.cpu().numpy().astype(np.float64)
        alive = state.atom_alive(params).cpu().numpy()
        nets = [float(np.sum(np.where(alive, q, 0.0)))] + [
            float(np.sum(np.asarray(species[s].charge, np.float64)))
            for s in insert_species]
        bad = max(abs(x) for x in nets)
        if bad > 1e-3:
            if cfg.allow_charged_cell:
                import warnings
                warnings.warn(
                    f"Ewald with a non-neutral cell: |sum q| = {bad:.6g} e "
                    "— applying the uniform-background (jellium) correction")
            else:
                raise ValueError(
                    f"Ewald with a non-neutral cell: |sum q| = {bad:.6g} e "
                    "(cell or insertable species). Set allow_charged_cell "
                    "to compute it in the jellium convention.")

    nsp = max(len(species), 1)
    thermo = Thermo.make(
        temperature=job.temperature, pressure=job.pressure,
        fugacity=compute_fugacities(job, names, nsp),
        nve_energy=job.total_energy,
        move_factor=job.move_factor, rot_factor=job.rot_factor,
        insert_probability=job.insert_probability,
        volume_probability=job.volume_probability,
        volume_change_factor=job.volume_change_factor,
        spinflip_probability=job.spinflip_probability,
        n_species=nsp, dtype=cfg.tdtype, device=device)
    return Setup(params, state, cfg, thermo, tuple(species), names,
                 float(sum(a.mass for a in frozen)))


def observables(su: Setup, state: SimState, stats=None) -> Dict[str, float]:
    """Per-corrtime observables (host floats)."""
    params = su.params
    e = state.reported_energy()
    obs = {f"energy_{k}": float(v) for k, v in e.as_dict().items()}
    obs["energy_total"] = float(e.total)
    obs["energy_es"] = float(e.es)
    obs["volume"] = float(torch.abs(torch.linalg.det(state.box)))
    obs["N"] = float(state.n_molecules(params))
    obs["N2"] = obs["N"] ** 2
    obs["UN"] = obs["energy_total"] * obs["N"]
    if su.cfg.ensemble == "nve":
        # kinetic temperature of the reservoir: T = 2(E - U)/F over the
        # alive movable molecules' degrees of freedom
        mov = (state.mol_alive & ~params.mol_frozen
               & (params.mol_species >= 0))
        f_dof = float(torch.sum(torch.where(
            mov, params.mol_dof.double(), 0.0)))
        k = float(su.thermo.nve_energy) - obs["energy_total"]
        obs["T_kinetic"] = 2.0 * k / max(f_dof, 1.0)
    if state.mu is not None:
        # RMS induced dipole per polarizable site [Debye] (the
        # reference's polar_rrms diagnostic)
        pol = (params.polar > 0) & state.atom_alive(params)
        n_pol = int(pol.sum())
        if n_pol:
            mu2 = torch.sum(state.mu * state.mu, dim=1)
            obs["polar_rrms_debye"] = float(
                torch.sqrt(torch.sum(torch.where(pol, mu2, 0.0)) / n_pol)
                * DEBYE_PER_EA)
    total_sorb_amu = 0.0
    for i, nm in enumerate(su.species_names):
        n_i = float(state.n_molecules_of(params, i))
        obs[f"N_{nm}"] = n_i
        total_sorb_amu += n_i * su.species[i].total_mass
    obs.update(sorbed_mass_obs(total_sorb_amu, obs["volume"],
                               su.frozen_mass))
    if stats is not None:
        acc = np.asarray(stats.accepts) / np.maximum(stats.attempts, 1)
        for i, nm in enumerate(("displace", "insert", "delete", "volume",
                                "spinflip")):
            obs[f"acc_{nm}"] = float(acc[i])
    return obs


def run_te(job: input_script.Job, log=None, device=None):
    """ensemble te: one energy evaluation + per-term printout."""
    su = setup(job, device=device)
    e, _ = energy_mod.total_energy(
        su.state.pos, su.state.box, su.state.mol_alive, su.params, su.cfg,
        su.thermo)
    output_io.print_energy_report(e, file=log)
    if job.polarizability_tensor:
        alpha = thole.polarizability_tensor(
            su.state.pos, su.state.box, su.state.atom_alive(su.params),
            su.params, su.cfg).cpu().numpy()
        p = log or sys.stdout
        print("=== polarizability tensor (A^3) ===", file=p)
        for row in alpha:
            print("  " + "  ".join(f"{v:12.6f}" for v in row), file=p)
    return e


def observables_batched(su: Setup, states: SimState,
                        n_chains: int) -> List[Dict[str, float]]:
    """Per-chain observables of a stacked state: the keys of
    ``observables`` without the acceptance ratios, from one host copy."""
    params = su.params
    e = states.reported_energy()
    cols = [e.total, e.rd, e.lrc, e.es, e.es_real, e.es_recip, e.es_self,
            e.es_excl, e.polar, e.vdw, torch.abs(torch.linalg.det(states.box)),
            (states.mol_alive & ~params.mol_frozen
             & (params.mol_species >= 0)).sum(1)]
    cols += [(states.mol_alive & (params.mol_species == i)).sum(1)
             for i in range(len(su.species_names))]
    if states.mu is not None:
        # mean squared induced dipole over the polarizable sites
        pol = ((params.polar > 0)[None, :] & states.mol_alive[:, params.mol_id]
               & params.atom_ok[None, :])
        mu2 = torch.sum(states.mu * states.mu, dim=2)
        n_pol = pol.sum(1)
        cols += [torch.sum(torch.where(pol, mu2, 0.0), dim=1)
                 / torch.clamp(n_pol, min=1), n_pol]
    host = torch.stack([x.double() for x in cols], 1).cpu().numpy()
    names = ("energy_total", "energy_rd", "energy_lrc", "energy_es",
             "energy_es_real", "energy_es_recip", "energy_es_self",
             "energy_es_excl", "energy_polar", "energy_vdw", "volume", "N")
    out = []
    for c in range(n_chains):
        obs = {k: float(host[c, i]) for i, k in enumerate(names)}
        obs["N2"] = obs["N"] ** 2
        obs["UN"] = obs["energy_total"] * obs["N"]
        if states.mu is not None and host[c, -1] > 0:
            obs["polar_rrms_debye"] = float(np.sqrt(host[c, -2])
                                            * DEBYE_PER_EA)
        total_amu = 0.0
        for i, nm in enumerate(su.species_names):
            obs[f"N_{nm}"] = float(host[c, len(names) + i])
            total_amu += obs[f"N_{nm}"] * su.species[i].total_mass
        obs.update(sorbed_mass_obs(total_amu, obs["volume"],
                                   su.frozen_mass))
        out.append(obs)
    return out


def _hist_make(job, box):
    """Population histogram, or None when not requested."""
    if not (job.pop_histogram or job.histogram_output):
        return None
    from mpmc_tpu_torch.utils.histogram import PopulationHistogram
    return PopulationHistogram(box.cpu().numpy(), job.hist_resolution)


def _hist_add(hist, state: SimState, params: Params):
    """Bin one chain's alive movable COMs.  run_mc_chains bins every
    chain into one grid — the reference's reduce of per-rank population
    histograms to rank 0."""
    coms = all_molecule_coms(state.pos, params).cpu().numpy()
    sel = metropolis._movable_mask(params, state.mol_alive).cpu().numpy()
    hist.add(coms[sel])


def _hist_finish(hist, job, writer, what=""):
    if hist is None:
        return
    path = job.histogram_output or "histogram.dx"
    hist.write_dx(path)
    print(f"population histogram{what} written to {path}", file=writer.log)


def _adapted(thermo, acc_displace, box, cfg):
    """Move sizes nudged toward ~50 % displace acceptance."""
    scale = float(np.clip(np.sqrt(max(acc_displace, 1e-3) / 0.5), 0.5, 2.0))
    rc_now = float(pairs_mod.derived_cutoff(box, cfg))
    return thermo.replace(
        move_factor=torch.clamp(thermo.move_factor * scale, 1e-3, rc_now),
        rot_factor=torch.clamp(thermo.rot_factor * scale, 1e-3, np.pi))


def _annealed(thermo, job):
    return thermo.replace(temperature=torch.clamp(
        thermo.temperature * job.simulated_annealing_schedule,
        min=job.simulated_annealing_target))


def run_mc(job: input_script.Job, log=None, jsonl_path=None, device=None):
    """The main MC loop (ensemble uvt/nvt/nve): one chain on the scan path,
    or under ``fused_mc`` on the fused NVT/NVE kernel (B3), the fused µVT
    kernel (B1) or, with polarization and ``polar_delayed``, the fused
    polar delayed acceptance (B6); ``chains N`` goes to
    ``run_mc_chains``."""
    if job.chains > 1:
        return run_mc_chains(job, log=log, jsonl_path=jsonl_path,
                             device=device)
    su = setup(job, device=device)
    device = su.state.pos.device
    cfg, params, thermo = su.cfg, su.params, su.thermo
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity.cpu(),
                    volume=float(torch.abs(torch.linalg.det(su.state.box))))
    if job.unknown_options:
        print(f"WARNING: unknown options ignored: {job.unknown_options}",
              file=writer.log)
    chunk = metropolis.run_chunk
    if cfg.fused_mc:
        # the reference's gate order: the NVT/NVE kernel, the µVT one (both
        # refuse polarization), then the polar delayed-acceptance kernel
        if mc_kernel.supported(cfg, params):
            chunk = functools.partial(
                metropolis.run_chunk_fused,
                tables=metropolis.nvt_fused_tables(params,
                                                   su.state.mol_alive))
            print("fused_mc: single-chain fused NVT kernel", file=writer.log)
        elif mc_kernel.supported_uvt(cfg, params):
            chunk = functools.partial(
                metropolis.run_chunk_fused_uvt,
                tables=metropolis.uvt_fused_tables(params, cfg))
            print("fused_mc: single-chain fused µVT kernel", file=writer.log)
        elif mc_kernel.supported_uvt_polar_da(cfg, params):
            chunk = functools.partial(
                metropolis.run_chunk_fused_uvt_polar_da,
                tables=metropolis.uvt_fused_tables(
                    params, mc_kernel.pda_effective_cfg(cfg, params)))
            print("fused_mc: polar delayed-acceptance stage-1 kernel "
                  "(exact SCF stage 2 per survivor)", file=writer.log)
        elif cfg.polarization and cfg.polar_delayed:
            print("WARNING: polar_delayed requested but the fused "
                  "stage-1 kernel refuses this combination (it needs "
                  "a delta-able static field — direct, polar_wolf, or "
                  "polar_ewald over coulomb ewald — the CG solver, "
                  "and no cdvdw) — the scan-path delayed acceptance "
                  "runs instead", file=writer.log)
        else:
            print("WARNING: fused_mc requested but unsupported for this "
                  "configuration (needs rigid <=8-site NVT/NVE or "
                  "<=8-species µVT, lj/none RD, none/cutoff/wolf/ewald ES, "
                  "a neutral template under ewald, f32) — scan path used",
                  file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    if job.frozen_output:
        frame = pqr_io.read(job.pqr_input)
        pqr_io.write(job.frozen_output, frame.frozen,
                     remark="frozen framework")
    avgs = Averages()
    hist = _hist_make(job, state.box)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    corr = max(cfg.corrtime, 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    steps_done = 0
    t0 = time.time()
    for _ in range(n_blocks):
        state, stats = chunk(state, params, cfg, thermo, corr,
                             generator=generator)
        steps_done += corr
        # per-corrtime refresh on the frozen-reuse fast path
        state = metropolis.initialize(state, params, cfg, thermo,
                                      frozen_rows=refresh_rows)
        stats = stats.host()
        obs = observables(su, state, stats)
        if cfg.polarization:
            obs["polar_iters_per_step"] = stats.polar_iters / corr
        avgs.add(obs)
        writer.log_block(int(state.step), obs, stats)
        writer.write_restart(params, state)
        writer.append_trajectory(params, state)
        writer.write_dipoles(params, state)
        if hist is not None:
            _hist_add(hist, state, params)
        if job.adapt_moves:
            thermo = _adapted(thermo, obs.get("acc_displace", 0.5),
                              state.box, cfg)
        if job.simulated_annealing:
            thermo = _annealed(thermo, job)
    wall = time.time() - t0
    _hist_finish(hist, job, writer)
    if job.pqr_output:
        pqr_io.write_state(job.pqr_output, params, state, su.species_names,
                           remark=f"final step {state.step}")
    writer.final_averages(avgs, float(thermo.temperature),
                          fugacities=thermo.fugacity.cpu().numpy())
    print(f"steps/sec: {steps_done / max(wall, 1e-9):.2f}  "
          f"({steps_done} steps in {wall:.2f}s)", file=writer.log)
    writer.close()
    return dataclasses.replace(su, state=state, thermo=thermo), avgs


def run_mc_chains(job: input_script.Job, log=None, jsonl_path=None,
                  device=None):
    """``chains N``: N independent chains advanced together in one launch
    per corrtime of the fused NVT kernel (B3) or the fused µVT kernel
    (B1).  Observables are averaged over the chains each corrtime (the
    reference's cross-rank observable reduce); restart and trajectory
    follow chain 0, with one file per chain under ``parallel_restarts``.
    The batched scan path the reference takes for what the fused gates
    refuse is not ported."""
    su = setup(job, device=device)
    device = su.state.pos.device
    cfg, params, thermo = su.cfg, su.params, su.thermo
    if mc_kernel.supported_multi(cfg, params):
        chunk = functools.partial(
            metropolis.run_chunk_fused_multi,
            tables=metropolis.nvt_fused_tables(params, su.state.mol_alive))
    elif mc_kernel.supported_uvt_multi(cfg, params):
        chunk = functools.partial(
            metropolis.run_chunk_fused_uvt_multi,
            tables=metropolis.uvt_fused_tables(params, cfg))
    else:
        _refuse("chains > 1 outside the fused NVT and µVT surfaces "
                "(batched scan chains)", "A7")
    C = job.chains
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity.cpu(),
                    volume=float(torch.abs(torch.linalg.det(su.state.box))),
                    n_chains=C)
    if job.unknown_options:
        print(f"WARNING: unknown options ignored: {job.unknown_options}",
              file=writer.log)
    print(f"batched chains: {C}", file=writer.log)
    print(f"fused_mc: chain-interleaved multi-chain kernel (C={C})",
          file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    states = multichain.stack_states(state, C)
    avgs = Averages()
    hist = _hist_make(job, state.box)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    corr = max(cfg.corrtime, 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    t0 = time.time()
    for _ in range(n_blocks):
        states, stats = chunk(states, params, cfg, thermo, corr,
                              generator=generator)
        states = multichain.initialize_batched(states, params, cfg, thermo,
                                               frozen_rows=refresh_rows)
        per_chain = observables_batched(su, states, C)
        obs = {k: float(np.mean([o[k] for o in per_chain]))
               for k in per_chain[0]}
        obs["N_sem_chains"] = float(np.std([o["N"] for o in per_chain])
                                    / np.sqrt(C))
        stats = stats.host()
        acc = stats.accepts.sum(0) / np.maximum(stats.attempts.sum(0), 1)
        for i, nm in enumerate(("displace", "insert", "delete", "volume",
                                "spinflip")):
            obs[f"acc_{nm}"] = float(acc[i])
        avgs.add(obs)
        st0 = slice_chain(states, 0)
        writer.log_block(int(st0.step), obs, None)
        writer.write_restart(params, st0)
        writer.write_parallel_restarts(params, states, C)
        writer.append_trajectory(params, st0)
        writer.append_parallel_trajectories(params, states, C)
        if hist is not None:
            for c in range(C):
                _hist_add(hist, slice_chain(states, c), params)
        if job.adapt_moves:
            thermo = _adapted(thermo, obs["acc_displace"], st0.box, cfg)
        if job.simulated_annealing:
            thermo = _annealed(thermo, job)
    wall = time.time() - t0
    steps_done = n_blocks * corr
    _hist_finish(hist, job, writer, f" ({C} chains reduced)")
    writer.final_averages(avgs, float(thermo.temperature),
                          fugacities=thermo.fugacity.cpu().numpy())
    print(f"steps/sec: {steps_done * C / max(wall, 1e-9):.2f} aggregate "
          f"({C} chains x {steps_done} steps in {wall:.2f}s)",
          file=writer.log)
    writer.close()
    return dataclasses.replace(su, state=st0, thermo=thermo,
                               states=states), avgs


def run(job: input_script.Job, **kw):
    """Run a parsed job on ``device`` (keyword; default the current CUDA
    device, and an error without one)."""
    if job.cfg.ensemble in ("nvt", "nve", "uvt"):
        return run_mc(job, **kw)
    if job.cfg.ensemble == "te":
        kw.pop("jsonl_path", None)
        return run_te(job, **kw)
    check_supported(job)
    raise NotImplementedError(
        f"ensemble {job.cfg.ensemble!r} not yet implemented")
