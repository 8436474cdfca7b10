"""High-level run entry: input files -> system -> MC loop -> outputs
(port of the single-chain scan path — with polarization and its delayed
acceptance —, the fused NVT/NVE, µVT and polar delayed-acceptance paths,
the fused multi-chain path, the batched scan chains — with polarization
too — and single-card parallel tempering of mpmc_tpu/mc/run.py).

The corrtime structure is the reference's: ``corrtime`` steps per chunk
(mc/metropolis.run_chunk on the scan path; under ``fused_mc``
run_chunk_fused / run_chunk_fused_multi in one launch of kernel B3 for
NVT and NVE, run_chunk_fused_uvt / run_chunk_fused_uvt_multi in one launch
of kernel B1 for µVT, and with polarization and ``polar_delayed``
run_chunk_fused_uvt_polar_da — kernel B6 per segment, the exact SCF per
survivor), then a refresh of the cached energies (full recompute on the
frozen-reuse fast path — B2 restricted to the sorbate rows; under
``cavity_bias`` the open-cell grid rebuilt), observables,
restart/trajectory output, under ``tmmc`` the collection matrix flushed
into float64 on the host (and under ``tmmc_bias`` eta rebuilt from it),
under ``quantum_rotation`` the rotor free-energy table rebuilt
(ops/qrot.py; the spins are drawn once, before a checkpoint is read),
and annealing/adaptation; a tmmc run ends by writing the matrix for
``python -m mpmc_tpu_torch.analyze tmmc``.  Under ``spectre`` (one chain)
the S-flagged sites' charges are renormalized between each chunk and its
refresh (mc/spectre.py); under ``quantum_vibration`` each block adds the
stretch levels' ``qvib_zpe`` and ``qvib_fundamental_shift``
(ops/qvib.py, one B4 launch per refresh).  ``cell_list`` attaches the
framework cell index at set-up (ops/celllist.attach) and ``mol_cache`` (a
RunConfig field, no deck keyword) carries the molecule-pair cache; the
ensembles surf, surf_fit and surf_multi_fit run in mc/surface.py.

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
from mpmc_tpu_torch.constants import ATM2K_A3, DEBYE_PER_EA
from mpmc_tpu_torch.io import checkpoint, input_script
from mpmc_tpu_torch.io import native as native_io
from mpmc_tpu_torch.io import output as output_io, pqr as pqr_io
from mpmc_tpu_torch.mc import fugacity as fug_mod
from mpmc_tpu_torch.mc import metropolis, moves
from mpmc_tpu_torch.mc import spectre as spectre_mod
from mpmc_tpu_torch.ops import energy as energy_mod
from mpmc_tpu_torch.ops import pairs as pairs_mod
from mpmc_tpu_torch.ops import qrot, qvib, thole
from mpmc_tpu_torch.ops.cuda import mc_kernel
from mpmc_tpu_torch.parallel import multichain, replica
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
    # parallel tempering: the last swap round's inputs and decisions
    # (run_mc_pt, run_mc_pt_fug)
    pt_round: Optional[dict] = None
    # quantum rotation: the rotor basis' largest l
    lmax: int = 4
    # species whose PQR atoms carry the S flag (mc/spectre.py)
    spectre_species: Tuple[int, ...] = ()


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


NPT_PT_TRAP = (
    "ensemble npt under parallel tempering: the swap rule (b_i - b_j)"
    "(E_i - E_j) lacks the P (V_i - V_j) term of the isothermal-isobaric "
    "weight, so the ladder would sample the wrong ensemble (the trap of "
    "mpmc_tpu/parallel/replica.py:109-131, :370-398)")


FH_PT_TRAP = (
    "feynman_hibbs / feynman_kleinert under parallel_tempering: the "
    "corrected pair energy depends on T, and the swap rule (b_i - b_j)"
    "(E_i - E_j) prices each configuration at its own rung's T only — the "
    "isothermal weight needs beta_i U_{T_i}(x_j) + beta_j U_{T_j}(x_i) - "
    "beta_i U_{T_i}(x_i) - beta_j U_{T_j}(x_j), so the ladder would sample "
    "the wrong ensemble (the trap of mpmc_tpu/parallel/replica.py:109-131 "
    "with mpmc_tpu/mc/run.py:963-973)")


def check_supported(job: input_script.Job):
    """Refuse every option outside the port's slice (NotImplementedError
    naming the ROADMAP item), and NPT or Feynman-Hibbs/Kleinert under a
    temperature ladder (ValueError, NPT_PT_TRAP and FH_PT_TRAP); NPT
    with a frozen molecule is refused by make_step_fn /
    make_batched_step_fn (metropolis.check_npt).  The RD forms sg,
    dreiding, b14_7, disp_expansion and coulomb gwp run on every route:
    under fused_mc in the fused kernels' form instances (B1, B3 and B6,
    mc_kernel.FORM_STEM) wherever the reference's gate takes them,
    else on the scan path and batched chains (B2 and B4's form instances,
    or for gwp the plain pass; log_pair_route).  Polar NPT, cdvdw and its
    repulsions, rd_crystal, spectre and quantum_vibration run where the
    reference runs them: the scan path and the batched chains (the fused
    gates refuse them, as the reference's do).  ``cell_list`` and
    ``mol_cache`` run on the scan path and the batched chains (the fused
    kernels ignore both, as the reference's do), and the ensembles surf,
    surf_fit and surf_multi_fit through mc/surface.py."""
    cfg = job.cfg
    if cfg.ensemble == "npt":
        if job.parallel_tempering or job.pt_fugacity:
            raise ValueError(NPT_PT_TRAP)
    if ((cfg.feynman_hibbs or cfg.feynman_kleinert)
            and job.parallel_tempering and not job.pt_fugacity):
        raise ValueError(FH_PT_TRAP)
    metropolis.check_cdvdw(cfg)
    if cfg.ensemble not in ("uvt", "nvt", "nve", "npt", "te", "replay",
                            "surf", "surf_fit", "surf_multi_fit"):
        _refuse(f"ensemble {cfg.ensemble}", "A12b")
    for flag, what, item in (
            (job.spatial_devices > 1, "spatial_devices", "A13"),
            (job.chain_devices > 1, "chain_devices", "A13")):
        if flag:
            _refuse(what, item)


def log_pair_route(cfg, log, params=None):
    """Name the route of the pair passes in the run log where it is not
    the kernels': B2 and B4's static gate (pair_kernel.supported, the
    reference's) refuses Feynman-Hibbs/Kleinert, coulomb gwp and the
    cdvdw repulsions, and the refresh and the per-move deltas run the
    plain tile pass on the device, as the reference's scan path runs its
    jnp tile pass for them; under rd_crystal, RD is the plain image sum
    and the rest the kernels' pass with rd none.  Under fused_mc with an
    RD form or coulomb gwp, name the fused kernels' form instances, which
    take them wherever a fused gate holds."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel
    if cfg.rd_crystal:
        print(f"pair passes: rd {cfg.rd_potential} from the periodic-image "
              f"lattice sum (order {cfg.rd_crystal_order}, plain, on the "
              "device), ES and the overlap test from the cutoff pass with "
              "rd none", file=log)
        cfg = dataclasses.replace(cfg, rd_potential="none", rd_crystal=False,
                                  cdvdw_repulsion="none")
    if not pair_kernel.supported(cfg):
        print("pair passes: the plain tile pass on the device (B2 and B4's "
              "gate refuses feynman_hibbs / feynman_kleinert / coulomb gwp "
              "/ the cdvdw repulsions, as the reference's does)", file=log)
    if cfg.cell_list and params is not None:
        ci = params.cell_index
        if ci is None:
            print("cell_list: no index (no explicit cutoff or frozen "
                  "framework, a cdvdw repulsion, or too little reduction) "
                  "— the dense per-move pass", file=log)
        else:
            print(f"cell_list: framework cell index, grid {ci.grid}, "
                  f"{ci.offsets.shape[0]} cells x {ci.fw_pos.shape[1]} "
                  f"slots = {ci.columns} of {ci.n_frozen} framework "
                  "columns a move — the per-move deltas are the culled "
                  "pass (plain, on the device; B4 is not launched)",
                  file=log)
    if metropolis.cache_eligible(cfg):
        print("mol_cache: the molecule-pair cache prices displace with one "
              "partials pass and delete with none (plain, on the device; "
              "B4 is not launched)", file=log)
    stem = mc_kernel.form_stem(cfg)
    if cfg.fused_mc and stem:
        print(f"fused_mc: rd {cfg.rd_potential} / coulomb {cfg.coulomb} "
              f"run in the fused kernels' form instances (uvt_{stem}_kernel, "
              f"nvt_{stem}_kernel, pda_{stem}_kernel) where a fused gate "
              "takes this deck", file=log)


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

    if job.vib_omega > 0.0:
        # quantum_vibration: the stretch fundamental of the sorbate
        # species (the PQR has no column for it); qvib.vibration_table
        # skips the non-linear ones
        species = [dataclasses.replace(sp, vib_omega=job.vib_omega)
                   for sp in species]

    insert_species = tuple(names.index(n) for n in insert_names)
    if job.cfg.tmmc and len(insert_species) != 1:
        raise ValueError(
            "tmmc requires exactly one insert species (the collection "
            f"matrix is over a scalar macrostate N); got {insert_names}")
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
    if cfg.cell_list:
        from mpmc_tpu_torch.ops import celllist
        params = celllist.attach(params, state.pos, state.box, cfg)

    if cfg.coulomb == "ewald" and not cfg.spectre:
        # non-neutral cells carry the jellium correction, but only on
        # explicit request (a net charge is usually an input mistake);
        # spectre's free charges are non-neutral by construction and its
        # renormalization governs their total
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

    # the species whose source atoms carry the PQR 'S' flag
    spectre_flags: Dict[str, bool] = {}
    for _, atoms in sorted(frame.movable_molecules().items()):
        spectre_flags.setdefault(atoms[0].mol_name,
                                 atoms[0].flag.upper().startswith("S"))
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
                 float(sum(a.mass for a in frozen)),
                 lmax=int(job.quantum_rotation_level_max),
                 spectre_species=tuple(i for i, n in enumerate(names)
                                       if spectre_flags.get(n, False)))


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
    if su.cfg.cavity_bias and state.cavity_open is not None:
        # open cells of the grid this refresh built
        obs["cavity_open"] = float(state.cavity_open.sum())
    if state.spin is not None and state.rot_f is not None:
        obs.update(_qrot_obs(su, state.spin[None], state.rot_f[None],
                             state.mol_alive[None])[0])
    if stats is not None:
        acc = np.asarray(stats.accepts) / np.maximum(stats.attempts, 1)
        for i, nm in enumerate(("displace", "insert", "delete", "volume",
                                "spinflip")):
            obs[f"acc_{nm}"] = float(acc[i])
    return obs


def qvib_obs(su: Setup, state: SimState, thermo: Thermo) -> Dict[str, float]:
    """The quantum-vibration block observables (the reference's keys,
    mpmc_tpu/mc/run.py:1604-1617): the mean zero-point level and the mean
    shift of the fundamental, (E1 - E0) - hbar w_e, over the molecules
    with stretch levels (qvib.vibration_table: one B4 launch); {} where
    there is none."""
    params = su.params
    vt = qvib.vibration_table(state.pos, state.box, state.atom_alive(params),
                              state.mol_alive, params, su.cfg, thermo,
                              list(su.species))
    ok = ~np.isnan(vt[:, 0])
    if not ok.any():
        return {}
    hw = {i: float(sp.vib_omega) * qvib.CM1_K
          for i, sp in enumerate(su.species)}
    sidx = params.mol_species.cpu().numpy()[ok]
    free = np.array([hw.get(int(s), 0.0) for s in sidx])
    return {"qvib_zpe": float(vt[ok, 0].mean()),
            "qvib_fundamental_shift": float(
                ((vt[ok, 1] - vt[ok, 0]) - free).mean())}


def _qrot_obs(su: Setup, spin, rot_f, mol_alive) -> List[Dict[str, float]]:
    """Per chain of [C]-stacked spins, tables and aliveness: the ortho
    fraction of the alive movable rotors (two or more sites) and the mean
    free energy of their spin species, ``energy_qrot`` (the reference's
    keys, mpmc_tpu/mc/run.py:452-466, :506-516); {} where a chain has no
    rotor.  One host copy."""
    params = su.params
    mask = ((mol_alive & ~params.mol_frozen & (params.mol_species >= 0)
             & (params.mol_natoms >= 2)))
    f = torch.gather(rot_f, 2, spin.long()[..., None])[..., 0]
    host = torch.stack([mask.sum(1).double(),
                        torch.where(mask, spin, 0).sum(1).double(),
                        torch.where(mask, f.double(), 0.0).sum(1)],
                       1).cpu().numpy()
    return [{} if n == 0 else {"ortho_fraction": float(o / n),
                               "energy_qrot": float(e / n)}
            for n, o, e in host]


def qrot_init(su: Setup, state: SimState, thermo: Thermo, times=None):
    """``state`` with the run's initial spins (qrot.initial_spins: the
    reference's draw) and the rotor table at its positions — the
    reference's run_mc set-up under quantum_rotation
    (mpmc_tpu/mc/run.py:1451-1466), made before a checkpoint is read."""
    params, cfg = su.params, su.cfg
    dev = state.pos.device
    spins = qrot.initial_spins(cfg.seed, None, params.n_mols_max)
    state = state.replace(spin=torch.as_tensor(spins, device=dev))
    return qrot_refresh(su, state, thermo, times)


def qrot_refresh(su: Setup, state: SimState, thermo: Thermo, times=None,
                 eigs=None):
    """``state`` with its rotor table rebuilt at its positions (every
    refresh; ``times`` as qrot.eigen_tables); ``eigs``: a list that gets
    the eigensolves."""
    cfg = su.cfg
    e = qrot.eigen_tables(state.pos, state.box, state.atom_alive(su.params),
                          state.mol_alive, su.params, cfg, thermo,
                          su.species, lmax=su.lmax, times=times)
    if eigs is not None:
        eigs.append(e)
    table = qrot.table_from_eigs(e, su.params.n_mols_max,
                                 float(thermo.temperature.reshape(-1)[0]))
    return state.replace(rot_f=torch.as_tensor(table, dtype=cfg.tdtype,
                                               device=state.pos.device))


def _qrot_init_batched(su: Setup, states: SimState, temps, times=None):
    """(stacked states with each chain's spins and table, [eigs] per
    chain) for the batched runs (the reference's _qrot_init_batched,
    mpmc_tpu/mc/run.py:341-363): the chains start from one configuration,
    so one eigensolve set serves every chain, its table at each chain's
    temperature ``temps``; the spins of each chain from one [C, M] draw."""
    params, cfg = su.params, su.cfg
    C, dev = states.pos.shape[0], states.pos.device
    st0 = slice_chain(states, 0)
    eigs0 = qrot.eigen_tables(st0.pos, st0.box, st0.atom_alive(params),
                              st0.mol_alive, params, cfg, su.thermo,
                              su.species, lmax=su.lmax, times=times)
    tables = np.stack([qrot.table_from_eigs(eigs0, params.n_mols_max, t)
                       for t in temps])
    spins = qrot.initial_spins(cfg.seed, C, params.n_mols_max)
    return states.replace(spin=torch.as_tensor(spins, device=dev),
                          rot_f=torch.as_tensor(tables, dtype=cfg.tdtype,
                                                device=dev)), [eigs0] * C


def _qrot_refresh_batched(su: Setup, states: SimState, temps, times=None):
    """(stacked states with each chain's table rebuilt at its positions
    and temperature ``temps``, [eigs] per chain): the reference's
    _qrot_refresh_batched (mpmc_tpu/mc/run.py:386-408), each refresh."""
    params, cfg = su.params, su.cfg
    tables, eigs_all = [], []
    for c in range(states.pos.shape[0]):
        st = slice_chain(states, c)
        th = su.thermo.replace(temperature=torch.as_tensor(
            float(temps[c]), dtype=cfg.tdtype, device=st.pos.device))
        eigs = qrot.eigen_tables(st.pos, st.box, st.atom_alive(params),
                                 st.mol_alive, params, cfg, th, su.species,
                                 lmax=su.lmax, times=times)
        eigs_all.append(eigs)
        tables.append(qrot.table_from_eigs(eigs, params.n_mols_max,
                                           float(temps[c])))
    return states.replace(rot_f=torch.as_tensor(
        np.stack(tables), dtype=cfg.tdtype,
        device=states.pos.device)), eigs_all


def _qrot_levels(su: Setup, eigs_all, device):
    """The chains' eigensolves as stacked level arrays on ``device``
    ([R, M, L] levels, parity, valid) for the on-device per-swap table
    rebuild (qrot.free_energies_from_levels)."""
    lv, pr, va = zip(*(qrot.level_arrays(e, su.params.n_mols_max, su.lmax)
                       for e in eigs_all))
    return (torch.as_tensor(np.stack(lv), device=device),
            torch.as_tensor(np.stack(pr), device=device),
            torch.as_tensor(np.stack(va), device=device))


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


def _frame_pressure(su: Setup, state: SimState, job) -> float:
    """Instantaneous pressure [atm] of one frame by the volume-perturbation
    virial, P = (N kT - dU/dlnV) / V, dU/dlnV the central difference of
    two full energies at ln V +- ``calc_pressure_dv`` (moves.scale_volume;
    on the card each one pass of B2)."""
    dlnv = job.calc_pressure_dv
    es = []
    for sgn in (1.0, -1.0):
        p2, b2 = moves.scale_volume(state.pos, state.box, su.params,
                                    sgn * dlnv)
        e2, _ = energy_mod.total_energy(p2, b2, state.mol_alive, su.params,
                                        su.cfg, su.thermo)
        es.append(float(e2.total))
    du_dlnv = (es[0] - es[1]) / (2.0 * dlnv)
    v = float(torch.abs(torch.linalg.det(state.box.double())))
    n = float(state.n_molecules(su.params))
    return (n * job.temperature - du_dlnv) / v / ATM2K_A3


class _ReplayLayout:
    """Where each row of a trajectory frame goes in a Setup's padded
    state: frozen rows, sorted by serial, fill the frozen prefix; movable
    molecules, in ascending mol_id, claim their species' slots in order
    (the reference's dest_map / layout_frame, mpmc_tpu/mc/run.py:631-700).
    Host copies of the slot tables are taken once per Setup."""

    def __init__(self, su: Setup):
        self.su = su
        params = su.params
        self.spec = params.mol_species.cpu().numpy()
        self.mol_atoms = params.mol_atoms.cpu().numpy()
        self.frozen = params.mol_frozen.cpu().numpy()
        self.n_frozen = int(params.mol_natoms.cpu().numpy()[
            self.frozen].sum())
        self.slots_of = [np.nonzero(self.spec == i)[0]
                         for i in range(len(su.species_names))]

    def fit(self, arr):
        """(dest rows [n], mol_alive [M]) of frame ``arr`` in the existing
        slots, or None when it does not fit: a changed frozen prefix, an
        unknown species, a molecule of the wrong size, or more molecules
        of a species than it has slots."""
        flags = np.frombuffer(arr["flags"], np.uint8) == ord("F")
        serials, mol_ids = arr["ids"][:, 0], arr["ids"][:, 1]
        frozen_rows = np.nonzero(flags)[0]
        if len(frozen_rows) != self.n_frozen:
            return None
        dest = np.empty(len(serials), np.int64)
        dest[frozen_rows[np.argsort(serials[frozen_rows],
                                    kind="stable")]] = np.arange(
            len(frozen_rows))
        alive = self.frozen.copy()
        cursor = [0] * len(self.slots_of)
        names = self.su.species_names
        mov = np.nonzero(~flags)[0]
        for mid in np.unique(mol_ids[mov]):
            rows = mov[mol_ids[mov] == mid]
            rows = rows[np.argsort(serials[rows], kind="stable")]
            name = native_io.decode_name(arr["mol_names"], rows[0])
            if name not in names:
                return None
            si = names.index(name)
            if (cursor[si] >= len(self.slots_of[si])
                    or len(rows) != self.su.species[si].natoms):
                return None
            slot = self.slots_of[si][cursor[si]]
            cursor[si] += 1
            dest[rows] = self.mol_atoms[slot][:len(rows)]
            alive[slot] = True
        return dest, alive


def run_replay(job: input_script.Job, log=None, device=None) -> Averages:
    """ensemble replay: the energies and observables of every frame of the
    trajectory ``pqr_input`` (with ``calc_pressure``, the virial
    pressure), averaged; returns the Averages (one sample per frame).

    Frames are read by the native reader, one in memory at a time
    (io/native.py::stream_frames_arrays).  A frame with the previous
    frame's layout writes its positions straight into the padded state; a
    frame whose molecules changed is laid out into the existing slots
    (_ReplayLayout.fit), and only a frame that does not fit — one that
    breaks the running molecule-count maximum — builds a new Setup.  Each
    frame is then one full energy (metropolis.initialize: on the card one
    pass of B2), and two more with the pressure."""
    avgs = Averages()
    su = layout = dest = prev_key = None
    n_setups = n_relayouts = 0
    for arr in native_io.stream_frames_arrays(job.pqr_input):
        key = (arr["flags"], arr["ids"][:, 1].tobytes(), arr["mol_names"])
        if su is None or key != prev_key:
            fit = layout.fit(arr) if layout is not None else None
            if fit is None:
                su = setup(job, device=device,
                           frame=native_io.frame_from_arrays(arr))
                n_setups += 1
                layout = _ReplayLayout(su)
                fit = layout.fit(arr)
            else:
                n_relayouts += 1
            dest, alive = fit
            dest = torch.as_tensor(dest, device=su.state.pos.device)
            su = dataclasses.replace(su, state=su.state.replace(
                mol_alive=torch.as_tensor(alive,
                                          device=su.state.pos.device)))
        prev_key = key
        pos = su.state.pos.clone()
        pos.index_copy_(0, dest, torch.as_tensor(
            arr["num"][:, :3], dtype=pos.dtype, device=pos.device))
        st = su.state.replace(pos=pos)
        if job.read_pqr_box and arr["box"] is not None:
            st = st.replace(box=torch.as_tensor(arr["box"], dtype=pos.dtype,
                                                device=pos.device))
        su = dataclasses.replace(su, state=st)
        state = metropolis.initialize(st, su.params, su.cfg, su.thermo)
        obs = observables(su, state)
        if job.calc_pressure:
            obs["pressure_atm"] = _frame_pressure(su, state, job)
        avgs.add(obs)
    writer = output_io.RunWriter(job, su.species_names if su else [],
                                 log=log)
    if su is not None:
        log_pair_route(su.cfg, writer.log)
    print(f"replay: {avgs.count()} frames, {n_setups} setups, "
          f"{n_relayouts} laid out into the existing slots", file=writer.log)
    writer.final_averages(avgs, job.temperature)
    writer.close()
    return avgs


def observables_batched(su: Setup, states: SimState, n_chains: int,
                        stats=None,
                        n_steps: int = 1) -> List[Dict[str, float]]:
    """Per-chain observables of a stacked state: the keys of
    ``observables`` without the acceptance ratios (with each chain's
    ``T_kinetic`` under nve), from one host copy; with polarization and
    the chunk's ``stats`` (``polar_iters`` [C]) each chain's
    ``polar_iters_per_step`` over ``n_steps``, as run_mc reports one
    chain's."""
    params = su.params
    e = states.reported_energy()
    cols = [e.total, e.rd, e.lrc, e.es, e.es_real, e.es_recip, e.es_self,
            e.es_excl, e.polar, e.vdw, torch.abs(torch.linalg.det(states.box)),
            (states.mol_alive & ~params.mol_frozen
             & (params.mol_species >= 0)).sum(1)]
    cols += [(states.mol_alive & (params.mol_species == i)).sum(1)
             for i in range(len(su.species_names))]
    i_dof = len(cols)
    # kinetic degrees of freedom of the alive movable molecules (nve)
    cols.append(torch.sum(torch.where(
        states.mol_alive & ~params.mol_frozen & (params.mol_species >= 0),
        params.mol_dof.double(), 0.0), dim=1))
    if states.mu is not None:
        # mean squared induced dipole over the polarizable sites
        pol = ((params.polar > 0)[None, :] & states.mol_alive[:, params.mol_id]
               & params.atom_ok[None, :])
        mu2 = torch.sum(states.mu * states.mu, dim=2)
        n_pol = pol.sum(1)
        cols += [torch.sum(torch.where(pol, mu2, 0.0), dim=1)
                 / torch.clamp(n_pol, min=1), n_pol]
    i_cav = len(cols)
    cav = su.cfg.cavity_bias and states.cavity_open is not None
    if cav:
        cols.append(states.cavity_open.sum(1))
    host = torch.stack([x.double() for x in cols], 1).cpu().numpy()
    names = ("energy_total", "energy_rd", "energy_lrc", "energy_es",
             "energy_es_real", "energy_es_recip", "energy_es_self",
             "energy_es_excl", "energy_polar", "energy_vdw", "volume", "N")
    out = []
    for c in range(n_chains):
        obs = {k: float(host[c, i]) for i, k in enumerate(names)}
        obs["N2"] = obs["N"] ** 2
        obs["UN"] = obs["energy_total"] * obs["N"]
        if su.cfg.ensemble == "nve":
            # the chain's kinetic temperature, 2 (E - U) / F (observables)
            k = float(su.thermo.nve_energy) - obs["energy_total"]
            obs["T_kinetic"] = 2.0 * k / max(float(host[c, i_dof]), 1.0)
        if states.mu is not None and host[c, i_cav - 1] > 0:
            obs["polar_rrms_debye"] = float(np.sqrt(host[c, i_cav - 2])
                                            * DEBYE_PER_EA)
        if cav:
            obs["cavity_open"] = float(host[c, i_cav])
        if su.cfg.polarization and stats is not None:
            obs["polar_iters_per_step"] = float(
                np.asarray(stats.polar_iters)[c]) / n_steps
        total_amu = 0.0
        for i, nm in enumerate(su.species_names):
            obs[f"N_{nm}"] = float(host[c, len(names) + i])
            total_amu += obs[f"N_{nm}"] * su.species[i].total_mass
        obs.update(sorbed_mass_obs(total_amu, obs["volume"],
                                   su.frozen_mass))
        out.append(obs)
    if states.spin is not None and states.rot_f is not None:
        for obs, q in zip(out, _qrot_obs(su, states.spin, states.rot_f,
                                         states.mol_alive)):
            obs.update(q)
    return out


def chains_mean(per_chain: List[Dict[str, float]]) -> Dict[str, float]:
    """The cross-chain block line of ``chains N``: each key's mean over
    the chains that report it, keys in first-seen order (a chain whose
    polarizable sites all died reports no ``polar_rrms_debye``), and
    ``N_sem_chains``, the chain spread's standard error of <N>."""
    keys: List[str] = []
    for o in per_chain:
        keys.extend(k for k in o if k not in keys)
    obs = {k: float(np.mean([o[k] for o in per_chain if k in o]))
           for k in keys}
    obs["N_sem_chains"] = float(np.std([o["N"] for o in per_chain])
                                / np.sqrt(max(len(per_chain), 1)))
    return obs


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


class _TmmcHost:
    """The run's TMMC matrix in float64 on the host (cfg.tmmc; the
    reference's tmmc_host, mpmc_tpu/mc/run.py:1435-1471, :1630-1683):
    after every block the device matrix (summed over chains) is added in
    and zeroed, so its float32 sums stay far below 2^24; under tmmc_bias
    eta = analyze.tmmc_eta of the total is rebuilt and shared by every
    chain; at the end io/output.write_tmmc writes the total."""

    def __init__(self, cfg: RunConfig):
        self.cfg = cfg
        self.c = None
        self.attempts = 0      # the run's insert + delete attempts

    def flush(self, state: SimState, thermo: Thermo, stats=None):
        """(state with a zeroed matrix, thermo with the rebuilt eta);
        ``stats``: the block's MCStats (host attempts), counted."""
        if not self.cfg.tmmc:
            return state, thermo
        if stats is not None:
            att = np.asarray(stats.attempts)
            self.attempts += int(att[..., metropolis.INSERT].sum()
                                 + att[..., metropolis.DELETE].sum())
        c = state.tmmc_c.double().cpu().numpy()
        if c.ndim == 3:                     # stacked chains pool
            c = c.sum(axis=0)
        self.c = c if self.c is None else self.c + c
        state = state.replace(tmmc_c=torch.zeros_like(state.tmmc_c))
        if self.cfg.tmmc_bias:
            from mpmc_tpu_torch import analyze
            eta = analyze.tmmc_eta(self.c)
            if eta is not None:
                thermo = thermo.replace(tmmc_eta=torch.as_tensor(
                    eta, dtype=self.cfg.tdtype,
                    device=state.tmmc_c.device))
        return state, thermo

    def extra(self, thermo: Thermo):
        """The checkpoint's plain values: the host matrix and eta."""
        if not self.cfg.tmmc:
            return None
        eta = thermo.tmmc_eta
        return {"tmmc_host": None if self.c is None else self.c.tolist(),
                "tmmc_eta": None if eta is None
                else eta.double().cpu().tolist()}

    def resume(self, extra, thermo: Thermo, device):
        """thermo with the checkpoint's eta; the host matrix restored."""
        if not self.cfg.tmmc or not extra:
            return thermo
        if extra.get("tmmc_host") is not None:
            self.c = np.asarray(extra["tmmc_host"], np.float64)
        if extra.get("tmmc_eta") is not None:
            thermo = thermo.replace(tmmc_eta=torch.as_tensor(
                extra["tmmc_eta"], dtype=self.cfg.tdtype, device=device))
        return thermo

    def write(self, job, su: Setup, thermo: Thermo, box, writer, what=""):
        if self.c is None:
            return
        path = output_io.write_tmmc(
            job.tmmc_output or "tmmc.json", self.c,
            temperature=float(thermo.temperature.reshape(-1)[0]),
            fugacities=[float(f) for f in thermo.fugacity.reshape(-1)],
            volume=float(torch.abs(torch.linalg.det(box.double()))),
            species=su.species_names,
            insert_species=self.cfg.insert_species[0])
        n = int(self.c[:, 0].sum() + self.c[:, 2].sum())
        print(f"tmmc collection matrix{what} written to {path}: {n} "
              f"attempts collected, of {self.attempts} insert + delete "
              "attempts", file=writer.log)


def _log_tmmc_bias(cfg, writer):
    if cfg.tmmc_bias:
        print("tmmc_bias: flat-histogram sampling — raw block averages are "
              "bias-weighted; read the isotherm from 'analyze tmmc' on the "
              "collection matrix", file=writer.log)


def run_mc(job: input_script.Job, log=None, jsonl_path=None, device=None):
    """The main MC loop (ensemble uvt/nvt/nve/npt): one chain on the scan
    path, or under ``fused_mc`` on the fused NVT/NVE kernel (B3), the
    fused µVT kernel (B1), with polarization and ``polar_delayed`` the
    fused polar delayed acceptance (B6), or under NPT the hybrid path (B3
    segments and scan-path volume attempts); ``chains N`` goes to
    ``run_mc_chains``."""
    if job.pt_fugacity:       # implies tempering, along the fugacity
        return run_mc_pt_fug(job, log=log, jsonl_path=jsonl_path,
                             device=device)
    if job.parallel_tempering:
        return run_mc_pt(job, log=log, jsonl_path=jsonl_path, device=device)
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
    log_pair_route(cfg, writer.log, params)
    _log_tmmc_bias(cfg, writer)
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
        elif mc_kernel.supported_npt(cfg, params):
            chunk = functools.partial(
                metropolis.run_chunk_fused_npt,
                tables=metropolis.nvt_fused_tables(params,
                                                   su.state.mol_alive))
            print("fused_mc: hybrid fused NPT (B3 segments + scan-path "
                  "volume moves)", file=writer.log)
        elif cfg.polarization and cfg.polar_delayed:
            print("WARNING: polar_delayed requested but the fused "
                  "stage-1 kernel refuses this combination (it needs "
                  "a delta-able static field — direct, polar_wolf, or "
                  "polar_ewald over coulomb ewald — the CG solver, "
                  "and no cdvdw) — the scan-path delayed acceptance "
                  "runs instead", file=writer.log)
        else:
            print("WARNING: fused_mc requested but unsupported for this "
                  "configuration (needs rigid <=8-site NVT/NVE / "
                  "frameworkless NPT or <=8-species µVT, lj/none RD, "
                  "none/cutoff/wolf/ewald ES, a neutral template under "
                  "ewald, f32) — scan path used",
                  file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    if cfg.quantum_rotation:
        # the spins and the rotor table, before a checkpoint is read (it
        # carries both)
        state = qrot_init(su, state, thermo)
    if job.frozen_output:
        frame = pqr_io.read(job.pqr_input)
        pqr_io.write(job.frozen_output, frame.frozen,
                     remark="frozen framework")
    avgs = Averages()
    tmmc = _TmmcHost(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    if job.checkpoint_input:
        # the state, the averages, the random stream and the TMMC matrix
        # and bias (exact resume)
        state, avgs, extra = checkpoint.load(job.checkpoint_input, state,
                                             generator=generator)
        thermo = tmmc.resume(extra, thermo, device)
        print(f"resumed exactly from {job.checkpoint_input} at step "
              f"{state.step}", file=writer.log)
    hist = _hist_make(job, state.box)
    corr = max(cfg.corrtime, 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    spectre_idx = None
    if cfg.spectre:
        spectre_idx = spectre_mod.spectre_atom_indices(params,
                                                       su.spectre_species)
        print(f"spectre: {len(spectre_idx)} free-charge sites",
              file=writer.log)
    steps_done = 0
    t0 = time.time()
    for _ in range(n_blocks):
        state, stats = chunk(state, params, cfg, thermo, corr,
                             generator=generator)
        steps_done += corr
        if spectre_idx is not None and len(spectre_idx):
            # renormalize the free charges; the refresh below rebuilds
            # every charge-dependent cache (its frozen reuse is off)
            params = spectre_mod.apply(params, spectre_idx, cfg)
            su = dataclasses.replace(su, params=params)
        # per-corrtime refresh on the frozen-reuse fast path
        state = metropolis.initialize(state, params, cfg, thermo,
                                      frozen_rows=refresh_rows)
        if cfg.quantum_rotation:
            state = qrot_refresh(su, state, thermo)
        stats = stats.host()
        obs = observables(su, state, stats)
        obs.update(spectre_mod.observables(params, spectre_idx))
        if cfg.quantum_vibration:
            obs.update(qvib_obs(su, state, thermo))
        if cfg.polarization:
            obs["polar_iters_per_step"] = stats.polar_iters / corr
        avgs.add(obs)
        writer.log_block(int(state.step), obs, stats)
        writer.write_restart(params, state)
        writer.append_trajectory(params, state)
        writer.write_dipoles(params, state)
        if hist is not None:
            _hist_add(hist, state, params)
        state, thermo = tmmc.flush(state, thermo, stats)
        if job.checkpoint_output:
            checkpoint.save(job.checkpoint_output, state, avgs,
                            extra=tmmc.extra(thermo), generator=generator)
        if job.adapt_moves:
            thermo = _adapted(thermo, obs.get("acc_displace", 0.5),
                              state.box, cfg)
        if job.simulated_annealing:
            thermo = _annealed(thermo, job)
    wall = time.time() - t0
    _hist_finish(hist, job, writer)
    tmmc.write(job, su, thermo, state.box, writer)
    if job.pqr_output:
        pqr_io.write_state(job.pqr_output, params, state, su.species_names,
                           remark=f"final step {state.step}")
    writer.final_averages(avgs, float(thermo.temperature),
                          fugacities=thermo.fugacity.cpu().numpy())
    print(f"steps/sec: {steps_done / max(wall, 1e-9):.2f}  "
          f"({steps_done} steps in {wall:.2f}s)", file=writer.log)
    writer.close()
    return dataclasses.replace(su, state=state, thermo=thermo), avgs


def _chains_route(cfg, params, mol_alive, C, writer, what="multi-chain",
                  fused_ok=True):
    """(chunk, fused) for C stacked chains: the fused NVT kernel (B3) or
    the fused µVT kernel (B1) where their gates hold under ``fused_mc``
    (and ``fused_ok``), else the batched scan chains (B4 over the chain
    axis; with polarization the SCF over the chains, B5 over the chain
    axis, which the fused gates refuse; under NPT a box per chain) — and
    the log lines that say which."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel
    log_pair_route(cfg, writer.log, params)
    fused = cfg.fused_mc and fused_ok
    if cfg.fused_mc and not fused_ok:
        print("fused_mc: feynman_hibbs / feynman_kleinert keep this "
              f"{what} run on the batched scan chains, as the reference's "
              "gate does", file=writer.log)
    if fused and mc_kernel.supported_multi(cfg, params):
        chunk = functools.partial(
            metropolis.run_chunk_fused_multi,
            tables=metropolis.nvt_fused_tables(params, mol_alive))
    elif fused and mc_kernel.supported_uvt_multi(cfg, params):
        chunk = functools.partial(
            metropolis.run_chunk_fused_uvt_multi,
            tables=metropolis.uvt_fused_tables(params, cfg))
    else:
        if fused:
            print("WARNING: fused_mc requested but unsupported for this "
                  "configuration (needs the fused NVT or µVT surface, no "
                  "nve) — batched scan chains used", file=writer.log)
        if cfg.cell_list and params.cell_index is not None:
            delta = "one culled cell-list pass over the chains"
        elif metropolis.cache_eligible(cfg):
            delta = ("from the chains' [C, M, M] molecule-pair caches, one "
                     "partials pass over the chains")
        elif pair_kernel.supported(cfg):
            delta = "one B4 launch over the chains"
        else:
            delta = "the plain tile pass over the chains"
        print(f"batched scan chains (C={C}): one step of every chain at "
              "a time, each move's delta " + delta
              + (", the SCF's matvec one B5 launch over the chains"
                 if cfg.polarization else ""), file=writer.log)
        return multichain.run_chunk_batched, False
    print(f"fused_mc: chain-interleaved {what} kernel (C={C})",
          file=writer.log)
    return chunk, True


def run_mc_chains(job: input_script.Job, log=None, jsonl_path=None,
                  device=None):
    """``chains N``: N independent chains advanced together, one launch
    per corrtime of the fused NVT kernel (B3) or the fused µVT kernel (B1)
    where their gates hold under ``fused_mc``, else as batched scan chains
    (multichain.run_chunk_batched: every chain one step at a time, B4 over
    the chain axis).  Observables are averaged over the chains each
    corrtime (the reference's cross-rank observable reduce); restart and
    trajectory follow chain 0, with one file per chain under
    ``parallel_restarts``."""
    su = setup(job, device=device)
    device = su.state.pos.device
    cfg, params, thermo = su.cfg, su.params, su.thermo
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
    if cfg.spectre:
        print("WARNING: spectre charge renormalization runs only in the "
              "single-chain driver (chains 1)", file=writer.log)
    _log_tmmc_bias(cfg, writer)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    chunk, _ = _chains_route(cfg, params, state.mol_alive, C, writer)
    states = multichain.stack_states(state, C)
    qrot_on = metropolis.spinflip_active(cfg)
    if qrot_on:
        states, _ = _qrot_init_batched(su, states,
                                       [float(thermo.temperature)] * C)
    avgs = Averages()
    tmmc = _TmmcHost(cfg)
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
        if qrot_on:       # each chain's table (tracks annealing T)
            states, _ = _qrot_refresh_batched(
                su, states, [float(thermo.temperature)] * C)
        per_chain = observables_batched(su, states, C, stats, corr)
        obs = chains_mean(per_chain)
        stats = stats.host()
        acc = stats.accepts.sum(0) / np.maximum(stats.attempts.sum(0), 1)
        for i, nm in enumerate(("displace", "insert", "delete", "volume",
                                "spinflip")):
            obs[f"acc_{nm}"] = float(acc[i])
        avgs.add(obs)
        st0 = slice_chain(states, 0)
        writer.log_block(int(st0.step), obs, None)
        _write_chains(writer, params, states, st0, C)
        if hist is not None:
            for c in range(C):
                _hist_add(hist, slice_chain(states, c), params)
        # the chains sample one state point: their matrices pool
        states, thermo = tmmc.flush(states, thermo, stats)
        if job.adapt_moves:
            thermo = _adapted(thermo, obs["acc_displace"], st0.box, cfg)
        if job.simulated_annealing:
            thermo = _annealed(thermo, job)
    wall = time.time() - t0
    steps_done = n_blocks * corr
    _hist_finish(hist, job, writer, f" ({C} chains reduced)")
    tmmc.write(job, su, thermo, st0.box, writer, f" ({C} chains summed)")
    writer.final_averages(avgs, float(thermo.temperature),
                          fugacities=thermo.fugacity.cpu().numpy())
    print(f"steps/sec: {steps_done * C / max(wall, 1e-9):.2f} aggregate "
          f"({C} chains x {steps_done} steps in {wall:.2f}s)",
          file=writer.log)
    writer.close()
    return dataclasses.replace(su, state=st0, thermo=thermo,
                               states=states), avgs


def _write_chains(writer, params, states, st0, n):
    """The per-corrtime files of stacked chains: restart and trajectory of
    ``st0``, and one of each per chain under ``parallel_restarts``."""
    writer.write_restart(params, st0)
    writer.write_parallel_restarts(params, states, n)
    writer.append_trajectory(params, st0)
    writer.append_parallel_trajectories(params, states, n)


def _pt_block(su, writer, avgs, hist, states, k, swap_acc, swap_att, temps,
              fugacities=None):
    """The end of a PT block after the refresh: the ladder's observables
    (the base rung ``k`` reported, with the swap acceptance so far), its
    JSONL ladder record, the files and the histogram; returns rung k's
    state."""
    R = states.pos.shape[0]
    st0 = slice_chain(states, k)
    obs_all = observables_batched(su, states, R)
    obs = obs_all[k]
    obs["swap_acceptance"] = swap_acc / max(swap_att, 1)
    avgs.add(obs)
    writer.log_block(int(st0.step), obs, None)
    writer.log_ladder(int(st0.step), temps, obs_all, fugacities=fugacities)
    _write_chains(writer, su.params, states, st0, R)
    if hist is not None:
        for c in range(R):
            _hist_add(hist, slice_chain(states, c), su.params)
    return st0


def _pt_finish(job, writer, avgs, hist, temperature, swap_acc, swap_att, R,
               steps_done, wall):
    """A PT run's closing lines: histogram, averages, swap acceptance and
    the aggregate rate."""
    _hist_finish(hist, job, writer, f" ({R} replicas reduced)")
    writer.final_averages(avgs, temperature)
    print(f"swap acceptance: {swap_acc}/{swap_att}", file=writer.log)
    print(f"steps/sec: {steps_done * R / max(wall, 1e-9):.2f} aggregate "
          f"({R} replicas x {steps_done} steps in {wall:.2f}s)",
          file=writer.log)
    writer.close()


def _pt_pair_uniforms(rng, R, parity):
    """[R] the uniforms ``host_swap*`` is about to draw from ``rng``, each
    at its pair's low lane (NaN elsewhere), read from a copy of the
    generator: the host route's round record."""
    twin = np.random.default_rng()
    twin.bit_generator.state = rng.bit_generator.state
    u = np.full(R, np.nan)
    for lo in range(parity, R - 1, 2):
        u[lo] = twin.random()
    return u


def run_mc_pt(job: input_script.Job, log=None, jsonl_path=None,
              device=None):
    """Parallel tempering on one card: R replicas on a geometric
    temperature ladder from ``temperature`` to ``max_temperature``
    (default twice it), neighbour temperature swaps every ``ptemp_freq``
    steps (at most corrtime).  ``n_replicas`` 0 means 4 (the reference
    takes max(JAX device count, 4)).  The replicas run as the fused
    multi-chain kernel (B3 for nvt, B1 for uvt, under ``fused_mc`` where
    its gate holds) with on-device swaps (replica.ladder_swap_batched, an
    explicit generator seeded seed + 101) and one host fetch per block;
    otherwise as batched scan chains with host swaps
    (replica.host_swap, numpy's default_rng(seed + 101)).  A µVT ladder
    adds the (beta_j/beta_i)^dN factor.  Observables and the restart
    follow the base-temperature replica, wherever it is.  Returns (Setup
    with the stacked ``states``, the per-replica ``thermo`` and the last
    round in ``pt_round``, averages)."""
    su = setup(job, device=device)
    device = su.state.pos.device
    cfg, params, thermo = su.cfg, su.params, su.thermo
    if cfg.ensemble == "nve":
        # Ray's microcanonical acceptance never reads the temperature a
        # ladder would swap
        raise ValueError("parallel tempering is undefined for ensemble "
                         "nve (the NVE acceptance does not read T)")
    R = job.n_replicas or 4
    t_max = job.max_temperature or 2.0 * job.temperature
    temps = replica.geometric_ladder(job.temperature, t_max, R)
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity.cpu(),
                    volume=float(torch.abs(torch.linalg.det(su.state.box))),
                    n_chains=R)
    print(f"parallel tempering: {R} replicas, T = "
          + " ".join(f"{t:.2f}" for t in temps), file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    chunk, fused = _chains_route(cfg, params, state.mol_alive, R, writer,
                                 "PT")
    if fused:
        print(f"fused_mc: on-device swaps (R={R})", file=writer.log)
    states = multichain.stack_states(state, R)
    thermos = replica.stack_thermo(thermo, temps)
    # spinflip: each replica's eigensolves are kept, so a swap rebuilds its
    # table at its new temperature with no eigensolve (on the device from
    # level arrays under fused swaps, on the host otherwise); every block
    # refreshes them (the reference's :826-1014)
    qrot_eigs = qrot_lv = None
    if metropolis.spinflip_active(cfg):
        states, qrot_eigs = _qrot_init_batched(su, states, temps)
        if fused:
            qrot_lv = _qrot_levels(su, qrot_eigs, device)
    rng = np.random.default_rng(cfg.seed + 101)
    swap_gen = torch.Generator(device=device).manual_seed(cfg.seed + 101)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    uvt = cfg.ensemble == "uvt"
    avgs = Averages()
    swap_acc, swap_att, swap_acc_dev = 0, 0, None
    corr = max(cfg.corrtime, 1)
    ptf = max(min(job.ptemp_freq, corr), 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    hist = _hist_make(job, su.state.box)
    parity, rnd = 0, None
    t0 = time.time()
    for _ in range(n_blocks):
        for _ in range(max(corr // ptf, 1)):
            states, _ = chunk(states, params, cfg, thermos, ptf,
                              generator=generator)
            n_mov = (replica.movable_counts(states.mol_alive,
                                            params.mol_frozen,
                                            params.mol_species)
                     if uvt else None)
            t_in = thermos.temperature
            if fused:
                u = replica.swap_uniforms(R, swap_gen, t_in.dtype)
                new_t, acc = replica.ladder_swap_batched(
                    t_in, states.energy, u, parity, n_mols=n_mov)
                thermos = thermos.replace(temperature=new_t)
                swap_acc_dev = acc if swap_acc_dev is None else \
                    swap_acc_dev + acc
                if qrot_lv is not None:
                    states = states.replace(
                        rot_f=qrot.free_energies_from_levels(
                            *qrot_lv, new_t.double()).to(cfg.tdtype))
            else:
                energies = states.energy.total.double().cpu().numpy()
                n_h = None if n_mov is None else n_mov.cpu().numpy()
                u = _pt_pair_uniforms(rng, R, parity)
                temps, acc = replica.host_swap(temps, energies, parity, rng,
                                               n_mols=n_h)
                swap_acc += acc
                thermos = replica.stack_thermo(thermo, temps)
                if qrot_eigs is not None:
                    states = states.replace(rot_f=torch.as_tensor(
                        np.stack([qrot.table_from_eigs(
                            qrot_eigs[r], params.n_mols_max, temps[r])
                            for r in range(R)]), dtype=cfg.tdtype,
                        device=device))
            rnd = {"temps": t_in, "energies": states.energy.total,
                   "n_mols": n_mov, "u": u, "parity": parity,
                   "new_temps": thermos.temperature, "accepted": acc}
            swap_att += max((R - parity) // 2, 0)
            parity ^= 1
        states = multichain.initialize_batched(states, params, cfg, thermos,
                                               frozen_rows=refresh_rows)
        if fused:
            # the swaps ran on the card: one fetch per block
            temps = thermos.temperature.double().cpu().numpy()
            swap_acc = int(swap_acc_dev)
        if qrot_eigs is not None:
            states, qrot_eigs = _qrot_refresh_batched(su, states, temps)
            if fused:
                qrot_lv = _qrot_levels(su, qrot_eigs, device)
        st0 = _pt_block(su, writer, avgs, hist, states,
                        int(np.argmin(temps)), swap_acc, swap_att, temps)
    _pt_finish(job, writer, avgs, hist, float(np.min(temps)), swap_acc,
               swap_att, R, n_blocks * corr, time.time() - t0)
    return dataclasses.replace(su, state=st0, thermo=thermos, states=states,
                               pt_round=rnd), avgs


def run_mc_pt_fug(job: input_script.Job, log=None, jsonl_path=None,
                  device=None):
    """Fugacity-ladder parallel tempering (``pt_fugacity on``): R µVT
    replicas at one temperature, each at a rung of a geometric fugacity
    ladder from ``pressure`` to ``max_pressure`` (default 10x); neighbour
    swaps exchange whole fugacity rows with ln P = sum_s (N_si - N_sj)
    ln(f_sj / f_si).  Under ``fused_mc`` where the µVT gate holds, the
    ladder is one B1 launch per round with a ln(f V) row per chain and
    on-device swaps (replica.ladder_swap_fugacity_batched, an explicit
    generator seeded seed + 103); otherwise batched scan chains with host
    swaps (replica.host_swap_fugacity, default_rng(seed + 103)).
    ``n_replicas`` 0 means 4.  Observables and the restart follow the
    base-pressure rung.  Returns (Setup with ``states``, ``thermo`` and
    ``pt_round``, averages)."""
    su = setup(job, device=device)
    device = su.state.pos.device
    cfg, params, thermo = su.cfg, su.params, su.thermo
    if cfg.ensemble != "uvt" or not cfg.insert_species:
        raise ValueError("pt_fugacity needs ensemble uvt with an "
                         "insertable sorbate (the ladder axis is the "
                         "grand-canonical fugacity)")
    if job.pressure <= 0:
        raise ValueError("pt_fugacity needs pressure > 0 (the ladder "
                         "base rung)")
    R = job.n_replicas or 4
    p_max = job.max_pressure or 10.0 * job.pressure
    if p_max <= job.pressure:
        raise ValueError(f"max_pressure {p_max} must exceed the base "
                         f"pressure {job.pressure}")
    scales = np.geomspace(1.0, p_max / job.pressure, R)
    base = thermo.fugacity.double().cpu().numpy()
    fug_rows = scales[:, None] * base[None, :]
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity.cpu(),
                    volume=float(torch.abs(torch.linalg.det(su.state.box))),
                    n_chains=R)
    print(f"fugacity-ladder PT: {R} replicas at T={job.temperature}, "
          "F_total = " + " ".join(f"{v:.4g}" for v in fug_rows.sum(axis=1)),
          file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    # FH/FK keep the ladder on the batched scan chains, as the reference's
    # gate does (mpmc_tpu/mc/run.py:1105-1116)
    chunk, fused = _chains_route(
        cfg, params, state.mol_alive, R, writer, "fugacity-ladder",
        fused_ok=not (cfg.feynman_hibbs or cfg.feynman_kleinert))
    if fused:
        print(f"fused_mc: on-device swaps (R={R})", file=writer.log)
    states = multichain.stack_states(state, R)
    thermos = replica.stack_thermo_fugacity(thermo, fug_rows)
    # spinflip: the table depends on T alone, which every rung shares, so
    # a swap keeps it; every block refreshes it
    temps_r = [float(job.temperature)] * R
    qrot_on = metropolis.spinflip_active(cfg)
    if qrot_on:
        states, _ = _qrot_init_batched(su, states, temps_r)
    rng = np.random.default_rng(cfg.seed + 103)
    swap_gen = torch.Generator(device=device).manual_seed(cfg.seed + 103)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    sp_ids = tuple(int(s) for s in cfg.insert_species)
    avgs = Averages()
    swap_acc, swap_att, swap_acc_dev = 0, 0, None
    corr = max(cfg.corrtime, 1)
    ptf = max(min(job.ptemp_freq, corr), 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    hist = _hist_make(job, su.state.box)
    parity, rnd = 0, None
    t0 = time.time()
    for _ in range(n_blocks):
        for _ in range(max(corr // ptf, 1)):
            states, _ = chunk(states, params, cfg, thermos, ptf,
                              generator=generator)
            f_in = thermos.fugacity
            if fused:
                counts = replica.movable_counts_per_species(
                    states.mol_alive, params.mol_frozen, params.mol_species,
                    sp_ids)
                u = replica.swap_uniforms(R, swap_gen, f_in.dtype)
                new_f, acc = replica.ladder_swap_fugacity_batched(
                    f_in, counts, u, parity, sp_ids)
                thermos = thermos.replace(fugacity=new_f)
                swap_acc_dev = acc if swap_acc_dev is None else \
                    swap_acc_dev + acc
            else:
                counts = replica.movable_counts(
                    states.mol_alive, params.mol_frozen, params.mol_species)
                u = _pt_pair_uniforms(rng, R, parity)
                fug_rows, acc = replica.host_swap_fugacity(
                    fug_rows, counts.cpu().numpy(), parity, rng)
                swap_acc += acc
                thermos = replica.stack_thermo_fugacity(thermo, fug_rows)
            rnd = {"fugacity": f_in, "counts": counts, "u": u,
                   "parity": parity, "sp_ids": sp_ids,
                   "new_fugacity": thermos.fugacity, "accepted": acc}
            swap_att += max((R - parity) // 2, 0)
            parity ^= 1
            # beta is shared: a fugacity swap changes only the acceptance
            # rules, so the cached energies stay valid
        states = multichain.initialize_batched(states, params, cfg, thermos,
                                               frozen_rows=refresh_rows)
        if qrot_on:
            states, _ = _qrot_refresh_batched(su, states, temps_r)
        if fused:
            fug_rows = thermos.fugacity.double().cpu().numpy()
            swap_acc = int(swap_acc_dev)
        f_tot = fug_rows.sum(axis=1)
        st0 = _pt_block(su, writer, avgs, hist, states,
                        int(np.argmin(f_tot)), swap_acc, swap_att,
                        [float(job.temperature)] * R, fugacities=f_tot)
    _pt_finish(job, writer, avgs, hist, float(job.temperature), swap_acc,
               swap_att, R, n_blocks * corr, time.time() - t0)
    return dataclasses.replace(su, state=st0, thermo=thermos, states=states,
                               pt_round=rnd), avgs


def run(job: input_script.Job, **kw):
    """Run a parsed job on ``device`` (keyword; default the current CUDA
    device, and an error without one)."""
    if job.cfg.ensemble in ("nvt", "nve", "uvt", "npt"):
        return run_mc(job, **kw)
    if job.cfg.ensemble == "te":
        kw.pop("jsonl_path", None)
        return run_te(job, **kw)
    if job.cfg.ensemble == "replay":
        kw.pop("jsonl_path", None)
        return run_replay(job, **kw)
    if job.cfg.ensemble in ("surf", "surf_fit", "surf_multi_fit"):
        from mpmc_tpu_torch.mc import surface
        kw.pop("jsonl_path", None)
        return {"surf": surface.run_surface,
                "surf_fit": surface.run_surface_fit,
                "surf_multi_fit": surface.run_surface_multi_fit}[
                    job.cfg.ensemble](job, **kw)
    check_supported(job)
    raise NotImplementedError(
        f"ensemble {job.cfg.ensemble!r} not yet implemented")
