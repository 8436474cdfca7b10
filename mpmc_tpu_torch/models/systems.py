"""Canonical model systems (port of mpmc_tpu/models/systems.py): builders
returning (params, state, cfg, thermo) on the CUDA device, or on the
device the caller names (``device="cpu"``).

The H2 model is the three-charge-site + single-LJ-site form of the
BSS-family hydrogen models; the framework is a synthetic charge-
alternating cubic lattice with MOF-like LJ parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo, resolve_device
from mpmc_tpu_torch.state import Species, build_system


def h2_bss3() -> Species:
    """Rigid 3-site H2: charged quadrupole + one LJ center."""
    d = 0.371  # A, half H-H bond
    return Species(
        name="H2",
        atom_names=("H2G", "H2E", "H2E"),
        pos=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, d], [0.0, 0.0, -d]]),
        mass=np.array([0.0, 1.008, 1.008]),
        charge=np.array([-0.93634, 0.46817, 0.46817]),
        polar=np.array([0.6938, 0.0, 0.0]),
        eps=np.array([34.2, 0.0, 0.0]),
        sig=np.array([2.96, 0.0, 0.0]),
    )


def lj_atom(name="AR", eps=119.8, sig=3.405, mass=39.948) -> Species:
    """Monatomic LJ species (argon-like)."""
    return Species(
        name=name, atom_names=(name,),
        pos=np.zeros((1, 3)), mass=np.array([mass]),
        charge=np.zeros(1), polar=np.zeros(1),
        eps=np.array([eps]), sig=np.array([sig]))


def _framework_lattice(n_side: int, spacing: float, polar: float = 0.0):
    """Synthetic charge-alternating cubic framework (rock-salt pattern,
    net charge zero for even n_side) with MOF-like LJ parameters."""
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3,
                               indexing="ij"), -1).reshape(-1, 3)
    pos = (ijk + 0.5) * spacing
    sign = (-1.0) ** ijk.sum(axis=1)
    F = len(pos)
    fp = {
        "charge": 0.30 * sign,
        "mass": np.full(F, 60.0),
        "polar": np.full(F, polar),
        "eps": np.full(F, 25.0),
        "sig": np.full(F, 3.0),
    }
    return pos, fp, n_side * spacing


def lj_fluid(n: int = 256, density: float = 0.0212, temperature=120.0,
             dtype="float32", seed=0, device=None):
    """NVT LJ fluid (n atoms, number density in A^-3)."""
    device = resolve_device(device)
    box_len = (n / density) ** (1.0 / 3.0)
    cfg = RunConfig(ensemble="nvt", rd_potential="lj", coulomb="none",
                    ortho_box=True, dtype=dtype, seed=seed)
    params, state = build_system(
        np.eye(3) * box_len, species=(lj_atom(),), capacity=(n,),
        initial_counts=(n,), dtype=cfg.tdtype, seed=seed, device=device)
    thermo = Thermo.make(temperature=temperature, move_factor=0.5,
                         rot_factor=0.0, n_species=1, dtype=cfg.tdtype,
                         device=device)
    return params, state, cfg, thermo


def mof_h2_gcmc(n_side: int = 8, spacing: float = 4.0, n_h2: int = 64,
                capacity: int = 256, temperature=77.0, pressure=1.0,
                polarization=False, dtype="float32", seed=0, ewald_kmax=7,
                corrtime=1000, device=None):
    """Synthetic MOF + H2 GCMC system (n_side=21: the 9,261-atom
    framework of the 10.8k bench system); ``polarization`` makes the
    framework sites polarizable (0.35 A^3) and turns the Thole model on."""
    device = resolve_device(device)
    fpos, fp, box_len = _framework_lattice(
        n_side, spacing, polar=0.35 if polarization else 0.0)
    h2 = h2_bss3()
    if n_h2 > n_side ** 3:
        raise ValueError(f"n_h2={n_h2} exceeds {n_side ** 3} interstitial "
                         "sites")
    # initial H2 COMs on the framework's interstitial (body-center) sites
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3,
                               indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    sites = (ijk[rng.permutation(len(ijk))[:n_h2]] + 1.0) * spacing
    initial_pos = {0: sites[:, None, :] + h2.pos[None, :, :]}
    cfg = RunConfig(
        ensemble="uvt", rd_potential="lj", coulomb="ewald",
        ewald_kmax=ewald_kmax, polarization=polarization,
        insert_species=(0,), ortho_box=True,
        cavity_autoreject_absolute=1.0, corrtime=corrtime, dtype=dtype,
        seed=seed)
    params, state = build_system(
        np.eye(3) * box_len, frozen_pos=fpos, frozen_params=fp,
        species=(h2,), capacity=(capacity,), initial_counts=(n_h2,),
        initial_pos=initial_pos, dtype=cfg.tdtype, seed=seed, device=device)
    thermo = Thermo.make(
        temperature=temperature, pressure=pressure, fugacity=[pressure],
        move_factor=1.0, rot_factor=np.pi, insert_probability=0.5,
        n_species=1, dtype=cfg.tdtype, device=device)
    return params, state, cfg, thermo


def jittered(params, state, seed, amplitude=0.3):
    """``state`` with every movable molecule shifted rigidly by a seeded
    uniform vector in [-amplitude, amplitude) A.  The builders put their
    molecules on lattices, where pairs sit exactly at r = rc and two
    correct evaluations (fused multiply-adds or separate roundings) may
    count such a tie differently; a jittered state has no such ties."""
    mov = (~params.mol_frozen & (params.mol_species >= 0)).cpu().numpy()
    shift = np.random.default_rng(seed).uniform(-amplitude, amplitude,
                                                (len(mov), 3))
    shift[~mov] = 0.0
    shift = torch.as_tensor(shift, dtype=state.pos.dtype,
                            device=state.pos.device)
    return state.replace(pos=state.pos + shift[params.mol_id])
