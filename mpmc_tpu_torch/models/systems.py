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


def co2_3site() -> Species:
    """Rigid 3-site CO2 (EPM2-style: Harris & Yung 1995 parameters)."""
    d = 1.149
    return Species(
        name="CO2",
        atom_names=("C", "O", "O"),
        pos=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, d], [0.0, 0.0, -d]]),
        mass=np.array([12.011, 15.999, 15.999]),
        charge=np.array([0.6512, -0.3256, -0.3256]),
        polar=np.zeros(3),
        eps=np.array([28.129, 80.507, 80.507]),
        sig=np.array([2.757, 3.033, 3.033]))


def n2_3site() -> Species:
    """Rigid N2 with a COM charge site (TraPPE-style: Potoff & Siepmann
    2001)."""
    d = 0.55
    return Species(
        name="N2",
        atom_names=("NCOM", "N", "N"),
        pos=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, d], [0.0, 0.0, -d]]),
        mass=np.array([0.0, 14.007, 14.007]),
        charge=np.array([0.964, -0.482, -0.482]),
        polar=np.zeros(3),
        eps=np.array([0.0, 36.0, 36.0]),
        sig=np.array([0.0, 3.31, 3.31]))


def ch4_united_atom() -> Species:
    """United-atom CH4 (TraPPE-UA: Martin & Siepmann 1998)."""
    return Species(
        name="CH4", atom_names=("CH4",), pos=np.zeros((1, 3)),
        mass=np.array([16.043]), charge=np.zeros(1), polar=np.zeros(1),
        eps=np.array([148.0]), sig=np.array([3.73]))


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


def mof_h2_ch4_gcmc(n_side: int = 6, spacing: float = 4.0,
                    n_h2: int = 16, n_ch4: int = 16, capacity: int = 64,
                    temperature=150.0, pressures=(1.0, 1.0),
                    dtype="float32", seed=0, ewald_kmax=5, corrtime=1000,
                    device=None):
    """Two-sorbate MOF GCMC (rigid 3-site H2 + united-atom CH4): the
    multi-sorbate µVT shape, per-species fugacities ``pressures`` and
    mixed per-species site counts (3 and 1)."""
    device = resolve_device(device)
    fpos, fp, box_len = _framework_lattice(n_side, spacing)
    h2, ch4 = h2_bss3(), ch4_united_atom()
    if n_h2 + n_ch4 > n_side ** 3:
        raise ValueError("initial loading exceeds interstitial sites")
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3,
                               indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    sites = (ijk[rng.permutation(len(ijk))[:n_h2 + n_ch4]] + 1.0) * spacing
    initial_pos = {
        0: sites[:n_h2, None, :] + h2.pos[None, :, :],
        1: sites[n_h2:, None, :] + ch4.pos[None, :, :],
    }
    cfg = RunConfig(
        ensemble="uvt", rd_potential="lj", coulomb="ewald",
        ewald_kmax=ewald_kmax, insert_species=(0, 1), ortho_box=True,
        cavity_autoreject_absolute=1.0, corrtime=corrtime, dtype=dtype,
        seed=seed)
    params, state = build_system(
        np.eye(3) * box_len, frozen_pos=fpos, frozen_params=fp,
        species=(h2, ch4), capacity=(capacity, capacity),
        initial_counts=(n_h2, n_ch4), initial_pos=initial_pos,
        dtype=cfg.tdtype, seed=seed, device=device)
    thermo = Thermo.make(
        temperature=temperature, pressure=pressures[0],
        fugacity=list(pressures), move_factor=1.0, rot_factor=np.pi,
        insert_probability=0.5, n_species=2, dtype=cfg.tdtype,
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


# Dreiding's zeta, and the share of the C6 term the C8 term takes at the
# LJ well of rd_form_columns' dispersion expansion
EXP6_ZETA = 13.772
C8_SHARE = 0.1


def rd_form_columns(eps, sig, form):
    """(eps, sig, c6, c8, c10) columns (float64 numpy) of the RD ``form``
    that hold each site's LJ well (eps [K], sig [A]) where it is: r_m =
    2^(1/6) sig.  dreiding and b14_7: well depth eps at r0 = r_m; sg: the
    columns as they are (it reads none); disp_expansion: the exp-6 of the
    same well and curvature, A = 6 eps e^z / (z - 6), B = z / r_m (0
    where sig = 0), C6 = z eps r_m^6 / (z - 6) with z = EXP6_ZETA, then
    C8 = C8_SHARE C6 r_m^2 (a tenth of the C6 term at r_m) and C10 by
    extrapolate_disp_coeffs' rule 49/40 C8^2 / C6."""
    eps = np.asarray(eps, np.float64)
    sig = np.asarray(sig, np.float64)
    zero = np.zeros_like(eps)
    rm = 2.0 ** (1.0 / 6.0) * sig
    if form == "sg":
        return eps, sig, zero, zero, zero
    if form in ("dreiding", "b14_7"):
        return eps, rm, zero, zero, zero
    if form != "disp_expansion":
        raise ValueError(f"rd_form_columns: no map to {form!r}")
    z = EXP6_ZETA
    a = 6.0 * eps * np.exp(z) / (z - 6.0)
    b = np.where(sig > 0, z / np.where(sig > 0, rm, 1.0), 0.0)
    c6 = z * eps * rm ** 6 / (z - 6.0)
    c8 = C8_SHARE * c6 * rm ** 2
    c10 = np.where(c6 > 0, 49.0 / 40.0 * c8 ** 2 / np.where(c6 > 0, c6, 1.0),
                   0.0)
    return a, b, c6, c8, c10


def with_rd_form(params, cfg, form, **cfg_kw):
    """(params, cfg) of a system with its LJ sites mapped to ``form``
    (rd_form_columns), on the params' device and type; ``cfg_kw`` sets
    further cfg fields (rd_lrc, damp_dispersion, coulomb ...)."""
    import dataclasses
    cols = rd_form_columns(params.eps.cpu().numpy(),
                           params.sig.cpu().numpy(), form)
    t = [torch.as_tensor(c, dtype=params.eps.dtype, device=params.device)
         for c in cols]
    params = params.replace(eps=t[0], sig=t[1], c6=t[2], c8=t[3], c10=t[4])
    return params, dataclasses.replace(cfg, rd_potential=form, **cfg_kw)
