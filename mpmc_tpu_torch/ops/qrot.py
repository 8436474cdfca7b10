"""Quantum rotation: hindered-rigid-rotor eigenspectra for linear sorbates
(port of mpmc_tpu/ops/qrot.py).

Each H2-like linear rotor in its crystal field gets a Hamiltonian in the
spherical-harmonic basis |l m| (l <= lmax),

    H = B l(l+1) delta + <l m| V(Omega) |l' m'>,

with B = hbar^2 / 2I from the species geometry and V(Omega) the
interaction energy (RD + real-space ES) of the molecule turned about its
COM to each of the G = 16 x 32 orientations of a Gauss-Legendre x
uniform-phi grid.  Para rotors couple only even-l states, ortho rotors
odd-l; ``symmetry_free_energies`` gives F = -T ln sum exp(-E / T) over
each symmetry's levels, and the spinflip move accepts with
exp(-(F_new - F_old) / T) (mc/metropolis.py).

Where the work runs:
- ``potentials_on_grid`` builds every orientation's rows [R G, A, 3] on
  the device and prices them in one B4 launch per refresh
  (pair_kernel.mol_pair_chains with the positions shared, stride 0);
  under Feynman-Hibbs/Kleinert B4's gate refuses and its plain version
  runs on the device, as every pair pass of the port does;
- the Hamiltonians and their eigensolves stay on the host in float64
  (``numpy.linalg.eigh`` over the stacked [R, L, L] matrices, the
  reference's LAPACK); the spherical-harmonic basis is built once per
  (lmax, grid) in numpy from associated Legendre functions, with the
  Condon-Shortley phase of scipy's ``sph_harm_y``;
- ``free_energies_from_levels`` rebuilds the [.., M, 2] table at new
  temperatures from the level arrays on the device (parallel tempering's
  swaps, no host sync); ``table_from_eigs`` is its host twin.

The reference's ``spinflip_sweep`` (a host sweep with no caller) is not
ported: the spinflip move is a per-step move of the MC engine.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Dict, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.constants import HBAR2_KB_AMU_A2

N_THETA, N_PHI = 16, 32
# a site this close to its molecule's COM (A) sits at it: far above the
# float32 rounding of a COM at ~100 A (1e-5 A), far below a bond
AXIAL_EPS = 1e-3


def rotational_constant(species) -> float:
    """B [K] = hbar^2 / (2 I kB) from the template geometry (the moment of
    inertia about the COM, amu A^2)."""
    pos = np.asarray(species.pos, np.float64)
    mass = np.asarray(species.mass, np.float64)
    inertia = float(np.sum(mass * np.sum(pos * pos, axis=1)))
    if inertia <= 0:
        raise ValueError(f"species {species.name}: zero moment of inertia")
    return HBAR2_KB_AMU_A2 / (2.0 * inertia)


def quadrature_grid(n_theta: int = N_THETA, n_phi: int = N_PHI):
    """(theta[g], phi[g], w[g]): Gauss-Legendre x uniform-phi quadrature."""
    x, wx = np.polynomial.legendre.leggauss(n_theta)
    theta = np.arccos(x)
    phi = (np.arange(n_phi) + 0.5) * 2.0 * np.pi / n_phi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    w = np.broadcast_to(wx[:, None] * (2.0 * np.pi / n_phi), th.shape)
    return th.reshape(-1), ph.reshape(-1), w.reshape(-1)


def orientation_axes(theta, phi):
    """Unit vectors of the grid orientations [G, 3]."""
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)],
                    axis=-1)


def _legendre(lmax: int, x):
    """{(l, m): P_l^m(x)} for 0 <= m <= l <= lmax with the
    Condon-Shortley phase, by the standard upward recurrences."""
    p = {}
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    pmm = np.ones_like(x)
    for m in range(lmax + 1):
        if m > 0:
            pmm = -(2 * m - 1) * s * pmm
        p[(m, m)] = pmm
        if m < lmax:
            p[(m + 1, m)] = (2 * m + 1) * x * pmm
        for l in range(m + 2, lmax + 1):
            p[(l, m)] = ((2 * l - 1) * x * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    return p


def spherical_harmonics(lmax: int, theta, phi):
    """([(lmax+1)^2, G] complex Y_lm(theta, phi) in the order l = 0..lmax,
    m = -l..l, [(lmax+1)^2] l(l+1)) — scipy's sph_harm_y(l, m, theta,
    phi) convention."""
    p = _legendre(lmax, np.cos(theta))
    nlm = (lmax + 1) ** 2
    y = np.zeros((nlm, len(theta)), np.complex128)
    ll = np.zeros(nlm)
    k = 0
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4.0 * math.pi)
                             * math.factorial(l - am)
                             / math.factorial(l + am))
            ypos = norm * p[(l, am)] * np.exp(1j * am * phi)
            y[k] = ypos if m >= 0 else (-1) ** am * np.conj(ypos)
            ll[k] = l * (l + 1)
            k += 1
    return y, ll


@functools.lru_cache(maxsize=8)
def _basis(lmax: int, n_theta: int, n_phi: int):
    """(theta, phi, w, axes, Y [L, G], l(l+1) [L]) of a grid and basis,
    built once per (lmax, grid)."""
    theta, phi, w = quadrature_grid(n_theta, n_phi)
    y, ll = spherical_harmonics(lmax, theta, phi)
    return theta, phi, w, orientation_axes(theta, phi), y, ll


def grid_rows(pos, params, mols, axes):
    """[R, G, A, 3] rows of each rotor ``mols`` [R] (int64 tensor) turned
    about its COM to each axis of ``axes`` [G, 3] (the reference's
    potential_on_grid): a linear molecule's sites keep their signed axial
    coordinate; padded rows repeat the first.  A site within AXIAL_EPS of
    the COM sits at it, and the signs are taken against the first site
    beyond it.  (The reference takes them against the first site, which
    for a rotor whose first site is its COM — the BSS H2's H2G — is
    rounding noise: both H2E can land on one side; see ROADMAP's reference
    traps.)"""
    dev = pos.device
    site = torch.arange(params.max_atoms_per_mol, device=dev)
    idx = params.mol_atoms[mols]                                  # [R,A]
    ok = site[None, :] < params.mol_natoms[mols][:, None]
    m = params.mass[idx] * ok
    rows = pos[idx]
    com = (torch.sum(m[..., None] * rows, dim=1)
           / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1e-30))
    rel = rows - com[:, None, :]
    d = torch.linalg.norm(rel, dim=-1)
    far = (d > AXIAL_EPS) & ok
    first = torch.argmax(far.to(torch.int8), dim=1)               # [R]
    ref = rel[torch.arange(rel.shape[0], device=dev), first]      # [R,3]
    sign = torch.where(torch.sum(rel * ref[:, None, :], dim=-1) >= 0, 1.0,
                       -1.0)
    s = torch.where(far, sign * d, torch.zeros_like(d))           # [R,A]
    new = (com[:, None, None, :]
           + s[:, None, :, None] * axes[None, :, None, :])        # [R,G,A,3]
    return torch.where(ok[:, None, :, None], new, new[:, :, :1])


def potentials_on_grid(pos, box, atom_alive, params, cfg, temperature,
                       mols, axes) -> torch.Tensor:
    """V(Omega_g) [R, G] in K on the device: rotor ``mols[r]``'s RD + real
    ES energy with every other molecule when its axis points along
    ``axes[g]`` (the reference's potential_on_grid, whose reciprocal-space
    change is second order at fixed COM and omitted).  One B4 launch over
    every rotor's G orientations, the positions shared."""
    from mpmc_tpu_torch.ops import pairs
    dev, dt = pos.device, pos.dtype
    ax = torch.as_tensor(axes, dtype=dt, device=dev)               # [G,3]
    G = ax.shape[0]
    if not len(mols):
        return torch.zeros((0, G), dtype=dt, device=dev)
    mt = torch.as_tensor([int(m) for m in mols], dtype=torch.int64,
                         device=dev)
    rows = grid_rows(pos, params, mt, ax)
    t = pairs.mol_pair_pass(
        pos, box, atom_alive, params, cfg, temperature,
        mt.repeat_interleave(G),
        row_pos=rows.reshape(-1, rows.shape[2], 3).contiguous(),
        scal=pairs.pair_scalars(box, cfg), shared=True)
    return (t.rd + t.es_real).reshape(len(mt), G)


def potential_on_grid(pos, box, atom_alive, params, cfg, temperature,
                      mol: int, axes) -> np.ndarray:
    """V(Omega_g) [G] of one rotor, float64 on the host."""
    return potentials_on_grid(pos, box, atom_alive, params, cfg,
                              temperature, [mol], axes)[0].double().cpu(
                                  ).numpy()


def rotor_hamiltonian(v_grid, w, y, ll, b_const):
    """Dense Hamiltonians [R, L, L] (complex Hermitian) of R rotors from
    their grid potentials v_grid [R, G] (mean removed), the quadrature
    weights w [G], the basis y [L, G] and l(l+1) [L], and B [R]."""
    v = np.atleast_2d(v_grid)
    h = (y[None, :, :] * (w[None, :] * v)[:, None, :]) @ y.conj().T
    b = np.atleast_1d(np.asarray(b_const, np.float64))
    return h + b[:, None, None] * np.diag(ll)[None]


def levels_from_potentials(v, b_const, lmax: int, n_theta: int = N_THETA,
                           n_phi: int = N_PHI):
    """(evals [R, L], l_of [R, L] int) from grid potentials v [R, G]
    (float64, host) and rotational constants [R]: one stacked eigh.  l_of
    labels each eigenvector by the l of its <l(l+1)>, rounded."""
    _, _, w, _, y, ll = _basis(int(lmax), n_theta, n_phi)
    v = np.atleast_2d(np.asarray(v, np.float64))
    vm = v.mean(axis=1)
    evals, evecs = np.linalg.eigh(rotor_hamiltonian(v - vm[:, None], w, y,
                                                    ll, b_const))
    weights = np.abs(evecs) ** 2
    lexp = np.einsum("rkn,k->rn", weights, ll)
    l_of = np.round((np.sqrt(4 * lexp + 1) - 1) / 2).astype(int)
    return evals + vm[:, None], l_of


def rotational_levels(pos, box, atom_alive, params, cfg, temperature,
                      mol: int, species, lmax: int = 4,
                      n_theta: int = N_THETA, n_phi: int = N_PHI):
    """(eigenvalues [K], their l labels) of one molecule in its current
    environment."""
    axes = _basis(int(lmax), n_theta, n_phi)[3]
    v = potential_on_grid(pos, box, atom_alive, params, cfg, temperature,
                          mol, axes)
    evals, l_of = levels_from_potentials(v[None], rotational_constant(species),
                                         lmax, n_theta, n_phi)
    return evals[0], l_of[0]


def symmetry_free_energies(evals, l_of, temperature) -> Tuple[float, float]:
    """(F_para, F_ortho) [K]: -T ln Z over the even-l / odd-l levels."""
    def f(par):
        sel = (l_of % 2) == par
        if not np.any(sel):
            return np.inf
        e = evals[sel]
        e0 = e.min()
        return e0 - temperature * np.log(
            np.sum(np.exp(-(e - e0) / temperature)))
    return f(0), f(1)


def rotor_slots(mol_alive, params, species_list):
    """([rotor slots], [their B]) of the alive movable molecules of two or
    more sites whose species has a moment of inertia, host ints."""
    alive = mol_alive.cpu().numpy()
    spec = params.mol_species.cpu().numpy()
    frozen = params.mol_frozen.cpu().numpy()
    natoms = params.mol_natoms.cpu().numpy()
    mols, bs = [], []
    for m in range(int(params.n_mols_max)):
        sidx = int(spec[m])
        if not alive[m] or frozen[m] or sidx < 0 or natoms[m] < 2:
            continue
        try:
            b = rotational_constant(species_list[sidx])
        except ValueError:
            continue            # zero moment of inertia: not a rotor
        mols.append(m)
        bs.append(b)
    return mols, bs


def eigen_tables(pos, box, atom_alive, mol_alive, params, cfg, thermo,
                 species_list, lmax: int = 4, times: Dict = None):
    """{mol: (evals, l_of)} for every alive movable linear rotor — the
    position-dependent part of the spinflip table (the temperature enters
    only through table_from_eigs, and through the pair terms under
    Feynman-Hibbs/Kleinert).  ``times``: a dict that gets the seconds of
    the grid potentials ("b4_s", the device synchronized) and of the
    eigensolves ("eigh_s") added."""
    mols, bs = rotor_slots(mol_alive, params, species_list)
    if not mols:
        return {}
    axes = _basis(int(lmax), N_THETA, N_PHI)[3]
    t0 = time.perf_counter()
    v = potentials_on_grid(pos, box, atom_alive, params, cfg,
                           thermo.temperature, mols, axes)
    v = v.double().cpu().numpy()
    t1 = time.perf_counter()
    evals, l_of = levels_from_potentials(v, np.asarray(bs), lmax)
    if times is not None:
        times["b4_s"] = times.get("b4_s", 0.0) + (t1 - t0)
        times["eigh_s"] = times.get("eigh_s", 0.0) + (time.perf_counter()
                                                      - t1)
    return {m: (evals[i], l_of[i]) for i, m in enumerate(mols)}


def table_from_eigs(eigs, n_mols: int, temperature) -> np.ndarray:
    """[M, 2] (F_para, F_ortho) [K] from cached eigensolves at the given
    temperature (zeros for non-rotor slots)."""
    table = np.zeros((int(n_mols), 2), np.float64)
    t = float(temperature)
    for m, (evals, l_of) in eigs.items():
        table[m] = symmetry_free_energies(evals, l_of, t)
    return table


def level_arrays(eigs, n_mols: int, lmax: int):
    """Array form of an ``eigen_tables`` cache: (levels [M, L] f64, parity
    [M, L] int32, valid [M, L] bool), L = (lmax+1)^2; rows absent from
    ``eigs`` are all-invalid."""
    L = (int(lmax) + 1) ** 2
    M = int(n_mols)
    levels = np.zeros((M, L), np.float64)
    par = np.zeros((M, L), np.int32)
    valid = np.zeros((M, L), bool)
    for m, (evals, l_of) in eigs.items():
        n = min(len(evals), L)
        levels[m, :n] = np.asarray(evals)[:n]
        par[m, :n] = np.asarray(l_of)[:n] % 2
        valid[m, :n] = True
    return levels, par, valid


def free_energies_from_levels(levels, par, valid, temperature):
    """``table_from_eigs`` on the device: [..., M, 2] (F_para, F_ortho)
    from the ``level_arrays`` form (tensors [..., M, L]) at
    ``temperature`` (a number, or a tensor [...] — one per replica);
    zeros for rows without levels."""
    t = torch.as_tensor(temperature, dtype=levels.dtype,
                        device=levels.device)
    t = t.reshape(t.shape + (1,) * (levels.ndim - 1 - t.ndim))      # [...,1]
    inf = torch.full_like(levels, math.inf)

    def f(p):
        sel = valid & (par == p)
        e0 = torch.where(sel, levels, inf).amin(dim=-1)
        has = torch.isfinite(e0)
        base = torch.where(has, e0, torch.zeros_like(e0))
        z = torch.sum(torch.where(
            sel, torch.exp(-(levels - base[..., None]) / t[..., None]),
            torch.zeros_like(levels)), dim=-1)
        fp = e0 - t * torch.log(torch.clamp(z, min=1e-300))
        return torch.where(has, fp, torch.full_like(fp, math.inf))

    has_rotor = torch.any(valid, dim=-1)
    table = torch.stack([f(0), f(1)], dim=-1)
    return torch.where(has_rotor[..., None], table, torch.zeros_like(table))


def free_energy_table(pos, box, atom_alive, mol_alive, params, cfg,
                      thermo, species_list, lmax: int = 4,
                      times: Dict = None) -> np.ndarray:
    """[M, 2] (F_para, F_ortho) [K] for every alive movable linear rotor
    (zeros elsewhere), float64 on the host — the per-corrtime table
    behind the per-step spinflip move."""
    eigs = eigen_tables(pos, box, atom_alive, mol_alive, params, cfg,
                        thermo, species_list, lmax=lmax, times=times)
    return table_from_eigs(eigs, int(params.n_mols_max),
                           float(thermo.temperature.reshape(-1)[0]))


def initial_spins(seed: int, n_chains=None, n_mols: int = 0) -> np.ndarray:
    """The normal-H2 initial spins, 3:1 ortho (1) : para (0), int32 [M]
    (or [C, M]) from numpy's default_rng(seed + 977) — the reference's
    draw, so both start from the same spins."""
    rng = np.random.default_rng(seed + 977)
    shape = (int(n_mols),) if n_chains is None else (int(n_chains),
                                                     int(n_mols))
    return (rng.random(shape) < 0.75).astype(np.int32)

