"""Quantum vibration: stretch eigenspectra of linear sorbates in their
environment (port of mpmc_tpu/ops/qvib.py).

For each alive movable linear sorbate the 1D radial stretch equation

    [ -hbar^2/(2 mu) d^2/db^2 + V_intra(b) + V_ext(b) ] psi = E psi

is solved by finite differences on a bond-length grid: b the distance
between the two mass-carrying ends (every site's signed axial offset
scales as b/b0, massless charge sites ride along), mu the reduced mass of
the two sides of the COM, V_intra = 1/2 k (b - b0)^2 from the species'
fundamental ``vib_omega`` [cm^-1] (hc/kB = 1.43877688 K cm), and V_ext(b)
the molecule's pair energy (RD + real-space ES) with everything else when
stretched about its COM along its current axis.  Reported per corrtime:
the zero-point energies and the field-induced shift of the fundamental,
(E1 - E0) - hbar w_e.  Purely diagnostic: nothing feeds the acceptance.

V_ext is B4 at position stride 0 (pairs.mol_pair_pass, ``shared``): every
(molecule, bond length) placement a chain of one launch against the one
system, as ops/qrot.py prices its orientation grid — one launch for
every eligible molecule of a refresh (``external_potentials_on_grid``).
The finite-difference Hamiltonian is tridiagonal; its lowest levels come
from LAPACK's tridiagonal bisection in host float64
(scipy.linalg.eigvalsh_tridiagonal), the eigenvalues the reference's
dense eigvalsh gives.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.constants import HBAR2_KB_AMU_A2
from mpmc_tpu_torch.state import all_molecule_coms

# hc/kB: 1 cm^-1 in Kelvin
CM1_K = 1.43877688
N_GRID = 224


def stretch_geometry(species) -> Tuple[np.ndarray, float, float]:
    """(axial offsets s_i [A], b0 [A], mu [amu]) of a linear species: s_i
    the signed template coordinate of each site along the axis of its
    farthest site from the centroid, b0 the end-to-end distance, mu from
    the summed masses on each side of the COM."""
    p = np.asarray(species.pos, np.float64)
    m = np.asarray(species.mass, np.float64)
    if species.natoms < 2:
        raise ValueError(f"species {species.name}: not a linear molecule")
    ext = p - p.mean(0)
    far = np.argmax(np.sum(ext * ext, 1))
    n = ext[far]
    nn = np.linalg.norm(n)
    if nn < 1e-9:
        raise ValueError(f"species {species.name}: degenerate template")
    n = n / nn
    s = p @ n
    b0 = float(s.max() - s.min())
    m_plus = float(np.sum(m[s > 1e-9]))
    m_minus = float(np.sum(m[s < -1e-9]))
    if b0 < 1e-9 or m_plus <= 0 or m_minus <= 0:
        raise ValueError(f"species {species.name}: no stretchable bond")
    mu = m_plus * m_minus / (m_plus + m_minus)
    return s, b0, mu


def stretch_grid(b0: float, mu: float, hw: float, n_grid: int = N_GRID,
                 n_widths: float = 7.0) -> np.ndarray:
    """Bond-length grid centred on b0 over +-n_widths ground-state widths
    sqrt(hbar/(mu w)) of the free oscillator (clipped to b > 0)."""
    width = np.sqrt(HBAR2_KB_AMU_A2 / (mu * max(hw, 1e-6)))
    half = n_widths * width
    lo = max(b0 - half, 0.05 * b0)
    return np.linspace(lo, b0 + half, n_grid)


def stretch_rows(pos, params, mols, s_list, b0_list, grids):
    """[R, G, A, 3] rows of molecule ``mols[r]`` stretched to each bond
    length of ``grids[r]`` ([R, G]) about its COM along its current axis:
    com + (b / b0) s_i axis, the axis the direction of the site with the
    largest template |s| (its sign that of s); padding rows take row 0."""
    dev, dt = pos.device, pos.dtype
    A = params.max_atoms_per_mol
    mt = torch.as_tensor([int(m) for m in mols], dtype=torch.int64,
                         device=dev)
    idx = params.mol_atoms[mt]                                   # [R, A]
    ok = (torch.arange(A, device=dev)[None, :]
          < params.mol_natoms[mt][:, None])
    com = all_molecule_coms(pos, params)[mt]                     # [R, 3]
    s = np.zeros((len(mols), A))
    far = np.zeros(len(mols), np.int64)
    sgn = np.zeros(len(mols))
    for r, sa in enumerate(s_list):
        sa = np.asarray(sa, np.float64)
        s[r, :len(sa)] = sa
        far[r] = int(np.argmax(np.abs(sa)))
        sgn[r] = float(np.sign(sa[far[r]]) or 1.0)
    st = torch.as_tensor(s, dtype=dt, device=dev)
    ar = torch.arange(len(mols), device=dev)
    axis_v = ((pos[idx[ar, torch.as_tensor(far, device=dev)]] - com)
              * torch.as_tensor(sgn, dtype=dt, device=dev)[:, None])
    axis = axis_v / torch.clamp(torch.linalg.norm(axis_v, dim=-1,
                                                  keepdim=True), min=1e-9)
    scale = (torch.as_tensor(np.asarray(grids, np.float64), dtype=dt,
                             device=dev)
             / torch.as_tensor(np.asarray(b0_list, np.float64), dtype=dt,
                               device=dev)[:, None])             # [R, G]
    rows = (com[:, None, None, :] + scale[:, :, None, None]
            * st[:, None, :, None] * axis[:, None, None, :])
    return torch.where(ok[:, None, :, None], rows, rows[:, :, :1])


def external_potentials_on_grid(pos, box, atom_alive, params, cfg,
                                temperature, mols, s_list, b0_list,
                                grids) -> torch.Tensor:
    """V_ext [R, G] in K on the device: molecule ``mols[r]``'s RD + real
    ES energy with every other molecule at each bond length of
    ``grids[r]`` (the reciprocal-space change is second order at fixed
    COM and left out, as in ops/qrot.py).  One B4 launch at position
    stride 0 over every (molecule, bond length)."""
    from mpmc_tpu_torch.ops import pairs
    grids = np.asarray(grids, np.float64).reshape(len(mols), -1)
    G = grids.shape[1]
    if not len(mols):
        return torch.zeros((0, G), dtype=pos.dtype, device=pos.device)
    rows = stretch_rows(pos, params, mols, s_list, b0_list, grids)
    mt = torch.as_tensor([int(m) for m in mols], dtype=torch.int64,
                         device=pos.device)
    t = pairs.mol_pair_pass(
        pos, box, atom_alive, params, cfg, temperature,
        mt.repeat_interleave(G),
        row_pos=rows.reshape(-1, rows.shape[2], 3).contiguous(),
        scal=pairs.pair_scalars(box, cfg), shared=True)
    return (t.rd + t.es_real).reshape(len(mols), G)


def external_potential_on_grid(pos, box, atom_alive, params, cfg,
                               temperature, mol: int, s_axial, b0: float,
                               b_grid) -> np.ndarray:
    """V_ext(b) [G] of one molecule, float64 on the host."""
    return external_potentials_on_grid(
        pos, box, atom_alive, params, cfg, temperature, [mol], [s_axial],
        [b0], [np.asarray(b_grid, np.float64)])[0].double().cpu().numpy()


def stretch_levels(b_grid, v_total, mu: float,
                   n_levels: int = 4) -> np.ndarray:
    """Lowest eigenvalues [K] of the 1D finite-difference Hamiltonian on
    ``b_grid`` (host float64; tridiagonal bisection)."""
    from scipy.linalg import eigvalsh_tridiagonal
    b_grid = np.asarray(b_grid, np.float64)
    v = np.asarray(v_total, np.float64)
    h_step = b_grid[1] - b_grid[0]
    kin = HBAR2_KB_AMU_A2 / (2.0 * mu * h_step * h_step)
    n = len(b_grid)
    k = min(n_levels, n)
    return eigvalsh_tridiagonal(v + 2.0 * kin, np.full(n - 1, -kin),
                                select="i", select_range=(0, k - 1))


def _levels(b_grid, v_ext, v_ext0, b0, mu, hw, n_levels):
    """Levels of V = 1/2 k (b - b0)^2 + V_ext(b) - V_ext(b0)."""
    k = mu * hw * hw / HBAR2_KB_AMU_A2        # K / A^2
    v = 0.5 * k * (b_grid - b0) ** 2 + (v_ext - v_ext0)
    return stretch_levels(b_grid, v, mu, n_levels)


def vibrational_levels(pos, box, atom_alive, params, cfg, temperature,
                       mol: int, species, n_grid: int = N_GRID,
                       n_levels: int = 4) -> Tuple[np.ndarray, float]:
    """(levels [K], hbar w_e [K]) of one linear sorbate in its
    environment, referenced to its current-geometry external energy
    (V_ext(b) - V_ext(b0)): a free molecule gives the bare ladder."""
    return _table_rows(pos, box, atom_alive, params, cfg, temperature,
                       [mol], [species], n_grid, n_levels)[0]


def _table_rows(pos, box, atom_alive, params, cfg, temperature, mols,
                species: Sequence, n_grid, n_levels) -> List:
    """[(levels, hbar w_e)] of molecules ``mols`` of ``species``: one B4
    launch over every molecule's n_grid bond lengths and its b0."""
    geo, grids = [], []
    for m, sp in zip(mols, species):
        hw = float(sp.vib_omega) * CM1_K
        if hw <= 0.0:
            raise ValueError(f"species {sp.name}: vib_omega not set")
        s, b0, mu = stretch_geometry(sp)
        bg = stretch_grid(b0, mu, hw, n_grid=n_grid)
        geo.append((s, b0, mu, hw, bg))
        grids.append(np.concatenate([bg, [b0]]))
    v = external_potentials_on_grid(
        pos, box, atom_alive, params, cfg, temperature, mols,
        [g[0] for g in geo], [g[1] for g in geo], grids).double().cpu(
            ).numpy()
    return [(_levels(bg, v[r, :-1], v[r, -1], b0, mu, hw, n_levels), hw)
            for r, (_, b0, mu, hw, bg) in enumerate(geo)]


def vibration_table(pos, box, atom_alive, mol_alive, params, cfg, thermo,
                    species_list, n_levels: int = 4) -> np.ndarray:
    """[M, n_levels] stretch levels [K] of every alive movable linear
    sorbate with a ``vib_omega`` (NaN rows elsewhere): one B4 launch for
    them all."""
    M = int(params.n_mols_max)
    table = np.full((M, n_levels), np.nan)
    alive_m = mol_alive.cpu().numpy()
    spec = params.mol_species.cpu().numpy()
    frozen = params.mol_frozen.cpu().numpy()
    natoms = params.mol_natoms.cpu().numpy()
    mols, sps = [], []
    for m in range(M):
        sidx = int(spec[m])
        if (not alive_m[m] or frozen[m] or sidx < 0 or natoms[m] < 2
                or float(species_list[sidx].vib_omega) <= 0.0):
            continue
        try:
            stretch_geometry(species_list[sidx])
        except ValueError:
            continue
        mols.append(m)
        sps.append(species_list[sidx])
    if not mols:
        return table
    temperature = thermo.temperature.reshape(-1)[0]
    for m, (levels, _) in zip(mols, _table_rows(
            pos, box, atom_alive, params, cfg, temperature, mols, sps,
            N_GRID, n_levels)):
        table[m] = levels
    return table
