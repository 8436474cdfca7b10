"""Periodic-image repulsion-dispersion lattice sum, ``rd_crystal`` (port
of mpmc_tpu/ops/crystal.py):

    U_rd = 1/2  sum_i sum_j sum'_n  u(|r_ij + n . h|)

over every integer image triple n with |n_a| <= rd_crystal_order, the
primed sum leaving out (i == j, n == 0); the n == 0 term also leaves out
intramolecular pairs, as the cutoff pass does.  No cutoff applies inside
the shells: the option exists for converged lattice energies of small
crystal cells where no legal cutoff (<= L/2) holds the RD tail, so
``rd_lrc`` is off (the input parser forces it).  A molecule's energy with
its own periodic images (n != 0, i == j included) is part of the sum and
changes under rotation and insertion, so the per-move term
(``mol_rd_crystal``) keeps it.

Plain PyTorch on the tensors' device, as the reference's jnp scan: the
image shifts are one batched axis of each row block's tile (at most
PLAIN_PAIRS pair values at once).  ops/pairs.py routes both passes here
for RD and takes ES from the cutoff pass with rd none.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpmc_tpu_torch.ops import pbc as pbc_ops

PLAIN_PAIRS = 1 << 23      # pair values of one batched (shift, row, col)


def image_shifts(order: int) -> np.ndarray:
    """All integer image triples |n_a| <= order, central (0,0,0) first."""
    g = np.arange(-order, order + 1)
    s = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    key = np.argsort((np.abs(s).max(1) > 0).astype(int), kind="stable")
    s = s[key]
    assert (s[0] == 0).all()
    return s


def _rd_values(dr0, shifts, ri, ci, params, cfg, temperature):
    """[S, B, M] RD pair energies at the displacements dr0 [B, M, 3] +
    each Cartesian shift [S, 3], rows ``ri`` [B] against columns ``ci``
    [M] (index tensors), no masks; r^2 <= 1e-12 is evaluated at 1 (the
    reference's guard).  Also the [S, B, M] r^2."""
    from mpmc_tpu_torch.ops import pairs
    d = dr0[None] + shifts[:, None, None, :]
    r2 = torch.sum(d * d, dim=-1)
    cfg_rd = dataclasses.replace(cfg, coulomb="none", rd_lrc=False,
                                 rd_crystal=False)
    qc = None
    if pairs.quantum(cfg):
        qc = (params.mol_mass_atom[ri][:, None],
              params.mol_mass_atom[ci][None, :], temperature)
    disp, _ = pairs.site_columns(params, cfg_rd)
    if disp is not None:
        disp = (tuple(c[ri][:, None] for c in disp),
                tuple(c[ci][None, :] for c in disp))
    rd_u, _, _, _ = pairs._tile_values(
        r2, params.charge[ri][:, None], params.eps[ri][:, None],
        params.sig[ri][:, None], params.charge[ci][None, :],
        params.eps[ci][None, :], params.sig[ci][None, :], cfg_rd, None, None,
        qc, disp, None)
    if rd_u is None:
        rd_u = torch.zeros_like(r2)
    return rd_u, r2


def _shifts(box, cfg):
    """The image shifts n . h [S, 3] of ``box`` (central first)."""
    s = torch.as_tensor(image_shifts(cfg.rd_crystal_order), dtype=box.dtype,
                        device=box.device)
    return s @ box


def rd_crystal_full(pos, box, atom_alive, params, cfg, temperature,
                    split_frozen=False):
    """Full-system crystal RD energy: a 0-d tensor, or with
    ``split_frozen`` (active, frozen_frozen), the frozen part holding the
    terms internal to the frozen framework (pairs.pair_pass's split)."""
    n = pos.shape[0]
    dev = pos.device
    shifts = _shifts(box, cfg)
    S = shifts.shape[0]
    box_inv = torch.linalg.inv(box)
    cols = torch.arange(n, device=dev)
    frozen = params.mol_frozen[params.mol_id]
    central = (torch.arange(S, device=dev) == 0)[:, None, None]
    zero = torch.zeros((), dtype=pos.dtype, device=dev)
    u = u_ff = zero
    B = max(1, min(n, PLAIN_PAIRS // max(S * n, 1)))
    for i0 in range(0, n, B):
        idx = cols[i0:i0 + B]
        dr0 = pbc_ops.min_image(pos[idx][:, None, :] - pos[None, :, :], box,
                                box_inv)
        rd_u, _ = _rd_values(dr0, shifts, idx, cols, params, cfg,
                             temperature)
        base = atom_alive[idx][:, None] & atom_alive[None, :]
        tri = cols[None, :] > idx[:, None]
        same = params.mol_id[idx][:, None] == params.mol_id[None, :]
        diag = cols[None, :] == idx[:, None]
        ff = (frozen[idx][:, None] & frozen[None, :] if split_frozen
              else torch.zeros_like(base))
        # central image: inter-molecular i < j only; the other images:
        # every i < j pair plus the half-weighted self image
        w_tri = torch.where(central, base & tri & ~same, base & tri)
        w_diag = ~central & base & diag
        for keep, acc in ((~ff, 0), (ff, 1)):
            part = (torch.sum(torch.where(w_tri & keep, rd_u, zero))
                    + 0.5 * torch.sum(torch.where(w_diag & keep, rd_u,
                                                  zero)))
            if acc == 0:
                u = u + part
            else:
                u_ff = u_ff + part
    return (u, u_ff) if split_frozen else u + u_ff


def mol_rd_crystal(pos, box, atom_alive, params, cfg, temperature, mol,
                   row_pos=None):
    """Crystal RD terms touching molecule ``mol`` (an int or 0-d tensor):
    its rows (or trial ``row_pos``) against every other alive molecule
    over all image shifts, plus 1/2 its energy with its own images (n !=
    0) — the delta analog of pairs.mol_pair_pass for the crystal sum."""
    from mpmc_tpu_torch.state import mol_rows, row_valid, take
    box_inv = torch.linalg.inv(box)
    shifts = _shifts(box, cfg)
    idx = take(params.mol_atoms, mol)
    valid = row_valid(params, mol)
    col_alive = atom_alive & (params.mol_id != mol)
    rows = mol_rows(pos, params, mol) if row_pos is None else row_pos
    cols = torch.arange(pos.shape[0], device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    dr0 = pbc_ops.min_image(rows[:, None, :] - pos[None, :, :], box,
                            box_inv)
    rd_u, _ = _rd_values(dr0, shifts, idx, cols, params, cfg, temperature)
    u = torch.sum(torch.where((valid[:, None] & col_alive[None, :])[None],
                              rd_u, zero))
    # the molecule's own block, its periodic images only
    dr_own = pbc_ops.min_image(rows[:, None, :] - rows[None, :, :], box,
                               box_inv)
    rd_own, _ = _rd_values(dr_own, shifts, idx, idx, params, cfg,
                           temperature)
    own = (valid[:, None] & valid[None, :])[None] & (
        torch.arange(shifts.shape[0], device=pos.device) > 0)[:, None, None]
    return u + 0.5 * torch.sum(torch.where(own, rd_own, zero))


def mol_rd_crystal_any(pos, box, atom_alive, params, cfg, temperature, mol,
                       row_pos=None, shared=False):
    """``mol_rd_crystal`` of one chain, or of each chain of a batched call
    (pairs.mol_pair_pass's layouts: ``pos`` [C, N, 3] with ``mol`` [C],
    or ``shared`` one system against C trial placements), [C]; ``box`` and
    ``temperature`` shared or one per chain."""
    if pos.ndim == 2 and not shared:
        return mol_rd_crystal(pos, box, atom_alive, params, cfg, temperature,
                              mol, row_pos=row_pos)
    t = torch.as_tensor(temperature)
    return torch.stack([
        mol_rd_crystal(pos if shared else pos[c],
                       box[c] if box.ndim == 3 else box,
                       atom_alive if shared else atom_alive[c], params, cfg,
                       t[c] if t.ndim else t, mol[c],
                       row_pos=None if row_pos is None else row_pos[c])
        for c in range(mol.shape[0])])
