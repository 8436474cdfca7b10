"""Trial-move proposal builders (port of mpmc_tpu/mc/moves.py).

Every random number comes from one row of the step's uniform table, with
the lane layout of the fused µVT kernel (mc_kernel.draw_uniforms(lanes=16),
consumed as in mc_kernel._kernel_uvt):

- lane 0: the slot, by rank among the eligible slots;
- lanes 1-3: the displacement, or the inserted molecule's fractional COM
  (under cavity bias its fractional position inside the picked cell);
- lanes 5-7: displace rotation (axis z, axis azimuth, angle / rot_factor),
  or the inserted molecule's Shoemake quaternion;
- lane 10: under cavity bias the open cell of an insert, by rank among the
  open cells of the grid.

Move semantics follow the reference: displace = uniform translation in a
cube of half-width ``move_factor`` plus a rotation about the mass-weighted
COM by a uniform angle in [0, rot_factor) about a uniform axis; insert =
the species template at a uniform fractional position and orientation.
All functions run on the device with no host sync.
"""
from __future__ import annotations

import math

import torch

from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.state import (Params, all_molecule_coms, chain_rows,
                                  molecule_com, mol_rows, row_valid, take)
from mpmc_tpu_torch.utils import quaternion as quat


def pick_by_rank(mask, u):
    """(index, count): the j-th True of ``mask`` (0-based, slot order) with
    j = min(floor(u * count), count - 1) — the kernel's rank pick.  With
    count 0 the index is 0 and the caller rejects the move.  Over chains:
    ``mask`` [C, M] and ``u`` [C] give [C] indices and counts."""
    cnt = torch.sum(mask, dim=-1)
    j = torch.minimum(torch.floor(u * cnt.to(u.dtype)),
                      (cnt - 1).to(u.dtype))
    cs = torch.cumsum(mask.to(torch.int64), -1)
    return torch.argmax((cs > j[..., None]).to(torch.int8), dim=-1), cnt


def _displace(rows, valid, com, u, move_factor, rot_factor):
    """Trial rows of a translate+rotate move of ``rows`` [..., A, 3] about
    ``com`` [..., 3] from uniform rows ``u`` [..., 16]."""
    disp = (2.0 * u[..., 1:4] - 1.0) * move_factor
    az = 2.0 * u[..., 5] - 1.0
    aphi = 2.0 * math.pi * u[..., 6]
    s = torch.sqrt(torch.clamp(1.0 - az * az, min=0.0))
    axis = torch.stack([s * torch.cos(aphi), s * torch.sin(aphi), az], -1)
    q = quat.from_axis_angle(axis, u[..., 7] * rot_factor)
    c = com[..., None, :]
    new = (c + disp[..., None, :]) + quat.rotate(rows - c, q[..., None, :])
    return torch.where(valid[..., None], new, new[..., :1, :]).contiguous()


def displace_rows(pos, params: Params, mol, u, move_factor, rot_factor):
    """[A,3] trial rows of a translate+rotate move of molecule ``mol``
    from one uniform row ``u`` [16].  Padded rows duplicate the first.
    Over chains: ``pos`` [C, N, 3], ``mol`` [C], ``u`` [C, 16] ->
    [C, A, 3], each chain's molecule moved by its own row."""
    if pos.ndim == 3:
        rows = chain_rows(pos, params, mol)
        valid = row_valid(params, mol)
        m = take(params.mass, take(params.mol_atoms, mol)) * valid
        com = (torch.sum(m[..., None] * rows, dim=-2)
               / torch.clamp(torch.sum(m, dim=-1), min=1e-30)[..., None])
        return _displace(rows, valid, com, u, move_factor, rot_factor)
    rows = mol_rows(pos, params, mol)
    valid = row_valid(params, mol)
    com = molecule_com(pos, params, mol)
    disp = (2.0 * u[1:4] - 1.0) * move_factor
    az = 2.0 * u[5] - 1.0
    aphi = 2.0 * math.pi * u[6]
    s = torch.sqrt(torch.clamp(1.0 - az * az, min=0.0))
    axis = torch.stack([s * torch.cos(aphi), s * torch.sin(aphi), az])
    q = quat.from_axis_angle(axis, u[7] * rot_factor)
    new = (com + disp) + quat.rotate(rows - com, q)
    return torch.where(valid[:, None], new, new[0]).contiguous()


def place_rows(params: Params, mol, species, u, box, frac=None):
    """[A,3] trial rows: the species template at fractional COM u[1:4]
    (``frac`` when given: the cavity-biased COM of ``cell_frac``) and
    Shoemake orientation u[5:8] (GCMC insertion).  Rows beyond the
    species' atom count duplicate the first row.  Over chains: ``mol``
    and ``species`` [C], ``u`` [C, 16] -> [C, A, 3]."""
    com = pbc_ops._apply33(u[..., 1:4] if frac is None else frac, box)
    q = quat.uniform_from(u[..., 5], u[..., 6], u[..., 7])
    new = (com[..., None, :]
           + quat.rotate(take(params.species_pos, species), q[..., None, :]))
    return torch.where(row_valid(params, mol)[..., None], new,
                       new[..., :1, :]).contiguous()


def cavity_open_grid(pos, box, atom_alive, g: int, radius, block=256):
    """[g^3] bool: the cells of a g x g x g grid over the cell whose centre
    has no alive atom within ``radius`` under the minimum image — the
    reference's cavity grid (mpmc_tpu/mc/moves.py:73-96), cell (i, j, k)
    at flat index (i g + j) g + k, in row blocks of ``block`` cells.  On
    the device, no host sync."""
    dt, dev = pos.dtype, pos.device
    ii = torch.arange(g, device=dev)
    frac = (torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"),
                        -1).reshape(-1, 3).to(dt) + 0.5) / g
    centers = pbc_ops._apply33(frac, box)
    box_inv = torch.linalg.inv(box)
    r = torch.as_tensor(radius, dtype=dt, device=dev)
    r2max = r * r
    out = []
    for b in range(0, centers.shape[0], block):
        dr = pbc_ops.min_image(centers[b:b + block, None, :] - pos[None],
                               box, box_inv)
        near = (torch.sum(dr * dr, -1) < r2max) & atom_alive[None, :]
        out.append(~torch.any(near, dim=1))
    return torch.cat(out)


def cell_frac(cell, u, g: int):
    """[..., 3] fractional position of a point inside grid cell ``cell``
    (flat index, [...] int), placed by lanes 1-3 of the uniform rows ``u``
    [..., 16]: (ijk + u) / g — the cavity-biased insert COM, in the
    arithmetic of the fused µVT kernel (mpmc_tpu/ops/pallas/
    mc_kernel.py:1166-1190)."""
    ijk = torch.stack([cell // (g * g), (cell // g) % g, cell % g], -1)
    return (ijk.to(u.dtype) + u[..., 1:4]) / g


def scale_volume(pos, box, params: Params, d_lnv):
    """Isotropic cell rescale by ln V -> ln V + ``d_lnv``, each atom
    shifted by (s - 1) times its molecule's centre of mass, s = exp(d_lnv
    / 3): rigid molecules keep their geometry (the NPT volume move, and
    the virial pressure's volume perturbation).  Returns (new_pos,
    new_box).  The frozen framework's COM moves too, so a volume move is
    only valid without one; the caller decides.  Over chains (``pos``
    [C, N, 3], ``box`` [C, 3, 3], ``d_lnv`` [C]) each chain is its
    single-chain call, bit for bit."""
    if pos.ndim == 3:
        out = [scale_volume(pos[c], box[c], params, d_lnv[c])
               for c in range(pos.shape[0])]
        return (torch.stack([p for p, _ in out]),
                torch.stack([b for _, b in out]))
    s = torch.exp(torch.as_tensor(d_lnv, dtype=pos.dtype,
                                  device=pos.device) / 3.0)
    coms = all_molecule_coms(pos, params)                # [M, 3]
    return pos + (s - 1.0) * coms[params.mol_id], box * s
