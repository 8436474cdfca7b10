"""Static-framework cell lists, ``cell_list`` (port of
mpmc_tpu/ops/celllist.py).

Most atoms of a sorption system belong to a frozen framework whose
positions never change, so a spatial index over them is exact and built
once:

- the framework atoms (the frozen prefix [0, F) of the padded atom array)
  are bucketed on the host into the cells of a fractional-coordinate grid;
  their positions and static parameters are stored cell-major ([nc, cap])
  on the device, one set of tables shared by every chain;
- the cell edge defaults to ``cutoff + reach`` (reach: the largest
  template-site distance from a species' unweighted site centroid), so the
  block of cells around a molecule's centroid covers every framework atom
  any of its sites sees inside the cutoff — no skin, no rebuild, exact;
- the sorbate slots (the [F, N) tail) are priced densely, so their motion
  needs no index maintenance.

The LJ / dispersion tail coefficient is not distance-limited; its
framework side depends only on the row atom's parameters, so it is a
per-atom table built with the index (``lrc_fw``), and only the sorbate
part is summed at run time.

The culled pass (``mol_pair_pass_culled``) replaces the per-move delta
pass ops/pairs.mol_pair_pass (B4 on the card) wherever ``cell_list`` is on
and an index is attached, as the reference routes it.  It is plain PyTorch
on the tensors' device — the reference computes it in jnp, outside any
Pallas kernel — over a leading chain axis in one batched pass: the cell
blocks of every chain's molecule, gathered from the shared tables, and
the sorbate tail form one [C, A, K cap + N - F] tile.  Its sums equal the
dense pass's to summation-order rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.constants import KE
from mpmc_tpu_torch.ops import lj as lj_ops
from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.ops import potentials

# pairs of one block of the culled pass ([c, A, columns] temporaries)
PLAIN_PAIRS = 1 << 23


@dataclasses.dataclass(frozen=True)
class CellIndex:
    """The framework's cell-major tables ([nc, cap], positions [nc, cap,
    3]) on the device, shared by every chain."""
    fw_pos: torch.Tensor
    fw_valid: torch.Tensor
    fw_q: torch.Tensor
    fw_eps: torch.Tensor
    fw_sig: torch.Tensor
    fw_c6: torch.Tensor
    fw_c8: torch.Tensor
    fw_c10: torch.Tensor
    fw_gwp: torch.Tensor
    offsets: torch.Tensor     # [K, 3] int64 cell offsets covering rc + reach
    lrc_fw: torch.Tensor      # [N] per-atom tail-coefficient sum vs framework
    fw_mass: torch.Tensor     # 0-d: the framework molecule's total mass (FH)
    grid: Tuple[int, int, int] = (1, 1, 1)
    n_frozen: int = 0

    @property
    def columns(self) -> int:
        """Framework columns a molecule's rows meet: K cells x cap."""
        return int(self.offsets.shape[0] * self.fw_pos.shape[1])


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _species_reach(params) -> float:
    """Largest template-site distance from the unweighted site centroid of
    each species: the culled pass centres its cell block on the unweighted
    mean of the molecule's rows, so coverage holds only when the reach is
    measured from that point (not from the COM the templates are stored
    around; the two differ for off-centre massless sites)."""
    sp = _np(params.species_pos)
    sn = params.species_natoms.cpu().numpy()
    reach = 0.0
    for s in range(sp.shape[0]):
        a = int(sn[s])
        if a:
            cen = sp[s, :a].mean(axis=0)
            reach = max(reach,
                        float(np.linalg.norm(sp[s, :a] - cen, axis=1).max()))
    return reach


def build_cell_index(params, pos, box, cfg,
                     cell_edge: Optional[float] = None,
                     min_reduction: Optional[float] = 0.8,
                     pad_cap: int = 8) -> Optional[CellIndex]:
    """Host-side construction of the framework cell index, its tables on
    ``params``' device.  None where culling cannot apply: no explicit
    cutoff, a cdvdw repulsion (the culled pass has no Drude branch), no
    frozen framework, or — unless ``min_reduction`` is None — K cap
    columns not below min_reduction F.  Raises under npt."""
    if cfg.ensemble == "npt":
        raise ValueError("cell_list requires a fixed box (not npt)")
    if cfg.cutoff is None:
        return None
    if cfg.cdvdw_repulsion != "none":
        return None
    if not bool(params.mol_frozen.any()):
        return None
    F = int(params.mol_natoms[0])
    if F == 0:
        return None

    box = _np(torch.as_tensor(box))
    pos = _np(torch.as_tensor(pos))
    rc = float(cfg.cutoff)
    R = rc + _species_reach(params) + 1e-9

    vol = abs(np.linalg.det(box))
    w = np.array([vol / np.linalg.norm(np.cross(box[1], box[2])),
                  vol / np.linalg.norm(np.cross(box[2], box[0])),
                  vol / np.linalg.norm(np.cross(box[0], box[1]))])
    # default edge >= R, so the 3^3 neighbourhood suffices
    e = cell_edge if cell_edge is not None else R * 1.001
    G = np.maximum(1, (w / e).astype(int))

    offs_axes = []
    for a in range(3):
        cr = int(np.floor(R * G[a] / w[a])) + 1
        if 2 * cr + 1 >= G[a]:
            offs_axes.append(np.arange(int(G[a])))
        else:
            offs_axes.append(np.arange(-cr, cr + 1))
    offsets = np.stack(np.meshgrid(*offs_axes, indexing="ij"),
                       -1).reshape(-1, 3)

    # bucket the framework atoms by fractional cell
    frac = (pos[:F] @ np.linalg.inv(box)) % 1.0
    cell3 = np.minimum((frac * G).astype(int), G - 1)
    flat = (cell3[:, 0] * G[1] + cell3[:, 1]) * G[2] + cell3[:, 2]
    nc = int(G[0] * G[1] * G[2])
    counts = np.bincount(flat, minlength=nc)
    cap = int(-(-max(1, counts.max()) // pad_cap) * pad_cap)
    if (min_reduction is not None
            and offsets.shape[0] * cap >= min_reduction * F):
        return None

    # cell-major slots, each cell's atoms in atom order (a stable sort)
    order = np.argsort(flat, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(F, np.int64)
    slot[order] = np.arange(F) - start[flat[order]]
    fw_valid = np.zeros((nc, cap), bool)
    fw_valid[flat, slot] = True

    dev, dt = params.device, params.eps.dtype

    def table(src, d3=False):
        out = np.zeros((nc, cap, 3) if d3 else (nc, cap), np.float64)
        out[flat, slot] = src
        return torch.as_tensor(out, dtype=dt, device=dev)

    cols = {k: _np(getattr(params, k))[:F]
            for k in ("charge", "eps", "sig", "c6", "c8", "c10",
                      "gwp_alpha")}
    return CellIndex(
        fw_pos=table(pos[:F], d3=True),
        fw_valid=torch.as_tensor(fw_valid, device=dev),
        fw_q=table(cols["charge"]), fw_eps=table(cols["eps"]),
        fw_sig=table(cols["sig"]), fw_c6=table(cols["c6"]),
        fw_c8=table(cols["c8"]), fw_c10=table(cols["c10"]),
        fw_gwp=table(cols["gwp_alpha"]),
        offsets=torch.as_tensor(offsets, dtype=torch.int64, device=dev),
        lrc_fw=torch.as_tensor(_framework_lrc_table(params, cfg, rc, F),
                               dtype=dt, device=dev),
        fw_mass=params.mol_mass[0].clone(),
        grid=tuple(int(g) for g in G), n_frozen=F)


def _framework_lrc_table(params, cfg, rc, F):
    """lrc_fw[i] = sum over framework atoms j of the tail coefficient
    T(mix(i, j)): the framework side of the delta pass's lrc_coeff,
    distance-independent and so a per-atom constant (float64, host),
    computed once per distinct site type."""
    N = params.n_atoms_max
    if not cfg.rd_lrc or cfg.rd_potential not in ("lj", "disp_expansion"):
        return np.zeros(N)
    c = {k: _np(getattr(params, k)) for k in ("eps", "sig", "c6", "c8",
                                              "c10")}
    keys = np.stack([c["eps"], c["sig"], c["c6"], c["c8"], c["c10"]], 1)
    uniq, inv = np.unique(keys.round(12), axis=0, return_inverse=True)
    f = {k: torch.as_tensor(v[:F], dtype=torch.float64)
         for k, v in c.items()}
    out_t = np.zeros(len(uniq))
    for t in range(len(uniq)):
        ei, si, c6i, c8i, c10i = (torch.tensor(float(x), dtype=torch.float64)
                                  for x in uniq[t])
        if cfg.rd_potential == "lj":
            em, sm = lj_ops.mix(ei, f["eps"], si, f["sig"], cfg.mixing_rule)
            tc = lj_ops.tail_coefficient(em, sm, rc)
        else:
            tc = potentials.disp_tail_coefficient(
                potentials.disp_mix(c6i, f["c6"]),
                potentials.disp_mix(c8i, f["c8"]),
                potentials.disp_mix(c10i, f["c10"]), rc)
        out_t[t] = float(tc.sum())
    return out_t[np.asarray(inv).reshape(-1)]


def attach(params, pos, box, cfg, cell_edge: Optional[float] = None,
           min_reduction: Optional[float] = 0.8):
    """``params`` with the framework cell index attached (host-side, once
    after build_system); ``params`` unchanged where culling cannot apply
    (build_cell_index)."""
    ci = build_cell_index(params, pos, box, cfg, cell_edge, min_reduction)
    if ci is None:
        return params
    return params.replace(cell_index=ci)


# ---------------------------------------------------------------------------
# the culled delta pass
# ---------------------------------------------------------------------------

def _culled_block(pos, atom_alive, params, cfg, temperature, mol, rows_pos,
                  index: CellIndex, scal):
    """The culled sums of a block of C chains: (rd, es_real raw, lrc,
    min_r2), each [C].  ``pos`` [C, N, 3] (or [1, N, 3] shared by every
    chain), ``atom_alive`` [C or 1, N], ``mol`` [C], ``rows_pos`` [C, A,
    3], ``temperature`` 0-d or [C], ``scal`` the pair header
    (pairs.pair_scalars).  One [C, A, K cap + N - F] tile: the K cell
    blocks around each chain's centroid, gathered from the shared tables,
    then every sorbate slot column; the per-pair values of
    pairs._tile_values with one-sided counting (rows and columns are
    molecule-disjoint): rd and es over pairs within rc, the tail over the
    sorbate pairs (the framework's from ``index.lrc_fw``), min_r2 over
    every pair."""
    from mpmc_tpu_torch.ops import pairs
    F, G = index.n_frozen, index.grid
    rc, alpha = scal[0], scal[1]
    box, box_inv = scal[2:11].reshape(3, 3), scal[11:20].reshape(3, 3)
    dtype, dev = pos.dtype, pos.device
    C = mol.shape[0]
    idx = params.mol_atoms[mol]                                 # [C, A]
    A = idx.shape[1]
    row_valid = (torch.arange(A, device=dev)[None, :]
                 < params.mol_natoms[mol][:, None])
    w = row_valid.to(dtype)
    com = (torch.sum(torch.where(row_valid[..., None], rows_pos,
                                 torch.zeros_like(rows_pos)), dim=1)
           / torch.clamp(torch.sum(w, dim=1), min=1.0)[:, None])
    # the cells per axis with the grid's Python ints (a grid tensor would
    # be a host-to-device copy, a host sync, per call)
    f = torch.remainder(pbc_ops._apply33(com, box_inv), 1.0)
    cells = [torch.remainder(
        torch.clamp((f[:, a] * G[a]).to(torch.int64), max=G[a] - 1)[:, None]
        + index.offsets[None, :, a], G[a]) for a in range(3)]   # [C, K] each
    flat = (cells[0] * G[1] + cells[1]) * G[2] + cells[2]
    n_s = pos.shape[1] - F

    def cols(table, col):
        """[C, K cap + N - F]: a framework table's cell blocks, then the
        per-atom column ``col``'s sorbate tail."""
        return torch.cat([table[flat].reshape(C, -1),
                          col[F:][None].expand(C, n_s)], 1)

    col_pos = torch.cat([index.fw_pos[flat].reshape(C, -1, 3),
                         pos[:, F:].expand(C, n_s, 3)], 1)
    sb_ok = atom_alive[:, F:] & (params.mol_id[F:][None, :] != mol[:, None])
    col_ok = torch.cat([index.fw_valid[flat].reshape(C, -1),
                        sb_ok.expand(C, n_s)], 1)
    dr = pbc_ops.min_image(rows_pos[:, :, None, :] - col_pos[:, None, :, :],
                           box, box_inv)
    r2 = torch.sum(dr * dr, dim=-1)                         # [C, A, cols]
    ok = row_valid[:, :, None] & col_ok[:, None, :]
    act = ok & (r2 < rc * rc)

    def row(x):
        return x[idx][:, :, None]

    def col(table, x):
        return cols(table, x)[:, None, :]
    qc = disp = gwp = None
    if pairs.quantum(cfg):
        t = torch.as_tensor(temperature, dtype=dtype, device=dev)
        qc = (params.mol_mass[mol][:, None, None],
              col(index.fw_mass.expand(index.fw_valid.shape),
                  params.mol_mass_atom), t.reshape(t.shape + (1, 1)))
    if cfg.rd_potential == "disp_expansion":
        disp = ((row(params.c6), row(params.c8), row(params.c10)),
                (col(index.fw_c6, params.c6), col(index.fw_c8, params.c8),
                 col(index.fw_c10, params.c10)))
    if cfg.coulomb == "gwp":
        gwp = (row(params.gwp_alpha), col(index.fw_gwp, params.gwp_alpha))
    rd_u, es_u, _, tc = pairs._tile_values(
        r2, row(params.charge), row(params.eps), row(params.sig),
        col(index.fw_q, params.charge), col(index.fw_eps, params.eps),
        col(index.fw_sig, params.sig), cfg, rc, alpha, qc, disp, gwp)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def s(values, mask):
        if values is None:
            return torch.zeros(C, dtype=dtype, device=dev)
        return torch.sum(torch.where(mask, values, zero), dim=(1, 2))

    lrc = torch.zeros(C, dtype=dtype, device=dev)
    if pairs.lrc_on(cfg):
        sb_col = (torch.arange(r2.shape[-1], device=dev) >= r2.shape[-1] - n_s)
        lrc = (s(tc, ok & sb_col) + torch.sum(torch.where(
            row_valid, index.lrc_fw[idx], torch.zeros_like(w)), dim=1))
    mn = torch.where(ok, r2, torch.full_like(r2, math.inf)).amin(dim=(1, 2))
    return s(rd_u, act), s(es_u, act), lrc, mn


def mol_pair_pass_culled(pos, box, atom_alive, params, cfg, temperature,
                         mol, index: CellIndex, row_pos=None, shared=False,
                         scal=None):
    """The culled equivalent of pairs.mol_pair_pass: one molecule's rows
    (or its trial ``row_pos``) against the framework cell blocks around
    its centroid, gathered from the index's shared tables, and against
    every sorbate slot column densely.  PairTerms of 0-d tensors for one
    chain (``pos`` [N, 3], ``mol`` an int or 0-d tensor); of [C] tensors
    over chains (``pos`` [C, N, 3], ``atom_alive`` [C, N], ``mol`` [C],
    ``row_pos`` [C, A, 3]) or with ``shared`` (``pos`` [N, 3] and
    ``atom_alive`` [N] every chain's, ``mol`` [C] and ``row_pos`` [C, A,
    3] the chains' own), in blocks of at most PLAIN_PAIRS pairs, each
    chain's value the same in any block.  ``temperature`` 0-d or [C];
    ``scal`` a precomputed pairs.pair_scalars(box, cfg) (the MC step's)."""
    from mpmc_tpu_torch.ops import pairs
    single = pos.ndim == 2 and not shared
    mol = torch.as_tensor(mol, device=pos.device).reshape(-1)
    if single:
        pos, atom_alive = pos[None], atom_alive[None]
        if row_pos is not None:
            row_pos = row_pos[None]
    elif shared:
        pos, atom_alive = pos[None], atom_alive[None]
    if box.ndim != 2:
        raise ValueError("cell_list: one box for every chain (not npt)")
    if scal is None:
        scal = pairs.pair_scalars(box, cfg)
    C = mol.shape[0]
    temp = torch.as_tensor(temperature, device=pos.device)
    cols = index.columns + pos.shape[1] - index.n_frozen
    step = max(1, PLAIN_PAIRS // max(params.max_atoms_per_mol * cols, 1))
    outs = []
    for c0 in range(0, C, step):
        sl = slice(c0, min(c0 + step, C))
        m = mol[sl]
        p = pos if shared else pos[sl]
        al = atom_alive if shared else atom_alive[sl]
        if row_pos is not None:
            rows = row_pos[sl]
        elif shared:
            rows = pos[0][params.mol_atoms[m]]
        else:
            ar = torch.arange(p.shape[0], device=pos.device)[:, None]
            rows = p[ar, params.mol_atoms[m]]
        outs.append(_culled_block(
            p, al, params, cfg, temp[sl] if temp.ndim else temp, m, rows,
            index, scal))
    rd, es, lrc, mn = (torch.cat(x) for x in zip(*outs))
    out = pairs.PairTerms(rd=rd, es_real=KE * es,
                          es_excl=torch.zeros_like(rd), lrc_coeff=lrc,
                          min_r2=mn)
    if single:
        return pairs.PairTerms(*(x[0] for x in (out.rd, out.es_real,
                                                out.es_excl, out.lrc_coeff,
                                                out.min_r2)))
    return out
