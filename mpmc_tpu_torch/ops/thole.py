"""Thole-Applequist polarizable induced-dipole model (port of
mpmc_tpu/ops/thole.py).

    mu_i = alpha_i ( E0_i + sum_{j != i} T_ij mu_j )
    U    = -(ke/2) sum_i mu_i . E0_i        (at the SCF fixed point)

- E0 is the intermolecular static field of the permanent charges with
  Thole damping: direct (B5 charge mode, ops/cuda/thole_kernel.py),
  Wolf-shifted (``polar_wolf``) or full Ewald (``polar_ewald``), the last
  two plain PyTorch, as in the reference.
- T is the damped dipole tensor over all polarizable pairs within rc,
  intramolecular included; its matvec is B5's dipole mode.
- Solvers: Jacobi-preconditioned CG on (diag(1/alpha) - T) mu = E0 (the
  default), relaxed Jacobi, or a dense direct solve for small systems.

Units: charges e, positions A, alpha A^3; fields carry no Coulomb
prefactor, dipoles are in e*A, and ke enters once in the energy.

The CG loop is the reference's ``while_loop`` with its semantics exactly:
the gate (``rs`` in residual mode, the last update ``ds`` in dipole mode,
a do-while with ds0 = inf) is read on the host once per iteration, so a
solve of n iterations makes n host syncs (n + 1 in residual mode).  The
tile-culled CG (``cull_supported``) runs wherever the configuration asks
for it: on the card through the kernel with a visit table, on the CPU
through its plain version.

Under ``cfg.spatial_axis`` (a rank d of D holding the replicated state,
parallel/spatial.py) the direct static field, the matvec and the SCF's
matvecs run B5 with a visit table of the rank's row tiles only (I mod D
== d, ``strip_visit``; with the culled CG, times the cull table): the
kernel writes exact zeros for the other row tiles, and the ranks' [N, 3]
outputs meet in one all-reduce (multihost.sum_disjoint) per field or CG
iteration.  The CG recurrence stays replicated (the reference's
solve_scf_sharded, mpmc_tpu/parallel/spatial.py:240).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mpmc_tpu_torch.constants import DEBYE_PER_EA, KE
from mpmc_tpu_torch.ops import ewald
from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
from mpmc_tpu_torch.ops.pairs import derived_alpha, derived_cutoff
from mpmc_tpu_torch.state import (chain_rows, chain_rows_update, mol_rows,
                                  mol_rows_update, row_valid)

_damping = tk.damping
_SQRT_PI = math.sqrt(math.pi)


def _zero(x):
    return torch.zeros_like(x)


def _inverse(box):
    """box^-1 without the host sync of torch.linalg.inv's error check (a
    cell is never singular)."""
    return torch.linalg.inv_ex(box)[0]


def static_field(pos, box, atom_alive, params, cfg):
    """Static field dispatcher: full Ewald (polar_ewald), Wolf-damped
    (polar_wolf), or the damped direct-cutoff field (B5)."""
    if cfg.polar_ewald:
        return static_field_ewald(pos, box, atom_alive, params, cfg)
    if cfg.polar_wolf:
        return static_field_wolf(pos, box, atom_alive, params, cfg)
    return static_field_direct(pos, box, atom_alive, params, cfg)


def _field_variant_consts(box, cfg, dtype):
    """(alpha, k_rc) of the screened field kernel of the wolf / ewald
    variants, (None, None) for direct: wolf's alpha (polar_wolf_alpha or
    the derived ES alpha) with the kernel's value at rc as its shift;
    ewald's splitting alpha with no shift."""
    if not (cfg.polar_wolf or cfg.polar_ewald):
        return None, None
    rc = derived_cutoff(box, cfg)
    if cfg.polar_ewald:
        return derived_alpha(rc, cfg), torch.zeros((), dtype=dtype,
                                                    device=box.device)
    if cfg.polar_wolf_alpha is not None:
        alpha = torch.as_tensor(cfg.polar_wolf_alpha, dtype=dtype,
                                device=box.device)
    else:
        alpha = derived_alpha(rc, cfg)
    two_a_pi = 2.0 * alpha / _SQRT_PI
    k_rc = (torch.special.erfc(alpha * rc) / rc + two_a_pi
            * torch.exp(-alpha * alpha * rc * rc)) / rc
    return alpha, k_rc


def _field_coef(r, r2s, d1, alpha=None, k_rc=None):
    """Pairwise field coefficient c(r) (field of a unit charge = c(r) dr):
    direct d1/r^3; with ``alpha`` the erfc-screened kernel shifted by
    ``k_rc`` plus the Thole near-field correction (wolf, ewald real)."""
    if alpha is None:
        return d1 / (r2s * r)
    two_a_pi = 2.0 * alpha / _SQRT_PI
    k_r = (torch.special.erfc(alpha * r) / r
           + two_a_pi * torch.exp(-alpha * alpha * r2s)) / r
    return (k_r - k_rc) / r + (d1 - 1.0) / (r2s * r)


def _intra_coef(r, r2s, alpha):
    """erf-complement kernel of the Ewald field's same-molecule
    correction: (erf(a r)/r - 2a/sqrt(pi) e^{-a^2 r^2}) / r^2."""
    two_a_pi = 2.0 * alpha / _SQRT_PI
    return (torch.special.erf(alpha * r) / r
            - two_a_pi * torch.exp(-alpha * alpha * r2s)) / r2s


def _per_chain(box):
    """x -> x shaped to broadcast over a chain's [C, rows, cols] tiles:
    a [C] tensor of per-chain cells (``box`` [C, 3, 3]) becomes [C, 1,
    1]; anything else (a shared cell's 0-d constants, None) passes."""
    def lead(x):
        if box.ndim == 3 and torch.is_tensor(x) and x.ndim == 1:
            return x[:, None, None]
        return x
    return lead


def _recip_field_w(box, alpha, kvecs, pair_w=2.0):
    """Per-k weight of the reciprocal-space field sum:
    (4 pi / V) pair_w exp(-k^2/4a^2) / k^2 (half-space table: pair_w 2);
    [C, Nk] for per-chain cells ``box`` [C, 3, 3] and ``kvecs``."""
    k2 = torch.sum(kvecs * kvecs, dim=-1)
    k2s = torch.where(k2 > 1e-12, k2, torch.ones_like(k2))
    volume = torch.abs(torch.linalg.det(box))
    if box.ndim == 3:
        volume = volume[:, None]
        alpha = alpha[:, None] if torch.as_tensor(alpha).ndim else alpha
    return ((4.0 * math.pi / volume) * pair_w
            * torch.exp(-k2 / (4.0 * alpha * alpha)) / k2s)


def _recip_field(pos, kv, w, sk_re, sk_im):
    """k-space field at ``pos`` [R,3] of a structure factor with weights
    ``w``: sum_k w_k [sin(k.r) S_re - cos(k.r) S_im] k."""
    phase = ewald._phase(pos, kv)                         # [..., R, K]
    return ((torch.sin(phase) * (w * sk_re)[..., None, :]) @ kv
            - (torch.cos(phase) * (w * sk_im)[..., None, :]) @ kv)


def _row_blocks(n, cfg):
    b = max(min(cfg.pair_chunk, n), 1)
    return [(i0, min(i0 + b, n)) for i0 in range(0, n, b)]


def static_field_wolf(pos, box, atom_alive, params, cfg):
    """Wolf-damped static field: the erfc-screened field kernel shifted to
    vanish at rc plus the Thole near-field correction, over intermolecular
    pairs within rc."""
    n = pos.shape[0]
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    alpha, k_rc = _field_variant_consts(box, cfg, pos.dtype)
    out = []
    for i0, i1 in _row_blocks(n, cfg):
        dr = pbc_ops.min_image(pos[i0:i1, None, :] - pos[None, :, :], box,
                               box_inv)
        r2 = torch.sum(dr * dr, -1)
        ok = (atom_alive[i0:i1, None] & atom_alive[None, :]
              & (params.mol_id[i0:i1, None] != params.mol_id[None, :])
              & (r2 < rc * rc))
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        d1, _ = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
        coef = torch.where(ok, params.charge[None, :]
                           * _field_coef(r, r2s, d1, alpha, k_rc), _zero(r))
        out.append(torch.einsum("bn,bnk->bk", coef, dr))
    return torch.cat(out)


def strip_visit(n, device, cfg):
    """[NI, NJ] int32 B5 visit table of this rank's row tiles (I mod D ==
    d) under ``cfg.spatial_axis``, else None."""
    from mpmc_tpu_torch.ops.pairs import spatial_strip
    strip = spatial_strip(cfg)
    if strip is None:
        return None
    d, D = strip
    _, ni, nj = tk.grid_shape(n)
    rows = (torch.arange(ni, device=device) % D) == d
    return rows[:, None].expand(ni, nj).to(torch.int32).contiguous()


def _met(field, visit):
    """A strip's field met with the other ranks' (one all-reduce), or the
    field as it is without a strip."""
    if visit is None:
        return field
    from mpmc_tpu_torch.parallel import multihost
    return multihost.sum_disjoint(field)


def static_field_direct(pos, box, atom_alive, params, cfg):
    """Damped intermolecular field E0 [N,3] of the permanent charges at
    every alive site, within the pair cutoff: B5 in charge mode (under
    ``cfg.spatial_axis`` the rank's row strip, met with the others')."""
    visit = strip_visit(pos.shape[0], pos.device, cfg)
    return _met(tk.charge_field(pos, box, atom_alive, params.charge,
                                params.mol_id32, derived_cutoff(box, cfg),
                                cfg.polar_damp, cfg.polar_damp_type,
                                ortho=cfg.ortho_box, visit=visit), visit)


def _chain_box(box, c):
    """Chain ``c``'s cell of a shared [3, 3] or per-chain [C, 3, 3] box."""
    return box[c] if box.ndim == 3 else box


def static_field_chains(pos, box, atom_alive, params, cfg):
    """``static_field`` of every chain (``pos`` [C, N, 3], ``atom_alive``
    [C, N]; [C, N, 3]) in a shared ``box`` [3, 3] or each in its own
    ([C, 3, 3]: the NPT chains): the direct field in one launch of B5
    over the chains (charge_field_chains, a header per chain with a box
    per chain), the Ewald and Wolf fields chain by chain."""
    if cfg.polar_ewald or cfg.polar_wolf:
        return torch.stack([static_field(p, _chain_box(box, c), a, params,
                                         cfg)
                            for c, (p, a) in enumerate(zip(pos,
                                                           atom_alive))])
    C, n = atom_alive.shape
    return tk.charge_field_chains(
        pos.contiguous(), box, atom_alive,
        params.charge.expand(C, n).contiguous(),
        params.mol_id32.expand(C, n).contiguous(), derived_cutoff(box, cfg),
        cfg.polar_damp, cfg.polar_damp_type, ortho=cfg.ortho_box)


def static_field_ewald(pos, box, atom_alive, params, cfg):
    """Full-Ewald periodic static field (tinfoil boundary): the k-space
    field of all charges + the erfc-screened real-space field (inter, in
    rc) - the erf-complement same-molecule field (all separations) + the
    Thole near-field correction (inter, in rc)."""
    n = pos.shape[0]
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    alpha = derived_alpha(rc, cfg)
    k_rc = torch.zeros((), dtype=pos.dtype, device=pos.device)
    q = torch.where(atom_alive, params.charge, _zero(params.charge))
    kv = ewald.kvectors(box, cfg.ewald_kmax)
    sk_re, sk_im = ewald.structure_factor(pos, params.charge, atom_alive, kv)
    w = _recip_field_w(box, alpha, kv)
    e_recip = _recip_field(pos, kv, w, sk_re, sk_im)
    cols = torch.arange(n, device=pos.device)
    out = []
    for i0, i1 in _row_blocks(n, cfg):
        rows = cols[i0:i1]
        dr = pbc_ops.min_image(pos[i0:i1, None, :] - pos[None, :, :], box,
                               box_inv)
        r2 = torch.sum(dr * dr, -1)
        same = params.mol_id[i0:i1, None] == params.mol_id[None, :]
        diag = rows[:, None] == cols[None, :]
        base_ok = atom_alive[i0:i1, None] & atom_alive[None, :] & ~diag
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        d1, _ = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
        m_real = base_ok & ~same & (r2 < rc * rc)
        m_intra = base_ok & same
        coef = (torch.where(m_real, _field_coef(r, r2s, d1, alpha, k_rc),
                            _zero(r))
                - torch.where(m_intra, _intra_coef(r, r2s, alpha), _zero(r))
                ) * q[None, :]
        out.append(torch.einsum("bn,bnk->bk", coef, dr))
    e = e_recip + torch.cat(out)
    return torch.where(atom_alive[:, None], e, _zero(e))


def field_delta_supported(cfg) -> bool:
    """Gate of the per-move delta field: direct and wolf are pairwise in
    the source charges; polar_ewald deltas when the energy path keeps
    S(k) (coulomb ewald)."""
    if not cfg.polarization:
        return False
    if cfg.polar_ewald:
        return cfg.coulomb == "ewald"
    return True


def residual_supported(cfg) -> bool:
    """Gate of the O(A N) initial CG residual: a delta-able field and the
    CG solver."""
    return field_delta_supported(cfg) and cfg.polar_solver == "cg"


def field_delta(pos, box, atom_alive, params, cfg, mol, e0, new_rows=None,
                insert=False, delete=False, sk=None):
    """O(A N) update of the cached static field when molecule ``mol``
    moves, appears or disappears: ``move_deltas`` without the residual."""
    return move_deltas(pos, box, atom_alive, params, cfg, mol, e0, None,
                       None, new_rows=new_rows, insert=insert, delete=delete,
                       with_residual=False, sk=sk)[0]


def _row_ops(params, mol, batched):
    """(rows, update, not_mol) for molecule ``mol`` — one chain (``mol``
    an int or 0-d tensor) or a leading chain axis (``mol`` [C]):
    ``rows(x)`` the molecule's [..., A, ...] rows of a per-site tensor
    (per chain when batched), ``update(x, r)`` writes them IN PLACE, and
    ``not_mol`` the [..., N] mask of the sites of other molecules."""
    if batched:
        return (lambda x: chain_rows(x, params, mol),
                lambda x, r: chain_rows_update(x, params, mol, r),
                params.mol_id[None, :] != mol[:, None])
    return (lambda x: mol_rows(x, params, mol),
            lambda x, r: mol_rows_update(x, params, mol, r),
            params.mol_id != mol)


def move_deltas(pos, box, atom_alive, params, cfg, mol, e0, mu, r_old,
                new_rows=None, insert=False, delete=False,
                with_residual=True, sk=None):
    """(e0_new, r0_new): the static field and the initial CG residual of
    the candidate after molecule ``mol`` (int or 0-d tensor) moves to
    ``new_rows``, is inserted there, or is deleted — O(A N), one shared
    displacement pass per tile, as the reference's ``move_deltas``:

    - tile (a): the moved rows (+ at the trial rows, - at the current
      ones) as charge and dipole sources at every other site;
    - tile (b): every other site as a source at the trial rows (charge
      field; dipole field with the [A,A] self-block), recomputed in full.

    polar_ewald adds the k-space field, linear in S(k): its delta at the
    unmoved sites and the post-move S(k)'s field at the trial rows (``sk``:
    the pre-move (sk_re, sk_im), recomputed when None).  ``atom_alive`` is
    the pre-move mask.  r0_new is None without ``with_residual``.

    Over chains (the reference vmaps this function): ``pos``, ``e0``,
    ``mu``, ``r_old`` [C, N, 3], ``atom_alive`` [C, N], ``mol`` [C],
    ``new_rows`` [C, A, 3] and ``sk`` [C, Nk] — one molecule per chain,
    every chain's deltas in the same few hundred launches.  ``box`` is
    the chains' shared cell, or one per chain [C, 3, 3] (the NPT chains:
    each chain's cutoff, field constants and k-vectors its own)."""
    dtype = pos.dtype
    batched = pos.ndim == 3
    rows_of, update, not_mol = _row_ops(params, mol, batched)
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    lead = _per_chain(box)
    rc2 = lead(rc * rc)
    A = params.max_atoms_per_mol
    valid = row_valid(params, mol)                        # [..., A]
    q_rows = torch.where(valid, mol_rows(params.charge, params, mol), 0.0)
    old_rows = rows_of(pos)
    mu_rows = (torch.where(valid[..., None], rows_of(mu), 0.0)
               if with_residual else None)
    pol_site = params.polar > 0
    pol_rows = valid & (mol_rows(params.polar, params, mol) > 0)
    other = atom_alive & not_mol
    other_pol = other & pol_site
    ew_f = cfg.polar_ewald
    alpha_f, k_rc = _field_variant_consts(box, cfg, dtype)
    alpha_b, k_rc_b = lead(alpha_f), lead(k_rc)

    if delete:
        src_pos, src_q, src_ok = old_rows, -q_rows, valid
        src_mu = -mu_rows if with_residual else None
    elif insert:
        src_pos, src_q, src_ok = new_rows, q_rows, valid
        src_mu = None               # inserted molecules carry mu = 0
    else:
        src_pos = torch.cat([new_rows, old_rows], -2)
        src_q = torch.cat([q_rows, -q_rows], -1)
        src_ok = torch.cat([valid, valid], -1)
        src_mu = (torch.cat([mu_rows, -mu_rows], -2) if with_residual
                  else None)

    # ---- tile (a): moved rows as sources vs every site --------------
    dr = pbc_ops.min_image(pos[..., None, :, :] - src_pos[..., :, None, :],
                           box, box_inv)                  # [..., S, N, 3]
    r2 = torch.sum(dr * dr, -1)
    in_rc = r2 < rc2
    r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    d1, d2 = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
    ok_f = src_ok[..., :, None] & other[..., None, :] & in_rc
    coef = torch.where(ok_f, src_q[..., :, None]
                       * _field_coef(r, r2s, d1, alpha_b, k_rc_b), _zero(r))
    e0_new = e0 + torch.einsum("...sn,...snk->...nk", coef, dr)

    if ew_f:
        kv = ewald.kvectors(box, cfg.ewald_kmax)
        if sk is None:
            sk = _structure_factor(pos, params, atom_alive, kv)
        sk_re_o, sk_im_o = sk
        d_re, d_im = ewald.mol_structure_factor(src_pos, src_q, src_ok, kv)
        w_k = _recip_field_w(box, alpha_f, kv)
        d_rec = _recip_field(pos, kv, w_k, d_re, d_im)
        e0_new = e0_new + torch.where(other[..., None], d_rec, _zero(d_rec))

    # ---- tile (b): the field / dipole field at the trial rows -------
    if delete:
        rows_field = torch.zeros(valid.shape + (3,), dtype=dtype,
                                 device=pos.device)
    else:
        drr = pbc_ops.min_image(new_rows[..., :, None, :]
                                - pos[..., None, :, :], box,
                                box_inv)                  # [..., A, N, 3]
        r2b = torch.sum(drr * drr, -1)
        in_rcb = r2b < rc2
        r2bs = torch.where(r2b > 1e-12, r2b, torch.ones_like(r2b))
        rb = torch.sqrt(r2bs)
        d1b, d2b = _damping(rb, cfg.polar_damp, cfg.polar_damp_type)
        okb = valid[..., :, None] & other[..., None, :] & in_rcb
        cb = torch.where(okb, params.charge
                         * _field_coef(rb, r2bs, d1b, alpha_b, k_rc_b),
                         _zero(rb))
        rows_field = torch.einsum("...an,...ank->...ak", cb, drr)
        if ew_f:
            # same-molecule erf-complement block at the new geometry
            dra_f = pbc_ops.min_image(
                new_rows[..., None, :, :] - new_rows[..., :, None, :], box,
                box_inv)
            r2i = torch.sum(dra_f * dra_f, -1)
            diag_a = torch.eye(A, dtype=torch.bool, device=pos.device)
            oki = valid[..., :, None] & valid[..., None, :] & ~diag_a
            r2is = torch.where(r2i > 1e-12, r2i, torch.ones_like(r2i))
            ri = torch.sqrt(r2is)
            ci = torch.where(oki, -q_rows[..., :, None]
                             * _intra_coef(ri, r2is, alpha_b), _zero(ri))
            rows_field = rows_field + torch.einsum("...st,...stk->...tk",
                                                   ci, dra_f)
            # k-space field at the trial rows with the post-move S(k)
            rows_field = rows_field + _recip_field(
                new_rows, kv, w_k, sk_re_o + d_re, sk_im_o + d_im)
    cur = rows_of(e0_new)
    rows_field = torch.where(valid[..., None], rows_field.to(dtype), cur)
    e0_out = update(e0_new, rows_field)
    if not with_residual:
        return e0_out, None

    # ---- residual: r0' = r_old + (b' - b) + (T' - T) mu -------------
    rr = r_old + torch.where(other_pol[..., None], e0_out - e0, _zero(e0))
    if src_mu is not None:
        okm = (src_ok[..., :, None] & other_pol[..., None, :] & in_rc
               & (r2 > 1e-12))
        inv_r3 = 1.0 / (r2s * r)
        mdotr = torch.einsum("...sk,...snk->...sn", src_mu, dr)
        c1 = torch.where(okm, 3.0 * d2 * mdotr * inv_r3 / r2s, _zero(r))
        c2 = torch.where(okm, d1 * inv_r3, _zero(r))
        rr = rr + (torch.einsum("...sn,...snk->...nk", c1, dr)
                   - torch.einsum("...sn,...sk->...nk", c2, src_mu))

    if delete:
        rows_r = torch.zeros(valid.shape + (3,), dtype=dtype,
                             device=pos.device)
    else:
        # dipole field at the trial rows from every other site
        okbp = (valid[..., :, None] & other_pol[..., None, :] & in_rcb
                & (r2b > 1e-12))
        inv_r3b = 1.0 / (r2bs * rb)
        mu_oth = torch.where(other_pol[..., None], mu, _zero(mu))
        mdotr_b = torch.einsum("...nk,...ank->...an", mu_oth, drr)
        c1b = torch.where(okbp, 3.0 * d2b * mdotr_b * inv_r3b / r2bs,
                          _zero(rb))
        c2b = torch.where(okbp, d1b * inv_r3b, _zero(rb))
        e_rows = (torch.einsum("...an,...ank->...ak", c1b, drr)
                  - torch.einsum("...an,...nk->...ak", c2b, mu_oth))
        # the [A,A] self-block: the molecule's own trial rows as sources
        dra = pbc_ops.min_image(
            new_rows[..., None, :, :] - new_rows[..., :, None, :], box,
            box_inv)
        r2a = torch.sum(dra * dra, -1)
        diag = torch.eye(A, dtype=torch.bool, device=pos.device)
        oka = (pol_rows[..., :, None] & valid[..., None, :] & ~diag
               & (r2a < rc2) & (r2a > 1e-12))
        r2as = torch.where(r2a > 1e-12, r2a, torch.ones_like(r2a))
        ra = torch.sqrt(r2as)
        d1a, d2a = _damping(ra, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3a = 1.0 / (r2as * ra)
        mdotr_a = torch.einsum("...sk,...sak->...sa", mu_rows, dra)
        c1a = torch.where(oka, 3.0 * d2a * mdotr_a * inv_r3a / r2as,
                          _zero(ra))
        c2a = torch.where(oka, d1a * inv_r3a, _zero(ra))
        e_rows = e_rows + (torch.einsum("...sa,...sak->...ak", c1a, dra)
                           - torch.einsum("...sa,...sk->...ak", c2a,
                                          mu_rows))
        p_rows = mol_rows(params.polar, params, mol)
        inv_a = torch.where(pol_rows, 1.0 / torch.clamp(p_rows, min=1e-30),
                            _zero(p_rows))
        rows_r = (torch.where(valid[..., None], rows_of(e0_out), 0.0)
                  - inv_a[..., None] * mu_rows + e_rows)
        rows_r = torch.where(pol_rows[..., None], rows_r, _zero(rows_r))
    cur_r = rows_of(rr)
    rows_r = torch.where(valid[..., None], rows_r.to(dtype), cur_r)
    return e0_out, update(rr, rows_r)


def _structure_factor(pos, params, atom_alive, kv):
    """S(k) of one chain, or of each chain of a stacked [C, N, 3] (``kv``
    shared or per chain)."""
    if pos.ndim == 2:
        return ewald.structure_factor(pos, params.charge, atom_alive, kv)
    parts = [ewald.structure_factor(p, params.charge, a,
                                    kv[c] if kv.ndim == 3 else kv)
             for c, (p, a) in enumerate(zip(pos, atom_alive))]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def residual_delta(pos, box, atom_alive, params, cfg, mol, mu, r_old,
                   e0_old, e0_new, new_rows=None, insert=False,
                   delete=False):
    """O(A N) initial CG residual r0' = b' - A' mu of the candidate from
    the previous solve's r_old = b - A mu: r0' = r_old + (b' - b) +
    (T' - T) mu, with (a) the moved dipoles as sources at every other
    polarizable site and (b) the moved rows' own entries recomputed.
    The sequential form of ``move_deltas``' residual (the tests hold the
    fused form against it); ``atom_alive`` is the pre-move mask.  Over
    chains as ``move_deltas`` with a shared box."""
    dtype = pos.dtype
    batched = pos.ndim == 3
    rows_of, update, not_mol = _row_ops(params, mol, batched)
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    A = params.max_atoms_per_mol
    valid = row_valid(params, mol)
    pol_rows = valid & (mol_rows(params.polar, params, mol) > 0)
    old_rows = rows_of(pos)
    mu_rows = torch.where(valid[..., None], rows_of(mu), 0.0)
    other_pol = (atom_alive & not_mol & (params.polar > 0))[..., None]
    r = r_old + torch.where(other_pol, e0_new - e0_old, _zero(e0_old))

    def dip_field(tgt_pos, src_pos, src_mu, ok):
        dr = pbc_ops.min_image(tgt_pos[..., None, :, :]
                               - src_pos[..., :, None, :],
                               box, box_inv)              # [..., S, T, 3]
        r2 = torch.sum(dr * dr, -1)
        okm = ok & (r2 < rc * rc) & (r2 > 1e-12)
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        rr = torch.sqrt(r2s)
        d1, d2 = _damping(rr, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3 = 1.0 / (r2s * rr)
        mdotr = torch.einsum("...sk,...stk->...st", src_mu, dr)
        c1 = torch.where(okm, 3.0 * d2 * mdotr * inv_r3 / r2s, _zero(rr))
        c2 = torch.where(okm, d1 * inv_r3, _zero(rr))
        return (torch.einsum("...st,...stk->...tk", c1, dr)
                - torch.einsum("...st,...sk->...tk", c2, src_mu))

    if delete:
        src_pos, src_mu, src_ok = old_rows, -mu_rows, valid
    elif insert:
        src_pos = None
    else:
        src_pos = torch.cat([new_rows, old_rows], -2)
        src_mu = torch.cat([mu_rows, -mu_rows], -2)
        src_ok = torch.cat([valid, valid], -1)
    if src_pos is not None:
        r = r + dip_field(pos, src_pos, src_mu,
                          src_ok[..., :, None] & other_pol[..., None, :, 0])

    if delete:
        rows_r = torch.zeros(valid.shape + (3,), dtype=dtype,
                             device=pos.device)
    else:
        src2_pos = torch.cat([pos, new_rows], -2)
        src2_mu = torch.cat([torch.where(other_pol, mu, _zero(mu)), mu_rows],
                            -2)
        src2_ok = torch.cat([other_pol[..., 0], pol_rows], -1)
        self_m = torch.cat([
            torch.zeros((pos.shape[-2], A), dtype=torch.bool,
                        device=pos.device),
            torch.eye(A, dtype=torch.bool, device=pos.device)])
        ok_b = src2_ok[..., :, None] & valid[..., None, :] & ~self_m
        e_rows = dip_field(new_rows, src2_pos, src2_mu, ok_b)
        p_rows = mol_rows(params.polar, params, mol)
        inv_a = torch.where(pol_rows, 1.0 / torch.clamp(p_rows, min=1e-30),
                            _zero(p_rows))
        rows_r = (torch.where(valid[..., None], rows_of(e0_new), 0.0)
                  - inv_a[..., None] * mu_rows + e_rows)
        rows_r = torch.where(pol_rows[..., None], rows_r, _zero(rows_r))
    cur = rows_of(r)
    rows_r = torch.where(valid[..., None], rows_r.to(dtype), cur)
    return update(r, rows_r)


def dipole_matvec(pos, box, atom_alive, params, cfg, mu):
    """(T mu)_i: the damped dipole field of every other polarizable site's
    dipole at site i, intramolecular pairs included, within the cutoff —
    B5 in dipole mode."""
    pol_ok = atom_alive & (params.polar > 0)
    visit = strip_visit(pos.shape[0], pos.device, cfg)
    return _met(tk.dipole_field(pos, box, pol_ok,
                                torch.where(pol_ok[:, None], mu, _zero(mu)),
                                params.mol_id32, derived_cutoff(box, cfg),
                                cfg.polar_damp, cfg.polar_damp_type,
                                ortho=cfg.ortho_box, visit=visit), visit)


# ---------------------------------------------------------------------------
# tile-culled CG
# ---------------------------------------------------------------------------

def cull_supported(cfg) -> bool:
    """Gate of the cell-sorted tile-culled SCF matvec: an orthorhombic
    box and the CG solver; ``polar_cull auto`` (the default) also needs
    an explicit cutoff, ``on`` forces it for the derived rc = L/2."""
    if cfg.polar_cull == "off":
        return False
    if not (cfg.polarization and cfg.ortho_box
            and cfg.polar_solver == "cg"):
        return False
    return cfg.polar_cull == "on" or cfg.cutoff is not None


def cull_perm(pos, box, pol_ok, rc):
    """(perm, inv): x-major lexicographic order of the sites on rc/2
    cells, dead and non-polarizable sites last (a stable sort, so ties
    keep the site order).  Recomputed per solve.  Over chains (``pos``
    [C, N, 3], ``pol_ok`` [C, N]): each chain's own order, [C, N], in the
    shared box or each in its own (``box`` [C, 3, 3], ``rc`` [C])."""
    n = pos.shape[-2]
    L = torch.diagonal(box, dim1=-2, dim2=-1)
    cell = torch.as_tensor(rc) / 2.0
    if box.ndim == 3:
        L, cell = L[:, None, :], cell.reshape(-1, 1, 1)
    frac = pos - L * torch.floor(pos / L)
    c = torch.floor(frac / cell)
    nc = torch.ceil(L / cell)
    key = (c[..., 0] * nc[..., 1] + c[..., 1]) * nc[..., 2] + c[..., 2]
    key = torch.where(pol_ok, key, torch.full_like(key, math.inf))
    perm = torch.argsort(key, dim=-1, stable=True)
    inv = torch.empty_like(perm)
    inv.scatter_(-1, perm, torch.arange(n, device=pos.device).expand_as(
        perm))
    return perm, inv


def cull_visit(pos_s, ok_s, box, rc, ti=tk.TI, tj=tk.TJ, n_pad=None):
    """Conservative [NI, NJ] int32 tile-visit table over cell-sorted sites
    for tiles of ``ti`` rows x ``tj`` columns: tile (I, J) is visited
    unless the smallest minimum-image distance between the two blocks'
    axis-aligned bounding boxes is >= rc (or either block holds no ok
    site).  Computed in float64 against rc inflated by 64 units in the
    last place of the box length in the sites' precision: the kernel's
    rounded r^2 of a pair just outside rc may fall inside it, and such a
    pair's tile must stay visited.  Over chains (``pos_s`` [C, N, 3],
    ``ok_s`` [C, N]): each chain's table, [C, NI, NJ], in the shared box
    or each in its own (``box`` [C, 3, 3], ``rc`` [C])."""
    n = pos_s.shape[-2]
    lead = pos_s.shape[:-2]
    if n_pad is None:
        n_pad = tk.grid_shape(n, ti, tj)[0]
    L = torch.diagonal(box, dim1=-2, dim2=-1).double()     # [3] or [C, 3]
    Lp = L[..., None, :]
    p = pos_s.double()
    p = p - Lp * torch.floor(p / Lp)                       # wrap to [0, L)
    pad = n_pad - n
    p = torch.cat([p, torch.zeros(lead + (pad, 3), dtype=p.dtype,
                                  device=p.device)], -2)
    ok = torch.cat([ok_s, torch.zeros(lead + (pad,), dtype=torch.bool,
                                      device=ok_s.device)], -1)
    lo = torch.where(ok[..., None], p, torch.full_like(p, 1e30))
    hi = torch.where(ok[..., None], p, torch.full_like(p, -1e30))

    def blocks(t):
        nb = n_pad // t
        mn = lo.reshape(lead + (nb, t, 3)).amin(-2)
        mx = hi.reshape(lead + (nb, t, 3)).amax(-2)
        nonempty = ok.reshape(lead + (nb, t)).any(-1)
        ctr = torch.where(nonempty[..., None], 0.5 * (mn + mx), _zero(mn))
        hw = torch.where(nonempty[..., None], 0.5 * (mx - mn), _zero(mn))
        return ctr, hw, nonempty

    ci, hwi, oki = blocks(ti)
    cj, hwj, okj = blocks(tj)
    dc = ci[..., :, None, :] - cj[..., None, :, :]
    Ld = L[..., None, None, :]
    dc = dc - Ld * torch.round(dc / Ld)
    gap = torch.clamp(torch.abs(dc) - hwi[..., :, None, :]
                      - hwj[..., None, :, :], min=0.0)
    mind2 = torch.sum(gap * gap, -1)
    rc_v = (torch.as_tensor(rc, dtype=torch.float64, device=p.device)
            + 64.0 * torch.finfo(pos_s.dtype).eps * L.amax(-1))
    if rc_v.ndim:
        rc_v = rc_v[:, None, None]
    visit = oki[..., :, None] & okj[..., None, :] & (mind2 < rc_v * rc_v)
    return visit.to(torch.int32)


# ---------------------------------------------------------------------------
# SCF solve
# ---------------------------------------------------------------------------

def solve_scf(pos, box, atom_alive, params, cfg, e0, mu0=None, r0=None):
    """Solve (diag(1/alpha) - T) mu = E0 by Jacobi-preconditioned CG (or
    relaxed Jacobi, or a direct solve).  Returns (mu [N,3], iterations (a
    host int), r [N,3] — CG's final recurrence residual — or None).
    Dead and non-polarizable sites are pinned to zero.  Stops when
    ||r||_rms <= polar_precision (residual mode) or the rms dipole change
    of the last iteration <= polar_precision Debye (dipole mode, at least
    one iteration), or after polar_max_iter iterations.  ``r0``: the
    initial residual b - A mu0 (move_deltas), which saves the warm
    start's matvec.  One chain of ``solve_scf_chains``."""
    lift = (lambda t: None if t is None else t[None])
    mu, iters, r = solve_scf_chains(pos[None], box, atom_alive[None], params,
                                    cfg, e0[None], lift(mu0), lift(r0))
    return mu[0], int(iters[0]), None if r is None else r[0]


def _on(x, device):
    """A host array on ``device`` without a host sync (a pinned,
    non-blocking copy on the card)."""
    t = torch.as_tensor(np.asarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _gather_sites(x, perm):
    """x[c, perm[c]] for every chain (x [C, N] or [C, N, 3])."""
    if x.ndim == 3:
        return torch.gather(x, 1, perm[..., None].expand(-1, -1, 3))
    return torch.gather(x, 1, perm)


def solve_scf_chains(pos, box, atom_alive, params, cfg, e0, mu0=None,
                     r0=None, active=None):
    """``solve_scf`` over a leading chain axis (``pos``, ``e0``, ``mu0``,
    ``r0`` [C, N, 3], ``atom_alive`` [C, N]) with the semantics of the
    reference's vmapped solve: each chain stops at its own gate, a closed
    chain's carry stays frozen, and its iteration count is its own.
    Returns (mu [C, N, 3], iterations (host int64 [C]), r [C, N, 3] or
    None).

    ``active`` (a sorted host sequence of chain indices, default all):
    the chains to solve; the others return their masked mu0 (zeros
    without one) and r0 with 0 iterations.  The active chains run their
    CG rounds together: one B5 launch over the chains still open
    (dipole_field_chains, the closed ones cost nothing) and one host read
    of the [C] gate vector per round.  The culled CG sorts each chain
    apart (its own cull_perm and visit table).  Jacobi runs
    polar_max_iter rounds over the active chains; ``direct`` solves each
    active chain in turn.  ``box``: the chains' shared cell [3, 3], or a
    cell per chain [C, 3, 3] (the NPT chains: each chain's rc, header
    row, cell order and visit table its own)."""
    C, n = pos.shape[:2]
    dev, dtype = pos.device, pos.dtype
    if active is None:
        act = tuple(range(C))
        act_d = torch.ones(C, dtype=torch.bool, device=dev)
    else:
        act = tuple(int(k) for k in active)
        m = np.zeros(C, bool)
        m[list(act)] = True
        act_d = _on(m, dev)
    pol_ok = atom_alive & (params.polar > 0)
    rc_c = derived_cutoff(box, cfg)
    polar_vec = params.polar.expand(C, n)
    mol_s, visit = params.mol_id32.expand(C, n).contiguous(), None
    cull = cull_supported(cfg)
    if cull:
        # each chain's CG recurrence in its own cell-sorted space with its
        # own tile-visit table; the culled matvec equals the dense one,
        # only the CG's reductions reassociate
        perm, invp = cull_perm(pos, box, pol_ok, rc_c)
        pos = _gather_sites(pos, perm)
        pol_ok = _gather_sites(pol_ok, perm)
        polar_vec = params.polar[perm]
        mol_s = params.mol_id32[perm]
        e0 = _gather_sites(e0, perm)
        mu0 = _gather_sites(mu0, perm) if mu0 is not None else None
        r0 = _gather_sites(r0, perm) if r0 is not None else None
        visit = cull_visit(pos, pol_ok, box, rc_c)
    strip = strip_visit(n, dev, cfg) if C == 1 else None
    if strip is not None:
        # this rank's row tiles of every matvec (in the culled sort's site
        # order when culled); the CG recurrence stays replicated
        visit = strip[None] if visit is None else visit * strip[None]
    pos = pos.contiguous()
    mask = pol_ok[..., None]
    inv_a = torch.where(pol_ok, 1.0 / torch.clamp(polar_vec, min=1e-30),
                        _zero(polar_vec))[..., None]
    b = torch.where(mask, e0, _zero(e0))
    nsites = torch.clamp(torch.sum(pol_ok, dim=-1), min=1).to(dtype)
    tol2 = (cfg.polar_precision ** 2) * nsites * 3
    x = torch.where(mask, mu0, 0.0) if mu0 is not None else _zero(e0)
    iters = np.zeros(C, np.int64)
    if cfg.polar_solver == "direct":
        mu = x.clone()
        for k in act:
            mu[k] = _solve_direct(pos[k], _chain_box(box, k), params, cfg,
                                  b[k], pol_ok[k])
        return mu, iters, None
    # B5's scalar header and work lists, once for every matvec of the solve
    fplan = tk.plan_chains(box, rc_c, cfg.polar_damp, n, C, visit)
    sub = {}

    def tmul(v, open_h, open_d):
        """(T v) of the open chains ``open_h`` (zeros for the others;
        ``open_d`` their mask on the device) through the solve's plan:
        one launch over the open chains."""
        if open_h not in sub:
            # the open chains' indices, built on the device (no sync);
            # every chain's list is the plan's own
            chains = (None if len(open_h) == C else torch.nonzero_static(
                open_d, size=len(open_h)).reshape(-1).to(torch.int32))
            sub[open_h] = tk.subplan(fplan, open_h, chains)
        return _met(tk.dipole_field_chains(
            pos, box, pol_ok, v, mol_s, rc_c, cfg.polar_damp,
            cfg.polar_damp_type, ortho=cfg.ortho_box, visit=visit,
            plan=sub[open_h], active=open_h), strip)

    def amul(v, open_h, open_d):
        v = torch.where(mask, v, _zero(v))
        return torch.where(mask, inv_a * v - tmul(v, open_h, open_d),
                           _zero(v))

    if cfg.polar_solver == "jacobi":
        # mu <- (1-g) mu + g alpha (E0 + T mu): the reference's plain
        # iteration with relaxation polar_gamma
        g = cfg.polar_gamma
        alpha_site = torch.where(mask, params.polar[:, None], 0.0)
        mu = x
        if act:
            for _ in range(cfg.polar_max_iter):
                t = tmul(torch.where(mask, mu, _zero(mu)), act, act_d)
                mu = torch.where(act_d[:, None, None] & mask,
                                 (1 - g) * mu + g * alpha_site * (b + t), mu)
            iters[list(act)] = cfg.polar_max_iter
        return mu, iters, None

    # --- preconditioned conjugate gradient (M = diag(1/alpha)), per chain
    dip_mode = cfg.polar_precision_mode == "dipole"
    if dip_mode:
        tol2 = ((cfg.polar_precision / DEBYE_PER_EA) ** 2) * nsites * 3
    alpha_site = torch.where(mask, polar_vec[..., None], 0.0)
    if r0 is not None:
        r = torch.where(mask, r0, 0.0)
    else:
        r = b - (amul(x, act, act_d) if act else _zero(x))
    z = alpha_site * r
    p = z
    rs = torch.sum(r * r, dim=(-2, -1))
    rz = torch.sum(r * z, dim=(-2, -1))
    ds = torch.full_like(rs, math.inf) if dip_mode else rs

    def safe(v):
        return torch.where(torch.abs(v) > 1e-300, v,
                           torch.full_like(v, 1e-300))

    def keep(sel, new, old):
        """``new`` on the open chains, ``old`` on the closed ones (no
        select while every chain is open)."""
        return new if sel is None else torch.where(sel, new, old)

    # every open chain has made the same number of rounds t, so the
    # iteration cap is a host test; dipole mode is a do-while (ds0 = inf)
    t = 0
    open_h, open_d = act, act_d
    while t < cfg.polar_max_iter:
        if not (dip_mode and t == 0):
            gate = (ds if dip_mode else rs) > tol2
            open_d = gate if len(open_h) == C else open_d & gate
            # the round's host read
            open_h = tuple(np.flatnonzero(open_d.cpu().numpy()).tolist())
        if not open_h:
            break
        ap = amul(p, open_h, open_d)
        alpha = rz / safe(torch.sum(p * ap, dim=(-2, -1)))
        dx = alpha[:, None, None] * p
        r_n = r - alpha[:, None, None] * ap
        z = alpha_site * r_n
        rz_new = torch.sum(r_n * z, dim=(-2, -1))
        beta = rz_new / safe(rz)
        sel = None if len(open_h) == C else open_d
        sel3 = None if sel is None else sel[:, None, None]
        x = keep(sel3, x + dx, x)
        p = keep(sel3, z + beta[:, None, None] * p, p)
        ds = keep(sel, torch.sum(dx * dx, dim=(-2, -1)) if dip_mode else rs,
                  ds)
        rs = keep(sel, torch.sum(r_n * r_n, dim=(-2, -1)), rs)
        rz = keep(sel, rz_new, rz)
        r = keep(sel3, r_n, r)
        iters[list(open_h)] += 1
        t += 1
    x = torch.where(mask, x, _zero(x))
    r = torch.where(mask, r, _zero(r))
    if cull:
        # back to the caller's site order
        x, r = _gather_sites(x, invp), _gather_sites(r, invp)
    return x, iters, r


def dipole_tensor(pos, box, site_ok, cfg):
    """Damped dipole-dipole tensor T [N,N,3,3] over the given sites (pair
    cutoff, Thole damping; zero blocks on the diagonal and where either
    site is masked).  Over chains: ``pos`` [C, N, 3], ``site_ok`` [C, N]
    and a shared ``box`` or one per chain [C, 3, 3] give [C, N, N, 3, 3]."""
    n = pos.shape[-2]
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    if rc.ndim:
        rc = rc[:, None, None]
    dr = pbc_ops.min_image(pos[..., :, None, :] - pos[..., None, :, :], box,
                           box_inv)
    r2 = torch.sum(dr * dr, -1)
    diag = torch.eye(n, dtype=torch.bool, device=pos.device)
    ok = (site_ok[..., :, None] & site_ok[..., None, :] & ~diag
          & (r2 < rc * rc))
    r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    d1, d2 = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
    inv_r3 = 1.0 / (r2s * r)
    eye3 = torch.eye(3, dtype=pos.dtype, device=pos.device)
    t = (3.0 * d2[..., None, None] * dr[..., :, None] * dr[..., None, :]
         * (inv_r3 / r2s)[..., None, None]
         - d1[..., None, None] * inv_r3[..., None, None] * eye3)
    return torch.where(ok[..., None, None], t, _zero(t))


def _solve_direct(pos, box, params, cfg, b, pol_ok):
    """Dense exact solve, O((3N)^3): small systems."""
    n = pos.shape[0]
    eye3 = torch.eye(3, dtype=pos.dtype, device=pos.device)
    t = dipole_tensor(pos, box, pol_ok, cfg)
    inv_a = torch.where(pol_ok, 1.0 / torch.clamp(params.polar, min=1e-30),
                        torch.ones_like(params.polar))
    a_mat = (torch.kron(torch.diag(inv_a), eye3)
             - t.permute(0, 2, 1, 3).reshape(3 * n, 3 * n))
    mu = torch.linalg.solve(a_mat, b.reshape(3 * n)).reshape(n, 3)
    return torch.where(pol_ok[:, None], mu, _zero(mu))


def polar_energy(mu, e0):
    """U_pol = -(ke/2) sum mu . E0   [K] ([C] over chains)."""
    return -0.5 * KE * torch.sum(mu * e0, dim=(-2, -1))


def zodid_energy(e0, atom_alive, params):
    """Zeroth-iteration polarization energy U* = -(ke/2) sum alpha |E0|^2
    (mu = alpha E0, no dipole coupling): the delayed-acceptance
    surrogate, O(N) given the cached field ([C] over chains)."""
    pol_ok = atom_alive & (params.polar > 0)
    a = torch.where(pol_ok, params.polar, _zero(params.polar))
    return -0.5 * KE * torch.sum(a * torch.sum(e0 * e0, dim=-1), dim=-1)


def polarizability_tensor(pos, box, atom_alive, params, cfg):
    """System polarizability tensor alpha[a,b] [A^3]: the summed induced
    dipole under a unit uniform field along each axis."""
    pol_ok = atom_alive & (params.polar > 0)
    cols = []
    for b in range(3):
        e0 = torch.zeros((pos.shape[0], 3), dtype=pos.dtype,
                         device=pos.device)
        e0[:, b] = 1.0
        e0 = torch.where(pol_ok[:, None], e0, _zero(e0))
        mu, _, _ = solve_scf(pos, box, atom_alive, params, cfg, e0)
        cols.append(torch.sum(torch.where(pol_ok[:, None], mu, _zero(mu)),
                              dim=0))
    return torch.stack(cols, dim=1)
