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
"""
from __future__ import annotations

import math

import torch

from mpmc_tpu_torch.constants import DEBYE_PER_EA, KE
from mpmc_tpu_torch.ops import ewald
from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
from mpmc_tpu_torch.ops.pairs import derived_alpha, derived_cutoff
from mpmc_tpu_torch.state import mol_rows, mol_rows_update, row_valid

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


def _recip_field_w(box, alpha, kvecs, pair_w=2.0):
    """Per-k weight of the reciprocal-space field sum:
    (4 pi / V) pair_w exp(-k^2/4a^2) / k^2 (half-space table: pair_w 2)."""
    k2 = torch.sum(kvecs * kvecs, dim=-1)
    k2s = torch.where(k2 > 1e-12, k2, torch.ones_like(k2))
    volume = torch.abs(torch.linalg.det(box))
    return ((4.0 * math.pi / volume) * pair_w
            * torch.exp(-k2 / (4.0 * alpha * alpha)) / k2s)


def _recip_field(pos, kv, w, sk_re, sk_im):
    """k-space field at ``pos`` [R,3] of a structure factor with weights
    ``w``: sum_k w_k [sin(k.r) S_re - cos(k.r) S_im] k."""
    phase = ewald._phase(pos, kv)                         # [R,K]
    return ((torch.sin(phase) * (w * sk_re)[None, :]) @ kv
            - (torch.cos(phase) * (w * sk_im)[None, :]) @ kv)


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


def static_field_direct(pos, box, atom_alive, params, cfg):
    """Damped intermolecular field E0 [N,3] of the permanent charges at
    every alive site, within the pair cutoff: B5 in charge mode."""
    return tk.charge_field(pos, box, atom_alive, params.charge,
                           params.mol_id32, derived_cutoff(box, cfg),
                           cfg.polar_damp, cfg.polar_damp_type,
                           ortho=cfg.ortho_box)


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
    the pre-move mask.  r0_new is None without ``with_residual``."""
    dtype = pos.dtype
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    A = params.max_atoms_per_mol
    valid = row_valid(params, mol)
    q_rows = torch.where(valid, mol_rows(params.charge, params, mol), 0.0)
    old_rows = mol_rows(pos, params, mol)
    mu_rows = (torch.where(valid[:, None], mol_rows(mu, params, mol), 0.0)
               if with_residual else None)
    pol_site = params.polar > 0
    pol_rows = valid & (mol_rows(params.polar, params, mol) > 0)
    other = atom_alive & (params.mol_id != mol)
    other_pol = other & pol_site
    ew_f = cfg.polar_ewald
    alpha_f, k_rc = _field_variant_consts(box, cfg, dtype)

    if delete:
        src_pos, src_q, src_ok = old_rows, -q_rows, valid
        src_mu = -mu_rows if with_residual else None
    elif insert:
        src_pos, src_q, src_ok = new_rows, q_rows, valid
        src_mu = None               # inserted molecules carry mu = 0
    else:
        src_pos = torch.cat([new_rows, old_rows])
        src_q = torch.cat([q_rows, -q_rows])
        src_ok = torch.cat([valid, valid])
        src_mu = (torch.cat([mu_rows, -mu_rows]) if with_residual
                  else None)

    # ---- tile (a): moved rows as sources vs every site --------------
    dr = pbc_ops.min_image(pos[None, :, :] - src_pos[:, None, :], box,
                           box_inv)                       # [S,N,3]
    r2 = torch.sum(dr * dr, -1)
    in_rc = r2 < rc * rc
    r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    d1, d2 = _damping(r, cfg.polar_damp, cfg.polar_damp_type)
    ok_f = src_ok[:, None] & other[None, :] & in_rc
    coef = torch.where(ok_f, src_q[:, None]
                       * _field_coef(r, r2s, d1, alpha_f, k_rc), _zero(r))
    e0_new = e0 + torch.einsum("sn,snk->nk", coef, dr)

    if ew_f:
        kv = ewald.kvectors(box, cfg.ewald_kmax)
        if sk is None:
            sk = ewald.structure_factor(pos, params.charge, atom_alive, kv)
        sk_re_o, sk_im_o = sk
        d_re, d_im = ewald.mol_structure_factor(src_pos, src_q, src_ok, kv)
        w_k = _recip_field_w(box, alpha_f, kv)
        d_rec = _recip_field(pos, kv, w_k, d_re, d_im)
        e0_new = e0_new + torch.where(other[:, None], d_rec, _zero(d_rec))

    # ---- tile (b): the field / dipole field at the trial rows -------
    if delete:
        rows_field = torch.zeros((A, 3), dtype=dtype, device=pos.device)
    else:
        drr = pbc_ops.min_image(new_rows[:, None, :] - pos[None, :, :], box,
                                box_inv)                  # [A,N,3]
        r2b = torch.sum(drr * drr, -1)
        in_rcb = r2b < rc * rc
        r2bs = torch.where(r2b > 1e-12, r2b, torch.ones_like(r2b))
        rb = torch.sqrt(r2bs)
        d1b, d2b = _damping(rb, cfg.polar_damp, cfg.polar_damp_type)
        okb = valid[:, None] & other[None, :] & in_rcb
        cb = torch.where(okb, params.charge[None, :]
                         * _field_coef(rb, r2bs, d1b, alpha_f, k_rc),
                         _zero(rb))
        rows_field = torch.einsum("an,ank->ak", cb, drr)
        if ew_f:
            # same-molecule erf-complement block at the new geometry
            dra_f = pbc_ops.min_image(
                new_rows[None, :, :] - new_rows[:, None, :], box, box_inv)
            r2i = torch.sum(dra_f * dra_f, -1)
            diag_a = torch.eye(A, dtype=torch.bool, device=pos.device)
            oki = valid[:, None] & valid[None, :] & ~diag_a
            r2is = torch.where(r2i > 1e-12, r2i, torch.ones_like(r2i))
            ri = torch.sqrt(r2is)
            ci = torch.where(oki, -q_rows[:, None]
                             * _intra_coef(ri, r2is, alpha_f), _zero(ri))
            rows_field = rows_field + torch.einsum("st,stk->tk", ci, dra_f)
            # k-space field at the trial rows with the post-move S(k)
            rows_field = rows_field + _recip_field(
                new_rows, kv, w_k, sk_re_o + d_re, sk_im_o + d_im)
    cur = mol_rows(e0_new, params, mol)
    rows_field = torch.where(valid[:, None], rows_field.to(dtype), cur)
    e0_out = mol_rows_update(e0_new, params, mol, rows_field)
    if not with_residual:
        return e0_out, None

    # ---- residual: r0' = r_old + (b' - b) + (T' - T) mu -------------
    rr = r_old + torch.where(other_pol[:, None], e0_out - e0,
                             _zero(e0))
    if src_mu is not None:
        okm = (src_ok[:, None] & other_pol[None, :] & in_rc
               & (r2 > 1e-12))
        inv_r3 = 1.0 / (r2s * r)
        mdotr = torch.einsum("sk,snk->sn", src_mu, dr)
        c1 = torch.where(okm, 3.0 * d2 * mdotr * inv_r3 / r2s, _zero(r))
        c2 = torch.where(okm, d1 * inv_r3, _zero(r))
        rr = rr + (torch.einsum("sn,snk->nk", c1, dr)
                   - torch.einsum("sn,sk->nk", c2, src_mu))

    if delete:
        rows_r = torch.zeros((A, 3), dtype=dtype, device=pos.device)
    else:
        # dipole field at the trial rows from every other site
        okbp = (valid[:, None] & other_pol[None, :] & in_rcb
                & (r2b > 1e-12))
        inv_r3b = 1.0 / (r2bs * rb)
        mu_oth = torch.where(other_pol[:, None], mu, _zero(mu))
        mdotr_b = torch.einsum("nk,ank->an", mu_oth, drr)
        c1b = torch.where(okbp, 3.0 * d2b * mdotr_b * inv_r3b / r2bs,
                          _zero(rb))
        c2b = torch.where(okbp, d1b * inv_r3b, _zero(rb))
        e_rows = (torch.einsum("an,ank->ak", c1b, drr)
                  - torch.einsum("an,nk->ak", c2b, mu_oth))
        # the [A,A] self-block: the molecule's own trial rows as sources
        dra = pbc_ops.min_image(
            new_rows[None, :, :] - new_rows[:, None, :], box, box_inv)
        r2a = torch.sum(dra * dra, -1)
        diag = torch.eye(A, dtype=torch.bool, device=pos.device)
        oka = (pol_rows[:, None] & valid[None, :] & ~diag
               & (r2a < rc * rc) & (r2a > 1e-12))
        r2as = torch.where(r2a > 1e-12, r2a, torch.ones_like(r2a))
        ra = torch.sqrt(r2as)
        d1a, d2a = _damping(ra, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3a = 1.0 / (r2as * ra)
        mdotr_a = torch.einsum("sk,sak->sa", mu_rows, dra)
        c1a = torch.where(oka, 3.0 * d2a * mdotr_a * inv_r3a / r2as,
                          _zero(ra))
        c2a = torch.where(oka, d1a * inv_r3a, _zero(ra))
        e_rows = e_rows + (torch.einsum("sa,sak->ak", c1a, dra)
                           - torch.einsum("sa,sk->ak", c2a, mu_rows))
        p_rows = mol_rows(params.polar, params, mol)
        inv_a = torch.where(pol_rows, 1.0 / torch.clamp(p_rows, min=1e-30),
                            _zero(p_rows))
        rows_r = (torch.where(valid[:, None], mol_rows(e0_out, params, mol),
                              0.0)
                  - inv_a[:, None] * mu_rows + e_rows)
        rows_r = torch.where(pol_rows[:, None], rows_r, _zero(rows_r))
    cur_r = mol_rows(rr, params, mol)
    rows_r = torch.where(valid[:, None], rows_r.to(dtype), cur_r)
    return e0_out, mol_rows_update(rr, params, mol, rows_r)


def residual_delta(pos, box, atom_alive, params, cfg, mol, mu, r_old,
                   e0_old, e0_new, new_rows=None, insert=False,
                   delete=False):
    """O(A N) initial CG residual r0' = b' - A' mu of the candidate from
    the previous solve's r_old = b - A mu: r0' = r_old + (b' - b) +
    (T' - T) mu, with (a) the moved dipoles as sources at every other
    polarizable site and (b) the moved rows' own entries recomputed.
    The sequential form of ``move_deltas``' residual (the tests hold the
    fused form against it); ``atom_alive`` is the pre-move mask."""
    dtype = pos.dtype
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    A = params.max_atoms_per_mol
    valid = row_valid(params, mol)
    pol_rows = valid & (mol_rows(params.polar, params, mol) > 0)
    old_rows = mol_rows(pos, params, mol)
    mu_rows = torch.where(valid[:, None], mol_rows(mu, params, mol), 0.0)
    other_pol = (atom_alive & (params.mol_id != mol)
                 & (params.polar > 0))[:, None]
    r = r_old + torch.where(other_pol, e0_new - e0_old, _zero(e0_old))

    def dip_field(tgt_pos, src_pos, src_mu, ok):
        dr = pbc_ops.min_image(tgt_pos[None, :, :] - src_pos[:, None, :],
                               box, box_inv)              # [S,T,3]
        r2 = torch.sum(dr * dr, -1)
        okm = ok & (r2 < rc * rc) & (r2 > 1e-12)
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        rr = torch.sqrt(r2s)
        d1, d2 = _damping(rr, cfg.polar_damp, cfg.polar_damp_type)
        inv_r3 = 1.0 / (r2s * rr)
        mdotr = torch.einsum("sk,stk->st", src_mu, dr)
        c1 = torch.where(okm, 3.0 * d2 * mdotr * inv_r3 / r2s, _zero(rr))
        c2 = torch.where(okm, d1 * inv_r3, _zero(rr))
        return (torch.einsum("st,stk->tk", c1, dr)
                - torch.einsum("st,sk->tk", c2, src_mu))

    if delete:
        src_pos, src_mu, src_ok = old_rows, -mu_rows, valid
    elif insert:
        src_pos = None
    else:
        src_pos = torch.cat([new_rows, old_rows])
        src_mu = torch.cat([mu_rows, -mu_rows])
        src_ok = torch.cat([valid, valid])
    if src_pos is not None:
        r = r + dip_field(pos, src_pos, src_mu,
                          src_ok[:, None] & other_pol[None, :, 0])

    if delete:
        rows_r = torch.zeros((A, 3), dtype=dtype, device=pos.device)
    else:
        src2_pos = torch.cat([pos, new_rows])
        src2_mu = torch.cat([torch.where(other_pol, mu, _zero(mu)), mu_rows])
        src2_ok = torch.cat([other_pol[:, 0], pol_rows])
        self_m = torch.cat([
            torch.zeros((pos.shape[0], A), dtype=torch.bool,
                        device=pos.device),
            torch.eye(A, dtype=torch.bool, device=pos.device)])
        ok_b = src2_ok[:, None] & valid[None, :] & ~self_m
        e_rows = dip_field(new_rows, src2_pos, src2_mu, ok_b)
        p_rows = mol_rows(params.polar, params, mol)
        inv_a = torch.where(pol_rows, 1.0 / torch.clamp(p_rows, min=1e-30),
                            _zero(p_rows))
        rows_r = (torch.where(valid[:, None], mol_rows(e0_new, params, mol),
                              0.0)
                  - inv_a[:, None] * mu_rows + e_rows)
        rows_r = torch.where(pol_rows[:, None], rows_r, _zero(rows_r))
    cur = mol_rows(r, params, mol)
    rows_r = torch.where(valid[:, None], rows_r.to(dtype), cur)
    return mol_rows_update(r, params, mol, rows_r)


def dipole_matvec(pos, box, atom_alive, params, cfg, mu):
    """(T mu)_i: the damped dipole field of every other polarizable site's
    dipole at site i, intramolecular pairs included, within the cutoff —
    B5 in dipole mode."""
    pol_ok = atom_alive & (params.polar > 0)
    return tk.dipole_field(pos, box, pol_ok,
                           torch.where(pol_ok[:, None], mu, _zero(mu)),
                           params.mol_id32, derived_cutoff(box, cfg),
                           cfg.polar_damp, cfg.polar_damp_type,
                           ortho=cfg.ortho_box)


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
    keep the site order).  Recomputed per solve."""
    n = pos.shape[0]
    L = torch.diagonal(box)
    cell = rc / 2.0
    frac = pos - L[None, :] * torch.floor(pos / L[None, :])
    c = torch.floor(frac / cell)
    ncy = torch.ceil(L[1] / cell)
    ncz = torch.ceil(L[2] / cell)
    key = (c[:, 0] * ncy + c[:, 1]) * ncz + c[:, 2]
    key = torch.where(pol_ok, key, torch.full_like(key, math.inf))
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=pos.device)
    return perm, inv


def cull_visit(pos_s, ok_s, box, rc, ti=tk.TI, tj=tk.TJ, n_pad=None):
    """Conservative [NI, NJ] int32 tile-visit table over cell-sorted sites
    for tiles of ``ti`` rows x ``tj`` columns: tile (I, J) is visited
    unless the smallest minimum-image distance between the two blocks'
    axis-aligned bounding boxes is >= rc (or either block holds no ok
    site).  Computed in float64 against rc inflated by 64 units in the
    last place of the box length in the sites' precision: the kernel's
    rounded r^2 of a pair just outside rc may fall inside it, and such a
    pair's tile must stay visited."""
    n = pos_s.shape[0]
    if n_pad is None:
        n_pad = tk.grid_shape(n, ti, tj)[0]
    L = torch.diagonal(box).double()
    p = pos_s.double()
    p = p - L[None, :] * torch.floor(p / L[None, :])       # wrap to [0, L)
    pad = n_pad - n
    p = torch.cat([p, torch.zeros((pad, 3), dtype=p.dtype,
                                  device=p.device)])
    ok = torch.cat([ok_s, torch.zeros(pad, dtype=torch.bool,
                                      device=ok_s.device)])
    lo = torch.where(ok[:, None], p, torch.full_like(p, 1e30))
    hi = torch.where(ok[:, None], p, torch.full_like(p, -1e30))

    def blocks(t):
        nb = n_pad // t
        mn = lo.reshape(nb, t, 3).amin(1)
        mx = hi.reshape(nb, t, 3).amax(1)
        nonempty = ok.reshape(nb, t).any(1)
        ctr = torch.where(nonempty[:, None], 0.5 * (mn + mx), _zero(mn))
        hw = torch.where(nonempty[:, None], 0.5 * (mx - mn), _zero(mn))
        return ctr, hw, nonempty

    ci, hwi, oki = blocks(ti)
    cj, hwj, okj = blocks(tj)
    dc = ci[:, None, :] - cj[None, :, :]
    dc = dc - L[None, None, :] * torch.round(dc / L[None, None, :])
    gap = torch.clamp(torch.abs(dc) - hwi[:, None, :] - hwj[None, :, :],
                      min=0.0)
    mind2 = torch.sum(gap * gap, -1)
    rc_v = (torch.as_tensor(rc, dtype=torch.float64, device=p.device)
            + 64.0 * torch.finfo(pos_s.dtype).eps * torch.max(L))
    visit = oki[:, None] & okj[None, :] & (mind2 < rc_v * rc_v)
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
    start's matvec."""
    pol_ok = atom_alive & (params.polar > 0)
    cull = cull_supported(cfg)
    polar_vec = params.polar
    rc_c = derived_cutoff(box, cfg)
    mol_s, visit = params.mol_id32, None
    if cull:
        # the CG recurrence runs in cell-sorted space with the tile-visit
        # table; the culled matvec equals the dense one, only the CG's
        # reductions reassociate
        perm, invp = cull_perm(pos, box, pol_ok, rc_c)
        pos = pos[perm]
        pol_ok = pol_ok[perm]
        polar_vec = polar_vec[perm]
        mol_s = mol_s[perm]
        e0 = e0[perm]
        mu0 = mu0[perm] if mu0 is not None else None
        r0 = r0[perm] if r0 is not None else None
        visit = cull_visit(pos, pol_ok, box, rc_c)
    mask = pol_ok[:, None]
    inv_a = torch.where(pol_ok, 1.0 / torch.clamp(polar_vec, min=1e-30),
                        _zero(polar_vec))[:, None]
    b = torch.where(mask, e0, _zero(e0))
    nsites = torch.clamp(torch.sum(pol_ok), min=1).to(pos.dtype)
    tol2 = (cfg.polar_precision ** 2) * nsites * 3
    if cfg.polar_solver == "direct":
        return _solve_direct(pos, box, params, cfg, b, pol_ok), 0, None
    # B5's scalar header and work list, once for every matvec of the solve
    fplan = tk.plan(box, rc_c, cfg.polar_damp, pos.shape[0], visit)

    def tmul(x):
        """(T x) of an x that is zero off the polarizable sites
        (dipole_matvec) through the solve's plan."""
        return tk.dipole_field(pos, box, pol_ok, x, mol_s, rc_c,
                               cfg.polar_damp, cfg.polar_damp_type,
                               ortho=cfg.ortho_box, visit=visit, plan=fplan)

    def amul(x):
        x = torch.where(mask, x, _zero(x))
        return torch.where(mask, inv_a * x - tmul(x), _zero(x))

    if cfg.polar_solver == "jacobi":
        # mu <- (1-g) mu + g alpha (E0 + T mu): the reference's plain
        # iteration with relaxation polar_gamma
        g = cfg.polar_gamma
        alpha_site = torch.where(mask, params.polar[:, None], 0.0)
        mu = mu0 if mu0 is not None else _zero(e0)
        for _ in range(cfg.polar_max_iter):
            t = tmul(torch.where(mask, mu, _zero(mu)))
            mu = torch.where(mask, (1 - g) * mu + g * alpha_site * (b + t),
                             _zero(mu))
        return mu, cfg.polar_max_iter, None

    # --- preconditioned conjugate gradient (M = diag(1/alpha)) ----------
    dip_mode = cfg.polar_precision_mode == "dipole"
    if dip_mode:
        tol2 = ((cfg.polar_precision / DEBYE_PER_EA) ** 2) * nsites * 3
    alpha_site = torch.where(mask, polar_vec[:, None], 0.0)
    x = torch.where(mask, mu0, 0.0) if mu0 is not None else _zero(e0)
    r = torch.where(mask, r0, 0.0) if r0 is not None else b - amul(x)
    z = alpha_site * r
    p = z
    rs = torch.sum(r * r)
    rz = torch.sum(r * z)
    gate = rs
    it = 0

    def safe(v):
        return torch.where(torch.abs(v) > 1e-300, v,
                           torch.full_like(v, 1e-300))

    # dipole mode is a do-while (ds0 = inf): its first gate is known
    while it < cfg.polar_max_iter and ((dip_mode and it == 0)
                                       or bool(gate > tol2)):
        ap = amul(p)
        alpha = rz / safe(torch.sum(p * ap))
        dx = alpha * p
        x = x + dx
        r = r - alpha * ap
        z = alpha_site * r
        rz_new = torch.sum(r * z)
        beta = rz_new / safe(rz)
        p = z + beta * p
        ds = torch.sum(dx * dx) if dip_mode else rs
        rs, rz = torch.sum(r * r), rz_new
        it += 1
        gate = ds if dip_mode else rs
    x = torch.where(mask, x, _zero(x))
    r = torch.where(mask, r, _zero(r))
    if cull:
        x, r = x[invp], r[invp]      # back to the caller's site order
    return x, it, r


def dipole_tensor(pos, box, site_ok, cfg):
    """Damped dipole-dipole tensor T [N,N,3,3] over the given sites (pair
    cutoff, Thole damping; zero blocks on the diagonal and where either
    site is masked)."""
    n = pos.shape[0]
    box_inv = _inverse(box)
    rc = derived_cutoff(box, cfg)
    dr = pbc_ops.min_image(pos[:, None, :] - pos[None, :, :], box, box_inv)
    r2 = torch.sum(dr * dr, -1)
    diag = torch.eye(n, dtype=torch.bool, device=pos.device)
    ok = site_ok[:, None] & site_ok[None, :] & ~diag & (r2 < rc * rc)
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
    """U_pol = -(ke/2) sum mu . E0   [K]."""
    return -0.5 * KE * torch.sum(mu * e0)


def zodid_energy(e0, atom_alive, params):
    """Zeroth-iteration polarization energy U* = -(ke/2) sum alpha |E0|^2
    (mu = alpha E0, no dipole coupling): the delayed-acceptance
    surrogate, O(N) given the cached field."""
    pol_ok = atom_alive & (params.polar > 0)
    a = torch.where(pol_ok, params.polar, _zero(params.polar))
    return -0.5 * KE * torch.sum(a * torch.sum(e0 * e0, dim=1))


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
