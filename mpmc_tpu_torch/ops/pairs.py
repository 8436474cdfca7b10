"""Masked O(N^2) pair-interaction passes (port of the GCMC slice of
mpmc_tpu/ops/pairs.py).

- ``pair_pass``     : full-system terms (refresh and full energy);
- ``mol_pair_pass`` : one molecule's rows against everything (the
                      per-move delta of displace, insert and delete);
- ``mol_pair_partials`` / ``pair_matrix`` : the same rows reduced per
                      column molecule — the molecule-pair energy cache
                      of ``mol_cache`` (plain PyTorch, the reference's
                      jnp path).

Both go through ops/cuda/pair_kernel.py: on a CUDA tensor they launch the
hand-written kernels (B2 and B4), on a CPU tensor they run the kernels'
plain versions, which are built from ``_tile_values``/``_block_terms``
below — the dense [rows, cols] reference math.  Under Feynman-Hibbs,
Feynman-Kleinert, coulomb gwp or a cdvdw repulsion the kernels' static
gate (pair_kernel.supported, the reference's) refuses, as the reference's
does, and both passes run that tile math on any device: the reference's
own route for these options.  The RD forms sg, dreiding, b14_7 and
disp_expansion (ops/potentials.py) run through the kernels.  Under
``rd_crystal`` the passes take ES and the closest approach from the
cutoff pass with rd none (the kernels' classical instance) and RD from
the periodic-image lattice sum of ops/crystal.py, as the reference's
pair_pass and mol_pair_pass route it.

Under ``cfg.spatial_axis`` (("atoms", D): a rank of D in a process group,
the replicated state of parallel/spatial.py) a single-geometry pass
computes this rank's share and the ranks' raw sums meet in one plane
(parallel/multihost.plane: sums added in rank order, the closest approach
the minimum): ``pair_pass`` over the row tiles I with I mod D == d (B2 on
a strip of its work list), ``mol_pair_pass`` over the column strip
[d nl, (d + 1) nl) (B4 on a column range), ``mol_pair_passes`` several
trial placements in one plane (the displacement's old and new rows).
Batched passes stay whole on every rank.

Raw pass outputs leave the Coulomb constant out; this module applies it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mpmc_tpu_torch.constants import KE
from mpmc_tpu_torch.ops import lj as lj_ops
from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.ops import potentials
from mpmc_tpu_torch.state import chain_rows, mol_rows, row_valid

# raw slot layout of a full pass: [rd, es_real, es_excl, lrc] for the
# active part, the same four for the frozen-frozen part, then min_r2
N_SLOTS = 9


def derived_cutoff(box, cfg):
    """Static cutoff if configured, else half min perpendicular width
    ([C] for stacked boxes [C, 3, 3])."""
    if cfg.cutoff is not None:
        # a fill on the device, not a host-to-device copy (a host sync)
        return torch.full(box.shape[:-2], cfg.cutoff, dtype=box.dtype,
                          device=box.device)
    return pbc_ops.default_cutoff(box)


def derived_alpha(cutoff, cfg):
    """Ewald splitting / Wolf damping parameter: ewald 3.5/rc, wolf 2/rc,
    unless ``ewald_alpha``/``wolf_alpha`` is given (elementwise: [C] for
    a [C] cutoff)."""
    if cfg.coulomb == "wolf":
        if cfg.wolf_alpha is not None:
            return torch.full_like(cutoff, cfg.wolf_alpha)
        return 2.0 / cutoff
    if cfg.ewald_alpha is not None:
        return torch.full_like(cutoff, cfg.ewald_alpha)
    return 3.5 / cutoff


def spatial_strip(cfg):
    """(d, D): this rank's strip under ``cfg.spatial_axis``, else None.
    The process group must hold exactly D ranks."""
    if cfg.spatial_axis is None:
        return None
    from mpmc_tpu_torch.parallel import multihost
    D = int(cfg.spatial_axis[1])
    if multihost.world() != D:
        raise ValueError(f"spatial_axis over {D} devices but the process "
                         f"group has {multihost.world()} ranks")
    return multihost.rank(), D


def _spatial_raw(raw, n_sum):
    """The ranks' raw pass sums (last axis: n_sum sums, then minima) met
    in one plane: the sums added in rank order, the minima taken."""
    from mpmc_tpu_torch.parallel import multihost
    p = multihost.plane(raw)
    return torch.cat([multihost.psum_rows(p[..., :n_sum]),
                      multihost.pmin_rows(p[..., n_sum:])], -1)


def pair_scalars(box, cfg):
    """The pair kernels' scalar header: [rc, alpha, box (9), box^-1 (9)],
    one small tensor on the box's device, read by the kernels from device
    memory (no host round trip per launch); [C, 20] for stacked boxes
    [C, 3, 3] (B4 over chains reads a row per chain).  The inverse skips
    linalg.inv's singularity check, a host sync on the card."""
    lead = box.shape[:-2]
    rc = derived_cutoff(box, cfg)
    alpha = derived_alpha(rc, cfg)
    inv = torch.linalg.inv_ex(box).inverse
    return torch.cat([rc.reshape(lead + (1,)), alpha.reshape(lead + (1,)),
                      box.reshape(lead + (9,)), inv.reshape(lead + (9,))],
                     -1).contiguous()


@dataclasses.dataclass(frozen=True)
class PairTerms:
    """Sums from a pair pass.  ``min_r2`` tracks the closest active
    inter-molecular approach (``cavity_autoreject_absolute``)."""
    rd: torch.Tensor
    es_real: torch.Tensor
    es_excl: torch.Tensor
    lrc_coeff: torch.Tensor   # sum of tail coefficients; U_lrc = lrc_coeff/V
    min_r2: torch.Tensor

    def combine(self, o):
        return PairTerms(self.rd + o.rd, self.es_real + o.es_real,
                         self.es_excl + o.es_excl,
                         self.lrc_coeff + o.lrc_coeff,
                         torch.minimum(self.min_r2, o.min_r2))


def lrc_on(cfg) -> bool:
    """Whether the RD terms carry a long-range tail: rd_lrc under lj or
    disp_expansion (the other forms have none, as in the reference)."""
    return bool(cfg.rd_lrc) and cfg.rd_potential in ("lj", "disp_expansion")


def site_columns(params, cfg):
    """(disp, gwp) per-atom columns a cfg's pair terms read beyond charge,
    eps and sig: ``disp`` (c6, c8, c10) under disp_expansion, or (polar,
    omega) — the Drude parameters — under a cdvdw repulsion, and the GWP
    widths under coulomb gwp, else None."""
    if cfg.cdvdw_repulsion != "none":
        disp = (params.polar, params.omega)
    elif cfg.rd_potential == "disp_expansion":
        disp = (params.c6, params.c8, params.c10)
    else:
        disp = None
    gwp = params.gwp_alpha if cfg.coulomb == "gwp" else None
    return disp, gwp


def _tile_values(r2, qi, ei, si, qj, ej, sj, cfg, rc, alpha, qc=None,
                 disp=None, gwp=None):
    """Per-pair values (no masks, no Coulomb constant) for broadcastable
    row/column parameter tensors: (rd_u, es_u, ex_u, tc), each None when
    its term is off.  The semantics of pairs._tile_values in the JAX
    package for rd lj/none/sg/dreiding/b14_7/disp_expansion and coulomb
    ewald/wolf/cutoff/gwp/none.  ``qc``: (the rows' molecular masses, the
    columns', the temperature), broadcastable, which adds the
    Feynman-Kleinert or (without it) Feynman-Hibbs correction to the LJ
    values.  ``disp``: ((c6, c8, c10) of the rows, of the columns), which
    disp_expansion needs, or under a cdvdw repulsion ((polar, omega) of
    the rows, of the columns), which replaces the RD form wholesale;
    ``gwp``: (the rows' GWP widths, the columns'), which coulomb gwp
    needs."""
    r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))  # guard i == j
    r = torch.sqrt(r2s)
    rd_u = tc = es_u = ex_u = None
    if cfg.cdvdw_repulsion != "none":
        if disp is None:
            raise ValueError("cdvdw repulsion pair terms need the polar and "
                             "omega columns")
        (ai, wi), (aj, wj) = disp
        rd_u = potentials.cdvdw_repulsion_energy(r, ei, ej, si, sj, ai, aj,
                                                 wi, wj, cfg)
        if cfg.rd_lrc:
            tc = potentials.cdvdw_repulsion_tail_coefficient(
                si, sj, ai, aj, wi, wj, rc, cfg) + torch.zeros_like(r2s)
    elif cfg.rd_potential == "lj":
        eps, sig = lj_ops.mix(ei, ej, si, sj, cfg.mixing_rule)
        rd_u = lj_ops.energy(r2s, eps, sig)
        if qc is not None:
            mm_i, mm_j, temp = qc
            # the reduced mass of the two molecules: a frozen framework's
            # huge molecular mass degrades it to mm_i
            red = mm_i * mm_j / torch.clamp(mm_i + mm_j, min=1e-30)
            if cfg.feynman_kleinert:
                rd_u = rd_u + lj_ops.feynman_kleinert(r, eps, sig, red, temp)
            else:
                rd_u = rd_u + lj_ops.feynman_hibbs(
                    r, eps, sig, red, temp, cfg.feynman_hibbs_order)
        if cfg.rd_lrc:
            tc = lj_ops.tail_coefficient(eps, sig, rc)
    elif cfg.rd_potential in potentials.FORMS:
        if cfg.rd_potential == "disp_expansion" and disp is None:
            raise ValueError("disp_expansion pair terms need the C6/C8/C10 "
                             "columns")
        (c6i, c8i, c10i), (c6j, c8j, c10j) = disp or ((None,) * 3,) * 2
        rd_u = potentials.rd_pair_energy_generic(
            r, ei, ej, si, sj, c6i, c6j, c8i, c8j, c10i, c10j, cfg)
        if cfg.rd_potential == "disp_expansion" and cfg.rd_lrc:
            tc = potentials.disp_tail_coefficient(
                potentials.disp_mix(c6i, c6j), potentials.disp_mix(c8i, c8j),
                potentials.disp_mix(c10i, c10j), rc)
    elif cfg.rd_potential != "none":
        raise ValueError(f"unknown rd_potential {cfg.rd_potential}")
    qq = qi * qj
    if cfg.coulomb == "ewald":
        es_u = qq * torch.special.erfc(alpha * r) / r
        ex_u = -qq * torch.erf(alpha * r) / r
    elif cfg.coulomb == "wolf":
        es_u = qq * (torch.special.erfc(alpha * r) / r
                     - torch.special.erfc(alpha * rc) / rc)
    elif cfg.coulomb == "cutoff":
        es_u = qq / r
    elif cfg.coulomb == "gwp":
        if gwp is None:
            raise ValueError("coulomb gwp pair terms need the GWP widths")
        # two normalized Gaussians of widths s_i, s_j: erf(r / sqrt(2 (s_i^2
        # + s_j^2))) / r, point charges where both widths are 0
        s2 = gwp[0] * gwp[0] + gwp[1] * gwp[1]
        smear = torch.where(
            s2 > 1e-12,
            torch.erf(r / torch.sqrt(2.0 * torch.clamp(s2, min=1e-12))),
            torch.ones_like(s2))
        es_u = qq * smear / r
    return rd_u, es_u, ex_u, tc


def _block_terms(pos_i, row_idx, row_ok, row_mol, row_frozen, qi, ei, si,
                 pos, col_ok, mol_id, col_frozen, charge, eps, sig, scal,
                 cfg, triangular, row_start=0, qc=None, disp=None,
                 gwp=None):
    """Raw [9] sums of one row block [B] against every column [N].
    ``qc``: (the rows' molecular masses [B], the columns' [N], the
    temperature), which a Feynman-Hibbs/Kleinert cfg needs; ``disp``:
    ((c6, c8, c10) of the rows [B], of the columns [N]) for
    disp_expansion; ``gwp``: (the rows' GWP widths [B], the columns' [N])
    for coulomb gwp.

    ``triangular``: count only cols > row (plus, with ``row_start``, every
    col < row_start — the skipped frozen-prefix rows reappear as columns).
    Otherwise every (row, col) pair counts once (molecule pass: the caller
    masks the molecule's own columns out of ``col_ok``).  Per-term masks:
    rd/es_real over inter pairs within rc, es_excl over intra pairs, lrc
    over inter pairs at any distance, min_r2 over active inter pairs at
    any distance; each sum split by ff = frozen row & frozen col.

    Over a batch of geometries (pair_kernel.pair_terms_chains_plain):
    ``pos_i`` [C, B, 3] and ``pos`` [C, N, 3], everything else shared,
    raw [C, 9]."""
    rc, alpha = scal[0], scal[1]
    box, box_inv = scal[2:11].reshape(3, 3), scal[11:20].reshape(3, 3)
    dr = pbc_ops.min_image(pos_i[..., :, None, :] - pos[..., None, :, :],
                           box, box_inv)
    r2 = torch.sum(dr * dr, dim=-1)                       # [(C,) B, N]
    lead = r2.shape[:-2]
    pair_ok = row_ok[:, None] & col_ok[None, :]
    if triangular:
        cols = torch.arange(pos.shape[-2], device=pos.device)
        tri = cols[None, :] > row_idx[:, None]
        if row_start:
            tri = tri | (cols[None, :] < row_start)
        pair_ok = pair_ok & tri
    same = row_mol[:, None] == mol_id[None, :]
    inter = pair_ok & ~same
    intra = pair_ok & same
    act = inter & (r2 < rc * rc)
    ff = row_frozen[:, None] & col_frozen[None, :]
    if quantum(cfg):
        if qc is None:
            raise ValueError("feynman_hibbs / feynman_kleinert pair terms "
                             "need the molecular masses and the temperature")
        qc = (qc[0][:, None], qc[1][None, :], qc[2])
    else:
        qc = None
    if disp is not None:
        disp = (tuple(c[:, None] for c in disp[0]),
                tuple(c[None, :] for c in disp[1]))
    if gwp is not None:
        gwp = (gwp[0][:, None], gwp[1][None, :])
    rd_u, es_u, ex_u, tc = _tile_values(
        r2, qi[:, None], ei[:, None], si[:, None], charge[None, :],
        eps[None, :], sig[None, :], cfg, rc, alpha, qc, disp, gwp)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

    def s(values, mask):
        if values is None:
            return torch.zeros(lead, dtype=pos.dtype, device=pos.device)
        # a position-free value (the tail coefficient) lacks the batch axis
        v = torch.broadcast_to(torch.where(mask, values, zero), r2.shape)
        return torch.sum(v, dim=(-2, -1))

    out = []
    for keep in (~ff, ff):
        out += [s(rd_u, act & keep), s(es_u, act & keep),
                s(ex_u, intra & keep), s(tc, inter & keep)]
    if r2.numel():
        mn = torch.where(inter & ~ff, r2, torch.full_like(r2, math.inf))
        out.append(mn.amin(dim=(-2, -1)))
    else:
        out.append(torch.full(lead, math.inf, dtype=pos.dtype,
                              device=pos.device))
    return torch.stack(out, -1)


def _pair_terms(raw):
    """(active, frozen_frozen) PairTerms from a raw [9] pass output (of
    [C] tensors from a raw [C, 9])."""
    r = raw.unbind(-1)
    act = PairTerms(rd=r[0], es_real=KE * r[1], es_excl=KE * r[2],
                    lrc_coeff=r[3], min_r2=r[8])
    ff = PairTerms(rd=r[4], es_real=KE * r[5], es_excl=KE * r[6],
                   lrc_coeff=r[7], min_r2=torch.full_like(r[8], math.inf))
    return act, ff


def quantum(cfg) -> bool:
    """Whether the LJ pair terms carry a Feynman-Hibbs/Kleinert correction
    (rd lj only, as in the reference)."""
    return (cfg.rd_potential == "lj"
            and bool(cfg.feynman_hibbs or cfg.feynman_kleinert))


def pair_pass(pos, box, atom_alive, params, cfg, temperature,
              split_frozen=False, row_start=0, scal=None):
    """Full-system pair terms: each (i<j) pair once.  With
    ``split_frozen`` returns (active, frozen_frozen) PairTerms.

    ``row_start`` restricts the rows to >= row_start, still paired
    triangularly against ALL columns plus every column < row_start: with
    the frozen-prefix layout (metropolis.frozen_refresh_rows) that is
    exactly the ACTIVE part of the split pass, at (N-F)/N of the cost —
    the per-corrtime fast refresh.  ``temperature`` (0-d) feeds the
    Feynman-Hibbs/Kleinert terms; where the gate pair_kernel.supported
    refuses them (and coulomb gwp and the cdvdw repulsions), the pass is
    B2's plain version on the tensors' device.  Under ``rd_crystal`` RD is
    the image sum (crystal.rd_crystal_full) and the rest the pass with rd
    none; it takes no ``row_start`` and no rd_lrc, as the reference's.

    Over a batch of geometries (the surf drivers, where the reference
    vmaps total_energy): ``pos`` [C, N, 3], everything else shared, one
    B2 launch over the batch (pair_kernel.pair_terms_chains), PairTerms
    of [C] tensors.  ``scal``: a precomputed pair_scalars(box, cfg)."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel

    if scal is None:
        scal = pair_scalars(box, cfg)
    if cfg.rd_crystal:
        from mpmc_tpu_torch.ops import crystal
        if cfg.rd_lrc:
            raise ValueError("rd_crystal implies rd_lrc off (the image "
                             "shells are the tail)")
        if row_start:
            raise ValueError("row-restricted pair_pass does not support "
                             "rd_crystal (image-sum split differs)")
        base = pair_pass(pos, box, atom_alive, params, _crystal_es(cfg),
                         temperature, split_frozen=split_frozen, scal=scal)
        if pos.dim() == 3:          # a batch: each geometry's image sum
            if split_frozen:
                raise ValueError("a batch of geometries takes no "
                                 "split_frozen under rd_crystal")
            cry = torch.stack([crystal.rd_crystal_full(
                p, box, atom_alive, params, cfg, temperature) for p in pos])
        else:
            cry = crystal.rd_crystal_full(pos, box, atom_alive, params, cfg,
                                          temperature,
                                          split_frozen=split_frozen)
        if split_frozen:
            return (dataclasses.replace(base[0], rd=base[0].rd + cry[0]),
                    dataclasses.replace(base[1], rd=base[1].rd + cry[1]))
        return dataclasses.replace(base, rd=base.rd + cry)
    frozen = params.mol_frozen[params.mol_id]
    args = (pos.contiguous(), params.charge, params.eps, params.sig,
            params.mol_id32, atom_alive, frozen, scal, cfg)
    disp, gwp = site_columns(params, cfg)
    batch = pos.dim() == 3
    strip = {} if batch else {"strip": spatial_strip(cfg)}
    if pair_kernel.supported(cfg):
        fn = pair_kernel.pair_terms_chains if batch else pair_kernel.pair_terms
        raw = fn(*args, row_start=row_start, disp=disp, **strip)
    else:
        fn = (pair_kernel.pair_terms_chains_plain if batch
              else pair_kernel.pair_terms_plain)
        raw = fn(*args, row_start=row_start,
                 qc=(params.mol_mass_atom, temperature), disp=disp, gwp=gwp,
                 **strip)
    if strip.get("strip") is not None:
        raw = _spatial_raw(raw, 8)
    act, ff = _pair_terms(raw)
    # row-restricted: ff slots are exact zeros (no frozen row)
    return (act, ff) if split_frozen else act.combine(ff)


def mol_pair_pass(pos, box, atom_alive, params, cfg, temperature, mol,
                  row_pos=None, scal=None, shared=False):
    """Pair terms between molecule ``mol``'s atoms (or its trial rows
    ``row_pos``) and all OTHER molecules, each pair once — the O(A N)
    per-move delta.  ``mol`` may be a 0-d device tensor (no host sync).
    ``scal``: a precomputed pair_scalars(box, cfg), which the MC step
    builds once per chunk (and after each NPT volume attempt).

    Over C chains (the batched scan step): ``pos`` [C, N, 3],
    ``atom_alive`` [C, N], ``mol`` [C], ``row_pos`` [C, A, 3], ``scal``
    [20] shared or [C, 20] (a box per chain), ``temperature`` 0-d or [C]
    — one B4 launch for every chain, PairTerms of [C] tensors.
    ``shared``: ``pos`` [N, 3] and ``atom_alive`` [N] are every chain's,
    ``mol`` [C] and ``row_pos`` [C, A, 3] the chains' own (B4 at position
    stride 0: one system, C trial placements; ops/qrot.py's rotor grid).
    Where the gate pair_kernel.supported refuses the cfg
    (Feynman-Hibbs/Kleinert, coulomb gwp, the cdvdw repulsions), the pass
    is B4's plain version on the tensors' device.  Under ``rd_crystal``
    RD is the molecule's image sum (crystal.mol_rd_crystal, per chain
    over chains) and the rest the pass with rd none.  Under ``cell_list``
    with an index attached (ops/celllist.attach) the pass is the culled
    one (celllist.mol_pair_pass_culled, plain PyTorch on the device, one
    batched pass over chains): B4 is not launched, as the reference's
    routing (rd_crystal, then the culled pass, then the kernel) has
    it.  Under ``cfg.spatial_axis`` one chain's pass is this rank's column
    strip, met with the others in one plane (mol_pair_passes)."""
    if cfg.rd_crystal:
        from mpmc_tpu_torch.ops import crystal
        base = mol_pair_pass(pos, box, atom_alive, params, _crystal_es(cfg),
                             temperature, mol, row_pos=row_pos, scal=scal,
                             shared=shared)
        cry = crystal.mol_rd_crystal_any(pos, box, atom_alive, params, cfg,
                                         temperature, mol, row_pos=row_pos,
                                         shared=shared)
        return dataclasses.replace(base, rd=base.rd + cry)
    if cfg.cell_list and params.cell_index is not None:
        from mpmc_tpu_torch.ops import celllist
        return celllist.mol_pair_pass_culled(
            pos, box, atom_alive, params, cfg, temperature, mol,
            params.cell_index, row_pos=row_pos, shared=shared, scal=scal)
    if cfg.spatial_axis is not None and pos.ndim == 2 and not shared:
        return mol_pair_passes(pos, box, atom_alive, params, cfg,
                               temperature, mol, [row_pos], scal=scal)[0]
    return _mol_terms(_mol_raw(pos, box, atom_alive, params, cfg,
                               temperature, mol, row_pos, scal, shared))


def _mol_terms(raw):
    """PairTerms of a raw [..., 4] molecule pass."""
    raw = raw.unbind(-1)
    return PairTerms(rd=raw[0], es_real=KE * raw[1],
                     es_excl=torch.zeros_like(raw[0]), lrc_coeff=raw[2],
                     min_r2=raw[3])


def _mol_raw(pos, box, atom_alive, params, cfg, temperature, mol, row_pos,
             scal, shared, cols=None):
    """The raw [4] (over chains [C, 4]) molecule pass of mol_pair_pass
    (its kernel route or the plain one), over the columns ``cols`` (c0,
    c1) only when given (one chain)."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel

    if scal is None:
        scal = pair_scalars(box, cfg)
    args = (pos, params.charge, params.eps, params.sig, params.mol_id32,
            atom_alive, params.mol_atoms, params.mol_natoms,
            torch.as_tensor(mol, device=pos.device), row_pos, scal, cfg)
    batched = pos.ndim == 3 or shared
    cut = {} if cols is None else {"cols": cols}
    disp, gwp = site_columns(params, cfg)
    if pair_kernel.supported(cfg):
        kernel = pair_kernel.mol_pair_chains if batched else \
            pair_kernel.mol_pair
        return kernel(*args, disp=disp, **cut)
    plain = pair_kernel.mol_pair_chains_plain if batched else \
        pair_kernel.mol_pair_plain
    return plain(*args, qc=(params.mol_mass_atom, temperature), disp=disp,
                 gwp=gwp, **cut)


def mol_pair_passes(pos, box, atom_alive, params, cfg, temperature, mol,
                    rows_list, scal=None):
    """[mol_pair_pass of ``mol`` with each of ``rows_list``'s trial rows
    (None: its current rows)] on one chain.  Under ``cfg.spatial_axis``
    each rank prices them against its column strip (B4 on a column
    range) and all of them meet in ONE plane: the displacement's old and
    new passes cost one collective, not two."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel

    strip = (None if cfg.rd_crystal or pos.ndim == 3
             or (cfg.cell_list and params.cell_index is not None)
             else spatial_strip(cfg))
    if strip is None:
        return [mol_pair_pass(pos, box, atom_alive, params, cfg,
                              temperature, mol, row_pos=r, scal=scal)
                for r in rows_list]
    cols = pair_kernel.strip_cols(pos.shape[0], strip)
    raw = torch.stack([_mol_raw(pos, box, atom_alive, params, cfg,
                                temperature, mol, r, scal, False, cols)
                       for r in rows_list])
    return [_mol_terms(x) for x in _spatial_raw(raw, 3)]


def _crystal_es(cfg):
    """The cutoff pass of an rd_crystal cfg: ES and the closest approach,
    rd none (the pair kernels' classical instance)."""
    return dataclasses.replace(cfg, rd_potential="none", rd_crystal=False,
                               cdvdw_repulsion="none")


def intra_terms(pos, box, params, cfg, mol, row_pos=None, scal=None):
    """Ewald exclusion correction of one molecule's internal pairs
    (-ke q_i q_j erf(alpha r)/r), for GCMC insert/delete.  ``scal`` as
    in mol_pair_pass (no cutoff, inverse or determinant per call).  Over
    C chains: ``pos`` [C, N, 3], ``mol`` [C], ``row_pos`` [C, A, 3] ->
    [C]."""
    batched = pos.ndim == 3
    if cfg.coulomb != "ewald":
        return torch.zeros(pos.shape[:1] if batched else (),
                           dtype=pos.dtype, device=pos.device)
    if scal is None:
        scal = pair_scalars(box, cfg)
    alpha = scal[1]
    valid = row_valid(params, mol)
    A = valid.shape[-1]
    if row_pos is not None:
        p = row_pos
    elif batched:
        p = chain_rows(pos, params, mol)
    else:
        p = mol_rows(pos, params, mol)
    dr = pbc_ops.min_image(p[..., :, None, :] - p[..., None, :, :], box,
                           scal[11:20].reshape(3, 3))
    r2 = torch.sum(dr * dr, -1)
    ar = torch.arange(A, device=pos.device)
    ok = ((ar[None, :] > ar[:, None]) & valid[..., :, None]
          & valid[..., None, :])
    r = torch.sqrt(torch.where(r2 > 1e-12, r2, torch.ones_like(r2)))
    q = mol_rows(params.charge, params, mol)
    qq = q[..., :, None] * q[..., None, :]
    e = torch.where(ok, qq * torch.erf(alpha * r) / r, torch.zeros_like(r))
    return -KE * (torch.sum(e, dim=(-2, -1)) if batched else torch.sum(e))


def _self_tail(eps, sig, c6, c8, c10, cfg, rc):
    """Each site's tail coefficient with itself, T_ii: the LJ one of its
    eps and sig, or the dispersion expansion's of its own C6, C8, C10."""
    if cfg.rd_potential == "lj":
        return lj_ops.tail_coefficient(eps, sig, rc)
    return potentials.disp_tail_coefficient(c6, c8, c10, rc)


def lrc_self_coefficient(atom_alive, params, cfg, rc):
    """Self (i==i periodic images) tail term: sum_i T_ii over alive atoms
    — the RD form's T_ii also under a cdvdw repulsion, as the reference's
    (mpmc_tpu/ops/pairs.py:569-580; the per-molecule term below takes
    the repulsion's: CDVDW_LRC_TRAP in mc/metropolis.py)."""
    if not lrc_on(cfg):
        return torch.zeros((), dtype=params.eps.dtype,
                           device=params.eps.device)
    tc = _self_tail(params.eps, params.sig, params.c6, params.c8,
                    params.c10, cfg, rc)
    return torch.sum(torch.where(atom_alive, tc, torch.zeros_like(tc)))


def mol_lrc_self_coefficient(params, cfg, rc, mol):
    """Sum of self tail coefficients T_ii over one molecule's atoms
    (GCMC insert/delete LRC delta: dU = (lrc_coeff + 0.5 * this) / V);
    [C] for ``mol`` [C].  Under a cdvdw repulsion the repulsion's T_ii,
    as the reference's (mpmc_tpu/ops/pairs.py:689-695)."""
    if not lrc_on(cfg):
        return torch.zeros(getattr(mol, "shape", ()), dtype=params.eps.dtype,
                           device=params.eps.device)
    rows = {k: mol_rows(getattr(params, k), params, mol)
            for k in ("eps", "sig", "c6", "c8", "c10", "polar", "omega")}
    if cfg.cdvdw_repulsion != "none":
        s, a, w = rows["sig"], rows["polar"], rows["omega"]
        tc = potentials.cdvdw_repulsion_tail_coefficient(s, s, a, a, w, w,
                                                         rc, cfg)
    else:
        tc = _self_tail(rows["eps"], rows["sig"], rows["c6"], rows["c8"],
                        rows["c10"], cfg, rc)
    return torch.sum(torch.where(row_valid(params, mol), tc,
                                 torch.zeros_like(tc)), dim=-1)


# ---------------------------------------------------------------------------
# molecule-pair energy cache (cfg.mol_cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MolPartials:
    """Per-column-molecule partial sums of one molecule's pair pass: the
    unit of the molecule-pair energy cache (displace needs one pass,
    delete none).  [M] each (``min_r2`` 0-d) for one chain, [C, M] ([C])
    over chains."""
    rd: torch.Tensor        # sum of RD pair energies against each molecule
    es_real: torch.Tensor   # real-space Coulomb, the constant applied
    lrc: torch.Tensor       # distance-independent tail coefficients
    min_r2: torch.Tensor    # closest approach (the overlap test)


def per_molecule_sums(v, params):
    """[..., N] -> [..., M]: the sum of v over each molecule's atoms (the
    padding rows, which carry the last slot's id, left out), one
    index_add over the atoms' molecule ids (the reference takes
    differences of one cumulative sum, a segment sum for its backend)."""
    out = torch.zeros(v.shape[:-1] + (params.n_mols_max,), dtype=v.dtype,
                      device=v.device)
    v = torch.where(params.atom_ok, v, torch.zeros_like(v))
    return out.index_add_(v.ndim - 1, params.mol_id, v)


def _partials_block(rows, valid, pos, col_ok, params, cfg, temperature,
                    idx, mol, scal):
    """(rd, es raw, lrc) [B, M] and min_r2 [B] of B row sets [B, A, 3]
    against the columns of ``pos`` ([B, N, 3], or [1, N, 3] shared)."""
    rc, alpha = scal[0], scal[1]
    dr = pbc_ops.min_image(rows[:, :, None, :] - pos[:, None, :, :],
                           scal[2:11].reshape(3, 3),
                           scal[11:20].reshape(3, 3))
    r2 = torch.sum(dr * dr, dim=-1)                         # [B, A, N]
    inter = valid[:, :, None] & col_ok[:, None, :]
    act = inter & (r2 < rc * rc)
    disp, gwp = site_columns(params, cfg)
    if disp is not None:
        disp = (tuple(c[idx][..., None] for c in disp), disp)
    if gwp is not None:
        gwp = (gwp[idx][..., None], gwp)
    qc = None
    if quantum(cfg):
        t = torch.as_tensor(temperature, dtype=r2.dtype, device=r2.device)
        qc = (params.mol_mass[mol][:, None, None], params.mol_mass_atom,
              t.reshape(t.shape + (1, 1)))
    rd_u, es_u, _, tc = _tile_values(
        r2, params.charge[idx][..., None], params.eps[idx][..., None],
        params.sig[idx][..., None], params.charge, params.eps, params.sig,
        cfg, rc, alpha, qc, disp, gwp)
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)

    def seg(values, mask):
        if values is None:
            return torch.zeros((r2.shape[0], params.n_mols_max),
                               dtype=r2.dtype, device=r2.device)
        return per_molecule_sums(
            torch.sum(torch.where(mask, values, zero), dim=1), params)

    mn = torch.where(inter, r2, torch.full_like(r2, math.inf)).amin(
        dim=(1, 2))
    return seg(rd_u, act), seg(es_u, act), seg(tc, inter), mn


def mol_pair_partials(pos, box, atom_alive, params, cfg, temperature, mol,
                      row_pos=None, shared=False, scal=None) -> MolPartials:
    """mol_pair_pass reduced per column molecule instead of to scalars:
    ``sum(p.rd)`` is mol_pair_pass(...).rd, and so on.  One chain
    (``pos`` [N, 3], ``mol`` 0-d), C chains (``pos`` [C, N, 3],
    ``atom_alive`` [C, N], ``mol`` [C], ``row_pos`` [C, A, 3]) or, with
    ``shared``, one system against the rows of ``mol`` [K] (pair_matrix),
    in blocks of at most PLAIN_PAIRS pairs.  Plain PyTorch on the
    tensors' device: the reference's jnp path, outside any kernel."""
    from mpmc_tpu_torch.ops.cuda.pair_kernel import PLAIN_PAIRS
    single = pos.ndim == 2 and not shared
    mol = torch.as_tensor(mol, device=pos.device).reshape(-1)
    if pos.ndim == 2:
        pos, atom_alive = pos[None], atom_alive[None]
        if row_pos is not None and single:
            row_pos = row_pos[None]
    if scal is None:
        scal = pair_scalars(box, cfg)
    temp = torch.as_tensor(temperature, device=pos.device)
    B = mol.shape[0]
    A = params.max_atoms_per_mol
    step = max(1, PLAIN_PAIRS // max(A * pos.shape[1], 1))
    one = pos.shape[0] == 1
    outs = []
    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        m = mol[sl]
        idx = params.mol_atoms[m]                               # [b, A]
        valid = (torch.arange(A, device=pos.device)[None, :]
                 < params.mol_natoms[m][:, None])
        p = pos if one else pos[sl]
        al = atom_alive if one else atom_alive[sl]
        if row_pos is not None:
            rows = row_pos[sl]
        elif one:
            rows = p[0][idx]
        else:
            rows = p[torch.arange(p.shape[0], device=pos.device)[:, None],
                     idx]
        col_ok = al & (params.mol_id[None, :] != m[:, None])
        outs.append(_partials_block(
            rows, valid, p, col_ok, params, cfg,
            temp[sl] if temp.ndim else temp, idx, m, scal))
    rd, es, lrc, mn = (torch.cat(x) for x in zip(*outs))
    out = MolPartials(rd=rd, es_real=KE * es, lrc=lrc, min_r2=mn)
    if single:
        return MolPartials(out.rd[0], out.es_real[0], out.lrc[0],
                           out.min_r2[0])
    return out


def pair_matrix(pos, box, atom_alive, params, cfg, temperature):
    """[M, M] symmetric molecule-pair matrices (rd, es_real, lrc_coeff):
    entry (m, o) is the total pair term between molecules m and o (each
    atom pair once; diagonal zero).  Built at the first refresh
    (metropolis.initialize) from one row pass of every molecule slot
    (mol_pair_partials over the slots), a frozen molecule's row (never a
    move's target, but a column of every sorbate row) filled by symmetry.
    Kept current by the accept-time row and column scatters: entries are
    always whole pass outputs, never sums of increments, so the cache
    cannot drift."""
    M = params.n_mols_max
    p = mol_pair_partials(pos, box, atom_alive, params, cfg, temperature,
                          torch.arange(M, device=pos.device), shared=True)
    # frozen rows (mol_atoms truncates the framework to A rows) and dead
    # slots stay zero; frozen rows come back from their columns below
    ok = atom_alive[params.mol_start] & ~params.mol_frozen
    frozen = params.mol_frozen[:, None]

    def assemble(c):
        c = torch.where(ok[:, None], c, torch.zeros_like(c))
        return torch.where(frozen, c.T, c)

    return assemble(p.rd), assemble(p.es_real), assemble(p.lrc)
