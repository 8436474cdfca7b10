"""The Metropolis Monte Carlo engine (port of the non-cache scan path,
with polarization and its delayed acceptance and the NPT volume move, and
of the fused NVT/NVE, µVT, hybrid NPT and polar delayed-acceptance paths
of mpmc_tpu/mc/metropolis.py).

The fused paths run a whole chunk in one kernel launch and apply its sums,
positions and S(k) to the state: ``run_chunk_fused`` (one chain) and
``run_chunk_fused_multi`` (C stacked chains) through kernel B3
(ops/cuda/mc_kernel.run_steps: NVT, or NVE for one chain), and
``run_chunk_fused_uvt`` / ``run_chunk_fused_uvt_multi`` through kernel B1
(run_steps_uvt).  ``run_chunk_fused_npt`` interleaves B3 displacement
segments with scan-path volume attempts.  ``run_chunk_fused_uvt_polar_da``
alternates launches of kernel B6 (run_steps_uvt_pda: stage 1 of the polar
delayed acceptance, up to PDA_SEG proposals frozen at the first survivor)
with the exact SCF stage 2 of each survivor.  The rest of this docstring
describes the scan path.

One step = one row of a [K, 16] uniform table (lane layout of
mc_kernel.draw_uniforms(lanes=16), consumed as mc_kernel._kernel_uvt does;
see mc/moves.py for lanes 0-3 and 5-7):

- lane 8 picks the move type: insert if u8 < p_ins/2, delete if
  u8 < p_ins, else displace (µVT); a volume attempt if u8 <
  volume_probability, else displace (NPT); always displace otherwise;
- lane 1 gives a volume attempt's d ln V = (2 u1 - 1)
  volume_change_factor (a volume attempt reads no displacement lane);
- lane 9 picks the species of an insert/delete when there are several;
- lane 4 is the acceptance coin: Metropolis at the temperature, or under
  ensemble nve Ray's rule against the kinetic reservoir E_total - U;
- lane 12 is the stage-2 coin of the polar delayed acceptance, the lane
  the fused polar DA kernel reads (stage 1 takes lane 4);
- lane 10, under ``cavity_bias``, picks an insert's open cell of the
  grid of the last refresh (``cavity_frac``; lanes 1-3 then place the COM
  inside it), and the acceptance gains +-ln(n_open / G^3), as B1 does;
- under ``quantum_rotation`` (not nve, ``spinflip_active``) the spinflip
  move is carved out before the move types above: lane 8 < p_spin under
  nvt (as B3), lane 11 < p_spin under uvt and npt (as B1 and B6).  It
  picks a rotor (lane 0, by rank among the alive movable molecules of two
  or more sites; none is a rejection), moves nothing, and is accepted on
  lane 4 with ln_bias = -(F[1 - s] - F[s]) / T from the refresh's table
  ``rot_f``; an accept flips ``spin`` only.  With polarization the trial
  keeps the rows, field and residual, and the SCF (or under
  ``polar_delayed`` the surrogate, then the SCF) runs as for any trial.

Under ``tmmc`` (µVT, one insert species) every insert or delete attempt
adds (1, a) to row N, the species' alive count before the move, of
``state.tmmc_c``, a the unbiased acceptance probability (0 on a hard
reject; under ``polar_delayed`` the reference's estimator, ``_tmmc_a``);
``tmmc_bias`` adds eta(N') - eta(N) of ``thermo.tmmc_eta`` to the
acceptance only.

A volume attempt rescales every molecule's centre of mass and the cell
(moves.scale_volume) and re-prices the whole system (energy.total_energy,
on the card one B2 pass), then rebuilds the chunk's box constants (cutoff,
alpha, the B4 header, k-vectors and weights) from the carried box, on the
device.  With polarization its candidate takes the static field of the
new positions in the new cell (B5) and the SCF warm-started from ``mu``
with no initial residual (the reference's b_volume: under NPT the CG's
O(A N) residual is off for every move, ``_pol_resid``); under
``polar_delayed`` the surrogate filters it first, as any trial.

Under ``mol_cache`` (``cache_eligible``: nvt/uvt/nve, pairwise terms, the
dense delta path) the state carries the molecule-pair matrices
``cache_rd``, ``cache_es``, ``cache_lrc`` [M, M] (pairs.pair_matrix,
built by the first refresh; [C, M, M] over chains): a displacement prices
its new rows with one partials pass (pairs.mol_pair_partials) and takes
its old interactions from its cache row, an insert takes its partials,
a delete its row alone (no pass), and an accepted move writes its fresh
partials into its row and column.  Under ``cell_list`` with an index
attached, every per-move pass is the culled one (ops/celllist.py).

Under ``cdvdw`` every trial — a volume attempt too — recomputes the
many-body dispersion of its configuration (ops/vdw.py: the 3P x 3P
eigensolve, as the reference reruns it per candidate); its change enters
the acceptance (stage 1 under the delayed acceptance) and its value the
``vdw`` slot of an accepted trial.

The move type is the only host decision of a step without polarization:
it is read from a host copy of lanes 8 and 11, made once per chunk.  Everything
else — slot pick, trial rows, the B4 delta passes, the S(k) delta,
acceptance and the commit — stays on the device with no sync.  The commit
updates ``pos`` and ``mol_alive`` in place (one clone per chunk keeps the
caller's state intact).

With polarization a step is the reference's full-geometry step: the
trial positions and alive mask are a clone of the state's with the
molecule's rows replaced; thole.move_deltas updates the static field and
the initial CG residual in O(A N), and thole.solve_scf re-solves the
dipoles warm-started from ``mu`` (B5 in every CG iteration).  The CG
reads its gate on the host once per iteration; under ``polar_delayed``
the stage-1 test (the zodid surrogate) is read once more, and only its
survivors run the SCF.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.constants import ATM2K_A3, KE
from mpmc_tpu_torch.mc import moves
from mpmc_tpu_torch.ops import energy as energy_mod
from mpmc_tpu_torch.ops import ewald, pairs, thole, vdw as vdw_mod
from mpmc_tpu_torch.ops.cuda import mc_kernel
from mpmc_tpu_torch.state import (EnergyBreakdown, Params, SimState,
                                  chain_rows, chain_rows_update, mol_rows,
                                  mol_rows_update, row_valid, slice_chain,
                                  stack_chains, take)

# global move-type ids (stats indexing)
DISPLACE, INSERT, DELETE, VOLUME, SPINFLIP = 0, 1, 2, 3, 4
N_MOVE_TYPES = 5
N_LANES = 16


@dataclasses.dataclass
class MCStats:
    attempts: np.ndarray    # [N_MOVE_TYPES] host counts
    accepts: torch.Tensor   # [N_MOVE_TYPES] int64 on the state's device
    # SCF iterations of the chunk (host count; [C] for stacked chains)
    polar_iters: int = 0

    @classmethod
    def zero(cls, device):
        return cls(np.zeros(N_MOVE_TYPES, np.int64),
                   torch.zeros(N_MOVE_TYPES, dtype=torch.int64,
                               device=device))

    def host(self):
        """The same counts with ``accepts`` fetched to the host."""
        return MCStats(self.attempts, self.accepts.cpu().numpy(),
                       self.polar_iters)


def draw_uniforms(generator: torch.Generator, n_steps, dtype=torch.float32):
    """[K, 16] uniforms in [0, 1) on the generator's device."""
    return torch.rand((n_steps, N_LANES), generator=generator, dtype=dtype,
                      device=generator.device)


def cache_eligible(cfg: RunConfig) -> bool:
    """Static gate of the molecule-pair energy cache (``mol_cache``), the
    reference's (mpmc_tpu/mc/metropolis.py:101-116): a fixed box (no NPT
    volume rescales), pairwise terms only (no polarization, no cdvdw
    many-body re-solve), and the dense delta path (rd_crystal, the
    culled pass of cell_list and the pallas_delta kernel emit no
    per-molecule partials); not under SPECTRE, which rewrites the charges
    every corrtime (cached ES entries would go stale)."""
    return bool(cfg.mol_cache
                and cfg.ensemble in ("nvt", "uvt", "nve")
                and not cfg.polarization
                and not cfg.cdvdw
                and not cfg.rd_crystal
                and not cfg.cell_list
                and not cfg.pallas_delta
                and not cfg.spectre)


def _cache_row(carry, key, mol):
    """Row ``mol`` of a carried cache matrix: [M] for one chain, [C, M]
    over chains (``mol`` [C])."""
    cache = carry[key]
    if cache.ndim == 3:
        return cache[torch.arange(cache.shape[0], device=cache.device), mol]
    return take(cache, mol)


def _cache_commit(carry, mol, accept):
    """The accept-time symmetric row and column scatter of the candidate's
    fresh columns (rd, es_real, lrc: ``carry["cache_cols"]``, set by the
    move) into the carried cache, in place (the reference's, metropolis
    .py:852-865): row and column ``mol`` become the fresh partials where
    the move is accepted, and stay where it is not.  A candidate without
    columns (spinflip) leaves the cache as it is."""
    cols = carry.pop("cache_cols", None)
    if cols is None:
        return
    for key, col in zip(("cache_rd", "cache_es", "cache_lrc"), cols):
        cache = carry[key]
        if cache.ndim == 3:
            ar = torch.arange(cache.shape[0], device=cache.device)
            row = torch.where(accept[:, None], col, cache[ar, mol])
            cache[ar, mol] = row
            cache[ar, :, mol] = row
        else:
            row = torch.where(accept, col, take(cache, mol))
            m = mol.reshape(1)
            cache.index_copy_(0, m, row[None])
            cache.index_copy_(1, m, row[:, None])


def spinflip_active(cfg: RunConfig) -> bool:
    """Whether the spinflip move runs: quantum_rotation outside nve (Ray's
    acceptance has no term for the rotor free-energy change, the
    reference's spinflip_active, mpmc_tpu/mc/metropolis.py:118-124)."""
    return cfg.quantum_rotation and cfg.ensemble != "nve"


def make_branch_picker(cfg: RunConfig):
    """(pick(u8_host [K], u11_host [K], thermo) -> [K] branch ids,
    branch_ids): the ensemble's move table.  µVT: insert_probability split
    evenly between insert and delete; NPT: a volume attempt with
    volume_probability; every other ensemble of this slice (nvt, nve)
    displaces.  Under spinflip_active the spinflip move comes first, on
    lane 8 < p_spin under nvt (B3's carve) and on lane 11 < p_spin
    otherwise (B1's and B6's), the last branch id; quantum_rotation under
    nve warns, as the reference does, and runs without it."""
    if cfg.ensemble == "uvt" and cfg.insert_species:
        ids = [DISPLACE, INSERT, DELETE]

        def pick(u8, thermo):
            p_ins = float(thermo.insert_probability)
            return np.where(u8 < 0.5 * p_ins, 1,
                            np.where(u8 < p_ins, 2, 0))
    elif cfg.ensemble == "npt":
        ids = [DISPLACE, VOLUME]

        def pick(u8, thermo):
            return np.where(u8 < float(thermo.volume_probability), 1, 0)
    else:
        ids = [DISPLACE]

        def pick(u8, thermo):
            return np.zeros(len(u8), np.int64)
    if not spinflip_active(cfg):
        if cfg.quantum_rotation:
            import warnings
            warnings.warn("quantum_rotation spinflip moves are disabled "
                          "under ensemble nve (the rotor free-energy "
                          "change has no kinetic-reservoir counterpart)")
        return (lambda u8, u11, thermo: pick(u8, thermo)), ids
    n_base = len(ids)
    nvt = cfg.ensemble == "nvt"

    def pick_spin(u8, u11, thermo):
        p_spin = float(thermo.spinflip_probability)
        return np.where((u8 if nvt else u11) < p_spin, n_base,
                        pick(u8, thermo))
    return pick_spin, ids + [SPINFLIP]


def _host_lanes(u):
    """(lane 8, lane 11) of a [.., K, 16] table's rows as host arrays: the
    chunk's one host read."""
    h = u[..., (8, 11)].cpu().numpy()
    return h[..., 0], h[..., 1]


def _movable_mask(params: Params, mol_alive):
    return mol_alive & ~params.mol_frozen & (params.mol_species >= 0)


def _overlap_r2(min_r2, cfg):
    if cfg.cavity_autoreject_absolute > 0.0:
        thr = cfg.cavity_autoreject_absolute
        return min_r2 < thr * thr
    return torch.zeros((), dtype=torch.bool, device=min_r2.device)


def _mol_sf_rows(rows, params, mol, kv):
    """Structure factor of one molecule from explicit rows (over chains:
    ``rows`` [C, A, 3], ``mol`` [C])."""
    return ewald.mol_structure_factor(rows, mol_rows(params.charge, params,
                                                     mol),
                                      row_valid(params, mol), kv)


def _mol_sf_delta(pos, new_rows, params, mol, kv):
    """S(k) change of moving one molecule, in one evaluation: the trial
    rows enter with +q and the current rows with -q (over chains: ``pos``
    [C, N, 3], ``new_rows`` [C, A, 3], ``mol`` [C])."""
    ok = row_valid(params, mol)
    q = mol_rows(params.charge, params, mol)
    cur = (chain_rows(pos, params, mol) if pos.ndim == 3
           else mol_rows(pos, params, mol))
    return ewald.mol_structure_factor(
        torch.cat([new_rows, cur], -2), torch.cat([q, -q], -1),
        torch.cat([ok, ok], -1), kv)


def _mol_self_energy(params, cfg, rc, alpha, mol):
    """Self energy of one molecule's charges (GCMC +/- delta; [C] for
    ``mol`` [C])."""
    if cfg.coulomb not in ("ewald", "wolf"):
        return torch.zeros(getattr(mol, "shape", ()),
                           dtype=params.charge.dtype,
                           device=params.charge.device)
    q = mol_rows(params.charge, params, mol)
    q2 = torch.where(row_valid(params, mol), q * q, torch.zeros_like(q))
    coef = alpha / math.sqrt(math.pi)
    if cfg.coulomb == "wolf":
        coef = coef + torch.special.erfc(alpha * rc) / (2.0 * rc)
    return -KE * coef * torch.sum(q2, dim=-1)


def _background_delta(atom_alive, params, alpha, volume, mol, sign):
    """Jellium-background delta for inserting (sign=+1) / deleting
    (sign=-1) molecule ``mol``: c_bg [(Q + sign q_m)^2 - Q^2]; exact zero
    for neutral templates.  Over chains: ``atom_alive`` [C, N], ``mol``
    [C] -> [C]."""
    q = mol_rows(params.charge, params, mol)
    q_m = torch.sum(torch.where(row_valid(params, mol), q,
                                torch.zeros_like(q)), dim=-1)
    q_tot = torch.sum(torch.where(atom_alive, params.charge,
                                  torch.zeros_like(params.charge)), dim=-1)
    c_bg = ewald.background_coefficient(alpha, volume)
    return c_bg * (2.0 * sign * q_tot * q_m + q_m * q_m)


NPT_FROZEN_TRAP = (
    "ensemble npt with a frozen framework: a volume move rescales every "
    "molecule's centre of mass, the framework's too, but it is priced "
    "with split_frozen=True, so the frozen-frozen energy change never "
    "enters the acceptance (the trap of mpmc_tpu/mc/metropolis.py:572-581)"
    "; run NPT without frozen molecules")


CDVDW_LRC_TRAP = (
    "ensemble uvt with cdvdw_sig_repulsion or cdvdw_9th_repulsion and "
    "rd_lrc: the full-system tail adds each site's self term T_ii of the "
    "RD form (mpmc_tpu/ops/pairs.py:569-580) while an insert or delete "
    "adds the repulsion's (mpmc_tpu/ops/pairs.py:689-695, "
    "mpmc_tpu/mc/metropolis.py:458-460), so the carried energy leaves the "
    "refreshed one at every accepted insert or delete; run it with rd_lrc "
    "off")


CELL_LIST_FUSED_LRC_TRAP = (
    "fused_mc µVT under cell_list with rd_lrc: the reference's fused "
    "kernel takes its per-chunk tail constants c1 and cx from the culled "
    "pass (mpmc_tpu/mc/metropolis.py:1377-1392), which adds the "
    "framework's whole tail table whatever the alive mask "
    "(mpmc_tpu/ops/celllist.py:364-367), so cx carries the framework's "
    "tail over V on every insert and delete; run it with rd_lrc off or "
    "without fused_mc")


def check_cell_list_fused(params: Params, cfg: RunConfig):
    """Refuse the reference's fused µVT tail trap under cell_list
    (CELL_LIST_FUSED_LRC_TRAP, ValueError): an attached index and an
    active tail."""
    if cfg.cell_list and params.cell_index is not None and pairs.lrc_on(cfg):
        raise ValueError(CELL_LIST_FUSED_LRC_TRAP)


def check_cdvdw(cfg: RunConfig):
    """Refuse the reference's µVT cdvdw-repulsion tail trap
    (CDVDW_LRC_TRAP, ValueError)."""
    if (cfg.ensemble == "uvt" and cfg.cdvdw_repulsion in ("sig", "9th")
            and pairs.lrc_on(cfg)):
        raise ValueError(CDVDW_LRC_TRAP)


def check_npt(params: Params, cfg: RunConfig):
    """Refuse what the NPT volume move cannot price: a frozen molecule
    (NPT_FROZEN_TRAP, ValueError).  One host read of the frozen flags."""
    if cfg.ensemble != "npt":
        return
    if bool(params.mol_frozen.any()):
        raise ValueError(NPT_FROZEN_TRAP)


def _pol_resid(cfg: RunConfig) -> bool:
    """Whether a polar trial carries the CG's O(A N) initial residual
    (thole.residual_supported), but never under NPT: a volume attempt
    rescales every site, so no residual update exists for it, and the
    reference turns the residual off for every move of the ensemble
    (mpmc_tpu/mc/metropolis.py:306-312)."""
    return thole.residual_supported(cfg) and cfg.ensemble != "npt"


def _trial_config(carry, params: Params, mol, rows, alive_new):
    """(positions, atom alive mask) of a trial from ``carry``: molecule
    ``mol``'s rows replaced by ``rows`` (a clone of the carried
    positions), and inserted (``alive_new`` True) or deleted (False); the
    carried ones for a trial that moves nothing (``rows`` and
    ``alive_new`` None).  Over chains: [C] ``mol`` and [C, A, 3] rows."""
    pos, alive = carry["pos"], carry["alive"]
    if rows is None and alive_new is None:
        return pos, alive
    batched = pos.ndim == 3
    own = ((params.mol_id[None, :] == mol[:, None]) if batched
           else (params.mol_id == mol)) & params.atom_ok
    if alive_new is False:
        return pos, alive & ~own
    update = chain_rows_update if batched else mol_rows_update
    pos_c = update(pos.clone(), params, mol, rows)
    return pos_c, (alive | own) if alive_new is True else alive


class _Chunk:
    """Per-chunk constants of a box: cutoff, Ewald tables, kernel scalar
    header, volume.  With stacked boxes [C, 3, 3] (the NPT chains) every
    constant carries a leading [C].  A volume attempt ``rebuild``s them
    from the carried box, on the device."""

    def __init__(self, box, params, cfg, thermo):
        self.cfg, self.thermo = cfg, thermo
        self.ewald = cfg.coulomb == "ewald"
        self.lrc = pairs.lrc_on(cfg)
        self.rebuild(box)

    def rebuild(self, box):
        cfg = self.cfg
        self.rc = pairs.derived_cutoff(box, cfg)
        self.alpha = pairs.derived_alpha(self.rc, cfg)
        self.scal = pairs.pair_scalars(box, cfg)
        self.volume = torch.abs(torch.linalg.det(box))
        if self.ewald:
            self.kv = ewald.kvectors(box, cfg.ewald_kmax)
            self.recip_w = ewald.recip_weights(box, self.alpha, self.kv)
        self.box = box
        self.ln_fv = torch.log(torch.clamp(
            self.thermo.fugacity * ATM2K_A3 * self.volume[..., None],
            min=1e-300))


def _volume_trial(carry, u, thermo, c: _Chunk, params: Params,
                  cfg: RunConfig):
    """(new pos, new box, energy delta, ln_bias, (sk_re, sk_im)) of an NPT
    volume attempt from ``carry`` (the reference's b_volume,
    mpmc_tpu/mc/metropolis.py:566-595): d ln V = (2 u1 - 1)
    volume_change_factor, the cell and every centre of mass rescaled, the
    candidate's full energy (split_frozen, polarization and cdvdw off),
    and ln_bias = (n + 1) d ln V - P (V_new - V_old) / T.  Over chains
    (``u`` [C, 16], stacked carry) each chain's own d ln V and one
    total_energy per chain (on the card C B2 launches)."""
    dtype = carry["pos"].dtype
    d_lnv = (2.0 * u[..., 1] - 1.0) * thermo.volume_change_factor
    new_pos, new_box = moves.scale_volume(carry["pos"], carry["box"], params,
                                          d_lnv)
    cfg_np = dataclasses.replace(cfg, polarization=False, cdvdw=False)
    ma = carry["mol_alive"]
    if new_pos.ndim == 3:
        per = [energy_mod.total_energy(new_pos[k], new_box[k], ma[k], params,
                                       cfg_np, thermo, split_frozen=True)
               for k in range(new_pos.shape[0])]
        e_new = EnergyBreakdown.stack([e for e, _, _ in per])
        sk = ((torch.stack([a["sk_re"] for _, _, a in per]),
               torch.stack([a["sk_im"] for _, _, a in per]))
              if c.ewald else None)
    else:
        e_new, _, aux = energy_mod.total_energy(
            new_pos, new_box, ma, params, cfg_np, thermo, split_frozen=True)
        sk = (aux["sk_re"], aux["sk_im"]) if c.ewald else None
    zero = torch.zeros_like(carry["energy"].polar)
    d = e_new.sub(dataclasses.replace(carry["energy"], polar=zero, vdw=zero))
    n = torch.sum(_movable_mask(params, ma), dim=-1).to(dtype)
    v_new = torch.abs(torch.linalg.det(new_box))
    ln_bias = ((n + 1.0) * d_lnv - thermo.pressure * ATM2K_A3
               * (v_new - c.volume) / thermo.temperature)
    return new_pos, new_box, d, ln_bias, sk


def _volume_step(carry, u, thermo, c: _Chunk, params: Params,
                 cfg: RunConfig, stats, trace=None):
    """One NPT volume attempt (``_volume_trial``), accepted on lane 4, its
    positions, box, energy and S(k) committed per chain, then the chunk's
    box constants rebuilt from the carried box (no host sync without
    polarization).  Under ``cdvdw`` the candidate's dispersion is
    recomputed in the new cell; with polarization its static field (B5
    over the chains, a header per chain) and SCF (solve_scf_chains over a
    box per chain) are the new cell's, through ``polar_stage``, and
    ``polar_delayed`` filters it with the surrogate first."""
    new_pos, new_box, d, ln_bias, sk = _volume_trial(carry, u, thermo, c,
                                                     params, cfg)
    alive = carry["alive"]
    du = d.total
    iters0 = stats.polar_iters
    if cfg.cdvdw:
        vdw_new = vdw_mod.vdw_energy(new_pos, new_box, alive, params, cfg)
        du = du + (vdw_new - carry["energy"].vdw)
    pol = cfg.polarization
    if pol:
        field = (thole.static_field_chains if new_pos.ndim == 3
                 else thole.static_field)
        pol_t = polar_stage(
            carry, c, params, cfg, thermo, u, None, None, None, du, ln_bias,
            torch.zeros_like(ln_bias, dtype=torch.bool), stats,
            trial=(new_pos, alive,
                   field(new_pos, new_box, alive, params, cfg), new_box))
        du = du + pol_t["d_polar"]
    if pol and cfg.polar_delayed:
        accept = polar_accept(pol_t, u, thermo)
    else:
        accept = (torch.log(torch.clamp(u[..., 4], min=1e-38))
                  < ln_bias - du / thermo.temperature)
    a3 = accept.reshape(accept.shape + (1, 1))
    carry["pos"] = torch.where(a3, new_pos, carry["pos"])
    carry["box"] = torch.where(a3, new_box, carry["box"])
    new_energy = carry["energy"].add(d)
    if cfg.cdvdw:
        new_energy = dataclasses.replace(new_energy, vdw=vdw_new)
    if pol:
        new_energy = polar_commit(carry, pol_t, accept, new_energy, cfg)
    carry["energy"] = new_energy.select(accept, carry["energy"])
    if c.ewald:
        a1 = accept.reshape(accept.shape + (1,))
        carry["sk_re"] = torch.where(a1, sk[0], carry["sk_re"])
        carry["sk_im"] = torch.where(a1, sk[1], carry["sk_im"])
    c.rebuild(carry["box"])
    stats.attempts[..., VOLUME] += 1
    stats.accepts[..., VOLUME] += accept.to(torch.int64)
    if trace is not None:
        rec = {"mol": None, "rows": None, "accept": accept,
               "reject": torch.zeros_like(accept), "ln_bias": ln_bias,
               "d": d, "box": new_box}
        if cfg.cdvdw:
            rec["vdw"] = vdw_new
        if pol:
            rec.update(pol_t, iters=stats.polar_iters - iters0)
        trace.append(rec)


def polar_trial(carry, c: _Chunk, params: Params, cfg: RunConfig, mol,
                rows, alive_new, spin=False):
    """(trial pos, trial alive, trial e0, initial residual or None) of
    moving (``alive_new`` None), inserting (True) or deleting (False)
    molecule ``mol`` to ``rows``, from ``carry``'s pos, alive, e0, mu,
    r_pol and S(k): the O(A N) move_deltas where the field is delta-able
    (with the CG's initial residual where ``_pol_resid``), else a rebuilt
    static field.  The carry's tensors are left as they are.
    Over chains: a carry of [C]-stacked tensors, ``mol`` [C] and ``rows``
    [C, A, 3] (one molecule per chain).  ``spin``: a spinflip's trial,
    which moves nothing: the carry's positions, field and residual (the
    reference's b_spinflip candidate), the field rebuilt where it is not
    delta-able."""
    pos, alive = carry["pos"], carry["alive"]
    field = (thole.static_field_chains if pos.ndim == 3
             else thole.static_field)
    resid = _pol_resid(cfg)
    if spin:
        if not thole.field_delta_supported(cfg):
            return pos, alive, field(pos, c.box, alive, params, cfg), None
        return pos, alive, carry["e0"], carry["r_pol"] if resid else None
    pos_c, alive_c = _trial_config(carry, params, mol, rows, alive_new)
    if not thole.field_delta_supported(cfg):
        return pos_c, alive_c, field(pos_c, c.box, alive_c, params,
                                     cfg), None
    e0_new, r0 = thole.move_deltas(
        pos, c.box, alive, params, cfg, mol, carry["e0"], carry["mu"],
        carry["r_pol"], new_rows=rows, insert=alive_new is True,
        delete=alive_new is False, with_residual=resid,
        sk=(carry["sk_re"], carry["sk_im"]) if c.ewald else None)
    return pos_c, alive_c, e0_new, r0


def polar_stage(carry, c: _Chunk, params: Params, cfg: RunConfig, thermo,
                u, mol, rows, alive_new, du, ln_bias, reject, stats,
                spin=False, trial=None):
    """The polar part of a step (make_step_fn's, and over [C]
    make_batched_step_fn's) for the trial of polar_trial, given its
    non-polar ``du``, ``ln_bias`` and ``reject``: the SCF of the trial
    (solve_scf, or solve_scf_chains over every chain's CG rounds at
    once), its iterations added to ``stats.polar_iters``.  Under
    ``polar_delayed`` (not nve: Ray's rule has no Boltzmann split) the
    zodid surrogate filters the trial first and only stage-1 survivors
    solve, after one host read of the stage-1 test (a bool, or a [C]
    vector whose survivors are the solve's active chains); the others
    keep mu and the residual and count no iteration, the numbers the
    reference's per-chain select gives.  Returns a dict: the trial's
    ``e0``, ``mu``, residual ``r``, polar energy ``polar`` and
    ``d_polar``, and under polar_delayed ``acc1`` and ``d_surr``.
    ``spin``: a spinflip's trial (polar_trial).  ``trial``: a volume
    attempt's (positions, atom alive, static field, cell) instead — the
    rescaled configuration, solved in its own cell from ``mu`` with no
    initial residual (the reference's b_volume)."""
    if trial is None:
        pos_c, alive_c, e0_new, r0 = polar_trial(carry, c, params, cfg, mol,
                                                 rows, alive_new, spin)
        box_t = c.box
    else:
        (pos_c, alive_c, e0_new, box_t), r0 = trial, None
    batched = pos_c.ndim == 3
    mu_new = carry["mu"]
    r_new = (carry["r_pol"] if _pol_resid(cfg)
             else torch.zeros_like(mu_new))
    out = {"e0": e0_new}
    survivors = None
    if cfg.polar_delayed and cfg.ensemble != "nve":
        d_surr = (thole.zodid_energy(e0_new, alive_c, params)
                  - thole.zodid_energy(carry["e0"], carry["alive"], params))
        acc1 = (~reject) & (torch.log(torch.clamp(u[..., 4], min=1e-38))
                            < ln_bias - (du + d_surr) / thermo.temperature)
        out.update(acc1=acc1, d_surr=d_surr)
        # the step's host read: which trials' SCF runs
        survivors = tuple(np.flatnonzero(acc1.cpu().numpy()).tolist())
    if survivors is None or survivors:
        if batched:
            mu_s, iters, r_s = thole.solve_scf_chains(
                pos_c, box_t, alive_c, params, cfg, e0_new, mu0=mu_new,
                r0=r0, active=survivors)
        else:
            mu_s, iters, r_s = thole.solve_scf(
                pos_c, box_t, alive_c, params, cfg, e0_new, mu0=mu_new,
                r0=r0)
        stats.polar_iters = stats.polar_iters + iters
        if r_s is None:              # jacobi / direct solvers
            r_s = torch.zeros_like(mu_new)
        if survivors is None:
            mu_new, r_new = mu_s, r_s
        else:
            keep = acc1.reshape(acc1.shape + (1, 1))
            mu_new = torch.where(keep, mu_s, mu_new)
            r_new = torch.where(keep, r_s, r_new)
    pol_new = thole.polar_energy(mu_new, e0_new)
    out.update(mu=mu_new, r=r_new, polar=pol_new,
               d_polar=pol_new - carry["energy"].polar)
    return out


def polar_accept(pol, u, thermo):
    """Stage 2 of the delayed acceptance: only the exact-vs-surrogate
    polar difference remains; stage-1 rejects carry acc1 = False."""
    return pol["acc1"] & (torch.log(torch.clamp(u[..., 12], min=1e-38))
                          < -(pol["d_polar"] - pol["d_surr"])
                          / thermo.temperature)


def polar_commit(carry, pol, accept, new_energy, cfg: RunConfig):
    """Carry the accepted trials' e0, mu and residual; returns
    ``new_energy`` with the trial's polar term."""
    keep = accept.reshape(accept.shape + (1, 1))
    carry["e0"] = torch.where(keep, pol["e0"], carry["e0"])
    carry["mu"] = torch.where(keep, pol["mu"], carry["mu"])
    if _pol_resid(cfg):
        carry["r_pol"] = torch.where(keep, pol["r"], carry["r_pol"])
    return dataclasses.replace(new_energy, polar=pol["polar"])


def cavity_frac(carry, u):
    """Fractional COM of a cavity-biased insert, or None without cavity
    bias: the open cell of rank j among the chunk's open cells (lane 10,
    j = min(floor(u n_open), n_open - 1)), then a uniform point inside it
    (lanes 1-3, moves.cell_frac).  With no open cell the pick is cell 0
    and the insert is rejected.  Over chains each chain picks in its own
    grid."""
    if "cav" not in carry:
        return None
    cell, _ = moves.pick_by_rank(carry["cav"], u[..., 10])
    return moves.cell_frac(cell, u, carry["cav_g"])


def tmmc_on(cfg: RunConfig) -> bool:
    """Whether the step collects the TMMC matrix: µVT with one insert
    species (the macrostate N is that species' alive count)."""
    return (cfg.tmmc and cfg.ensemble == "uvt"
            and len(cfg.insert_species) == 1)


def _tmmc_state(carry, params, cfg, thermo, t):
    """(N before the move [...], the flat-histogram tilt eta(N') - eta(N)
    of the acceptance or 0) of an insert (t = 1) or delete (t = 2): N' =
    N +- 1 clipped to eta's rows; the tilt only under tmmc_bias with a
    bias table."""
    n_cur = torch.sum(carry["mol_alive"]
                      & (params.mol_species == cfg.insert_species[0]),
                      dim=-1)
    eta = thermo.tmmc_eta
    if not (cfg.tmmc_bias and eta is not None):
        return n_cur, torch.zeros((), dtype=cfg.tdtype, device=n_cur.device)
    n_to = torch.clamp(n_cur + (1 if t == 1 else -1), 0, eta.shape[0] - 1)
    return n_cur, (eta[n_to] - eta[n_cur]).to(cfg.tdtype)


def _tmmc_a(pol_t, reject, ln_acc, ln_bias, du, d_eta, pol_da, thermo):
    """The probability the TMMC matrix collects for one attempt: the
    unbiased min(1, e^{ln_acc}), 0 on a hard reject; under the delayed
    acceptance the reference's estimator 1{stage-1 accept} min(1, a1) /
    min(1, a1 e^{d_eta}) min(1, a2) (mpmc_tpu/mc/metropolis.py:805-821),
    a1 from the non-polar ``du`` and the surrogate, a2 the exact
    stage-2 factor."""
    zero = torch.zeros_like(ln_acc)
    if not pol_da:
        return torch.where(reject, zero, torch.exp(torch.clamp(ln_acc,
                                                               max=0.0)))
    ln1 = ln_bias - (du + pol_t["d_surr"]) / thermo.temperature
    ln2 = -(pol_t["d_polar"] - pol_t["d_surr"]) / thermo.temperature
    x = torch.exp(torch.clamp(ln1, max=0.0) - torch.clamp(ln1 + d_eta,
                                                          max=0.0)
                  + torch.clamp(ln2, max=0.0))
    return torch.where(pol_t["acc1"], x, zero)


def _tmmc_add(tm, n_cur, t, a):
    """Add (1, a) to row ``n_cur`` of the insert (t = 1) or delete (t = 2)
    columns of the TMMC matrix ``tm`` [K, 4] (over chains [C, K, 4] with
    [C] rows and probabilities), on the device."""
    col = 0 if t == 1 else 2
    n = n_cur.reshape(-1)
    cols = torch.cat([torch.full_like(n, col), torch.full_like(n, col + 1)])
    vals = torch.cat([torch.ones_like(a.reshape(-1)), a.reshape(-1)]).to(
        tm.dtype)
    if tm.ndim == 3:
        ar = torch.arange(tm.shape[0], device=tm.device)
        tm.index_put_((torch.cat([ar, ar]), torch.cat([n, n]), cols), vals,
                      accumulate=True)
    else:
        tm.index_put_((torch.cat([n, n]), cols), vals, accumulate=True)


def _move_passes(params: Params, cfg: RunConfig, cache_mode: bool):
    """(displace pass, insert pass, delete pass) of a step builder, one
    chain or C: a displacement's (d_rd, d_es, the trial's min_r2) from
    two mol_pair_pass calls, or under the molecule-pair cache from the
    trial's partials against the cache row; an insert's and a delete's
    inter PairTerms from mol_pair_pass, or under the cache from the
    trial's partials (insert) and the cache row alone (delete: no pass).
    Under the cache each records its fresh columns for the accept's
    scatter (the displacement's tail column is its row: tails do not
    depend on r; a delete's are zeros)."""
    def displace_pass(carry, thermo, c, mol, rows):
        pos, alive = carry["pos"], carry["alive"]
        if not cache_mode:
            old = pairs.mol_pair_pass(pos, c.box, alive, params, cfg,
                                      thermo.temperature, mol, scal=c.scal)
            new = pairs.mol_pair_pass(pos, c.box, alive, params, cfg,
                                      thermo.temperature, mol, row_pos=rows,
                                      scal=c.scal)
            return new.rd - old.rd, new.es_real - old.es_real, new.min_r2
        new = pairs.mol_pair_partials(pos, c.box, alive, params, cfg,
                                      thermo.temperature, mol, row_pos=rows,
                                      scal=c.scal)
        carry["cache_cols"] = (new.rd, new.es_real,
                               _cache_row(carry, "cache_lrc", mol))
        return (torch.sum(new.rd, -1)
                - torch.sum(_cache_row(carry, "cache_rd", mol), -1),
                torch.sum(new.es_real, -1)
                - torch.sum(_cache_row(carry, "cache_es", mol), -1),
                new.min_r2)

    def insert_pass(carry, thermo, c, slot, rows):
        if not cache_mode:
            return pairs.mol_pair_pass(carry["pos"], c.box, carry["alive"],
                                       params, cfg, thermo.temperature,
                                       slot, row_pos=rows, scal=c.scal)
        p = pairs.mol_pair_partials(carry["pos"], c.box, carry["alive"],
                                    params, cfg, thermo.temperature, slot,
                                    row_pos=rows, scal=c.scal)
        carry["cache_cols"] = (p.rd, p.es_real, p.lrc)
        return pairs.PairTerms(
            rd=torch.sum(p.rd, -1), es_real=torch.sum(p.es_real, -1),
            es_excl=torch.zeros_like(p.min_r2),
            lrc_coeff=torch.sum(p.lrc, -1), min_r2=p.min_r2)

    def delete_pass(carry, thermo, c, slot):
        if not cache_mode:
            return pairs.mol_pair_pass(carry["pos"], c.box, carry["alive"],
                                       params, cfg, thermo.temperature,
                                       slot, scal=c.scal)
        rows = [_cache_row(carry, k, slot)
                for k in ("cache_rd", "cache_es", "cache_lrc")]
        carry["cache_cols"] = tuple(torch.zeros_like(r) for r in rows)
        rd, es, lrc = (torch.sum(r, -1) for r in rows)
        return pairs.PairTerms(rd=rd, es_real=es,
                               es_excl=torch.zeros_like(rd), lrc_coeff=lrc,
                               min_r2=torch.full_like(rd, math.inf))

    return displace_pass, insert_pass, delete_pass


def make_step_fn(params: Params, cfg: RunConfig):
    """The single-step function of this (params, cfg):
    step(carry, u, t, thermo, c, stats, trace=None) with ``carry`` a dict
    of the mutable state (pos, mol_alive updated in place; energy, sk and
    the polar tensors replaced; under NPT box and pos replaced by a
    volume attempt), ``u`` the step's [16] uniform row, ``t`` the
    host-chosen branch index, ``c`` the chunk's _Chunk constants (rebuilt
    in place by a volume attempt); ``stats`` accumulates in place.  A
    ``trace`` list gets one dict per step with the trial and its decision
    (the tests replay them)."""
    if cfg.ensemble not in ("uvt", "nvt", "nve", "npt"):
        raise NotImplementedError(
            f"ensemble {cfg.ensemble} is not yet ported — ROADMAP A12b")
    check_npt(params, cfg)
    check_cdvdw(cfg)
    dtype = cfg.tdtype
    nve = cfg.ensemble == "nve"
    dev = params.device
    pol = cfg.polarization
    cdvdw = cfg.cdvdw
    # delayed acceptance (polar_stage)
    pol_da = pol and cfg.polar_delayed and not nve
    zero = torch.zeros((), dtype=dtype, device=dev)
    species = (torch.as_tensor(cfg.insert_species, dtype=torch.int64,
                               device=dev)
               if cfg.insert_species else None)
    n_sp = len(cfg.insert_species)
    cav = cfg.cavity_bias
    tm_on = tmmc_on(cfg)
    # the molecule-pair cache: displace prices its old interactions from
    # the cache row (one partials pass), delete from the row alone (none)
    cache_mode = cache_eligible(cfg)
    _displace_pass, _insert_pass, _delete_pass = _move_passes(params, cfg,
                                                              cache_mode)

    def eb(rd=zero, lrc=zero, es_real=zero, es_recip=zero, es_self=zero,
           es_excl=zero):
        return EnergyBreakdown(rd, lrc, es_real, es_recip, es_self, es_excl,
                               zero, zero)

    def recip(c, carry, d_re, d_im):
        new_re = carry["sk_re"] + d_re
        new_im = carry["sk_im"] + d_im
        e_new = ewald.recip_energy_w(new_re, new_im, *c.recip_w)
        return new_re, new_im, e_new - carry["energy"].es_recip

    def pick_species(u):
        if n_sp == 1:
            return species[0]
        j = torch.clamp((u[9] * n_sp).to(torch.int64), max=n_sp - 1)
        return take(species, j)

    def self_and_lrc(c, slot, lrc_coeff):
        """(self energy, LRC delta) of molecule ``slot`` appearing: its
        charges' self term and (pair tail sum + half its own) / V."""
        d_lrc = zero
        if c.lrc:
            own = pairs.mol_lrc_self_coefficient(params, cfg, c.rc, slot)
            d_lrc = (lrc_coeff + 0.5 * own) / c.volume
        return _mol_self_energy(params, cfg, c.rc, c.alpha, slot), d_lrc

    def b_displace(carry, u, thermo, c):
        pos = carry["pos"]
        mol, cnt = moves.pick_by_rank(
            _movable_mask(params, carry["mol_alive"]), u[0])
        rows = moves.displace_rows(pos, params, mol, u,
                                   thermo.move_factor, thermo.rot_factor)
        d_rd, d_es, min_r2 = _displace_pass(carry, thermo, c, mol, rows)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        if c.ewald:
            sk = recip(c, carry, *_mol_sf_delta(pos, rows, params, mol,
                                                c.kv))
        d = eb(rd=d_rd, es_real=d_es, es_recip=sk[2])
        reject = (cnt == 0) | _overlap_r2(min_r2, cfg)
        return mol, rows, None, d, zero, reject, sk

    def b_insert(carry, u, thermo, c):
        pos, mol_alive = carry["pos"], carry["mol_alive"]
        si = pick_species(u)
        slot, free = moves.pick_by_rank(
            ~mol_alive & (params.mol_species == si), u[0])
        frac = cavity_frac(carry, u)
        rows = moves.place_rows(params, slot, si, u, c.box, frac=frac)
        inter = _insert_pass(carry, thermo, c, slot, rows)
        intra = pairs.intra_terms(pos, c.box, params, cfg, slot,
                                  row_pos=rows, scal=c.scal)
        d_self, d_lrc = self_and_lrc(c, slot, inter.lrc_coeff)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        if c.ewald:
            sk = recip(c, carry, *_mol_sf_rows(rows, params, slot, c.kv))
            d_self = d_self + _background_delta(
                carry["alive"], params, c.alpha, c.volume, slot, 1.0)
        d = eb(rd=inter.rd, lrc=d_lrc, es_real=inter.es_real,
               es_recip=sk[2], es_self=d_self, es_excl=intra)
        n_s = torch.sum(mol_alive & (params.mol_species == si)).to(dtype)
        ln_bias = (take(c.ln_fv, si)
                   - torch.log(thermo.temperature * (n_s + 1.0)))
        reject = (free == 0) | _overlap_r2(inter.min_r2, cfg)
        if cav:
            ln_bias = ln_bias + carry["cav_lnf"]
            reject = reject | (carry["cav_n"] == 0)
        return slot, rows, True, d, ln_bias, reject, sk

    def b_delete(carry, u, thermo, c):
        pos, mol_alive = carry["pos"], carry["mol_alive"]
        si = pick_species(u)
        slot, cnt = moves.pick_by_rank(
            _movable_mask(params, mol_alive) & (params.mol_species == si),
            u[0])
        inter = _delete_pass(carry, thermo, c, slot)
        intra = pairs.intra_terms(pos, c.box, params, cfg, slot,
                                  scal=c.scal)
        d_self, d_lrc = self_and_lrc(c, slot, inter.lrc_coeff)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        d_bg = zero
        if c.ewald:
            o_re, o_im = _mol_sf_rows(mol_rows(pos, params, slot), params,
                                      slot, c.kv)
            sk = recip(c, carry, -o_re, -o_im)
            # quadratic in Q: not the negated insert delta
            d_bg = _background_delta(carry["alive"], params, c.alpha,
                                     c.volume, slot, -1.0)
        d = eb(rd=-inter.rd, lrc=-d_lrc, es_real=-inter.es_real,
               es_recip=sk[2], es_self=-d_self + d_bg, es_excl=-intra)
        n_s = torch.sum(mol_alive & (params.mol_species == si)).to(dtype)
        ln_bias = (torch.log(torch.clamp(n_s, min=1e-30)
                             * thermo.temperature) - take(c.ln_fv, si))
        if cav:
            ln_bias = ln_bias - carry["cav_lnf"]
        return slot, None, False, d, ln_bias, cnt == 0, sk

    def b_spinflip(carry, u, thermo, c):
        """The reference's b_spinflip (mpmc_tpu/mc/metropolis.py:599-627):
        a rotor by rank (lane 0), d_f = F[1 - s] - F[s] of the refresh's
        table, no pair pass and no S(k) delta."""
        mol, cnt = moves.pick_by_rank(
            _movable_mask(params, carry["mol_alive"])
            & (params.mol_natoms >= 2), u[0])
        s_cur = take(carry["spin"], mol).to(torch.int64)
        f = take(carry["rot_f"], mol)
        d_f = take(f, 1 - s_cur) - take(f, s_cur)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        return mol, None, None, eb(), -d_f / thermo.temperature, cnt == 0, sk

    branches = ([b_displace, b_insert, b_delete]
                if cfg.ensemble == "uvt" and cfg.insert_species
                else [b_displace])
    if cfg.ensemble == "npt":
        branches = [b_displace, None]          # the volume move (_volume_step)
    _, branch_ids = make_branch_picker(cfg)
    if branch_ids[-1] == SPINFLIP:
        branches = branches + [b_spinflip]

    def step(carry, u, t, thermo, c, stats, trace=None):
        if branch_ids[t] == VOLUME:
            _volume_step(carry, u, thermo, c, params, cfg, stats, trace)
            return
        spin = branch_ids[t] == SPINFLIP
        mol, rows, alive_new, d, ln_bias, reject, sk = branches[t](
            carry, u, thermo, c)
        du = d.total
        if cdvdw:
            # the trial's many-body dispersion, recomputed in full
            pos_v, alive_v = _trial_config(carry, params, mol, rows,
                                           alive_new)
            vdw_new = vdw_mod.vdw_energy(pos_v, c.box, alive_v, params, cfg)
            du = du + (vdw_new - carry["energy"].vdw)
        du_np = du
        iters0 = stats.polar_iters
        # TMMC: N before the move and the flat-histogram tilt, which
        # enters the acceptance (stage 1 under the delayed acceptance),
        # never the collection
        tm = tm_on and t in (1, 2)
        d_eta = zero
        if tm:
            n_cur, d_eta = _tmmc_state(carry, params, cfg, thermo, t)
        if pol:
            pol_t = polar_stage(carry, c, params, cfg, thermo, u, mol, rows,
                                alive_new, du,
                                ln_bias + d_eta if tm else ln_bias, reject,
                                stats, spin)
            du = du + pol_t["d_polar"]
        if nve:
            # Ray's microcanonical rule (reference metropolis.py:756-777):
            # the reservoir K = E_total - U (U with the frozen part, the
            # convention of total_energy) weights configurations as
            # K^(F/2 - 1), F the kinetic DOF of the alive movable molecules
            k_old = thermo.nve_energy - (carry["energy"].total
                                         + carry["u_frozen"])
            k_new = k_old - du
            f_dof = torch.sum(torch.where(
                _movable_mask(params, carry["mol_alive"]), params.mol_dof,
                zero))
            live = (k_new > 0) & (k_old > 0)
            one = torch.ones_like(k_new)
            ln_acc = torch.where(
                live, (0.5 * f_dof - 1.0)
                * (torch.log(torch.where(live, k_new, one))
                   - torch.log(torch.where(live, k_old, one))),
                torch.full_like(k_new, -math.inf))
        else:
            ln_acc = ln_bias - du / thermo.temperature
        if pol_da:
            accept = polar_accept(pol_t, u, thermo)
        else:
            accept = (~reject) & (torch.log(torch.clamp(u[4], min=1e-38))
                                  < (ln_acc + d_eta if tm else ln_acc))
        if tm:
            _tmmc_add(carry["tmmc_c"], n_cur, t, _tmmc_a(
                pol_t if pol else None, reject, ln_acc, ln_bias, du_np,
                d_eta, pol_da, thermo))
        if rows is not None:
            cur = mol_rows(carry["pos"], params, mol)
            mol_rows_update(carry["pos"], params, mol,
                            torch.where(accept, rows, cur))
        if alive_new is not None:
            ma = carry["mol_alive"]
            ma.index_put_((mol.reshape(1),), torch.where(
                accept, alive_new, take(ma, mol)).reshape(1))
            carry["alive"] = ma[params.mol_id] & params.atom_ok
        new_energy = carry["energy"].add(d)
        if cdvdw:
            new_energy = dataclasses.replace(new_energy, vdw=vdw_new)
        if pol:
            new_energy = polar_commit(carry, pol_t, accept, new_energy, cfg)
        carry["energy"] = new_energy.select(accept, carry["energy"])
        if cache_mode:
            _cache_commit(carry, mol, accept)
        if c.ewald:
            carry["sk_re"] = torch.where(accept, sk[0], carry["sk_re"])
            carry["sk_im"] = torch.where(accept, sk[1], carry["sk_im"])
        if spin:
            cur = take(carry["spin"], mol)
            carry["spin"].index_put_((mol.reshape(1),), torch.where(
                accept, 1 - cur, cur).reshape(1))
        gid = branch_ids[t]
        stats.attempts[gid] += 1
        stats.accepts[gid] += accept.to(torch.int64)
        if trace is not None:
            rec = {"mol": mol, "rows": rows, "accept": accept,
                   "reject": reject, "ln_bias": ln_bias, "d": d}
            if cdvdw:
                rec["vdw"] = vdw_new
            if pol:
                rec.update(pol_t, iters=stats.polar_iters - iters0)
            trace.append(rec)

    return step


def _carry(state: SimState, params: Params, cfg: RunConfig):
    """The mutable state of a chunk (single chain, or [C]-stacked chains):
    clones of ``pos`` and ``mol_alive``, the rest as it is."""
    carry = {"pos": state.pos.clone(), "mol_alive": state.mol_alive.clone(),
             "box": state.box, "energy": state.energy, "sk_re": state.sk_re,
             "sk_im": state.sk_im, "mu": state.mu, "e0": state.e0,
             "r_pol": state.r_pol}
    carry["alive"] = (carry["mol_alive"][..., params.mol_id]
                      & params.atom_ok)
    carry["u_frozen"] = (state.e_frozen.total if state.e_frozen is not None
                         else torch.zeros(state.pos.shape[:-2],
                                          dtype=cfg.tdtype,
                                          device=state.pos.device))
    if (cfg.cavity_bias and state.cavity_open is None) or (
            tmmc_on(cfg) and state.tmmc_c is None):
        raise ValueError("cavity_bias / tmmc: the state has no cavity grid "
                         "or TMMC matrix — initialize it first")
    if cfg.cavity_bias:
        # the grid of the last refresh, and its n_open and
        # ln(n_open / G^3) for every insert and delete of the chunk
        carry["cav"] = state.cavity_open
        carry["cav_g"] = cfg.cavity_grid
        carry["cav_n"] = torch.sum(state.cavity_open, dim=-1)
        carry["cav_lnf"] = (torch.log(torch.clamp(
            carry["cav_n"].to(cfg.tdtype), min=1e-30))
            - math.log(float(cfg.cavity_grid) ** 3))
    if tmmc_on(cfg):
        carry["tmmc_c"] = state.tmmc_c.clone()
    if cache_eligible(cfg):
        if state.cache_rd is None:
            raise ValueError("mol_cache: the state has no molecule-pair "
                             "cache — initialize it first")
        for k in ("cache_rd", "cache_es", "cache_lrc"):
            carry[k] = getattr(state, k).clone()
    if spinflip_active(cfg):
        if state.spin is None or state.rot_f is None:
            raise ValueError("quantum_rotation: the state has no spins or "
                             "rotor table — build them first "
                             "(run.qrot_init)")
        carry["spin"] = state.spin.clone()
        carry["rot_f"] = state.rot_f
    return carry


def _from_carry(state: SimState, carry, n_steps: int) -> SimState:
    """``state`` with a chunk's carry written back, ``n_steps`` on."""
    return state.replace(pos=carry["pos"], box=carry["box"],
                         mol_alive=carry["mol_alive"],
                         energy=carry["energy"], sk_re=carry["sk_re"],
                         sk_im=carry["sk_im"], mu=carry["mu"],
                         e0=carry["e0"], r_pol=carry["r_pol"],
                         tmmc_c=carry.get("tmmc_c", state.tmmc_c),
                         spin=carry.get("spin", state.spin),
                         cache_rd=carry.get("cache_rd", state.cache_rd),
                         cache_es=carry.get("cache_es", state.cache_es),
                         cache_lrc=carry.get("cache_lrc", state.cache_lrc),
                         step=state.step + n_steps)


def chunk_setup(state: SimState, params: Params, cfg: RunConfig,
                thermo: Thermo, uniforms):
    """(step, carry, consts, branch ids [K] on the host, stats) for a
    chunk over the uniform table ``uniforms`` — everything the step loop
    needs, after the chunk's one host sync (the copy of lanes 8 and 11).  The
    carry holds clones of ``pos`` and ``mol_alive``, the box, and the
    table as ``carry["u"]`` on the state's device."""
    u = uniforms.to(device=state.pos.device, dtype=cfg.tdtype)
    pick, _ = make_branch_picker(cfg)
    branch = pick(*_host_lanes(u), thermo)
    carry = _carry(state, params, cfg)
    carry["u"] = u
    return (make_step_fn(params, cfg), carry,
            _Chunk(state.box, params, cfg, thermo), branch,
            MCStats.zero(state.pos.device))


def run_chunk(state: SimState, params: Params, cfg: RunConfig,
              thermo: Thermo, n_steps: int, generator=None, uniforms=None):
    """Run ``n_steps`` Metropolis steps; returns (state, MCStats).

    The [n_steps, 16] uniform table is ``uniforms`` when given (tests
    inject it), else drawn from ``generator`` (a torch.Generator on the
    state's device)."""
    if uniforms is None:
        uniforms = draw_uniforms(generator, n_steps, cfg.tdtype)
    step, carry, c, branch, stats = chunk_setup(state, params, cfg, thermo,
                                                uniforms)
    uniforms = carry["u"]
    for k in range(n_steps):
        step(carry, uniforms[k], int(branch[k]), thermo, c, stats)
    return _from_carry(state, carry, n_steps), stats


# ---------------------------------------------------------------------------
# Batched scan chains: C chains, one step of each per row of a [C, K, 16]
# table (parallel/multichain.run_chunk_batched)
# ---------------------------------------------------------------------------

def make_batched_step_fn(params: Params, cfg: RunConfig):
    """The step of C stacked chains (the scan step of ``make_step_fn``
    over a leading [C]; the reference vmaps its step over chains):
    step(carry, u, t, thermo, c, stats, trace=None) with ``carry`` a dict
    of [C]-stacked tensors (pos [C,N,3] and mol_alive [C,M] updated in
    place), ``u`` the step's [C, 16] uniform rows, ``t`` the branch index
    every chain shares, ``c`` the chunk's _Chunk (box shared; ``ln_fv``
    [S] or [C, S]).  ``thermo.temperature`` may be [C] (one per chain).
    Each chain picks its own target, trial and coin from its own row and
    is accepted by its own mask; ``stats`` counts accepts per chain.  No
    host sync without polarization.

    With polarization the step is ``make_step_fn``'s polar step over [C]
    (the reference vmaps it): polar_trial over the chains (one batched
    move_deltas), then thole.solve_scf_chains — every chain's CG rounds
    together, each chain stopping at its own gate, one host read of the
    [C] gate vector a round; ``stats.polar_iters`` counts per chain.
    Under ``polar_delayed`` the stage-1 test of every chain is read once
    (one [C] vector) and only its survivors solve: the others keep mu
    and the residual and count no iteration, which are the numbers the
    reference's per-chain select gives.

    Under NPT every chain has its own box (``carry["box"]`` [C, 3, 3], a
    ``c`` with [C] constants: the B4 header [C, 20], k-vectors [C, Nk,
    3], recip weights per chain); a volume step is every chain's attempt
    at once (the move type is shared), each with its own d ln V and
    acceptance, and with polarization each chain's static field and SCF
    in its own new cell (B5 over the chains with a header per chain).
    Under ``cdvdw`` each chain's trial dispersion is one batched
    eigensolve over the chains."""
    if cfg.ensemble not in ("uvt", "nvt", "nve", "npt"):
        raise NotImplementedError(
            f"ensemble {cfg.ensemble} is not yet ported — ROADMAP A12b")
    check_npt(params, cfg)
    check_cdvdw(cfg)
    dtype = cfg.tdtype
    nve = cfg.ensemble == "nve"
    dev = params.device
    pol = cfg.polarization
    cdvdw = cfg.cdvdw
    pol_da = pol and cfg.polar_delayed and not nve
    species = (torch.as_tensor(cfg.insert_species, dtype=torch.int64,
                               device=dev)
               if cfg.insert_species else None)
    n_sp = len(cfg.insert_species)
    cav = cfg.cavity_bias
    tm_on = tmmc_on(cfg)
    cache_mode = cache_eligible(cfg)     # make_step_fn's, per chain
    _displace_pass, _insert_pass, _delete_pass = _move_passes(params, cfg,
                                                              cache_mode)

    def recip(c, carry, d_re, d_im):
        new_re = carry["sk_re"] + d_re
        new_im = carry["sk_im"] + d_im
        e_new = ewald.recip_energy_w(new_re, new_im, *c.recip_w)
        return new_re, new_im, e_new - carry["energy"].es_recip

    def pick_species(u):
        if n_sp == 1:
            return species[0].expand(u.shape[0])
        j = torch.clamp((u[:, 9] * n_sp).to(torch.int64), max=n_sp - 1)
        return species[j]

    def ln_fv(c, si):
        if c.ln_fv.ndim == 1:
            return c.ln_fv[si]
        return c.ln_fv[torch.arange(si.shape[0], device=dev), si]

    def self_and_lrc(c, slot, lrc_coeff, zero):
        d_lrc = zero
        if c.lrc:
            own = pairs.mol_lrc_self_coefficient(params, cfg, c.rc, slot)
            d_lrc = (lrc_coeff + 0.5 * own) / c.volume
        return _mol_self_energy(params, cfg, c.rc, c.alpha, slot), d_lrc

    def eb(zero, rd=None, lrc=None, es_real=None, es_recip=None,
           es_self=None, es_excl=None):
        z = [zero if x is None else x
             for x in (rd, lrc, es_real, es_recip, es_self, es_excl)]
        return EnergyBreakdown(*z, zero, zero)

    def b_displace(carry, u, thermo, c, zero):
        pos = carry["pos"]
        mol, cnt = moves.pick_by_rank(
            _movable_mask(params, carry["mol_alive"]), u[:, 0])
        rows = moves.displace_rows(pos, params, mol, u, thermo.move_factor,
                                   thermo.rot_factor)
        d_rd, d_es, min_r2 = _displace_pass(carry, thermo, c, mol, rows)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        if c.ewald:
            sk = recip(c, carry, *_mol_sf_delta(pos, rows, params, mol,
                                                c.kv))
        d = eb(zero, rd=d_rd, es_real=d_es, es_recip=sk[2])
        reject = (cnt == 0) | _overlap_r2(min_r2, cfg)
        return mol, rows, None, d, zero, reject, sk

    def b_insert(carry, u, thermo, c, zero):
        pos, mol_alive = carry["pos"], carry["mol_alive"]
        si = pick_species(u)
        same = params.mol_species[None, :] == si[:, None]
        slot, free = moves.pick_by_rank(~mol_alive & same, u[:, 0])
        frac = cavity_frac(carry, u)
        rows = moves.place_rows(params, slot, si, u, c.box, frac=frac)
        inter = _insert_pass(carry, thermo, c, slot, rows)
        intra = pairs.intra_terms(pos, c.box, params, cfg, slot,
                                  row_pos=rows, scal=c.scal)
        d_self, d_lrc = self_and_lrc(c, slot, inter.lrc_coeff, zero)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        if c.ewald:
            sk = recip(c, carry, *_mol_sf_rows(rows, params, slot, c.kv))
            d_self = d_self + _background_delta(
                carry["alive"], params, c.alpha, c.volume, slot, 1.0)
        d = eb(zero, rd=inter.rd, lrc=d_lrc, es_real=inter.es_real,
               es_recip=sk[2], es_self=d_self, es_excl=intra)
        n_s = torch.sum(mol_alive & same, dim=-1).to(dtype)
        ln_bias = ln_fv(c, si) - torch.log(thermo.temperature * (n_s + 1.0))
        reject = (free == 0) | _overlap_r2(inter.min_r2, cfg)
        if cav:
            ln_bias = ln_bias + carry["cav_lnf"]
            reject = reject | (carry["cav_n"] == 0)
        return slot, rows, True, d, ln_bias, reject, sk

    def b_delete(carry, u, thermo, c, zero):
        pos, mol_alive = carry["pos"], carry["mol_alive"]
        si = pick_species(u)
        same = params.mol_species[None, :] == si[:, None]
        slot, cnt = moves.pick_by_rank(
            _movable_mask(params, mol_alive) & same, u[:, 0])
        inter = _delete_pass(carry, thermo, c, slot)
        intra = pairs.intra_terms(pos, c.box, params, cfg, slot,
                                  scal=c.scal)
        d_self, d_lrc = self_and_lrc(c, slot, inter.lrc_coeff, zero)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        d_bg = zero
        if c.ewald:
            o_re, o_im = _mol_sf_rows(chain_rows(pos, params, slot), params,
                                      slot, c.kv)
            sk = recip(c, carry, -o_re, -o_im)
            d_bg = _background_delta(carry["alive"], params, c.alpha,
                                     c.volume, slot, -1.0)
        d = eb(zero, rd=-inter.rd, lrc=-d_lrc, es_real=-inter.es_real,
               es_recip=sk[2], es_self=-d_self + d_bg, es_excl=-intra)
        n_s = torch.sum(mol_alive & same, dim=-1).to(dtype)
        ln_bias = (torch.log(torch.clamp(n_s, min=1e-30)
                             * thermo.temperature) - ln_fv(c, si))
        if cav:
            ln_bias = ln_bias - carry["cav_lnf"]
        return slot, None, False, d, ln_bias, cnt == 0, sk

    def b_spinflip(carry, u, thermo, c, zero):
        """make_step_fn's b_spinflip per chain."""
        mol, cnt = moves.pick_by_rank(
            _movable_mask(params, carry["mol_alive"])
            & (params.mol_natoms >= 2), u[:, 0])
        ar = torch.arange(mol.shape[0], device=dev)
        s_cur = carry["spin"][ar, mol].to(torch.int64)
        f = carry["rot_f"][ar, mol]                                  # [C,2]
        d_f = f[ar, 1 - s_cur] - f[ar, s_cur]
        sk = (carry["sk_re"], carry["sk_im"], zero)
        return (mol, None, None, eb(zero), -d_f / thermo.temperature,
                cnt == 0, sk)

    branches = ([b_displace, b_insert, b_delete]
                if cfg.ensemble == "uvt" and cfg.insert_species
                else [b_displace])
    if cfg.ensemble == "npt":
        branches = [b_displace, None]          # the volume move (_volume_step)
    _, branch_ids = make_branch_picker(cfg)
    if branch_ids[-1] == SPINFLIP:
        branches = branches + [b_spinflip]

    def step(carry, u, t, thermo, c, stats, trace=None):
        if branch_ids[t] == VOLUME:
            _volume_step(carry, u, thermo, c, params, cfg, stats, trace)
            return
        spin = branch_ids[t] == SPINFLIP
        C = u.shape[0]
        zero = torch.zeros(C, dtype=dtype, device=dev)
        mol, rows, alive_new, d, ln_bias, reject, sk = branches[t](
            carry, u, thermo, c, zero)
        du = d.total
        if cdvdw:
            # the trial's many-body dispersion, recomputed in full
            pos_v, alive_v = _trial_config(carry, params, mol, rows,
                                           alive_new)
            vdw_new = vdw_mod.vdw_energy(pos_v, c.box, alive_v, params, cfg)
            du = du + (vdw_new - carry["energy"].vdw)
        du_np = du
        iters0 = stats.polar_iters
        tm = tm_on and t in (1, 2)     # make_step_fn's TMMC, per chain
        d_eta = zero
        if tm:
            n_cur, d_eta = _tmmc_state(carry, params, cfg, thermo, t)
        if pol:
            pol_t = polar_stage(carry, c, params, cfg, thermo, u, mol, rows,
                                alive_new, du,
                                ln_bias + d_eta if tm else ln_bias, reject,
                                stats, spin)
            du = du + pol_t["d_polar"]
        if nve:
            # Ray's microcanonical rule per chain (make_step_fn's)
            k_old = thermo.nve_energy - (carry["energy"].total
                                         + carry["u_frozen"])
            k_new = k_old - du
            f_dof = torch.sum(torch.where(
                _movable_mask(params, carry["mol_alive"]), params.mol_dof,
                torch.zeros((), dtype=dtype, device=dev)), dim=-1)
            live = (k_new > 0) & (k_old > 0)
            one = torch.ones_like(k_new)
            ln_acc = torch.where(
                live, (0.5 * f_dof - 1.0)
                * (torch.log(torch.where(live, k_new, one))
                   - torch.log(torch.where(live, k_old, one))),
                torch.full_like(k_new, -math.inf))
        else:
            ln_acc = ln_bias - du / thermo.temperature
        if pol_da:
            accept = polar_accept(pol_t, u, thermo)
        else:
            accept = (~reject) & (torch.log(torch.clamp(u[:, 4],
                                                        min=1e-38))
                                  < (ln_acc + d_eta if tm else ln_acc))
        if tm:
            _tmmc_add(carry["tmmc_c"], n_cur, t, _tmmc_a(
                pol_t if pol else None, reject, ln_acc, ln_bias, du_np,
                d_eta, pol_da, thermo))
        ar = torch.arange(C, device=dev)
        if rows is not None:
            idx = params.mol_atoms[mol]                       # [C, A]
            cur = carry["pos"][ar[:, None], idx]
            carry["pos"].index_put_(
                (ar[:, None].expand_as(idx), idx),
                torch.where(accept[:, None, None], rows, cur))
        if alive_new is not None:
            ma = carry["mol_alive"]
            ma[ar, mol] = torch.where(accept, alive_new, ma[ar, mol])
            carry["alive"] = ma[:, params.mol_id] & params.atom_ok
        new_energy = carry["energy"].add(d)
        if cdvdw:
            new_energy = dataclasses.replace(new_energy, vdw=vdw_new)
        if pol:
            new_energy = polar_commit(carry, pol_t, accept, new_energy, cfg)
        carry["energy"] = new_energy.select(accept, carry["energy"])
        if cache_mode:
            _cache_commit(carry, mol, accept)
        if c.ewald:
            carry["sk_re"] = torch.where(accept[:, None], sk[0],
                                         carry["sk_re"])
            carry["sk_im"] = torch.where(accept[:, None], sk[1],
                                         carry["sk_im"])
        if spin:
            cur = carry["spin"][ar, mol]
            carry["spin"][ar, mol] = torch.where(accept, 1 - cur, cur)
        gid = branch_ids[t]
        stats.attempts[:, gid] += 1
        stats.accepts[:, gid] += accept.to(torch.int64)
        if trace is not None:
            rec = {"mol": mol, "rows": rows, "accept": accept,
                   "reject": reject, "ln_bias": ln_bias, "d": d}
            if cdvdw:
                rec["vdw"] = vdw_new
            if pol:
                rec.update(pol_t, iters=stats.polar_iters - iters0)
            trace.append(rec)

    return step


def batched_chunk_setup(states: SimState, params: Params, cfg: RunConfig,
                        thermo: Thermo, uniforms):
    """(step, carry, consts, branch ids [K] on the host, stats) for a
    chunk of the stacked ``states`` over the [C, K, 16] table
    ``uniforms``: ``chunk_setup`` over chains.  Every chain takes the
    move type of chain 0's lanes 8 and 11 (the reference's shared
    move-type draw: a move type per step for the batch, targets and coins
    per chain), read in the chunk's one host sync.  The carry holds the
    chains' mu, e0 and r_pol (the polar step's); ``stats.polar_iters`` is
    [C].  The
    constants are chain 0's box's (every ensemble but NPT shares the box),
    under NPT each chain's ([C] constants)."""
    u = uniforms.to(device=states.pos.device, dtype=cfg.tdtype)
    C = states.pos.shape[0]
    pick, _ = make_branch_picker(cfg)
    branch = pick(*_host_lanes(u[0]), thermo)
    carry = _carry(states, params, cfg)
    carry["u"] = u
    dev = states.pos.device
    stats = MCStats(np.zeros((C, N_MOVE_TYPES), np.int64),
                    torch.zeros((C, N_MOVE_TYPES), dtype=torch.int64,
                                device=dev), np.zeros(C, np.int64))
    box = states.box if cfg.ensemble == "npt" else states.box[0]
    return (make_batched_step_fn(params, cfg), carry,
            _Chunk(box, params, cfg, thermo), branch, stats)


# ---------------------------------------------------------------------------
# Fused paths: the k-table both kernels read
# ---------------------------------------------------------------------------

def _fused_ktable(box, cfg, alpha):
    """(kvecs [Nk,3], folded coefficients [Nk]) for the fused kernel's S(k)
    delta, or (None, None) outside ewald: KE (2 pi / V) w exp(-k^2/4a^2)
    / k^2 with the half-space pair weight w = 2, so dE_recip is a plain
    dot with |S + dS|^2 - |S|^2."""
    if cfg.coulomb != "ewald":
        return None, None
    kv = ewald.kvectors(box, cfg.ewald_kmax)
    k2 = torch.sum(kv * kv, dim=-1)
    k2s = torch.where(k2 > 1e-12, k2, torch.ones_like(k2))
    vol = torch.abs(torch.linalg.det(box))
    kcoef = (KE * (2.0 * math.pi / vol) * 2.0
             * torch.exp(-k2 / (4.0 * alpha * alpha)) / k2s)
    return kv, torch.where(k2 > 1e-12, kcoef, torch.zeros_like(kcoef))


def _mol_mass_plane(params: Params, cfg: RunConfig):
    """The fused kernels' molecule-mass column plane (each atom's
    molecular mass) under a Feynman-Hibbs/Kleinert correction, else
    None."""
    return params.mol_mass_atom if mc_kernel.quantum_option(cfg) else None


def _form_kw(params: Params, cfg: RunConfig):
    """The fused kernels' form columns (pairs.site_columns): ``disp``, the
    (c6, c8, c10) columns under disp_expansion, and ``gwp``, the GWP
    widths under coulomb gwp, each None where off."""
    disp, gwp = pairs.site_columns(params, cfg)
    return dict(disp=disp, gwp=gwp)


# ---------------------------------------------------------------------------
# Fused NVT/NVE path (kernel B3, ops/cuda/mc_kernel.run_steps)
# ---------------------------------------------------------------------------

def nvt_fused_tables(params: Params, mol_alive):
    """Tables of the fused NVT kernel, built once per run on the host
    (aliveness never changes under NVT): (mv_start [Mv] int32, mv_natoms
    [Mv] int32, a_max, mv_slots [Mv] int64, f_dof), the tensors on the
    params' device; ``f_dof`` is the kinetic degrees of freedom of the
    alive movable molecules (the NVE exponent is f_dof/2 - 1)."""
    start, natoms, a_max, slots = mc_kernel.movable_mols(params, mol_alive)
    f_dof = float(params.mol_dof.cpu().numpy().astype(np.float64)[slots]
                  .sum())
    dev = params.device
    return (torch.as_tensor(start, device=dev),
            torch.as_tensor(natoms, device=dev), a_max,
            torch.as_tensor(slots, dtype=torch.int64, device=dev), f_dof)


def fused_nvt_launch_args(states: SimState, params: Params, cfg: RunConfig,
                          thermo: Thermo, uniforms, tables):
    """(args, kwargs) of mc_kernel.run_steps (or its plain version) for a
    chunk of the stacked ``states`` over the [C, K, 16] table ``uniforms``
    (reference _fused_chunk_nvt and _fused_chunk_nvt_multi).  The chains
    share the box, the parameters and the aliveness of chain 0; the
    temperature may carry a leading [C] (one beta per chain), the move
    sizes are chain 0's.  Under NVE the kinetic reservoir at chunk entry
    is nve_energy - (U + U_frozen) per chain, re-derived from the energy
    totals at every chunk."""
    mv_start, mv_natoms, a_max, _, f_dof = tables
    C = states.pos.shape[0]
    box = states.box[0]
    rc = pairs.derived_cutoff(box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    kv, kcoef = _fused_ktable(box, cfg, alpha)
    betas = (1.0 / thermo.temperature).reshape(-1).expand(C).contiguous()
    alive = states.mol_alive[0][params.mol_id] & params.atom_ok
    thr = cfg.cavity_autoreject_absolute
    ew = cfg.coulomb == "ewald"
    args = (states.pos, alive, params.eps, params.sig, params.charge,
            params.mass, mv_start, mv_natoms, box, rc, alpha, betas,
            thermo.move_factor.reshape(-1)[0],
            thermo.rot_factor.reshape(-1)[0], thr * thr,
            uniforms.to(device=states.pos.device,
                        dtype=cfg.tdtype).contiguous(), cfg)
    kw = dict(kvecs=kv, kcoef=kcoef,
              sk_re=states.sk_re.contiguous() if ew else None,
              sk_im=states.sk_im.contiguous() if ew else None, a_max=a_max,
              mol_mass=_mol_mass_plane(params, cfg), **_form_kw(params, cfg))
    if cfg.ensemble == "nve":
        u = states.energy.total
        if states.e_frozen is not None:
            u = u + states.e_frozen.total
        kw.update(nve_k0=(thermo.nve_energy - u).double(),
                  nve_g=0.5 * f_dof - 1.0)
    if spinflip_active(cfg):
        kw.update(_spin_kw(states, tables[3], cfg, thermo))
    return args, kw


def _spin_kw(states, order, cfg, thermo):
    """The fused kernels' spinflip keywords for the stacked ``states``:
    each chain's rotor table in the kernels' dtype and its spins, in the
    kernel's molecule (B3) or slot (B1) order ``order``, and p_spin (a
    device scalar: no host sync)."""
    return dict(rot_f=states.rot_f[:, order].to(cfg.tdtype).contiguous(),
                spin=states.spin[:, order].contiguous(),
                p_spin=thermo.spinflip_probability)


def _spin_back(states, order, spin_out):
    """``states`` with the kernel's spins [C, len(order)] written back."""
    spin = states.spin.clone()
    spin[:, order] = spin_out
    return states.replace(spin=spin)


def _apply_fused_nvt(states, sums, new_pos, sk_re, sk_im, cfg, n_steps):
    """(stacked state, MCStats with [C,5] counts) after a B3 launch: the
    sums' energy deltas (rd, es_real, es_recip; the self, exclusion and
    tail terms do not change under rigid moves), positions and S(k).  The
    attempts are known on the host (no sync) but under spinflip, whose
    carve moves attempts from DISPLACE to SPINFLIP: one host copy of the
    chains' spinflip attempts."""
    d = sums.to(states.pos.dtype)
    e = states.energy
    energy = dataclasses.replace(
        e, rd=e.rd + d[:, 0], es_real=e.es_real + d[:, 1],
        es_recip=e.es_recip + d[:, 2])
    C = sums.shape[0]
    attempts = np.zeros((C, N_MOVE_TYPES), np.int64)
    attempts[:, DISPLACE] = n_steps
    accepts = torch.zeros((C, N_MOVE_TYPES), dtype=torch.int64,
                          device=sums.device)
    accepts[:, DISPLACE] = sums[:, 3].to(torch.int64)
    if spinflip_active(cfg):
        att_sp = sums[:, 5].cpu().numpy().astype(np.int64)
        attempts[:, DISPLACE] -= att_sp
        attempts[:, SPINFLIP] = att_sp
        accepts[:, SPINFLIP] = sums[:, 4].to(torch.int64)
    new = states.replace(pos=new_pos, energy=energy,
                         step=states.step + n_steps)
    if cfg.coulomb == "ewald":
        new = new.replace(sk_re=sk_re.contiguous(), sk_im=sk_im.contiguous())
    return new, MCStats(attempts, accepts)


def run_chunk_fused_multi(states: SimState, params: Params, cfg: RunConfig,
                          thermo: Thermo, n_steps: int, generator=None,
                          uniforms=None, tables=None):
    """K NVT steps for C stacked chains in ONE launch of B3.  Returns
    (states, MCStats with [C,5] counts).  ``thermo.temperature`` may carry
    a leading [C] (per-chain temperatures, as the reference's
    ``thermo_batched``).

    The [C, K, 16] uniform table is ``uniforms`` when given (tests inject
    it), else drawn from ``generator`` (a torch.Generator on the states'
    device): each chain gets its own rows.  ``tables``: a
    ``nvt_fused_tables`` result to reuse across chunks.  The caller has
    checked mc_kernel.supported_multi(cfg, params) (or, for one chain,
    mc_kernel.supported)."""
    if tables is None:
        tables = nvt_fused_tables(params, states.mol_alive[0])
    if uniforms is None:
        uniforms = torch.rand((states.pos.shape[0], n_steps, N_LANES),
                              generator=generator, dtype=cfg.tdtype,
                              device=generator.device)
    args, kw = fused_nvt_launch_args(states, params, cfg, thermo, uniforms,
                                     tables)
    out = mc_kernel.run_steps(*args, **kw)
    new, stats = _apply_fused_nvt(states, out[1], out[0], out[2], out[3],
                                  cfg, n_steps)
    if spinflip_active(cfg):
        new = _spin_back(new, tables[3], out[4])
    return new, stats


def run_chunk_fused(state: SimState, params: Params, cfg: RunConfig,
                    thermo: Thermo, n_steps: int, generator=None,
                    uniforms=None, tables=None):
    """K NVT (or NVE) translate+rotate steps of one chain in ONE launch of
    B3 — the single-chain form of ``run_chunk_fused_multi`` (C = 1).
    ``uniforms``: an injected [K, 16] table; returns (state, MCStats)."""
    if uniforms is not None:
        uniforms = uniforms.reshape(1, n_steps, N_LANES)
    states, stats = run_chunk_fused_multi(
        stack_chains([state]), params, cfg, thermo, n_steps,
        generator=generator, uniforms=uniforms, tables=tables)
    return slice_chain(states, 0), MCStats(stats.attempts[0],
                                           stats.accepts[0])


def run_chunk_fused_npt(state: SimState, params: Params, cfg: RunConfig,
                        thermo: Thermo, n_steps: int, generator=None,
                        uniforms=None, tables=None):
    """K NPT steps as B3 displacement segments interleaved with scan-path
    volume attempts — the hybrid fused NPT path (the reference's
    run_chunk_fused_npt and _fused_npt_segment,
    mpmc_tpu/mc/metropolis.py:1256-1336).  B3 cannot price a volume move
    (it shifts every coordinate and re-prices every term), so the chunk
    runs n_v = round(pv K) volume attempts (pv = volume_probability, read
    once on the host) spaced evenly, divmod(K - n_v, n_v) displacement
    steps before each; each part leaves the NPT distribution invariant,
    so their fixed-order composition samples it too.  A segment's launch
    takes rc, alpha and the k-table from the box it starts in
    (fused_nvt_launch_args), so a volume attempt needs no cache rebuilt.
    Returns (state, MCStats); ``state.step`` advances by exactly K.

    The [K, 16] uniform table is ``uniforms`` when given (tests inject
    it), else drawn from ``generator``: each segment takes its next rows,
    each volume attempt the next one (lanes 1 and 4 as on the scan
    path).  ``tables``: an ``nvt_fused_tables`` result to reuse across
    chunks (NPT never changes aliveness).  The caller has checked
    mc_kernel.supported_npt(cfg, params)."""
    if uniforms is None:
        uniforms = draw_uniforms(generator, n_steps, cfg.tdtype)
    uniforms = uniforms.to(device=state.pos.device, dtype=cfg.tdtype)
    if tables is None:
        tables = nvt_fused_tables(params, state.mol_alive)
    cfg_nvt = dataclasses.replace(cfg, ensemble="nvt")
    pv = float(thermo.volume_probability)
    n_v = int(round(pv * n_steps))
    if n_v <= 0:
        return run_chunk_fused(state, params, cfg_nvt, thermo, n_steps,
                               uniforms=uniforms, tables=tables)
    step = make_step_fn(params, cfg)
    stats = MCStats.zero(state.pos.device)
    base, rem = divmod(n_steps - n_v, n_v)
    row = 0
    for s in range(n_v):
        n_disp = base + 1 if s < rem else base
        if n_disp > 0:
            state, s2 = run_chunk_fused(state, params, cfg_nvt, thermo,
                                        n_disp,
                                        uniforms=uniforms[row:row + n_disp],
                                        tables=tables)
            stats.attempts += s2.attempts
            stats.accepts += s2.accepts
            row += n_disp
        carry = _carry(state, params, cfg)
        step(carry, uniforms[row], 1, thermo,
             _Chunk(state.box, params, cfg, thermo), stats)
        state = _from_carry(state, carry, 1)
        row += 1
    return state, stats


# ---------------------------------------------------------------------------
# Fused µVT path (kernel B1, ops/cuda/mc_kernel.run_steps_uvt)
# ---------------------------------------------------------------------------

def uvt_fused_tables(params: Params, cfg: RunConfig):
    """Slot and template tables of the fused µVT kernel, built once per
    run on the host: (slots [Ms] int64, slot_start [Ms] int32,
    species_idx [Ms] int32, tmpl [S,A,3], natoms [S] int32, A_list,
    rep_slots), tensors on the params' device.  ``rep_slots[s]`` = two
    distinct slots of species s (the second -1 when it has one slot), the
    molecules ``_uvt_chunk_consts`` evaluates."""
    slots, slot_start, species_idx, A_list = mc_kernel.movable_slots(
        params, cfg.insert_species)
    A = max(A_list)
    species_pos = params.species_pos.cpu().numpy()
    tmpl = np.zeros((len(A_list), A, 3), np.float64)
    rep_slots = []
    for s, si in enumerate(cfg.insert_species):
        tp = species_pos[si][:A_list[s]]
        tmpl[s, :A_list[s]] = tp
        tmpl[s, A_list[s]:] = tp[:1]
        own = slots[species_idx == s]
        rep_slots.append((int(own[0]), int(own[1]) if len(own) >= 2 else -1))
    dev = params.device
    return (torch.as_tensor(slots, dtype=torch.int64, device=dev),
            torch.as_tensor(slot_start, device=dev),
            torch.as_tensor(species_idx, device=dev),
            torch.as_tensor(tmpl, dtype=params.charge.dtype, device=dev),
            torch.as_tensor(np.asarray(A_list, np.int32), device=dev),
            A_list, tuple(rep_slots))


def _uvt_chunk_consts(pos, box, params, thermo, cfg, A_list, rep_slots):
    """Per-chunk per-species constants of the fused µVT kernel: ([S]
    d_self, [S] d_excl, [S] c1, [S,S] cx, [S] lnfv — [C, S] for a
    per-chain ``thermo.fugacity`` [C, n_species] —, kvecs, kcoef), from
    the same helpers the scan path's insert and delete use, so both paths
    agree term by term.  The LRC coefficients pair a representative slot
    with the frozen atoms (c1) and with a slot of each species (cx); on
    the card they run through B4.  Under cell_list with an index and a
    tail it refuses the reference's trap (check_cell_list_fused)."""
    check_cell_list_fused(params, cfg)
    S = len(A_list)
    rc = pairs.derived_cutoff(box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    kv, kcoef = _fused_ktable(box, cfg, alpha)
    volume = torch.abs(torch.linalg.det(box))
    dtype, dev = pos.dtype, pos.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    a_cap = params.max_atoms_per_mol
    lrc_on = pairs.lrc_on(cfg)
    frozen_atoms = params.mol_frozen[params.mol_id] & params.atom_ok
    # the tail coefficients below do not depend on the temperature (a
    # ladder's [C] would not fit one molecule's pass)
    temp = thermo.temperature.reshape(-1)[0]
    d_self, d_excl, c1, lnfv, cx = [], [], [], [], []
    for s in range(S):
        si = cfg.insert_species[s]
        A = A_list[s]
        s0 = rep_slots[s][0]
        d_self.append(_mol_self_energy(params, cfg, rc, alpha, s0))
        tp = params.species_pos[si][:A]
        tmpl_rows = torch.cat([tp, tp[:1].expand(a_cap - A, 3)])
        d_excl.append(pairs.intra_terms(pos, box, params, cfg, s0,
                                        row_pos=tmpl_rows.to(dtype)))
        f = thermo.fugacity[..., si] * ATM2K_A3
        lnfv.append(torch.log(torch.clamp(f * volume, min=1e-300)))
        if lrc_on:
            own = pairs.mol_lrc_self_coefficient(params, cfg, rc, s0)
            c_mf = pairs.mol_pair_pass(pos, box, frozen_atoms, params, cfg,
                                       temp, s0).lrc_coeff
            c1.append((c_mf + 0.5 * own) / volume)
            row = []
            for t in range(S):
                other = rep_slots[t][0] if t != s else rep_slots[s][1]
                if other < 0:
                    row.append(zero)
                    continue
                other_atoms = (params.mol_id == other) & params.atom_ok
                row.append(pairs.mol_pair_pass(
                    pos, box, other_atoms, params, cfg, temp,
                    s0).lrc_coeff / volume)
            cx.append(torch.stack(row))
        else:
            c1.append(zero)
            cx.append(torch.zeros(S, dtype=dtype, device=dev))
    return (torch.stack(d_self), torch.stack(d_excl), torch.stack(c1),
            torch.stack(cx), torch.stack(lnfv, -1), kv, kcoef)


def _apply_fused(states, sums, slots, slot_alive, new_pos, sk_re, sk_im,
                 cfg, n_steps):
    """(stacked state, MCStats with [C,5] counts) after a fused launch:
    the sums' energy deltas, the slot table's alive row, positions and
    S(k).  One host copy of the attempt counts (spinflip's among them)."""
    d = sums.to(states.pos.dtype)
    e = states.energy
    energy = dataclasses.replace(
        e, rd=e.rd + d[:, 0], es_real=e.es_real + d[:, 1],
        es_recip=e.es_recip + d[:, 2], es_self=e.es_self + d[:, 3],
        es_excl=e.es_excl + d[:, 4], lrc=e.lrc + d[:, 5])
    mol_alive = states.mol_alive.clone()
    mol_alive[:, slots] = slot_alive
    C = sums.shape[0]
    attempts = np.zeros((C, N_MOVE_TYPES), np.int64)
    att = sums[:, 9:14].cpu().numpy().astype(np.int64)
    attempts[:, :3] = att[:, :3]
    attempts[:, SPINFLIP] = att[:, 4]
    accepts = torch.zeros((C, N_MOVE_TYPES), dtype=torch.int64,
                          device=sums.device)
    accepts[:, :3] = sums[:, 6:9].to(torch.int64)
    accepts[:, SPINFLIP] = sums[:, 12].to(torch.int64)
    new = states.replace(pos=new_pos, mol_alive=mol_alive, energy=energy,
                         step=states.step + n_steps)
    if cfg.coulomb == "ewald":
        new = new.replace(sk_re=sk_re.contiguous(), sk_im=sk_im.contiguous())
    return new, MCStats(attempts, accepts)


def fused_uvt_launch_args(states: SimState, params: Params,
                          cfg: RunConfig, thermo: Thermo, uniforms, tables):
    """(args, kwargs) of mc_kernel.run_steps_uvt (or its plain version)
    for a chunk of the stacked ``states`` over the [C, K, 16] table
    ``uniforms``, with the per-species constants of this chunk.  They
    come from chain 0: they depend only on the shared box, fugacities and
    frozen framework, never on sorbate positions.  ``thermo.temperature``
    may be [C] (a temperature ladder: one beta per chain) and
    ``thermo.fugacity`` [C, n_species] (a fugacity ladder: one ln(f V)
    row per chain); otherwise every chain gets the same."""
    slots, slot_start, species_idx, tmpl, natoms, A_list, rep_slots = tables
    C = states.pos.shape[0]
    box = states.box[0]
    rc = pairs.derived_cutoff(box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    d_self, d_excl, c1, cx, lnfv, kv, kcoef = _uvt_chunk_consts(
        states.pos[0], box, params, thermo, cfg, A_list, rep_slots)
    betas = (1.0 / thermo.temperature).expand(C).contiguous()
    lnfvs = lnfv.expand(C, len(A_list)).contiguous()
    alive = states.mol_alive[:, params.mol_id] & params.atom_ok[None]
    thr = cfg.cavity_autoreject_absolute
    ew = cfg.coulomb == "ewald"
    args = (states.pos, alive, params.eps, params.sig, params.charge,
            params.mass, slot_start, species_idx,
            states.mol_alive[:, slots].contiguous(), tmpl, natoms, box, rc,
            alpha, betas, thermo.move_factor, thermo.rot_factor, thr * thr,
            thermo.insert_probability, lnfvs, d_self, d_excl, c1, cx,
            uniforms.to(device=states.pos.device,
                        dtype=cfg.tdtype).contiguous(), cfg)
    kw = dict(kvecs=kv, kcoef=kcoef,
              sk_re=states.sk_re.contiguous() if ew else None,
              sk_im=states.sk_im.contiguous() if ew else None,
              mol_mass=_mol_mass_plane(params, cfg), **_form_kw(params, cfg))
    kw.update(_fused_extras(states, cfg, thermo))
    if spinflip_active(cfg):
        kw.update(_spin_kw(states, slots, cfg, thermo))
    return args, kw


def _fused_extras(states, cfg, thermo):
    """B1's cavity and TMMC keywords for a chunk of the stacked ``states``
    (run_steps_uvt): each chain's open-cell list from the grid of its last
    refresh, a zeroed [C, K, 4] delta of the TMMC matrix, and under
    tmmc_bias the shared eta (None: no tilt yet)."""
    kw = {}
    if cfg.cavity_bias:
        if states.cavity_open is None:
            raise ValueError("cavity_bias: the state has no cavity grid — "
                             "initialize it first")
        kw["cav_list"], kw["cav_n"] = mc_kernel.pack_cavity(
            states.cavity_open)
    if cfg.tmmc:
        if states.tmmc_c is None:
            raise ValueError("tmmc: the state has no TMMC matrix — "
                             "initialize it first")
        kw["tmmc_out"] = torch.zeros(states.tmmc_c.shape, dtype=torch.float64,
                                     device=states.pos.device)
        if cfg.tmmc_bias and thermo.tmmc_eta is not None:
            kw["eta"] = thermo.tmmc_eta.to(states.pos.device,
                                           cfg.tdtype).contiguous()
    return kw


def run_chunk_fused_uvt_multi(states: SimState, params: Params,
                              cfg: RunConfig, thermo: Thermo, n_steps: int,
                              generator=None, uniforms=None, tables=None):
    """K GCMC steps for C stacked chains (state fields with a leading [C],
    parallel/multichain.stack_states) in ONE launch of B1.  Returns
    (states, MCStats with [C,5] counts).

    The [C, K, 16] uniform table is ``uniforms`` when given (tests inject
    it), else drawn from ``generator`` (a torch.Generator on the states'
    device): each chain gets its own rows.  ``tables``: a
    ``uvt_fused_tables`` result to reuse across chunks.  The caller has
    checked mc_kernel.supported_uvt_multi(cfg, params)."""
    if tables is None:
        tables = uvt_fused_tables(params, cfg)
    if uniforms is None:
        uniforms = torch.rand((states.pos.shape[0], n_steps, N_LANES),
                              generator=generator, dtype=cfg.tdtype,
                              device=generator.device)
    args, kw = fused_uvt_launch_args(states, params, cfg, thermo, uniforms,
                                     tables)
    out = mc_kernel.run_steps_uvt(*args, **kw)
    new_pos, slot_alive, sums, sk_re, sk_im = out[:5]
    new, stats = _apply_fused(states, sums, tables[0], slot_alive, new_pos,
                              sk_re, sk_im, cfg, n_steps)
    if spinflip_active(cfg):
        new = _spin_back(new, tables[0], out[5])
    if cfg.tmmc:       # the chunk's collection, added to each chain's
        new = new.replace(tmmc_c=states.tmmc_c + kw["tmmc_out"].to(
            states.tmmc_c.dtype))
    return new, stats


def run_chunk_fused_uvt(state: SimState, params: Params, cfg: RunConfig,
                        thermo: Thermo, n_steps: int, generator=None,
                        uniforms=None, tables=None):
    """K GCMC steps (displace | insert | delete) of one chain in ONE launch
    of B1 — the single-chain form of ``run_chunk_fused_uvt_multi`` (C =
    1).  ``uniforms``: an injected [K, 16] table; returns (state,
    MCStats)."""
    if uniforms is not None:
        uniforms = uniforms.reshape(1, n_steps, N_LANES)
    states, stats = run_chunk_fused_uvt_multi(
        stack_chains([state]), params, cfg, thermo, n_steps,
        generator=generator, uniforms=uniforms, tables=tables)
    return slice_chain(states, 0), MCStats(stats.attempts[0],
                                           stats.accepts[0])


# ---------------------------------------------------------------------------
# Fused polar delayed acceptance (kernel B6, mc_kernel.run_steps_uvt_pda)
# ---------------------------------------------------------------------------

def _pda_tilt(state: SimState, params: Params, cfg: RunConfig,
              thermo: Thermo):
    """(N, eta(N + 1) - eta(N), eta(N - 1) - eta(N)) at the state's count N
    of the TMMC species, on the device — the tilts of B6's stage-1 test
    under tmmc_bias (0 without a bias table), N clipped to eta's rows as
    the reference does (mpmc_tpu/mc/metropolis.py:1643-1653)."""
    n_c = torch.sum(state.mol_alive
                    & (params.mol_species == cfg.insert_species[0]))
    eta = thermo.tmmc_eta
    if not (cfg.tmmc_bias and eta is not None):
        z = torch.zeros((), dtype=cfg.tdtype, device=n_c.device)
        return n_c, z, z
    k_e = eta.shape[0]
    up = torch.clamp(n_c + 1, 0, k_e - 1)
    dn = torch.clamp(n_c - 1, 0, k_e - 1)
    return (n_c, (eta[up] - eta[n_c]).to(cfg.tdtype),
            (eta[dn] - eta[n_c]).to(cfg.tdtype))


def pda_launch_args(state: SimState, params: Params, cfg: RunConfig,
                    thermo: Thermo, uniforms, tables, consts=None,
                    cav=None, tilt=None):
    """(args, kwargs) of mc_kernel.run_steps_uvt_pda (or its plain
    version) for one segment of ``state`` over the [K, 16] table
    ``uniforms`` — the launch of the reference's _fused_chunk_uvt_pda.
    ``cfg`` is the µVT cfg the path runs (mc_kernel.pda_effective_cfg),
    ``tables`` a ``uvt_fused_tables`` result for it, ``consts`` the
    chunk's ``_uvt_chunk_consts`` (computed when None), ``cav`` the
    chunk's ``mc_kernel.pack_cavity`` of the state's grid (computed when
    None under cavity bias); under tmmc_bias the tilts at the state's N,
    ``tilt`` (``_pda_tilt``, computed when None)."""
    slots, slot_start, species_idx, tmpl, natoms, A_list, rep_slots = tables
    box = state.box
    rc = pairs.derived_cutoff(box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    if consts is None:
        consts = _uvt_chunk_consts(state.pos, box, params, thermo, cfg,
                                   A_list, rep_slots)
    d_self, d_excl, c1, cx, lnfv, kv, kcoef = consts
    paf, pkrc = thole._field_variant_consts(box, cfg, state.pos.dtype)
    thr = cfg.cavity_autoreject_absolute
    ew = cfg.coulomb == "ewald"
    args = (state.pos, state.atom_alive(params), params.eps, params.sig,
            params.charge, params.mass, params.polar, state.e0, slot_start,
            species_idx, state.mol_alive[slots], tmpl, natoms, box, rc, alpha,
            1.0 / thermo.temperature, thermo.move_factor, thermo.rot_factor,
            thr * thr, thermo.insert_probability, lnfv, d_self, d_excl, c1,
            cx, uniforms.to(device=state.pos.device,
                            dtype=cfg.tdtype).contiguous(), cfg)
    kw = dict(kvecs=kv, kcoef=kcoef, sk_re=state.sk_re if ew else None,
              sk_im=state.sk_im if ew else None,
              field_alpha=0.0 if paf is None else paf,
              field_krc=0.0 if pkrc is None else pkrc,
              mol_mass=_mol_mass_plane(params, cfg), **_form_kw(params, cfg))
    if cfg.cavity_bias:
        if cav is None:
            if state.cavity_open is None:
                raise ValueError("cavity_bias: the state has no cavity "
                                 "grid — initialize it first")
            cav = mc_kernel.pack_cavity(state.cavity_open)
        kw.update(cav_list=cav[0], cav_n=cav[1].reshape(1))
    if mc_kernel._pda_bias(cfg):
        if tilt is None:
            tilt = _pda_tilt(state, params, cfg, thermo)
        _, kw["d_eta_ins"], kw["d_eta_del"] = tilt
    if spinflip_active(cfg):
        kw.update(rot_f=state.rot_f[slots].to(cfg.tdtype).contiguous(),
                  spin=state.spin[slots].contiguous(),
                  p_spin=thermo.spinflip_probability)
    return args, kw


def _pda_stage2(state: SimState, params: Params, cfg: RunConfig,
                thermo: Thermo, c: _Chunk, rec, mt, mol, natoms):
    """(state, accept, CG iterations, ln a2) after the exact SCF stage 2
    of B6's survivor — move type ``mt``, molecule ``mol`` with ``natoms``
    sites, record ``rec`` [8,16] on the device (reference _fused_chunk_uvt_pda's
    stage2_full): the scan path's polar_trial gives the trial geometry,
    field and residual, then the warm-started solve and its polar energy;
    the survivor is accepted with ln u2 < -(d_polar - d*) / T,
    and on accept the positions, aliveness, e0, mu, the CG residual and
    S(k) are committed, with the energy plus the record's six deltas and
    the new polar term.  The accept stays on the device.  A spinflip
    survivor (``mt`` 3) ran its whole acceptance in stage 1 and moved
    nothing: its spin flips, with no SCF (the reference's spin_path,
    mpmc_tpu/mc/metropolis.py:1647-1668), accepted in 0 iterations."""
    dtype, dev = state.pos.dtype, state.pos.device
    if mt == 3:
        spin = state.spin.clone()
        spin[mol] = 1 - spin[mol]
        return (state.replace(spin=spin),
                torch.ones((), dtype=torch.bool, device=dev), 0,
                torch.zeros((), dtype=dtype, device=dev))
    insert, delete = mt == 1, mt == 2
    rows = rec[2:5, :natoms].T.to(dtype)
    rows = torch.cat([rows, rows[:1].expand(
        params.max_atoms_per_mol - natoms, 3)]).contiguous()
    pos = state.pos
    carry = {"pos": pos, "alive": state.atom_alive(params), "e0": state.e0,
             "mu": state.mu, "r_pol": state.r_pol, "sk_re": state.sk_re,
             "sk_im": state.sk_im}
    pos_c, alive_c, e0_new, r0 = polar_trial(
        carry, c, params, cfg, mol, None if delete else rows,
        {0: None, 1: True, 2: False}[mt])
    mol_alive = state.mol_alive
    if insert or delete:
        mol_alive = mol_alive.clone()
        mol_alive[mol] = insert
    mu_new, iters, r_new = thole.solve_scf(pos_c, state.box, alive_c, params,
                                           cfg, e0_new, mu0=state.mu, r0=r0)
    pol_new = thole.polar_energy(mu_new, e0_new)
    d_surr, u2 = rec[0, 9].to(dtype), rec[0, 5].to(dtype)
    ln2 = -(pol_new - state.energy.polar - d_surr) / thermo.temperature
    accept = torch.log(torch.clamp(u2, min=1e-38)) < ln2
    deltas = rec[1, :6].to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    # record row 1: rd, es_real, es_recip, es_self, es_excl, lrc
    d = EnergyBreakdown(deltas[0], deltas[5], deltas[1], deltas[2],
                        deltas[3], deltas[4], zero, zero)
    energy = dataclasses.replace(state.energy.add(d), polar=pol_new)
    new = state.replace(
        pos=torch.where(accept, pos_c, pos),
        mol_alive=torch.where(accept, mol_alive, state.mol_alive),
        e0=torch.where(accept, e0_new, state.e0),
        mu=torch.where(accept, mu_new, state.mu),
        r_pol=torch.where(accept, r_new, state.r_pol),
        energy=energy.select(accept, state.energy))
    if c.ewald:
        if delete:
            d_re, d_im = _mol_sf_rows(mol_rows(pos, params, mol), params, mol,
                                      c.kv)
            d_re, d_im = -d_re, -d_im
        elif insert:
            d_re, d_im = _mol_sf_rows(rows, params, mol, c.kv)
        else:
            d_re, d_im = _mol_sf_delta(pos, rows, params, mol, c.kv)
        new = new.replace(
            sk_re=torch.where(accept, state.sk_re + d_re, state.sk_re),
            sk_im=torch.where(accept, state.sk_im + d_im, state.sk_im))
    return new, accept, iters, ln2


def run_chunk_fused_uvt_polar_da(state: SimState, params: Params,
                                 cfg: RunConfig, thermo: Thermo,
                                 n_steps: int, generator=None, uniforms=None,
                                 tables=None):
    """About ``n_steps`` polar delayed-acceptance steps: a host loop over
    segments, each one launch of B6 (mc_kernel.run_steps_uvt_pda: up to
    PDA_SEG proposals from the fixed state, frozen at the first stage-1
    survivor) and one host read of its record, then the exact SCF stage 2
    for that survivor (_pda_stage2) — the reference's
    run_chunk_fused_uvt_polar_da.  Stage-1 rejections change nothing, so
    the sampled distribution is the scan path's delayed acceptance (exact
    w.r.t. the SCF target).  The chunk stops once the segments' n_done
    reach ``n_steps``: it may overshoot by < PDA_SEG stage-1 rejections,
    never by an accepted move; ``state.step`` and the stats count the
    steps done.  Returns (state, MCStats).

    Each segment's [PDA_SEG, 16] table is drawn from ``generator`` (a
    torch.Generator on the state's device), or is the next of an injected
    ``uniforms`` [n_seg, PDA_SEG, 16] (tests).  ``tables``: a
    ``uvt_fused_tables`` result for mc_kernel.pda_effective_cfg(cfg) to
    reuse across chunks.  ``ensemble nvt`` runs the same kernel in the
    all-displace limit (insert_probability 0).  The caller has checked
    mc_kernel.supported_uvt_polar_da(cfg, params)."""
    if cfg.ensemble == "nvt":
        thermo = thermo.replace(insert_probability=torch.zeros_like(
            thermo.insert_probability))
    cfg = mc_kernel.pda_effective_cfg(cfg, params)
    if tables is None:
        tables = uvt_fused_tables(params, cfg)
    slots_h = tables[0].cpu().numpy()
    natoms_h = params.mol_natoms.cpu().numpy()
    consts = _uvt_chunk_consts(state.pos, state.box, params, thermo, cfg,
                               tables[5], tables[6])
    cav = (mc_kernel.pack_cavity(state.cavity_open) if cfg.cavity_bias
           else None)
    tm = tmmc_on(cfg)
    if tm:
        if state.tmmc_c is None:
            raise ValueError("tmmc: the state has no TMMC matrix — "
                             "initialize it first")
        state = state.replace(tmmc_c=state.tmmc_c.clone())
    c = _Chunk(state.box, params, cfg, thermo)
    dev = state.pos.device
    stats = MCStats.zero(dev)
    done = n_seg = 0
    while done < n_steps:
        if uniforms is None:
            u = torch.rand((mc_kernel.PDA_SEG, N_LANES), generator=generator,
                           dtype=cfg.tdtype, device=generator.device)
        elif n_seg < uniforms.shape[0]:
            u = uniforms[n_seg]
        else:
            raise ValueError(f"uniforms: {uniforms.shape[0]} segments used "
                             f"up after {done} of {n_steps} steps")
        n_seg += 1
        # TMMC: the segment's N (its state is fixed) and the bias tilts
        tilt = _pda_tilt(state, params, cfg, thermo) if tm else None
        args, kw = pda_launch_args(state, params, cfg, thermo, u, tables,
                                   consts, cav=cav, tilt=tilt)
        rec = mc_kernel.run_steps_uvt_pda(*args, **kw)
        head = rec[0, :12].cpu().numpy()     # the segment's one host read
        done += int(head[0])
        stats.attempts[[DISPLACE, INSERT, DELETE, SPINFLIP]] += head[
            [6, 7, 8, 11]].astype(np.int64)
        tmmc_c = state.tmmc_c
        if head[1] > 0.5:
            mt, mol = int(head[2]), int(slots_h[int(head[3])])
            state, accept, iters, ln2 = _pda_stage2(
                state, params, cfg, thermo, c, rec, mt, mol,
                int(natoms_h[mol]))
            stats.accepts[(DISPLACE, INSERT, DELETE, SPINFLIP)[mt]] += (
                accept.to(torch.int64))
            stats.polar_iters += iters
            if tm and mt in (1, 2):     # the survivor's estimator
                tmmc_c.index_put_(
                    (tilt[0].reshape(1),
                     torch.tensor([2 * mt - 1], device=dev)),
                    _pda_tmmc_x(rec, mt, ln2, tilt, cfg, thermo).reshape(
                        1).to(tmmc_c.dtype), accumulate=True)
        if tm:
            # every insert and delete attempt of the segment, at its N
            # (the reference's :1746-1760)
            tmmc_c.index_put_(
                (tilt[0].reshape(1).expand(2),
                 torch.tensor([0, 2], device=dev)),
                torch.tensor(head[7:9], dtype=tmmc_c.dtype, device=dev),
                accumulate=True)
            state = state.replace(tmmc_c=tmmc_c)
    return state.replace(step=state.step + done), stats


def _pda_tmmc_x(rec, mt, ln2, tilt, cfg, thermo):
    """The TMMC estimator of B6's survivor, an insert (mt 1) or delete
    (2): min(1, a2), under tmmc_bias times the importance weight min(1,
    a1) / min(1, a1 e^{d_eta}), ln a1 = lnb - (du + d*) / T from the
    record's unbiased lnb, six deltas and d* (the reference's
    _fused_chunk_uvt_pda, mpmc_tpu/mc/metropolis.py:1719-1735)."""
    dtype = cfg.tdtype
    x = torch.exp(torch.clamp(ln2, max=0.0))
    if not (cfg.tmmc_bias and thermo.tmmc_eta is not None):
        return x
    du1 = (rec[1, :6].sum() + rec[0, 9]).to(dtype)
    ln1 = rec[0, 10].to(dtype) - du1 / thermo.temperature
    d_eta = tilt[1] if mt == 1 else tilt[2]
    return x * torch.exp(torch.clamp(ln1, max=0.0)
                         - torch.clamp(ln1 + d_eta, max=0.0))



def frozen_refresh_rows(params: Params, cfg: RunConfig) -> int:
    """Row count F for the frozen-reuse fast refresh, or 0: F > 0 iff
    every frozen atom sits in a row < F (frozen-prefix layout) and no move
    of the ensemble touches a frozen coordinate or the box.  Host-side,
    once per run."""
    if cfg.ensemble == "npt" or cfg.feynman_hibbs or cfg.feynman_kleinert:
        return 0
    if cfg.spectre or cfg.rd_crystal:
        return 0
    af = (params.mol_frozen[params.mol_id] & params.atom_ok).cpu().numpy()
    n_f = int(af.sum())
    if n_f == 0 or not af[:n_f].all():
        return 0
    return n_f


def initialize(state: SimState, params: Params, cfg: RunConfig,
               thermo: Thermo, frozen_rows: int = 0, e0=None) -> SimState:
    """Full-energy refresh (at start and every corrtime — washes out
    delta-accumulation error).  ``state.energy`` holds the active part;
    the frozen-framework terms live in ``state.e_frozen``.

    ``frozen_rows`` (from ``frozen_refresh_rows``) reuses a valid
    ``state.e_frozen`` and re-sums only rows >= frozen_rows.  ``e0``: the
    static field of ``state`` when the caller has it (total_energy)."""
    reuse = frozen_rows > 0 and state.e_frozen is not None
    e, e_frozen, aux = energy_mod.total_energy(
        state.pos, state.box, state.mol_alive, params, cfg, thermo,
        mu0=state.mu, split_frozen=True,
        frozen_cached=state.e_frozen if reuse else None,
        active_row_start=frozen_rows if reuse else 0, e0=e0)
    # without polarization there are no dipoles to carry
    mu = aux.get("mu", state.mu) if cfg.polarization else None
    # the cavity grid follows the refreshed positions (a stale grid between
    # refreshes is the reference's rule); the TMMC matrix is a statistic,
    # allocated once and never reset here
    cavity_open = state.cavity_open
    if cfg.cavity_bias:
        cavity_open = moves.cavity_open_grid(
            state.pos, state.box, state.atom_alive(params), cfg.cavity_grid,
            cfg.cavity_radius)
    tmmc_c = state.tmmc_c
    if cfg.tmmc and tmmc_c is None:
        tmmc_c = torch.zeros((params.n_mols_max + 1, 4), dtype=cfg.tdtype,
                             device=state.pos.device)
    # the molecule-pair cache: built once (the accept-time scatters keep
    # its entries exact), and again at every refresh where the pair
    # values depend on the temperature (FH/FK: annealing or a ladder may
    # have moved it since the entries were written)
    cache = (state.cache_rd, state.cache_es, state.cache_lrc)
    if cache_eligible(cfg):
        if cache[0] is None or cfg.feynman_hibbs or cfg.feynman_kleinert:
            cache = pairs.pair_matrix(state.pos, state.box,
                                      state.atom_alive(params), params, cfg,
                                      thermo.temperature)
    else:
        cache = (None, None, None)
    return state.replace(energy=e, e_frozen=e_frozen,
                         sk_re=aux.get("sk_re"), sk_im=aux.get("sk_im"),
                         mu=mu, e0=aux.get("e0"), r_pol=aux.get("r_pol"),
                         cavity_open=cavity_open, tmmc_c=tmmc_c,
                         cache_rd=cache[0], cache_es=cache[1],
                         cache_lrc=cache[2])
