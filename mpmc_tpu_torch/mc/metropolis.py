"""The Metropolis Monte Carlo engine, scan path (port of the row-level,
non-cache part of mpmc_tpu/mc/metropolis.py).

One step = one row of a [K, 16] uniform table (lane layout of
mc_kernel.draw_uniforms(lanes=16), consumed as mc_kernel._kernel_uvt does;
see mc/moves.py for lanes 0-3 and 5-7):

- lane 8 picks the move type: insert if u8 < p_ins/2, delete if
  u8 < p_ins, else displace (µVT); always displace otherwise;
- lane 9 picks the species of an insert/delete when there are several;
- lane 4 is the acceptance coin.

The move type is the only host decision of a step: it is read from a host
copy of lane 8, made once per chunk.  Everything else — slot pick, trial
rows, the B4 delta passes, the S(k) delta, acceptance and the commit —
stays on the device with no sync, so a chunk can later be captured in a
CUDA graph.  The commit updates ``pos`` and ``mol_alive`` in place (one
clone per chunk keeps the caller's state intact).
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
from mpmc_tpu_torch.ops import ewald, pairs
from mpmc_tpu_torch.state import (EnergyBreakdown, Params, SimState,
                                  mol_rows, mol_rows_update, row_valid,
                                  take)

# global move-type ids (stats indexing)
DISPLACE, INSERT, DELETE, VOLUME, SPINFLIP = 0, 1, 2, 3, 4
N_MOVE_TYPES = 5
N_LANES = 16


@dataclasses.dataclass
class MCStats:
    attempts: np.ndarray    # [N_MOVE_TYPES] host counts
    accepts: torch.Tensor   # [N_MOVE_TYPES] int64 on the state's device

    @classmethod
    def zero(cls, device):
        return cls(np.zeros(N_MOVE_TYPES, np.int64),
                   torch.zeros(N_MOVE_TYPES, dtype=torch.int64,
                               device=device))

    def host(self):
        """The same counts with ``accepts`` fetched to the host."""
        return MCStats(self.attempts, self.accepts.cpu().numpy())


def draw_uniforms(generator: torch.Generator, n_steps, dtype=torch.float32):
    """[K, 16] uniforms in [0, 1) on the generator's device."""
    return torch.rand((n_steps, N_LANES), generator=generator, dtype=dtype,
                      device=generator.device)


def make_branch_picker(cfg: RunConfig):
    """(pick(u8_host [K], thermo) -> [K] branch ids, branch_ids): the
    ensemble's move table.  µVT: insert_probability split evenly between
    insert and delete; every other ensemble of this slice displaces."""
    if cfg.ensemble == "uvt" and cfg.insert_species:
        ids = [DISPLACE, INSERT, DELETE]

        def pick(u8, thermo):
            p_ins = float(thermo.insert_probability)
            return np.where(u8 < 0.5 * p_ins, 1,
                            np.where(u8 < p_ins, 2, 0))
    else:
        ids = [DISPLACE]

        def pick(u8, thermo):
            return np.zeros(len(u8), np.int64)
    return pick, ids


def _movable_mask(params: Params, mol_alive):
    return mol_alive & ~params.mol_frozen & (params.mol_species >= 0)


def _overlap_r2(min_r2, cfg):
    if cfg.cavity_autoreject_absolute > 0.0:
        thr = cfg.cavity_autoreject_absolute
        return min_r2 < thr * thr
    return torch.zeros((), dtype=torch.bool, device=min_r2.device)


def _mol_sf_rows(rows, params, mol, kv):
    """Structure factor of one molecule from explicit rows."""
    return ewald.mol_structure_factor(rows, mol_rows(params.charge, params,
                                                     mol),
                                      row_valid(params, mol), kv)


def _mol_sf_delta(pos, new_rows, params, mol, kv):
    """S(k) change of moving one molecule, in one evaluation: the trial
    rows enter with +q and the current rows with -q."""
    ok = row_valid(params, mol)
    q = mol_rows(params.charge, params, mol)
    return ewald.mol_structure_factor(
        torch.cat([new_rows, mol_rows(pos, params, mol)]),
        torch.cat([q, -q]), torch.cat([ok, ok]), kv)


def _mol_self_energy(params, cfg, rc, alpha, mol):
    """Self energy of one molecule's charges (GCMC +/- delta)."""
    if cfg.coulomb not in ("ewald", "wolf"):
        return torch.zeros((), dtype=params.charge.dtype,
                           device=params.charge.device)
    q = mol_rows(params.charge, params, mol)
    q2 = torch.where(row_valid(params, mol), q * q, torch.zeros_like(q))
    coef = alpha / math.sqrt(math.pi)
    if cfg.coulomb == "wolf":
        coef = coef + torch.special.erfc(alpha * rc) / (2.0 * rc)
    return -KE * coef * torch.sum(q2)


def _background_delta(atom_alive, params, alpha, volume, mol, sign):
    """Jellium-background delta for inserting (sign=+1) / deleting
    (sign=-1) molecule ``mol``: c_bg [(Q + sign q_m)^2 - Q^2]; exact zero
    for neutral templates."""
    q = mol_rows(params.charge, params, mol)
    q_m = torch.sum(torch.where(row_valid(params, mol), q, torch.zeros_like(q)))
    q_tot = torch.sum(torch.where(atom_alive, params.charge,
                                  torch.zeros_like(params.charge)))
    c_bg = ewald.background_coefficient(alpha, volume)
    return c_bg * (2.0 * sign * q_tot * q_m + q_m * q_m)


class _Chunk:
    """Per-chunk constants of a fixed box: cutoff, Ewald tables, kernel
    scalar header, volume."""

    def __init__(self, box, params, cfg, thermo):
        self.rc = pairs.derived_cutoff(box, cfg)
        self.alpha = pairs.derived_alpha(self.rc, cfg)
        self.scal = pairs.pair_scalars(box, cfg)
        self.volume = torch.abs(torch.linalg.det(box))
        self.ewald = cfg.coulomb == "ewald"
        if self.ewald:
            self.kv = ewald.kvectors(box, cfg.ewald_kmax)
            self.recip_w = ewald.recip_weights(box, self.alpha, self.kv)
        self.box = box
        self.lrc = cfg.rd_potential == "lj" and cfg.rd_lrc
        self.ln_fv = torch.log(torch.clamp(
            thermo.fugacity * ATM2K_A3 * self.volume, min=1e-300))


def make_step_fn(params: Params, cfg: RunConfig):
    """The single-step function of this (params, cfg):
    step(carry, u, t, thermo, c, stats) with ``carry`` a dict of the
    mutable state (pos, mol_alive updated in place; energy, sk replaced),
    ``u`` the step's [16] uniform row, ``t`` the host-chosen branch index,
    ``c`` the chunk's _Chunk constants; ``stats`` accumulates in place."""
    if cfg.ensemble not in ("uvt", "nvt"):
        raise NotImplementedError(
            f"ensemble {cfg.ensemble} is not yet ported — ROADMAP A8")
    dtype = cfg.tdtype
    dev = params.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    species = (torch.as_tensor(cfg.insert_species, dtype=torch.int64,
                               device=dev)
               if cfg.insert_species else None)
    n_sp = len(cfg.insert_species)

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
        alive = carry["alive"]
        rows = moves.displace_rows(pos, params, mol, u,
                                   thermo.move_factor, thermo.rot_factor)
        old = pairs.mol_pair_pass(pos, c.box, alive, params, cfg,
                                  thermo.temperature, mol, scal=c.scal)
        new = pairs.mol_pair_pass(pos, c.box, alive, params, cfg,
                                  thermo.temperature, mol, row_pos=rows,
                                  scal=c.scal)
        sk = (carry["sk_re"], carry["sk_im"], zero)
        if c.ewald:
            sk = recip(c, carry, *_mol_sf_delta(pos, rows, params, mol,
                                                c.kv))
        d = eb(rd=new.rd - old.rd, es_real=new.es_real - old.es_real,
               es_recip=sk[2])
        reject = (cnt == 0) | _overlap_r2(new.min_r2, cfg)
        return mol, rows, None, d, zero, reject, sk

    def b_insert(carry, u, thermo, c):
        pos, mol_alive = carry["pos"], carry["mol_alive"]
        si = pick_species(u)
        slot, free = moves.pick_by_rank(
            ~mol_alive & (params.mol_species == si), u[0])
        rows = moves.place_rows(params, slot, si, u, c.box)
        inter = pairs.mol_pair_pass(pos, c.box, carry["alive"], params, cfg,
                                    thermo.temperature, slot, row_pos=rows,
                                    scal=c.scal)
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
        return slot, rows, True, d, ln_bias, reject, sk

    def b_delete(carry, u, thermo, c):
        pos, mol_alive = carry["pos"], carry["mol_alive"]
        si = pick_species(u)
        slot, cnt = moves.pick_by_rank(
            _movable_mask(params, mol_alive) & (params.mol_species == si),
            u[0])
        inter = pairs.mol_pair_pass(pos, c.box, carry["alive"], params, cfg,
                                    thermo.temperature, slot, scal=c.scal)
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
        return slot, None, False, d, ln_bias, cnt == 0, sk

    branches = ([b_displace, b_insert, b_delete]
                if cfg.ensemble == "uvt" and cfg.insert_species
                else [b_displace])
    _, branch_ids = make_branch_picker(cfg)

    def step(carry, u, t, thermo, c, stats):
        mol, rows, alive_new, d, ln_bias, reject, sk = branches[t](
            carry, u, thermo, c)
        du = d.total
        ln_acc = ln_bias - du / thermo.temperature
        accept = (~reject) & (torch.log(torch.clamp(u[4], min=1e-38))
                              < ln_acc)
        if rows is not None:
            cur = mol_rows(carry["pos"], params, mol)
            mol_rows_update(carry["pos"], params, mol,
                            torch.where(accept, rows, cur))
        if alive_new is not None:
            ma = carry["mol_alive"]
            ma.index_put_((mol.reshape(1),), torch.where(
                accept, alive_new, take(ma, mol)).reshape(1))
            carry["alive"] = ma[params.mol_id] & params.atom_ok
        carry["energy"] = carry["energy"].add(d).select(accept,
                                                        carry["energy"])
        if c.ewald:
            carry["sk_re"] = torch.where(accept, sk[0], carry["sk_re"])
            carry["sk_im"] = torch.where(accept, sk[1], carry["sk_im"])
        gid = branch_ids[t]
        stats.attempts[gid] += 1
        stats.accepts[gid] += accept.to(torch.int64)

    return step


def chunk_setup(state: SimState, params: Params, cfg: RunConfig,
                thermo: Thermo, uniforms):
    """(step, carry, consts, branch ids [K] on the host, stats) for a
    chunk over the uniform table ``uniforms`` — everything the step loop
    needs, after the chunk's one host sync (the copy of lane 8).  The
    carry holds clones of ``pos`` and ``mol_alive`` and the table as
    ``carry["u"]`` on the state's device."""
    u = uniforms.to(device=state.pos.device, dtype=cfg.tdtype)
    pick, _ = make_branch_picker(cfg)
    branch = pick(u[:, 8].cpu().numpy(), thermo)
    carry = {"pos": state.pos.clone(), "mol_alive": state.mol_alive.clone(),
             "energy": state.energy, "sk_re": state.sk_re,
             "sk_im": state.sk_im, "u": u}
    carry["alive"] = carry["mol_alive"][params.mol_id] & params.atom_ok
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
    return state.replace(pos=carry["pos"], mol_alive=carry["mol_alive"],
                         energy=carry["energy"], sk_re=carry["sk_re"],
                         sk_im=carry["sk_im"],
                         step=state.step + n_steps), stats


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
               thermo: Thermo, frozen_rows: int = 0) -> SimState:
    """Full-energy refresh (at start and every corrtime — washes out
    delta-accumulation error).  ``state.energy`` holds the active part;
    the frozen-framework terms live in ``state.e_frozen``.

    ``frozen_rows`` (from ``frozen_refresh_rows``) reuses a valid
    ``state.e_frozen`` and re-sums only rows >= frozen_rows."""
    reuse = frozen_rows > 0 and state.e_frozen is not None
    e, e_frozen, aux = energy_mod.total_energy(
        state.pos, state.box, state.mol_alive, params, cfg, thermo,
        split_frozen=True,
        frozen_cached=state.e_frozen if reuse else None,
        active_row_start=frozen_rows if reuse else 0)
    return state.replace(energy=e, e_frozen=e_frozen,
                         sk_re=aux.get("sk_re"), sk_im=aux.get("sk_im"))
