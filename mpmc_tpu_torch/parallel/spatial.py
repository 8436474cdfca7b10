"""Atom-sharded (spatial) passes over D ranks (port of
mpmc_tpu/parallel/spatial.py).

The reference tiles the O(N^2) pair matrix by row blocks across a device
mesh under ``shard_map``; here a mesh slot is a rank of a
``torch.distributed`` group (parallel/multihost.py), every rank holds the
whole (replicated) state, and a pass computes only the rank's share:

- the full pair pass: B2 over the rank's row tiles (I mod D == d, a strip
  of its work list; pairs.pair_pass under ``cfg.spatial_axis``), the nine
  sums met in one plane;
- the Ewald reciprocal sum: the k-table padded to a multiple of D and
  split into D contiguous blocks (``recip_energy_sharded``, plain
  PyTorch as the reference's is jnp; the energy paths keep S(k) whole,
  since the MC step's deltas read it);
- the direct static field and every SCF matvec: B5 with a visit table of
  the rank's row tiles, the [N, 3] fields met in one all-reduce
  (thole.strip_visit); the CG recurrence replicated;
- the MC step's per-move delta: B4 over the rank's column strip
  [d nl, (d + 1) nl) (pairs.mol_pair_passes: the displacement's old and
  new rows in one plane), and the per-corrtime refresh the strips above.

The ranks stay in lockstep: every rank draws the same uniforms (one
generator seeded alike), and every accept reads only replicated inputs and
the planes, whose bits are the same on every rank.  ``check_lockstep``
(multihost) compares a digest of the state at every block end and stops
the run if the ranks differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpmc_tpu_torch.ops import ewald, pairs, thole
from mpmc_tpu_torch.parallel import multihost

AXIS = "atoms"


def spatial_cfg(cfg, D=None):
    """``cfg`` sharded over the D ranks of the group (the reference's
    _spatial_cfg, mpmc_tpu/parallel/spatial.py:387): spatial_axis set,
    the fused routes off."""
    D = multihost.world() if D is None else int(D)
    return dataclasses.replace(cfg, spatial_axis=(AXIS, D), fused_mc=False)


def pair_pass_sharded(pos, box, atom_alive, params, cfg, temperature):
    """Full-system PairTerms with the row tiles split over the ranks (B2
    on each rank's strip), one plane of the sums."""
    return pairs.pair_pass(pos, box, atom_alive, params, spatial_cfg(cfg),
                           temperature)


def recip_energy_sharded(pos, charge, alive, box, alpha, kmax):
    """Ewald reciprocal energy with the k-vector table split over the
    ranks: the half-space table padded to a multiple of D, rank d taking
    block d; each rank's weighted |S(k)|^2 partial sum meets the others'
    in one plane."""
    d, D = multihost.rank(), multihost.world()
    ints = ewald.half_space_ints(kmax)
    K = len(ints)
    per = -(-K // D)
    ints_p = np.pad(ints, ((0, per * D - K), (0, 0)))
    ok = np.arange(per * D) < K
    mine = torch.as_tensor(ints_p[d * per:(d + 1) * per], dtype=pos.dtype,
                           device=pos.device)
    ok_d = torch.as_tensor(ok[d * per:(d + 1) * per], device=pos.device)
    recip = 2.0 * torch.pi * torch.linalg.inv_ex(box).inverse.transpose(0, 1)
    kv = ewald._phase(mine, recip.transpose(0, 1))
    sk_re, sk_im = ewald.structure_factor(pos, charge, alive, kv)
    pref, w = ewald.recip_weights(box, alpha, kv)
    w = torch.where(ok_d, w, torch.zeros_like(w))
    e = pref * torch.sum(w * (sk_re * sk_re + sk_im * sk_im))
    return multihost.psum(e.reshape(1))[0]


def static_field_sharded(pos, box, atom_alive, params, cfg):
    """The damped direct-cutoff static field E0 (B5 charge mode) with the
    target rows split over the ranks: one [N, 3] all-reduce."""
    return thole.static_field_direct(pos, box, atom_alive, params,
                                     spatial_cfg(cfg))


def solve_scf_sharded(pos, box, atom_alive, params, cfg, e0, mu0=None):
    """The Thole SCF with every matvec's rows split over the ranks (B5
    on the rank's row tiles, one [N, 3] all-reduce per CG iteration) and
    the CG recurrence replicated: the same fixed point, Jacobi
    preconditioner and stopping rule as thole.solve_scf.  Returns (mu
    [N, 3], iterations), both the same on every rank."""
    mu, iters, _ = thole.solve_scf(pos, box, atom_alive, params,
                                   spatial_cfg(cfg), e0, mu0)
    return mu, iters


def total_energy_sharded(pos, box, mol_alive, params, cfg, thermo):
    """The single-point energy with its O(N^2) passes split over the
    ranks — ``ensemble te`` under ``spatial_devices``
    (mpmc_tpu/parallel/spatial.py:178): ops/energy.total_energy under
    ``spatial_cfg``, so the pair pass (B2 strips, one plane), the direct
    static field and the SCF's matvec (B5 strips) shard themselves, as
    in the MC loop's refresh; the reciprocal sum, polar_ewald /
    polar_wolf's static field and the cdvdw pass are whole on every rank.
    Returns (EnergyBreakdown, aux)."""
    from mpmc_tpu_torch.ops import energy as energy_mod
    return energy_mod.total_energy(pos, box, mol_alive, params,
                                   spatial_cfg(cfg), thermo)


# ---------------------------------------------------------------------------
# the spatial MC step: replicated state, sharded passes
# ---------------------------------------------------------------------------

# the reference's refusal (mpmc_tpu/mc/run.py:1527-1534), word for word
MC_REFUSAL = ("spatial_devices with this configuration is unsupported in "
              "the MC loop (needs the scan-path jnp surface: no cdvdw/"
              "cell_list/rd_crystal/mol_cache/spectre; polarization only "
              "on the direct damped field, not polar_ewald/polar_wolf)")


def mc_supported(cfg) -> bool:
    """Static gate of the spatial MC step (the reference's,
    mpmc_tpu/parallel/spatial.py:370): the scan-path surface without the
    per-move machinery that holds whole-system caches outside the
    sharded passes; polarization on the direct damped field only."""
    if cfg.polarization and (cfg.polar_ewald or cfg.polar_wolf):
        return False
    return (not cfg.cdvdw and not cfg.cell_list and not cfg.rd_crystal
            and not cfg.mol_cache and not cfg.spectre
            and cfg.ensemble in ("nvt", "uvt", "npt", "nve"))


def run_chunk_spatial(state, params, cfg, thermo, n_steps, generator=None,
                      uniforms=None):
    """``metropolis.run_chunk`` with the pair passes split over the ranks
    (module docstring).  Every rank must pass the same uniforms (or a
    generator seeded alike).  Raises where mc_supported refuses."""
    from mpmc_tpu_torch.mc import metropolis
    if not mc_supported(cfg):
        raise ValueError(MC_REFUSAL)
    return metropolis.run_chunk(state, params, spatial_cfg(cfg), thermo,
                                n_steps, generator=generator,
                                uniforms=uniforms)


def initialize_spatial(state, params, cfg, thermo, frozen_rows=0):
    """The per-corrtime full refresh with the passes split over the ranks
    (the in-loop analog of total_energy_sharded)."""
    from mpmc_tpu_torch.mc import metropolis
    return metropolis.initialize(state, params, spatial_cfg(cfg), thermo,
                                 frozen_rows=frozen_rows)


def replicate(state):
    """``state`` with rank 0's positions, box and aliveness on every rank
    (one broadcast each): the replicated state the spatial step assumes,
    whatever each rank read at set-up (the ranks of a multi-host job read
    their own hosts' files)."""
    return state.replace(pos=multihost.broadcast(state.pos),
                         box=multihost.broadcast(state.box),
                         mol_alive=multihost.broadcast(state.mol_alive))


def check_lockstep(state, what="spatial MC"):
    """Raise unless every rank holds the same positions, aliveness and
    energy total (one plane of digests, multihost.check_lockstep)."""
    multihost.check_lockstep(what, state.pos, state.mol_alive,
                             state.energy.total.reshape(1))
