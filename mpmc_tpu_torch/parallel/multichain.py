"""Many independent MC chains on one card, and over D ranks (port of
mpmc_tpu/parallel/multichain.py).

A stacked state is a ``SimState`` whose tensor fields carry a leading [C]
(``state.stack_chains``); ``state.slice_chain`` takes one chain back out.
Two routes advance the chains together:

- the fused kernels, one launch per chunk (mc/metropolis.
  run_chunk_fused_uvt_multi over B1, run_chunk_fused_multi over B3);
- ``run_chunk_batched``, the batched scan chains: one step of every chain
  per row of a [C, K, 16] uniform table (metropolis.make_batched_step_fn),
  each move's delta one launch of B4 over the chain axis; with
  polarization every chain's SCF in the same CG rounds, each round one
  launch of B5 over the chains still open (thole.solve_scf_chains).

``chain_devices D`` (``ChainBlock``): rank d of a process group
(parallel/multihost.py) advances the chains [d C/D, (d + 1) C/D) with the
same launches (B1 or B3 over its C/D chains, B4 and B5 over them on the
batched route).  Chain c gets the same numbers whichever rank holds it:
every rank draws the whole [C, K, 16] table from the run's generator
(seeded alike on every rank) and keeps its rows, and the batched route's
shared move types come from global chain 0's row.  The chains never
meet inside a chunk (the reference's shard_map has no collective either);
at a block end one all-reduce per state field gathers the stack for the
observables and the files (rank 0 writes).

Statistical note (the reference's): the chains share the move *type* of
each step — here chain 0's lane 8 — while every chain draws its own
target, displacement and acceptance coin from its own row.  Each chain
remains a valid Metropolis chain; only the move-type sequence is shared,
which does not bias any chain's stationary distribution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.mc import metropolis
from mpmc_tpu_torch.ops import thole
from mpmc_tpu_torch.state import (Params, SimState, chain_block, map_state,
                                  slice_chain, stack_chains)


def stack_states(state: SimState, n: int) -> SimState:
    """``n`` copies of one state, stacked (each chain owns its tensors)."""
    return stack_chains([state] * n)


def chain_thermo(thermo: Thermo, c: int) -> Thermo:
    """Chain ``c``'s Thermo of a per-chain one (a parallel-tempering
    ladder: ``temperature`` [C], ``fugacity`` [C, S]); shared knobs stay
    as they are (the TMMC bias ``tmmc_eta`` is one table for every
    chain)."""
    kw = {}
    for f in dataclasses.fields(thermo):
        v = getattr(thermo, f.name)
        if f.name == "tmmc_eta":
            continue
        base = 1 if f.name == "fugacity" else 0
        if isinstance(v, torch.Tensor) and v.ndim > base:
            kw[f.name] = v[c]
    return thermo.replace(**kw)


def run_chunk_batched(states: SimState, params: Params, cfg: RunConfig,
                      thermo: Thermo, n_steps: int, generator=None,
                      uniforms=None, trace=None, branch_u=None):
    """Advance C stacked chains ``n_steps`` steps each, in lockstep;
    returns (states, MCStats with [C, 5] counts).

    The [C, n_steps, 16] uniform table is ``uniforms`` when given (tests
    inject it), else drawn from ``generator`` (a torch.Generator on the
    states' device).  ``thermo`` may be per chain (the reference's
    ``thermo_batched``: ``temperature`` [C], ``fugacity`` [C, S]); the
    move-type probabilities and move sizes are shared.  ``trace``: a list
    that gets the step's record (make_batched_step_fn).  The chains' mu,
    e0 and r_pol are carried (polarization), and under NPT each chain's
    box.  ``branch_u`` [n_steps, 16]: the row that picks the shared move
    types (default chain 0's; ChainBlock passes global chain 0's)."""
    C = states.pos.shape[0]
    if uniforms is None:
        uniforms = torch.rand((C, n_steps, metropolis.N_LANES),
                              generator=generator, dtype=cfg.tdtype,
                              device=generator.device)
    step, carry, c, branch, stats = metropolis.batched_chunk_setup(
        states, params, cfg, thermo, uniforms, branch_u=branch_u)
    u = carry["u"]
    for k in range(n_steps):
        step(carry, u[:, k], int(branch[k]), thermo, c, stats, trace)
    return metropolis._from_carry(states, carry, n_steps), stats


def initialize_batched(states: SimState, params: Params, cfg: RunConfig,
                       thermo: Thermo, frozen_rows: int = 0) -> SimState:
    """Full-energy refresh of every chain, one after the other (the
    reference maps the refresh over chains too: a batched O(N^2) pass
    would hold a [C, rows, N] tile, and it runs once per corrtime), each
    in its own box (NPT chains), with every chain's static field taken
    first in one pass over the chains (thole.static_field_chains: one
    launch of B5 over the chains, each in its own box, a header per
    chain).
    ``thermo`` may be per chain (chain_thermo); ``frozen_rows`` as in
    metropolis.initialize."""
    e0 = None
    if cfg.polarization:
        alive = states.mol_alive[:, params.mol_id] & params.atom_ok
        e0 = thole.static_field_chains(states.pos, states.box, alive,
                                       params, cfg)
    return stack_chains([
        metropolis.initialize(slice_chain(states, c), params, cfg,
                              chain_thermo(thermo, c),
                              frozen_rows=frozen_rows,
                              e0=None if e0 is None else e0[c])
        for c in range(states.pos.shape[0])])


def thermo_block(thermo: Thermo, lo: int, hi: int, C: int) -> Thermo:
    """Chains [lo, hi)'s Thermo of a per-chain one over C chains (a
    ladder: ``temperature`` [C], ``fugacity`` [C, S]); a shared Thermo
    as it is."""
    kw = {}
    for f in dataclasses.fields(thermo):
        v = getattr(thermo, f.name)
        if f.name == "tmmc_eta" or not isinstance(v, torch.Tensor):
            continue
        base = 1 if f.name == "fugacity" else 0
        if v.ndim > base and v.shape[0] == C:
            kw[f.name] = v[lo:hi]
    return thermo.replace(**kw)


class ChainBlock:
    """Rank d's block [lo, hi) of C stacked chains under ``chain_devices
    D`` (module docstring); at D = 1 the whole stack and no collective.
    The reference's refusal of a C not divisible by D is kept
    (mpmc_tpu/mc/run.py:1248-1250)."""

    def __init__(self, C: int, D: int = 1, what: str = "chains",
                 device=None):
        from mpmc_tpu_torch.parallel import multihost
        D = max(int(D), 1)
        if C % D:
            raise ValueError(f"{what} {C} not divisible by chain_devices "
                             f"{D}")
        if D > 1 and multihost.world() != D:
            raise ValueError(f"chain_devices {D} but the process group has "
                             f"{multihost.world()} ranks")
        self.C, self.D, self.device = C, D, device
        self.lo, self.hi = multihost.block(C, multihost.rank() if D > 1
                                           else 0, D)

    @property
    def n(self) -> int:
        """The chains of this rank's block."""
        return self.hi - self.lo

    def local(self, states: SimState) -> SimState:
        return chain_block(states, self.lo, self.hi) if self.D > 1 \
            else states

    def thermo(self, thermo: Thermo) -> Thermo:
        return thermo_block(thermo, self.lo, self.hi, self.C) \
            if self.D > 1 else thermo

    def uniforms(self, generator, n_steps: int, dtype):
        """(this block's rows of the whole [C, n_steps, 16] table, global
        chain 0's row): the single-process run's draw, split."""
        u = torch.rand((self.C, n_steps, metropolis.N_LANES),
                       generator=generator, dtype=dtype,
                       device=generator.device)
        return u[self.lo:self.hi], u[0]

    def rows(self, t):
        """The [C, ...] stack of a per-chain tensor of this block: one
        all-reduce (the tensor itself at D = 1)."""
        from mpmc_tpu_torch.parallel import multihost
        if self.D == 1:
            return t
        return multihost.gather_rows(t, self.lo, self.hi, self.C)

    def gather(self, states: SimState) -> SimState:
        """The whole stack from every rank's block (the files and the
        observables read it; one all-reduce per tensor field)."""
        if self.D == 1:
            return states
        return map_state(lambda xs: self.rows(xs[0]), [states])

    def gather_stats(self, stats):
        """MCStats of the whole stack ([C, ...] counts) from this block's."""
        if self.D == 1:
            return stats

        def full(x):
            if isinstance(x, torch.Tensor):
                return self.rows(x)
            if isinstance(x, np.ndarray) and x.ndim:
                return self.rows(torch.as_tensor(
                    x, device=self.device)).cpu().numpy()
            return x
        return dataclasses.replace(stats, **{
            f.name: full(getattr(stats, f.name))
            for f in dataclasses.fields(stats)})

    def chunk(self, chunk, states, params, cfg, thermo, n_steps,
              generator):
        """``chunk`` (a stacked-chain route: run_chunk_batched, or the
        fused B1 / B3 multi-chain launches) over this block: its rows of
        the whole table, with the batched route's move types from global
        chain 0.  Returns (block states, block stats)."""
        if self.D == 1:
            return chunk(states, params, cfg, thermo, n_steps,
                         generator=generator)
        u, u0 = self.uniforms(generator, n_steps, cfg.tdtype)
        kw = {"branch_u": u0} if chunk is run_chunk_batched else {}
        return chunk(states, params, cfg, self.thermo(thermo), n_steps,
                     uniforms=u, **kw)
