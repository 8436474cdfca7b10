"""Many independent MC chains on one card (port of
mpmc_tpu/parallel/multichain.py, without the chain_devices sharding of
ROADMAP A13).

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

Statistical note (the reference's): the chains share the move *type* of
each step — here chain 0's lane 8 — while every chain draws its own
target, displacement and acceptance coin from its own row.  Each chain
remains a valid Metropolis chain; only the move-type sequence is shared,
which does not bias any chain's stationary distribution.
"""
from __future__ import annotations

import dataclasses

import torch

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.mc import metropolis
from mpmc_tpu_torch.ops import thole
from mpmc_tpu_torch.state import Params, SimState, slice_chain, stack_chains


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
                      uniforms=None, trace=None):
    """Advance C stacked chains ``n_steps`` steps each, in lockstep;
    returns (states, MCStats with [C, 5] counts).

    The [C, n_steps, 16] uniform table is ``uniforms`` when given (tests
    inject it), else drawn from ``generator`` (a torch.Generator on the
    states' device).  ``thermo`` may be per chain (the reference's
    ``thermo_batched``: ``temperature`` [C], ``fugacity`` [C, S]); the
    move-type probabilities and move sizes are shared.  ``trace``: a list
    that gets the step's record (make_batched_step_fn).  The chains' mu,
    e0 and r_pol are carried (polarization), and under NPT each chain's
    box."""
    C = states.pos.shape[0]
    if uniforms is None:
        uniforms = torch.rand((C, n_steps, metropolis.N_LANES),
                              generator=generator, dtype=cfg.tdtype,
                              device=generator.device)
    step, carry, c, branch, stats = metropolis.batched_chunk_setup(
        states, params, cfg, thermo, uniforms)
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
