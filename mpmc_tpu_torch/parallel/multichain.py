"""Many independent MC chains on one card (port of the fused-path part of
mpmc_tpu/parallel/multichain.py).

A stacked state is a ``SimState`` whose tensor fields carry a leading [C]
(``state.stack_chains``); ``state.slice_chain`` takes one chain back out.
The chains advance together in one launch of the fused µVT kernel
(mc/metropolis.run_chunk_fused_uvt_multi), each with its own rows of one
uniform table drawn from one torch.Generator, so every chain is a valid
Metropolis chain of its own.  The batched scan path (``run_chunk_batched``)
is ROADMAP A7.
"""
from __future__ import annotations

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.mc import metropolis
from mpmc_tpu_torch.state import Params, SimState, slice_chain, stack_chains


def stack_states(state: SimState, n: int) -> SimState:
    """``n`` copies of one state, stacked (each chain owns its tensors)."""
    return stack_chains([state] * n)


def initialize_batched(states: SimState, params: Params, cfg: RunConfig,
                       thermo: Thermo, frozen_rows: int = 0) -> SimState:
    """Full-energy refresh of every chain, one after the other (the
    reference maps the refresh over chains too: a batched O(N^2) pass
    would hold a [C, rows, N] tile, and it runs once per corrtime).
    ``frozen_rows`` as in metropolis.initialize."""
    return stack_chains([
        metropolis.initialize(slice_chain(states, c), params, cfg, thermo,
                              frozen_rows=frozen_rows)
        for c in range(states.pos.shape[0])])
