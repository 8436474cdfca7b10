"""A multi-device dry run on tiny shapes (the port's analog of
``dryrun_multichip`` in the reference's __graft_entry__.py): over D ranks
it drives the chain axis, the PT ladder, the sharded pair / reciprocal /
SCF passes and the spatial MC step once each, and checks that what comes
out is finite and agrees across ranks.

    python -m mpmc_tpu_torch.parallel.dryrun 2 --cpu     # 2 gloo CPU ranks
    python -m mpmc_tpu_torch.parallel.dryrun 2           # 2 GPUs (NCCL)

``run(device)`` is the body each rank runs inside its process group;
``main`` starts the ranks (parallel/multihost.spawn).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mpmc_tpu_torch.parallel import multihost


def run(device):
    """The dry run on this rank (module docstring)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.parallel import multichain, replica, spatial

    D = multihost.world()
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, ewald_kmax=3, corrtime=4,
        device=device)

    # the replica axis: a PT round of R = 2D replicas, R/D on each rank
    temps = replica.geometric_ladder(77.0, 200.0, 2 * D)
    _, ladder, history = replica.run_parallel_tempering(
        params, state, cfg, thermo, temps, n_rounds=2, steps_per_round=4)
    assert np.isfinite(history[-1]["mean_energy"])
    assert np.allclose(np.sort(ladder), np.sort(temps))

    # the chain axis: 2D chains, a block of 2 on each rank, one chunk and
    # a refresh, then the stack gathered
    st0 = metropolis.initialize(state, params, cfg, thermo)
    blk = multichain.ChainBlock(2 * D, D, device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    loc, _ = blk.chunk(multichain.run_chunk_batched,
                       blk.local(multichain.stack_states(st0, 2 * D)),
                       params, cfg, thermo, 4, gen)
    loc = multichain.initialize_batched(loc, params, cfg, thermo)
    chains = blk.gather(loc)
    assert torch.isfinite(chains.energy.total).all()

    # the atom axis: the row-tiled pair pass and the k-split reciprocal sum
    alive = state.atom_alive(params)
    t = spatial.pair_pass_sharded(state.pos, state.box, alive, params, cfg,
                                  thermo.temperature)
    rc = pairs.derived_cutoff(state.box, cfg)
    e_recip = spatial.recip_energy_sharded(
        state.pos, params.charge, alive, state.box,
        pairs.derived_alpha(rc, cfg), cfg.ewald_kmax)
    assert bool(torch.isfinite(t.rd)) and bool(torch.isfinite(e_recip))

    # the row-tiled Thole SCF: one [N, 3] all-reduce per CG iteration
    pparams, pstate, pcfg, _ = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, ewald_kmax=3, polarization=True,
        device=device)
    palive = pstate.atom_alive(pparams)
    e0 = spatial.static_field_sharded(pstate.pos, pstate.box, palive,
                                      pparams, pcfg)
    mu, it = spatial.solve_scf_sharded(pstate.pos, pstate.box, palive,
                                       pparams, pcfg, e0)
    assert bool(torch.isfinite(mu).all()) and it >= 1
    assert torch.allclose(e0, thole.static_field(pstate.pos, pstate.box,
                                                 palive, pparams, pcfg),
                          rtol=1e-4, atol=1e-6)

    # the spatial MC step: replicated state, sharded passes, lockstep
    gen = torch.Generator(device=device).manual_seed(5)
    st_sp, stats = spatial.run_chunk_spatial(st0, params, cfg, thermo, 6,
                                             generator=gen)
    st_sp = spatial.initialize_spatial(st_sp, params, cfg, thermo)
    spatial.check_lockstep(st_sp, "dry run")
    assert int(np.asarray(stats.attempts).sum()) == 6
    assert bool(torch.isfinite(st_sp.energy.total))
    if multihost.is_root():
        print(f"dry run: {D} ranks on {device}: PT ladder "
              f"{np.round(ladder, 2).tolist()}, chains "
              f"{chains.pos.shape[0]}, pair rd {float(t.rd):.6g}, recip "
              f"{float(e_recip):.6g}, SCF {it} iterations, spatial MC "
              f"E {float(st_sp.energy.total):.6g}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mpmc_tpu_torch.parallel.dryrun")
    ap.add_argument("ranks", type=int, help="D, the ranks to start")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None)
    args = ap.parse_args(argv)
    multihost.check_devices(args.ranks, "dry run ranks", args.cpu)
    multihost.spawn(run, args.ranks, cpu=args.cpu,
                    backend=args.dist_backend)


if __name__ == "__main__":
    main()

