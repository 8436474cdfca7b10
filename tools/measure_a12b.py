"""Where the time of PR 19's decks goes, on the card: the polar NPT step
(scan and 8 batched chains), its volume attempt, the per-chain
``move_deltas`` of the NPT chains, and the rd_crystal step.

    python tools/measure_a12b.py [out.json]

Systems are chip_smoke.py's: ``polar_fluid`` (3,456 polar H2, 10,368
sites, 77 K, 200 atm, float32) and the fcc argon crystal of
``phase_rd_crystal`` (256 atoms, order 3, float64).  Each chunk runs once
untimed, then once on the host clock and once under torch.profiler
(chip_smoke._profile: ms per step, device busy share, the named kernel's
share of the device time, top kernels).  The polar volume attempt: 10
steps at volume_probability 1 against 10 at 0 (host clock, median of 3).
The NPT chains' move_deltas: one call over 8 chains with a cell per
chain (a per-chain loop) against the same call with the shared cell of
chain 0 (one batched call), host clock, median of 5.  Needs a CUDA
device.
"""
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(out):
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.mc import metropolis, moves
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import thole
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import build_system, chain_rows
    dev, smi = cs.phase_device()
    rep = {"device": smi}
    g = torch.Generator(device=dev).manual_seed(3)
    params, state, cfg, thermo = cs.polar_fluid("float32", dev)
    state = metropolis.initialize(state, params, cfg, thermo)
    rep["npt_polar"] = cs._profile(
        "npt_polar", lambda: metropolis.run_chunk(
            state, params, cfg, thermo, 50, generator=g), 50, dev,
        kernel="thole_field")

    def steps(pv):
        th = thermo.replace(volume_probability=torch.full_like(
            thermo.volume_probability, pv))
        return statistics.median(cs._clock_host(
            lambda: metropolis.run_chunk(state, params, cfg, th, 10,
                                         generator=g), dev)
            for _ in range(3)) * 1e2
    vol_ms, disp_ms = steps(1.0), steps(0.0)
    rep["npt_polar_volume_attempt_ms"] = vol_ms
    rep["npt_polar_displace_step_ms"] = disp_ms
    C = cs.C_POLAR
    f = torch.linspace(*cs.HEADER_SCALE, C, dtype=torch.float64)
    pos, box = moves.scale_volume(
        state.pos.expand(C, -1, -1), state.box.expand(C, 3, 3), params,
        (3.0 * torch.log(f)).to(device=dev, dtype=state.pos.dtype))
    states = multichain.initialize_batched(
        multichain.stack_states(state, C).replace(pos=pos.contiguous(),
                                                  box=box.contiguous()),
        params, cfg, thermo)
    rep["npt_polar_c8"] = cs._profile(
        "npt_polar_c8", lambda: multichain.run_chunk_batched(
            states, params, cfg, thermo, 20, generator=g), 20, dev,
        kernel="thole_field")
    alive = states.mol_alive[:, params.mol_id] & params.atom_ok
    mol = torch.full((C,), int(torch.nonzero(states.mol_alive[0])[0]),
                     device=dev)
    rows = chain_rows(states.pos, params, mol) + 0.3

    def deltas(b):
        return thole.move_deltas(states.pos, b, alive, params, cfg, mol,
                                 states.e0, states.mu, states.r_pol,
                                 new_rows=rows, with_residual=False,
                                 sk=(states.sk_re, states.sk_im))
    rep["move_deltas_c8_per_chain_cells_ms"] = statistics.median(
        cs._clock_host(lambda: deltas(states.box), dev)
        for _ in range(5)) * 1e3
    rep["move_deltas_c8_shared_cell_ms"] = statistics.median(
        cs._clock_host(lambda: deltas(states.box[0]), dev)
        for _ in range(5)) * 1e3
    a = 5.26
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                      [0, 0.5, 0.5]])
    ijk = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    sites = ((ijk[:, None, :] + basis[None]) * a).reshape(-1, 3)
    sp = systems.lj_atom(name="AR")
    p2, s2 = build_system(np.eye(3) * 4 * a, species=(sp,),
                          capacity=(len(sites),),
                          initial_counts=(len(sites),),
                          initial_pos={0: sites[:, None, :]},
                          dtype=torch.float64, device=dev)
    c2 = RunConfig(ensemble="nvt", coulomb="none", dtype="float64",
                   rd_crystal=True, rd_crystal_order=3, rd_lrc=False)
    t2 = Thermo.make(temperature=40.0, move_factor=0.1, rot_factor=0.0,
                     n_species=1, dtype=torch.float64, device=dev)
    s2 = metropolis.initialize(s2, p2, c2, t2)
    rep["rd_crystal"] = cs._profile(
        "rd_crystal", lambda: metropolis.run_chunk(s2, p2, c2, t2, 100,
                                                   generator=g), 100, dev,
        kernel="mol_pair")
    print(json.dumps({k: v for k, v in rep.items()
                      if not isinstance(v, dict)}))
    with open(out, "w") as fh:
        json.dump(rep, fh, indent=1)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "a12b.json")
