"""B3 and B6 under coulomb gwp with a quantum correction (rd lj): the
instances no deck launches, timed on the card tests' shapes.

    python tools/measure_gwp_fh.py [out.json]

The systems are those of tests/test_torch_cuda.py's
test_nvt_kernel_rd_forms_match_plain and test_pda_kernel_rd_forms_match_
plain for the forms gwp+fh2, gwp+fh4 and gwp+fk: the MOF + H2 system
(n_side 6, 20 H2; B3's with 20 slots, B6's polar with 40) with GWP widths
0.2-0.6 A (numpy seed 17) on every charged site, jittered (seed 7) and
initialized, float32.  B3 runs one chain (C = 1) on a numpy-seeded [1,
200, 16] table, B6 a survivor-free 16-step table (chip_smoke's
_pda_survivor_free), both at G = 16.  Each is timed per step with
chip_smoke.time_calls (CUDA events, median of 20 launches) and on the card
alone (chip_smoke.time_device; where the host cannot queue ahead of so
short a launch, the kernel's device time in a torch.profiler trace), its
plain version once on the card, and
its bound from the operations the plain version's trace counts
(chip_smoke._fused_ops / _pda_ops) and the bytes of its arguments.
Needs a CUDA device.
"""
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANTUM = {"fh2": {"feynman_hibbs": True},
           "fh4": {"feynman_hibbs": True, "feynman_hibbs_order": 4},
           "fk": {"feynman_kleinert": True}}
K_NVT = 200


def _system(device, q, ensemble, capacity, polarization=False):
    """The card tests' _fused_form_system for the form gwp+<q>."""
    import torch

    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=capacity, dtype="float32",
        device=device, polarization=polarization)
    cfg = dataclasses.replace(cfg, **QUANTUM[q])
    charge = params.charge.cpu().numpy()
    w = np.random.default_rng(17).uniform(0.2, 0.6, charge.shape)
    params = params.replace(gwp_alpha=torch.as_tensor(
        np.where(charge != 0, w, 0.0), dtype=params.eps.dtype,
        device=device))
    cfg = dataclasses.replace(cfg, coulomb="gwp", ensemble=ensemble,
                              fused_mc=True)
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    return params, state, cfg, thermo


def _card_ms(cs, fn, dev, n, kernel):
    """ms of one call on the card alone: chip_smoke.time_device (calls
    back to back behind a spin kernel), or, where the host cannot queue
    ahead of so short a launch, the device time of the CUDA kernels whose
    name holds ``kernel`` in a torch.profiler trace of n calls (None if
    the trace shows none)."""
    import torch
    try:
        return cs.time_device(fn, dev, n=n), "time_device"
    except AssertionError:
        pass
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
    us = sum(getattr(e, "device_time_total", 0.0) or
             getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages() if kernel in e.key)
    return (us / 1e3 / n if us > 0 else None), "profiler"


def main(out=None):
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import _build
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    dev, smi = cs.phase_device()
    for name in _build.build():
        _build.library(name)
    rng = np.random.default_rng(2030)
    rep = {"card": smi}
    for q in QUANTUM:
        # B3, one chain
        params, state, cfg, thermo = _system(dev, q, "nvt", 20)
        u = torch.as_tensor(rng.random((1, K_NVT, 16)), dtype=cfg.tdtype,
                            device=dev)
        a, kw = metropolis.fused_nvt_launch_args(
            multichain.stack_states(state, 1), params, cfg, thermo, u,
            metropolis.nvt_fused_tables(params, state.mol_alive))
        launch = lambda: mk.run_steps(*a, **kw, cluster=16)  # noqa: E731
        trace = []
        pms = cs.time_calls(lambda: mk.run_steps_plain(*a, **kw), dev,
                            n=1) / K_NVT
        mk.run_steps_plain(*a, **kw, trace=trace)
        nk = kw["kvecs"].shape[0] if kw.get("kvecs") is not None else 0
        ops = cs._fused_ops(trace, cfg, nk)
        bound, by = cs._bound_ms(ops, cs._nbytes(*[
            x for x in a if torch.is_tensor(x)], *[
            v for v in kw.values() if torch.is_tensor(v)]))
        card, how = _card_ms(cs, launch, dev, 20, "nvt")
        rep[f"b3_gwp_{q}"] = {
            "ms": cs.time_calls(launch, dev) / K_NVT,
            "device_ms": None if card is None else card / K_NVT, "by": how,
            "plain_ms": pms, "bound_ms": bound / K_NVT, "bound_by": by,
            "ops_per_step": ops / K_NVT, "steps": K_NVT, "C": 1, "G": 16}
        # B6, the polar system's survivor-free table
        params, state, cfg, thermo = _system(dev, q, "uvt", 40,
                                             polarization=True)
        cfg = dataclasses.replace(cfg, polar_delayed=True)
        state = metropolis.initialize(state, params, cfg, thermo)
        tables = metropolis.uvt_fused_tables(params, cfg)

        def args_of(u):
            return metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                              tables)

        def b6(u):
            x, y = args_of(u)
            return mk.run_steps_uvt_pda(*x, **y, cluster=16)

        u = cs._pda_survivor_free(b6, torch.as_tensor(
            rng.random((mk.PDA_SEG, 16)), dtype=cfg.tdtype, device=dev), rng)
        a, kw = args_of(u)
        trace = []
        mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)
        nk = kw["kvecs"].shape[0] if kw.get("kvecs") is not None else 0
        ops = cs._pda_ops(trace, "direct", nk, mk.quantum_option(cfg), cfg)
        bound, by = cs._bound_ms(ops, cs._nbytes(*[
            x for x in a if torch.is_tensor(x)], *[
            v for v in kw.values() if torch.is_tensor(v)]) + 8 * 16 * 8)
        S = mk.PDA_SEG
        card, how = _card_ms(cs, lambda: b6(u), dev, 50, "pda")
        rep[f"b6_gwp_{q}"] = {
            "ms": cs.time_calls(lambda: b6(u), dev) / S,
            "device_ms": None if card is None else card / S, "by": how,
            "plain_ms": cs.time_calls(lambda: mk.run_steps_uvt_pda_plain(
                *a, **kw), dev, n=1) / S,
            "bound_ms": bound / S, "bound_by": by, "ops_per_step": ops / S,
            "steps": S, "G": 16}
        for k in (f"b3_gwp_{q}", f"b6_gwp_{q}"):
            e = rep[k]
            card = ("not measured" if e["device_ms"] is None else
                    f"{e['device_ms'] * 1e3:.3f}")
            print(f"{k}: {e['ms'] * 1e3:.3f} us/step per call, {card} on "
                  f"the card alone ({e['by']}); plain "
                  f"{e['plain_ms'] * 1e3:.1f}; bound "
                  f"{e['bound_ms'] * 1e3:.4f} us/step ({e['bound_by']}; "
                  f"{e['ops_per_step']:.3e} ops/step)", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
