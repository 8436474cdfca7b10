"""Parallel tempering on one card and over ranks (port of
mpmc_tpu/parallel/replica.py: the swap rules, the library drivers
``run_parallel_tempering_fused`` and ``run_parallel_tempering_fused_multi``,
and the mesh ``PTRunner`` / ``run_parallel_tempering``).

Replicas are the stacked chains of parallel/multichain.py, each at one
rung of a ladder: a temperature ladder (``stack_thermo``) or, at one shared
temperature, a ladder of fugacity rows (``stack_thermo_fugacity``).  As in
the reference, the configuration stays and the rung moves: a swap exchanges
two replicas' temperatures (or fugacity rows).  Neighbour pairs (p, p+1),
(p+2, p+3), ... with p the round's parity; one uniform per pair, read by
both partners from the pair's low lane, so both take the same decision.

- ``host_swap`` / ``host_swap_fugacity``: on the host, with numpy's
  generator (the run seeds it ``default_rng(seed + 101)`` or ``+ 103``),
  for the batched scan route, whose energies come to the host anyway;
- ``ladder_swap_batched`` / ``ladder_swap_fugacity_batched``: on the
  device, for the fused routes (one host fetch per block), over the
  round's uniforms (``swap_uniforms``, from an explicit
  ``torch.Generator``; the tests feed the reference key's instead).

The library drivers run R replicas for n rounds of fused steps, then a
ladder swap on the device each round: ``run_parallel_tempering_fused``
one single-chain launch of B3 (NVT) or B1 (µVT) per replica,
``run_parallel_tempering_fused_multi`` one launch over every replica.

The mesh driver (``PTRunner``, ``run_parallel_tempering``): the reference
puts one replica on each mesh slot and swaps over ``ppermute``; here each
rank of the process group holds its block of R/D replicas (one rank: all
of them) and advances it as batched scan chains, a temperature per
replica.  A swap round's energies and molecule counts meet in one plane
(``ladder_rows``); every rank draws the round's uniforms from a generator
seeded alike, so every rank takes the same decisions and holds the same
ladder, and the replica means come from the same plane.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.state import Params


def geometric_ladder(t_min: float, t_max: float, n: int) -> np.ndarray:
    """Geometric temperature ladder (``parallel_tempering`` +
    ``max_temperature``)."""
    if n == 1:
        return np.array([t_min])
    return t_min * (t_max / t_min) ** (np.arange(n) / (n - 1))


def stack_thermo(thermo: Thermo, temps) -> Thermo:
    """``thermo`` with a per-replica temperature ladder ``temps`` [R];
    every other knob stays shared."""
    t = torch.as_tensor(np.asarray(temps, np.float64),
                        dtype=thermo.temperature.dtype,
                        device=thermo.temperature.device)
    return thermo.replace(temperature=t)


def stack_thermo_fugacity(thermo: Thermo, fug_rows) -> Thermo:
    """``thermo`` with a per-replica fugacity ladder ``fug_rows`` [R, S]
    (atm) at the shared temperature (fixed-T grand-canonical ladder)."""
    f = torch.as_tensor(np.asarray(fug_rows, np.float64),
                        dtype=thermo.fugacity.dtype,
                        device=thermo.fugacity.device)
    return thermo.replace(fugacity=f)


def host_swap_fugacity(fug_rows, n_mols, parity: int,
                       rng) -> Tuple[np.ndarray, int]:
    """Host neighbour FUGACITY swap of a fixed-T grand-canonical ladder:
    with beta shared and every species on one composition ray, the µVT
    swap rule reduces to ln P = (N_i - N_j) ln(F_j / F_i), F the row sum.
    Swaps whole rows.  Returns (fug_rows [R, S], accepted count)."""
    fugs = np.array(fug_rows, np.float64)
    tot = fugs.sum(axis=1)
    n = np.asarray(n_mols, np.float64)
    n_acc = 0
    for lo in range(parity, fugs.shape[0] - 1, 2):
        ln_p = ((n[lo] - n[lo + 1])
                * np.log(tot[lo + 1] / tot[lo]))
        if np.log(rng.random()) < ln_p:
            fugs[[lo, lo + 1]] = fugs[[lo + 1, lo]]
            n_acc += 1
    return fugs, n_acc


def host_swap(temps, energies, parity: int, rng,
              n_mols=None) -> Tuple[np.ndarray, int]:
    """Host neighbour temperature swap: P = min(1, exp[(b_i - b_j)(E_i -
    E_j)]), and for a µVT ladder (``n_mols`` [R]) the factor
    (beta_j / beta_i)^(N_i - N_j) (see _ladder_swap_core).  Returns
    (temps [R], accepted count)."""
    temps = np.array(temps, np.float64)
    energies = np.asarray(energies, np.float64)
    n_acc = 0
    for lo in range(parity, len(temps) - 1, 2):
        ln_p = ((1.0 / temps[lo] - 1.0 / temps[lo + 1])
                * (energies[lo] - energies[lo + 1]))
        if n_mols is not None:
            ln_p += ((float(n_mols[lo]) - float(n_mols[lo + 1]))
                     * np.log(temps[lo] / temps[lo + 1]))
        if np.log(rng.random()) < ln_p:
            temps[lo], temps[lo + 1] = temps[lo + 1], temps[lo]
            n_acc += 1
    return temps, n_acc


def _pairs(R: int, parity: int, device):
    """(in_pair [R] bool, partner [R], pair_lo [R]) of the round."""
    i = torch.arange(R, device=device)
    hi = parity + 2 * ((R - parity) // 2)
    in_pair = (i >= parity) & (i < hi)
    left = in_pair & (((i - parity) % 2) == 0)
    partner = torch.where(in_pair, torch.where(left, i + 1, i - 1), i)
    return in_pair, partner, torch.minimum(i, partner)


def _ladder_swap_core(temps, energies, u, parity: int, n_mols=None):
    """On-device temperature swap of one round: ``temps`` [R], ``energies``
    [R], ``u`` [R] uniforms (pair (lo, lo+1) reads u[lo]).  With ``n_mols``
    [R] (a µVT ladder: the same fugacity, different T) the configurational
    weight (beta f V)^N e^(-beta U) / N! adds (beta_j / beta_i)^(N_i -
    N_j) = exp[(N_i - N_j) ln(T_i / T_j)], symmetric between partners.
    Returns ([R] new temps, accepted pairs as a 0-d int32 tensor)."""
    R = temps.shape[0]
    in_pair, partner, pair_lo = _pairs(R, parity, temps.device)
    t_other = temps[partner]
    e_other = energies[partner]
    ln_p = (1.0 / temps - 1.0 / t_other) * (energies - e_other)
    if n_mols is not None:
        n = n_mols.to(temps.dtype)
        ln_p = ln_p + (n - n[partner]) * (torch.log(temps)
                                          - torch.log(t_other))
    uu = u.to(temps.dtype)[pair_lo]
    accept = in_pair & (torch.log(torch.clamp(uu, min=1e-300)) < ln_p)
    new_t = torch.where(accept, t_other, temps)
    return new_t, torch.sum(accept.to(torch.int32)) // 2


def swap_uniforms(R: int, generator: torch.Generator, dtype):
    """The [R] uniforms of one on-device swap round, from an explicit
    generator on the replicas' device."""
    return torch.rand(R, generator=generator, dtype=dtype,
                      device=generator.device)


def ladder_swap_batched(temps, energy, u, parity: int, n_mols=None):
    """On-device ladder swap for the stacked replicas: ``temps`` [R],
    ``energy`` a stacked EnergyBreakdown (its ``total``) or an [R]
    tensor, ``u`` the round's swap_uniforms.  Returns ([R] new temps,
    accepted pairs)."""
    e = energy.total if hasattr(energy, "total") else energy
    return _ladder_swap_core(temps, e.to(temps.dtype), u, parity,
                             n_mols=n_mols)


def movable_counts(mol_alive, mol_frozen, mol_species):
    """[R] alive movable molecules per replica (the µVT swap factor)."""
    return torch.sum(mol_alive & ~mol_frozen & (mol_species >= 0), dim=-1)


def movable_counts_per_species(mol_alive, mol_frozen, mol_species,
                               sp_ids):
    """[R, S] alive movable molecules per replica and insertable species
    (``sp_ids`` = cfg.insert_species, in that column order)."""
    mov = mol_alive & ~mol_frozen
    return torch.stack([torch.sum(mov & (mol_species == s), dim=-1)
                        for s in sp_ids], dim=-1)


def ladder_swap_fugacity_batched(fug, counts, u, parity: int, sp_ids):
    """On-device neighbour FUGACITY swap of a fixed-T ladder (the fused
    pt_fugacity route): exchanging rungs i and j accepts with ln P =
    sum_s (N_si - N_sj) ln(f_sj / f_si) (beta shared; the ATM2K_A3 V
    factors cancel).  ``fug`` [R, n_species] rows, swapped whole;
    ``counts`` [R, S] in ``sp_ids`` order; ``u`` the round's
    swap_uniforms, the pair coin as in _ladder_swap_core.  Returns
    ([R, n_species] rows, accepted pairs)."""
    R = fug.shape[0]
    in_pair, partner, pair_lo = _pairs(R, parity, fug.device)
    cols = torch.as_tensor(sp_ids, dtype=torch.int64, device=fug.device)
    lnf = torch.log(torch.clamp(fug[:, cols], min=1e-300))
    n = counts.to(fug.dtype)
    ln_p = torch.sum((n - n[partner]) * (lnf[partner] - lnf), dim=-1)
    uu = u.to(fug.dtype)[pair_lo]
    accept = in_pair & (torch.log(torch.clamp(uu, min=1e-300)) < ln_p)
    new_f = torch.where(accept[:, None], fug[partner], fug)
    return new_f, torch.sum(accept.to(torch.int32)) // 2


def _pt_refusals(cfg: RunConfig):
    """The refusals both library drivers share (the reference's): pair
    energies that depend on T (a swap would leave the carried totals
    stale), spinflip moves (per-replica rotor tables), and NVE (its
    acceptance never reads T)."""
    if cfg.feynman_hibbs or cfg.feynman_kleinert:
        raise ValueError("fused PT does not support T-dependent pair "
                         "energies (feynman_hibbs/kleinert)")
    if cfg.quantum_rotation and cfg.ensemble != "nve":
        raise ValueError("fused PT does not support quantum_rotation "
                         "spinflip moves — use run_mc_pt")
    if cfg.ensemble == "nve":
        raise ValueError("fused PT is undefined for ensemble nve (the NVE "
                         "acceptance does not read T)")


def _round_uniforms(round_uniforms, r, R, gen, dtype):
    """Round ``r``'s [R] swap uniforms: the injected row, or drawn."""
    if round_uniforms is not None:
        return torch.as_tensor(round_uniforms[r], dtype=dtype,
                               device=gen.device)
    return swap_uniforms(R, gen, dtype)


def _finish(temps, n_acc):
    """(temps ndarray, accepted swaps) in the drivers' one host fetch."""
    host = torch.cat([temps.double(), n_acc.double().reshape(1)]).cpu()
    return host[:-1].numpy(), int(host[-1])


def run_parallel_tempering_fused(params, state, cfg: RunConfig,
                                 thermo: Thermo, temps, n_rounds: int,
                                 steps_per_round: int, seed: int = 0,
                                 round_uniforms=None, trace=None):
    """Single-card PT over the single-chain fused paths (the reference's
    run_parallel_tempering_fused, mpmc_tpu/parallel/replica.py:400-496):
    each round every replica runs ``steps_per_round`` steps in one launch
    of B3 (NVT, mc_kernel.supported) or B1 (µVT, supported_uvt), a
    refresh (metropolis.initialize) every corrtime but after the last
    round, then one on-device ladder swap of neighbour temperatures
    (_ladder_swap_core; with each replica's molecule count under µVT).
    The replicas' uniform tables come from a torch.Generator seeded
    ``seed``, the round uniforms from one seeded ``seed + 7`` (or the
    injected [n_rounds, R] ``round_uniforms``); ``trace`` gets each
    round's inputs and decisions.  Returns (list of R states, [R] final
    temperatures ndarray, accepted swaps), after one host fetch."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel
    _pt_refusals(cfg)
    if mc_kernel.supported(cfg, params):
        runner = metropolis.run_chunk_fused
        tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    elif mc_kernel.supported_uvt(cfg, params):
        runner = metropolis.run_chunk_fused_uvt
        tables = metropolis.uvt_fused_tables(params, cfg)
    else:
        raise ValueError("fused PT needs a fused-gate-supported config "
                         "(mc_kernel.supported / supported_uvt)")
    uvt = cfg.ensemble == "uvt"
    R = len(temps)
    dev = state.pos.device
    dtype = thermo.temperature.dtype
    state = metropolis.initialize(state, params, cfg, thermo)
    states = [state] * R
    temp_t = torch.as_tensor(np.asarray(temps, np.float64), dtype=dtype,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    swap_gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    corr = max(int(cfg.corrtime), 1)
    since_refresh = 0
    fr = metropolis.frozen_refresh_rows(params, cfg)
    for r in range(n_rounds):
        thermos = [thermo.replace(temperature=temp_t[i]) for i in range(R)]
        states = [runner(states[i], params, cfg, thermos[i],
                         steps_per_round, generator=gen, tables=tables)[0]
                  for i in range(R)]
        since_refresh += steps_per_round
        if since_refresh >= corr and r + 1 < n_rounds:
            states = [metropolis.initialize(states[i], params, cfg,
                                            thermos[i], frozen_rows=fr)
                      for i in range(R)]
            since_refresh = 0
        energies = torch.stack([st.energy.total for st in states])
        n_mols = (torch.stack([st.n_molecules(params) for st in states])
                  if uvt else None)
        u = _round_uniforms(round_uniforms, r, R, swap_gen, dtype)
        new_t, acc = _ladder_swap_core(temp_t, energies.to(dtype), u, r % 2,
                                       n_mols=n_mols)
        if trace is not None:
            trace.append({"temps": temp_t, "energies": energies,
                          "n_mols": n_mols, "u": u, "parity": r % 2,
                          "new_temps": new_t, "accepted": acc})
        temp_t = new_t
        n_acc = n_acc + acc
    final, n = _finish(temp_t, n_acc)
    return states, final, n


def run_parallel_tempering_fused_multi(params, state, cfg: RunConfig,
                                       thermo: Thermo, temps,
                                       n_rounds: int, steps_per_round: int,
                                       seed: int = 0, round_uniforms=None,
                                       trace=None):
    """Single-card PT with every replica in one launch a round (the
    reference's run_parallel_tempering_fused_multi and its rounds,
    mpmc_tpu/parallel/replica.py:499-644): B3 over the R chains (NVT,
    mc_kernel.supported_multi) or B1 (µVT, supported_uvt_multi; the
    fugacity shared, the swap with each replica's molecule count), one
    beta per chain; a batched refresh (multichain.initialize_batched)
    every corrtime but after the last round; then one on-device
    ladder_swap over the replicas.  The chain width is bounded by the
    card's cluster fitting (mc_kernel.cluster_size), not by a fixed cap.
    Uniforms, ``trace`` and the host fetch as in
    run_parallel_tempering_fused.  Returns (stacked states [R, ...], [R]
    final temperatures ndarray, accepted swaps)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel
    from mpmc_tpu_torch.parallel import multichain
    _pt_refusals(cfg)
    uvt = cfg.ensemble == "uvt"
    if uvt:
        if not mc_kernel.supported_uvt_multi(cfg, params):
            raise ValueError("multi-chain fused µVT PT needs "
                             "mc_kernel.supported_uvt_multi(cfg, params)")
        runner = metropolis.run_chunk_fused_uvt_multi
        tables = metropolis.uvt_fused_tables(params, cfg)
    elif mc_kernel.supported_multi(cfg, params):
        runner = metropolis.run_chunk_fused_multi
        tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    else:
        raise ValueError("multi-chain fused PT needs "
                         "mc_kernel.supported_multi(cfg, params)")
    R = len(temps)
    dev = state.pos.device
    state = metropolis.initialize(state, params, cfg, thermo)
    states = multichain.stack_states(state, R)
    thermos = stack_thermo(thermo, temps)
    dtype = thermos.temperature.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    swap_gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    corr = max(int(cfg.corrtime), 1)
    since_refresh = 0
    fr = metropolis.frozen_refresh_rows(params, cfg)
    for r in range(n_rounds):
        since_refresh += steps_per_round
        states, _ = runner(states, params, cfg, thermos, steps_per_round,
                           generator=gen, tables=tables)
        if since_refresh >= corr and r + 1 < n_rounds:
            states = multichain.initialize_batched(states, params, cfg,
                                                   thermos, frozen_rows=fr)
            since_refresh = 0
        n_mols = (movable_counts(states.mol_alive, params.mol_frozen,
                                 params.mol_species) if uvt else None)
        u = _round_uniforms(round_uniforms, r, R, swap_gen, dtype)
        t_in = thermos.temperature
        new_t, acc = _ladder_swap_core(t_in, states.energy.total.to(dtype),
                                       u, r % 2, n_mols=n_mols)
        if trace is not None:
            trace.append({"temps": t_in, "energies": states.energy.total,
                          "n_mols": n_mols, "u": u, "parity": r % 2,
                          "new_temps": new_t, "accepted": acc})
        thermos = thermos.replace(temperature=new_t)
        n_acc = n_acc + acc
    final, n = _finish(thermos.temperature, n_acc)
    return states, final, n


# ---------------------------------------------------------------------------
# the mesh driver: replicas in blocks over the ranks of a process group
# ---------------------------------------------------------------------------

def ladder_rows(blk, energy, n_mols=None):
    """(energy [R], n_mols [R] or None) of the whole ladder from this
    rank's block (multichain.ChainBlock ``blk``): one plane, none at D =
    1.  The values travel in float64 (exact for the float32 energies and
    the counts) and come back in their own types."""
    if blk.D == 1:
        return energy, n_mols
    cols = [energy.double()] + ([] if n_mols is None else [n_mols.double()])
    full = blk.rows(torch.stack(cols, -1))
    return (full[:, 0].to(energy.dtype),
            None if n_mols is None else full[:, 1].to(n_mols.dtype))


class PTRunner:
    """One parallel-tempering round over the ranks (the reference's
    PTRunner, mpmc_tpu/parallel/replica.py:133): this rank's block of the
    R replicas advances ``steps_per_round`` steps of ``chunk`` (a
    stacked-chain route; default the batched scan chains), each replica
    at its rung's temperature, then one neighbour swap of temperatures
    with a shared coin per pair (_ladder_swap_core; under µVT with each
    replica's movable count), and the replica means of the energy and the
    molecule count.  run_mc_pt drives its ladder through it, over
    ``chain_devices`` ranks (``D``; default the group's)."""

    def __init__(self, params: Params, cfg: RunConfig, R: int,
                 steps_per_round: int, device=None, chunk=None, D=None):
        from mpmc_tpu_torch.parallel import multichain, multihost
        self.params, self.cfg, self.R = params, cfg, R
        self.steps = steps_per_round
        self.chunk = multichain.run_chunk_batched if chunk is None else chunk
        self.blk = multichain.ChainBlock(
            R, multihost.world() if D is None else D, "n_replicas",
            device=device)

    def advance(self, states, thermos: Thermo, generator):
        """(block states, energy [R], movable counts [R], block stats):
        this rank's block advances one round's steps, then the ladder's
        energies and counts meet in one plane (``ladder_rows``)."""
        params = self.params
        states, stats = self.blk.chunk(self.chunk, states, params, self.cfg,
                                       thermos, self.steps, generator)
        energy, n = ladder_rows(
            self.blk, states.energy.total,
            movable_counts(states.mol_alive, params.mol_frozen,
                           params.mol_species))
        return states, energy, n, stats

    def round(self, states, thermos: Thermo, generator, u, parity: int):
        """(block states, thermos with the new [R] ladder, record) of one
        round: ``states`` this rank's block, ``thermos`` the whole ladder,
        ``u`` the round's [R] swap uniforms (the same on every rank)."""
        states, energy, n, stats = self.advance(states, thermos, generator)
        n_mols = n if self.cfg.ensemble == "uvt" else None
        t_in = thermos.temperature
        new_t, acc = _ladder_swap_core(t_in, energy.to(t_in.dtype), u,
                                       parity, n_mols=n_mols)
        rec = {"temps": t_in, "energies": energy, "n_mols": n_mols, "u": u,
               "parity": parity, "new_temps": new_t, "accepted": acc,
               "mean_energy": energy.double().mean(),
               "mean_N": n.double().mean(),
               "swap_acceptance": 2.0 * acc.double() / self.R,
               "stats": stats}
        return states, thermos.replace(temperature=new_t), rec


def run_parallel_tempering(params, state, cfg: RunConfig, thermo: Thermo,
                           temps, n_rounds: int, steps_per_round: int,
                           seed: int = 0, round_uniforms=None, trace=None,
                           log=None):
    """Drive a PT run over the ranks of the process group (one rank:
    all replicas on it) — the reference's run_parallel_tempering
    (mpmc_tpu/parallel/replica.py:237): replicate, then alternate
    even/odd swap rounds.  The replicas' uniform tables come from a
    generator seeded ``seed`` (every rank draws the whole table and keeps
    its rows), the swap uniforms from one seeded ``seed + 7`` (or the
    injected [n_rounds, R] ``round_uniforms``).  Returns (this rank's
    block of states, the final [R] ladder ndarray, history: a dict a
    round with the replica-mean energy and N, the swap acceptance and the
    ladder); ``trace`` gets each round's record, and rank 0 prints each
    round to ``log`` (the multi-host drive, mpmc_tpu/parallel/
    multihost.py:98: every process calls this with the same inputs)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain, multihost
    temps = np.asarray(temps, np.float64)
    R = len(temps)
    multihost.global_replica_mesh(R)
    if metropolis.spinflip_active(cfg):
        raise ValueError("mesh parallel tempering does not support "
                         "quantum_rotation spinflip moves — use the "
                         "single-card PT driver (run_mc_pt)")
    dev = state.pos.device
    state = metropolis.initialize(state, params, cfg, thermo)
    states = multihost.distribute(multichain.stack_states(state, R), R)
    thermos = stack_thermo(thermo, temps)
    dtype = thermos.temperature.dtype
    runner = PTRunner(params, cfg, R, steps_per_round, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    swap_gen = torch.Generator(device=dev).manual_seed(seed + 7)
    history = []
    for r in range(n_rounds):
        u = _round_uniforms(round_uniforms, r, R, swap_gen, dtype)
        states, thermos, rec = runner.round(states, thermos, gen, u, r % 2)
        if trace is not None:
            trace.append(rec)
        history.append({
            "round": r, "mean_energy": float(rec["mean_energy"]),
            "mean_N": float(rec["mean_N"]),
            "swap_acceptance": float(rec["swap_acceptance"]),
            "temperatures": thermos.temperature.double().cpu().tolist()})
        if log is not None and multihost.is_root():
            print(f"PT round {r}: <E>={history[-1]['mean_energy']:.3f} "
                  f"swap_acc={history[-1]['swap_acceptance']:.2f}",
                  file=log, flush=True)
    return states, thermos.temperature.double().cpu().numpy(), history
