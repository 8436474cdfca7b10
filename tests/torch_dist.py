"""Shared set-up of the multi-device CPU tests: D gloo ranks on the CPU,
spawned once for many cases (parallel/multihost.spawn), each rank's
results saved by ``torch.save`` and read back by the test process.

The rank functions live here (a module that imports no JAX) so the
spawned processes import only the port."""
import pathlib

import torch


def run_ranks(fn, D, tmp_path, *args):
    """[rank 0's result, ..., rank D-1's] of ``fn(device, *args)`` run on
    D gloo ranks on the CPU (one process group for all of them)."""
    return run_groups(fn, (D,), tmp_path, *args)[D]


def run_groups(fn, Ds, tmp_path, *args):
    """{D: run_ranks(fn, D, ...)} for each D of ``Ds``, the groups started
    together (threads of this process, each waiting on its ranks)."""
    return start_groups(fn, Ds, tmp_path, *args)()


def start_groups(fn, Ds, tmp_path, *args):
    """Start run_groups' ranks and return a function that waits for them
    and returns its result: the caller computes its references
    meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    from mpmc_tpu_torch.parallel import multihost

    def one(D):
        out = pathlib.Path(tmp_path) / f"ranks_{fn.__name__}_{D}"
        out.mkdir(parents=True, exist_ok=True)
        multihost.spawn(_rank, D, args=(fn, str(out), args), cpu=True,
                        timeout=120)
        return [torch.load(out / f"rank{d}.pt", weights_only=False)
                for d in range(D)]

    ex = ThreadPoolExecutor(len(Ds))
    futs = {D: ex.submit(one, D) for D in Ds}

    def wait():
        try:
            return {D: f.result() for D, f in futs.items()}
        finally:
            ex.shutdown()
    return wait


def _rank(device, fn, out, args):
    from mpmc_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    res = fn(device, *args)
    torch.save(res, pathlib.Path(out) / f"rank{multihost.rank()}.pt")


def to_np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def spatial_passes(device, cases):
    """Each case (name, P, S, C, T): the sharded passes of
    parallel/spatial.py on this rank — pair terms, the reciprocal sum,
    the static field, the SCF (mu, iterations) where polar, and the total
    energy's terms."""
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.parallel import spatial
    out = {}
    for name, P, S, C, T in cases:
        alive = S.mol_alive[P.mol_id] & P.atom_ok
        pt = spatial.pair_pass_sharded(S.pos, S.box, alive, P, C,
                                       T.temperature)
        r = {"pair": [float(getattr(pt, k)) for k in
                      ("rd", "es_real", "es_excl", "lrc_coeff", "min_r2")]}
        rc = pairs.derived_cutoff(S.box, C)
        if C.coulomb == "ewald":
            r["recip"] = float(spatial.recip_energy_sharded(
                S.pos, P.charge, alive, S.box, pairs.derived_alpha(rc, C),
                C.ewald_kmax))
        if C.polarization:
            e0 = spatial.static_field_sharded(S.pos, S.box, alive, P, C)
            mu, it = spatial.solve_scf_sharded(S.pos, S.box, alive, P, C, e0)
            r["e0"], r["mu"], r["iters"] = to_np(e0), to_np(mu), int(it)
        e, _ = spatial.total_energy_sharded(S.pos, S.box, S.mol_alive, P, C,
                                            T)
        r["te"] = {k: float(getattr(e, k)) for k in
                   ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
                    "polar", "vdw")}
        out[name] = r
    return out


def spatial_mc(device, cases):
    """Each case (name, P, S, C, T, uniforms [K, 16]): the spatial MC
    step on this rank — the sharded refresh, K steps of
    spatial.run_chunk_spatial over the injected uniforms, a fresh sharded
    recompute — and the rank's collectives."""
    from mpmc_tpu_torch.parallel import multihost, spatial
    out = {}
    for name, P, S, C, T, U in cases:
        st = spatial.initialize_spatial(S, P, C, T)
        multihost.reset_counts()
        st, stats = spatial.run_chunk_spatial(st, P, C, T, U.shape[0],
                                              uniforms=U)
        coll = {k: v for k, v in multihost.counts.items()
                if k != "seconds"}      # the same on every rank
        fresh = spatial.initialize_spatial(st, P, C, T)
        spatial.check_lockstep(st, name)
        out[name] = {"pos": to_np(st.pos), "box": to_np(st.box),
                     "mol_alive": to_np(st.mol_alive),
                     "energy": float(st.energy.total),
                     "fresh": float(fresh.energy.total),
                     "accepts": to_np(stats.accepts),
                     "attempts": to_np(stats.attempts),
                     "polar_iters": int(stats.polar_iters),
                     "collectives": coll}
    return out


def gcmc_deck(tmp_path, extra="", numsteps=40, precision="float64",
              name="deck", polar=False):
    """A small MOF + H2 GCMC deck (n_side 3, 12 H2 slots; polarizable
    framework with ``polar``) written to tmp_path; returns its path."""
    from mpmc_tpu_torch.io import pqr
    from mpmc_tpu_torch.models import systems
    tmp_path = pathlib.Path(tmp_path)
    params, state, _, _ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=polar, device="cpu")
    pqr.write_state(str(tmp_path / f"{name}.pqr"), params, state, ["H2"])
    L = float(state.box[0, 0])
    text = (f"ensemble uvt\nnumsteps {numsteps}\ncorrtime 20\nseed 3\n"
            f"temperature 77\npressure 20.0\nbasis1 {L} 0 0\n"
            f"basis2 0 {L} 0\nbasis3 0 0 {L}\ninsert_probability 0.5\n"
            "cavity_autoreject_absolute 1.0\nmax_molecules 12\n"
            "allow_charged_cell on\n"
            + ("polarization on\n" if polar else "")
            + f"precision {precision}\npqr_input {tmp_path / f'{name}.pqr'}\n"
            + extra)
    path = tmp_path / f"{name}.inp"
    path.write_text(text)
    return str(path)


def deck_runs(device, decks):
    """Each (name, deck path): run.run of the deck on this rank (the
    log discarded), then the stacked chains' (pos, mol_alive, energy) and,
    under a ladder, the temperatures."""
    import io

    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run as run_mod
    out = {}
    for name, path in decks:
        buf = io.StringIO()
        su, avgs = run_mod.run(input_script.parse_file(path), log=buf,
                               device=device)
        out[name] = {"pos": to_np(su.states.pos),
                     "mol_alive": to_np(su.states.mol_alive),
                     "energy": to_np(su.states.energy.total),
                     "temps": to_np(su.thermo.temperature),
                     "N": avgs.mean("N"), "log": buf.getvalue()}
    return out


def mesh_pt(device, P, S, C, T, temps, rounds, spr, U):
    """replica.run_parallel_tempering over the group (multihost's drive,
    the injected round uniforms ``U`` [rounds, R]): this rank's block and
    history, each round's record, and the replica stack's distribution
    (its rows against the whole stack's) and the replica-count guard."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain, multihost
    trace = []
    states, ladder, history = multihost.run_parallel_tempering(
        P, S, C, T, temps, rounds, spr, seed=5, round_uniforms=U)
    # the records again, from the library driver with a trace
    from mpmc_tpu_torch.parallel import replica
    replica.run_parallel_tempering(P, S, C, T, temps, rounds, spr, seed=5,
                                   round_uniforms=U, trace=trace)
    R = len(temps)
    stack = multichain.stack_states(metropolis.initialize(S, P, C, T), R)
    stack = stack.replace(pos=stack.pos + torch.arange(
        R, dtype=stack.pos.dtype)[:, None, None])
    mine = multihost.distribute(stack, R)
    guards = []
    for n in (multihost.world() - 1, R + 1):
        try:
            multihost.global_replica_mesh(n)
            guards.append(None)
        except ValueError as e:
            guards.append(str(e))
    return {"history": history, "ladder": ladder,
            "energy": to_np(states.energy.total),
            "trace": [{k: to_np(v) for k, v in rec.items()
                       if k not in ("stats",)} for rec in trace],
            "mine_pos": to_np(mine.pos), "stack_pos": to_np(stack.pos),
            "mine_energy": to_np(mine.energy.total), "guards": guards}
