"""The port's batched polar chains (metropolis.make_batched_step_fn with
polarization, thole.solve_scf_chains, B5 over a chain axis) against the
JAX package and the port's own single-chain polar path, float64 on the
CPU: plain B5 over chains against the per-chain plain version, the
batched move_deltas / residual_delta against ``jax.vmap`` of the
reference's, solve_scf_chains against ``jax.vmap(solve_scf)`` (per-chain
iteration counts), each chain's decisions against a single-chain run
over the same rows (plain, delayed acceptance, nve), bookkeeping after
60 steps, and the CLI decks of polar chains and polar PT."""
import dataclasses
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import thole as jt  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import thole as tt  # noqa: E402
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import chain_rows, slice_chain  # noqa: E402
from torch_polar import cell, cloud, polar_deck, to_np  # noqa: E402

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar")


def _system(**cfg_kw):
    """((params, cfg) of the reference's small polar GCMC system
    mof_h2_gcmc(n_side=3, n_h2=4, capacity=8, polarization=True) in
    float64, use_pallas off), and the port of it (P, S initialized by the
    port, C, T)."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8,
                                      polarization=True, dtype="float64")
    c = dataclasses.replace(c, use_pallas=False, **cfg_kw)
    P, S, C, T = convert.from_jax(p, s, c, t)
    return (p, c), (P, tm.initialize(S, P, C, T), C, T)


def _table(C, K, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).random((C, K, 16)))


def _chains(C=3, K=40, **cfg_kw):
    """(jax system, port P, C-stacked states after a K-step batched polar
    chunk — each chain its own loading, positions, e0, mu and r_pol —,
    port cfg, thermo)."""
    j, (P, S, cfg, T) = _system(**cfg_kw)
    states, _ = multichain.run_chunk_batched(
        multichain.stack_states(S, C), P, cfg, T, K, uniforms=_table(C, K))
    return j, P, states, cfg, T


# ---------------------------------------------------------------------------
# B5 over chains, plain
# ---------------------------------------------------------------------------

B5_CASES = [(m, d, lay) for m in ("charge", "dipole")
            for d in ("exponential", "linear", "none")
            for lay in ("dense-ortho", "dense-tri", "culled")]


@pytest.mark.parametrize("mode,damp,layout", B5_CASES,
                         ids=[f"{m}-{d}-{lay}" for m, d, lay in B5_CASES])
def test_plain_b5_over_chains_is_the_per_chain_plain(mode, damp, layout):
    """The plain B5 over [C] (the CPU route of charge_field_chains /
    dipole_field_chains) gives each chain the single-chain plain field of
    its own sites, dense in an orthorhombic and a skewed cell and culled
    with each chain's own visit table (cell-sorted at rc 9 A): rel 1e-13
    of max |E|; an active subset computes those chains alike and leaves
    the others zero."""
    C, n = 3, 300
    clouds = [cloud(n=n, L=20.0, seed=s) for s in (3, 4, 5)]
    box = torch.as_tensor(cell(20.0, layout == "dense-tri"))
    pos, ok, q, mu, mol = (torch.as_tensor(np.stack([c[i] for c in clouds]))
                           for i in range(5))
    mol = mol.to(torch.int32)
    src = q if mode == "charge" else mu
    rc = torch.tensor(9.0, dtype=torch.float64)
    visit = None
    if layout == "culled":
        perm, _ = tt.cull_perm(pos, box, ok, rc)
        pos, ok, src, mol = (tt._gather_sites(x, perm)
                             for x in (pos, ok, src, mol))
        visit = tt.cull_visit(pos, ok, box, rc)
        assert visit.shape == (C,) + tk.grid_shape(n)[1:]
        assert 0 < float(visit.float().mean()) < 1
    chains_fn, one_fn = ((tk.charge_field_chains, tk.charge_field_plain)
                         if mode == "charge"
                         else (tk.dipole_field_chains, tk.dipole_field_plain))
    args = (pos, box, ok, src, mol, rc, 2.1304, damp)
    got = chains_fn(*args, ortho=layout != "dense-tri", visit=visit)
    assert got.shape == (C, n, 3)
    sub = chains_fn(*args, visit=visit, active=(0, 2))
    for c in range(C):
        one = one_fn(pos[c], box, ok[c], src[c], mol[c], rc, 2.1304, damp,
                     visit=None if visit is None else visit[c])
        scale = float(one.abs().max())
        assert scale > 0
        torch.testing.assert_close(got[c], one, rtol=0, atol=1e-13 * scale)
        if c == 1:
            assert not sub[c].any()
        else:
            torch.testing.assert_close(sub[c], one, rtol=0,
                                       atol=1e-13 * scale)


def test_chain_plans_list_each_chains_items():
    """plan_chains: every chain's items dense, the joined visit tables'
    items culled (one slot each) with each chain's count; subplan of an
    active subset lists those chains' items only, with the chain indices
    on the device and no other chain's tile."""
    C, n = 3, 300
    _, ni, nj = tk.grid_shape(n)
    box = torch.eye(3, dtype=torch.float64) * 20.0
    rc = torch.tensor(9.0, dtype=torch.float64)
    dense = tk.plan_chains(box, rc, 2.1304, n, C)
    assert dense.wl is None and dense.slots == C * ni * nj
    assert dense.listed is None and dense.chains is None
    rng = np.random.default_rng(0)
    visit = torch.as_tensor(rng.integers(0, 2, (C, ni, nj)),
                            dtype=torch.int32)
    culled = tk.plan_chains(box, rc, 2.1304, n, C, visit)
    assert culled.counts == tuple(int(v.sum()) for v in visit)
    assert culled.slots == int(visit.sum())
    assert torch.equal(culled.wl, tk.work_list(visit.reshape(C * ni, nj)))
    sub = tk.subplan(culled, (0, 2))
    assert sub.listed == (0, 2) and sub.chains.tolist() == [0, 2]
    assert sub.slots == culled.counts[0] + culled.counts[2]
    assert torch.equal(sub.wl, tk.work_list(visit[[0, 2]].reshape(-1, nj)))
    assert tk.subplan(culled, (0, 1, 2)) is culled
    assert tk.subplan(dense, (1,)).slots == ni * nj
    with pytest.raises(ValueError):
        tk.subplan(culled, (2, 0))
    with pytest.raises(ValueError, match="another call"):
        tk.check_plan(culled, box, rc, 2.1304, n, visit.clone(), C)


# ---------------------------------------------------------------------------
# the batched per-move deltas against jax.vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("move", ["displace", "insert", "delete"])
def test_batched_move_deltas_match_jax_vmap(move):
    """thole.move_deltas and residual_delta over a leading chain axis (one
    molecule per chain) against jax.vmap of the reference's on the same
    three chains: rel 1e-12 of the largest entry of the pre-move
    field."""
    (p, c), P, states, cfg, _ = _chains()
    C = states.pos.shape[0]
    alive = states.mol_alive[:, P.mol_id] & P.atom_ok
    if move == "insert":
        free = ~states.mol_alive & (P.mol_species == 0)
        mol = free.to(torch.int8).argmax(1)
        assert free[torch.arange(C), mol].all()
        rows = torch.as_tensor([4.1, 5.2, 6.3], dtype=torch.float64).expand(
            C, P.max_atoms_per_mol, 3).clone()
    else:
        mask = tm._movable_mask(P, states.mol_alive)
        mol, cnt = tmoves.pick_by_rank(mask, torch.tensor([0.2, 0.5, 0.8]))
        assert (cnt > 0).all()
        rows = chain_rows(states.pos, P, mol) + torch.tensor(
            [0.3, -0.2, 0.15], dtype=torch.float64)
    kw = {"displace": {}, "insert": {"insert": True},
          "delete": {"delete": True}}[move]
    new_rows = None if move == "delete" else rows
    e0_t, r_t = tt.move_deltas(states.pos, states.box[0], alive, P, cfg, mol,
                               states.e0, states.mu, states.r_pol,
                               new_rows=new_rows, **kw)
    r_seq = tt.residual_delta(states.pos, states.box[0], alive, P, cfg, mol,
                              states.mu, states.r_pol, states.e0, e0_t,
                              new_rows=new_rows, **kw)
    box = jnp.asarray(to_np(states.box[0]))

    def ref(pos, al, m, e0, mu, r_old, nr):
        return jt.move_deltas(pos, box, al, p, c, m, e0, mu, r_old,
                              new_rows=None if move == "delete" else nr,
                              **kw)

    def ref_resid(pos, al, m, mu, r_old, e0_old, e0_new, nr):
        return jt.residual_delta(pos, box, al, p, c, m, mu, r_old, e0_old,
                                 e0_new,
                                 new_rows=None if move == "delete" else nr,
                                 **kw)

    j = {k: jnp.asarray(to_np(v)) for k, v in dict(
        pos=states.pos, al=alive, m=mol.to(torch.int32), e0=states.e0,
        mu=states.mu, r_old=states.r_pol, nr=rows).items()}
    e0_j, r_j = jax.jit(jax.vmap(ref))(j["pos"], j["al"], j["m"], j["e0"],
                                       j["mu"], j["r_old"], j["nr"])
    rs_j = jax.jit(jax.vmap(ref_resid))(j["pos"], j["al"], j["m"], j["mu"],
                                        j["r_old"], j["e0"], e0_j, j["nr"])
    # the scale of the field the deltas update (a residual is b - A mu,
    # b the field; a deletion may leave no intermolecular field at all)
    scale = float(states.e0.abs().max())
    assert scale > 0
    for got, want in ((e0_t, e0_j), (r_t, r_j), (r_seq, rs_j)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-12 * scale)


# ---------------------------------------------------------------------------
# the SCF over chains against jax.vmap(solve_scf)
# ---------------------------------------------------------------------------

SCF_CASES = ("cg", "cg-dipole", "cg-cull", "cg-active")


@pytest.mark.parametrize("case", SCF_CASES)
def test_solve_scf_chains_matches_jax_vmap(case):
    """solve_scf_chains on three chains' trial states (each a displaced
    molecule, r0 from move_deltas) against jax.vmap of the reference's
    solve_scf: equal per-chain iteration counts (different chains
    stopping at different rounds), mu and the residual within rel 1e-10
    — residual and dipole mode, the culled CG (each
    chain sorted apart, against the reference's dense CG) and an active
    subset (the others keep mu0 and r0 with 0 iterations)."""
    kw = {"polar_precision": 1e-9}
    if case == "cg-dipole":
        kw.update(polar_precision_mode="dipole", polar_precision=1e-7)
    if case == "cg-cull":
        kw.update(cutoff=6.0, polar_cull="on")
    (p, c), P, states, cfg, _ = _chains(**kw)
    assert tt.cull_supported(cfg) == (case == "cg-cull")
    C = states.pos.shape[0]
    alive = states.mol_alive[:, P.mol_id] & P.atom_ok
    mask = tm._movable_mask(P, states.mol_alive)
    mol, _ = tmoves.pick_by_rank(mask, torch.tensor([0.1, 0.6, 0.9]))
    # chain 1's molecule stays put (its warm start is converged already)
    rows = chain_rows(states.pos, P, mol) + torch.tensor(
        [[[0.4, -0.3, 0.2]], [[0.0, 0.0, 0.0]], [[1.1, 0.8, -0.6]]],
        dtype=torch.float64)
    e0_new, r0 = tt.move_deltas(states.pos, states.box[0], alive, P, cfg,
                                mol, states.e0, states.mu, states.r_pol,
                                new_rows=rows)
    pos_c = states.pos.clone()
    for k in range(C):
        pos_c[k, P.mol_atoms[mol[k]]] = rows[k]
    active = (0, 2) if case == "cg-active" else None
    mu_t, it_t, r_t = tt.solve_scf_chains(pos_c, states.box[0], alive, P, cfg,
                                          e0_new, mu0=states.mu, r0=r0,
                                          active=active)
    box = jnp.asarray(to_np(states.box[0]))
    mu_j, it_j, r_j = jax.jit(jax.vmap(
        lambda pos, al, e0, mu0, r_0: jt.solve_scf(pos, box, al, p, c, e0,
                                                   mu0, r_0)))(
        *(jnp.asarray(to_np(x)) for x in (pos_c, alive, e0_new, states.mu,
                                          r0)))
    it_j, mu_j, r_j = np.asarray(it_j), np.asarray(mu_j), np.asarray(r_j)
    assert isinstance(it_t, np.ndarray) and it_t.shape == (C,)
    for k in range(C):
        if active is not None and k not in active:
            assert it_t[k] == 0
            np.testing.assert_array_equal(
                to_np(mu_t[k]), np.where(to_np(alive[k] & (P.polar > 0))[:,
                                                                       None],
                                         to_np(states.mu[k]), 0.0))
            continue
        assert it_t[k] == it_j[k] < cfg.polar_max_iter
        scale = np.abs(mu_j[k]).max()
        np.testing.assert_allclose(to_np(mu_t[k]), mu_j[k], rtol=0,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(to_np(r_t[k]), r_j[k], rtol=0,
                                   atol=1e-10 * scale)
    # the chains stop at different rounds
    assert len(set(it_t.tolist())) > 1


# ---------------------------------------------------------------------------
# the batched polar chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "delayed", "nve"])
def test_batched_polar_chunk_makes_the_single_chain_decisions(variant):
    """C = 3 polar chains over an injected [3, K, 16] table: each chain
    ends in the state, energies (the polar term included), dipoles, accept
    counts and CG iterations of a single-chain run_chunk over its own
    rows with chain 0's lane 8 (the shared move type) — plain Metropolis,
    the delayed acceptance (only stage-1 survivors solve) and nve (Ray's
    rule with the polar term)."""
    kw = {"delayed": {"polar_delayed": True}, "nve": {"ensemble": "nve"},
          "plain": {}}[variant]
    _, (P, S, cfg, T) = _system(**kw)
    if variant == "nve":
        T = T.replace(nve_energy=S.reported_energy().total + 300.0)
    K = 40
    u = _table(3, K, seed=2)
    trace = []
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, cfg, T, K, uniforms=u, trace=trace)
    st_h = stats.host()
    assert st_h.polar_iters.shape == (3,)
    if variant == "delayed":
        solved = sum(to_np(r["acc1"]).astype(int) for r in trace)
        assert 0 < solved.sum() < 3 * K
        assert all((r["iters"][~to_np(r["acc1"])] == 0).all() for r in trace)
    for c in range(3):
        uc = u[c].clone()
        uc[:, 8] = u[0, :, 8]
        one, st1 = tm.run_chunk(S, P, cfg, T, K, uniforms=uc)
        sc = slice_chain(states, c)
        st1 = st1.host()
        assert st_h.accepts[c].tolist() == st1.accepts.tolist()
        assert int(st_h.polar_iters[c]) == st1.polar_iters
        assert torch.equal(sc.mol_alive, one.mol_alive)
        torch.testing.assert_close(sc.pos, one.pos, rtol=0, atol=1e-12)
        torch.testing.assert_close(sc.mu, one.mu, rtol=0, atol=1e-12)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(one.energy, k)), rel=1e-12, abs=1e-10), k
    assert int(stats.accepts.sum()) > 0


def test_batched_polar_chains_bookkeeping_after_60_steps():
    """The reference's test_batched_chains_with_polar_delta_field on the
    port: after 60 batched steps every chain's carried static field
    equals a full rebuild (1e-12) and its carried total equals a fresh
    initialize (1e-9)."""
    _, (P, S, cfg, T) = _system()
    g = torch.Generator().manual_seed(0)
    sts, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, cfg, T, 60, generator=g)
    assert int(stats.accepts.sum()) > 0
    for c in range(3):
        st = slice_chain(sts, c)
        full = tt.static_field(st.pos, st.box, st.atom_alive(P), P, cfg)
        assert float((st.e0 - full).abs().max()) < 1e-12, c
        fresh = tm.initialize(st, P, cfg, T)
        assert float(st.energy.total) == pytest.approx(
            float(fresh.energy.total), abs=1e-9), c


def test_from_jax_carries_stacked_polar_states():
    """convert.from_jax of the reference's stacked polar chains (its
    multichain.stack_states of an initialized state) gives the port's
    stacked state: mu, e0 and r_pol [C, N, 3] equal to the reference's,
    which the batched polar chunk then runs from."""
    from mpmc_tpu.mc import metropolis as jm
    from mpmc_tpu.parallel import multichain as jmulti
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8,
                                      polarization=True, dtype="float64")
    c = dataclasses.replace(c, use_pallas=False)
    stacked = jmulti.stack_states(jm.initialize(s, p, c, t), 3)
    P, states, C, T = convert.from_jax(p, stacked, c, t)
    for k in ("mu", "e0", "r_pol"):
        got, want = getattr(states, k), np.asarray(getattr(stacked, k))
        assert got.shape == (3,) + P.charge.shape + (3,)
        np.testing.assert_array_equal(to_np(got), want)
    sts, _ = multichain.run_chunk_batched(states, P, C, T, 5,
                                          uniforms=_table(3, 5))
    assert sts.mu.shape == states.mu.shape


# ---------------------------------------------------------------------------
# CLI decks
# ---------------------------------------------------------------------------

DECKS = {"chains": "chains 3\n", "pt": "parallel_tempering on\n"
         "n_replicas 3\nptemp_freq 5\n",
         "pt-fugacity": "pt_fugacity on\nn_replicas 3\nptemp_freq 5\n"}


@pytest.mark.parametrize("deck", list(DECKS))
def test_cli_polar_chains_and_pt_decks(tmp_path, deck):
    """``python -m mpmc_tpu_torch --cpu`` on the small polar deck with
    ``chains 3``, with ``parallel_tempering on`` and with ``pt_fugacity
    on`` (3 replicas, corrtime 10, 20 steps): the batched route with
    polarization, logged without a WARNING, one block line per corrtime,
    each chain's polar term and dipoles; the PT ladders stay a
    permutation of their rungs."""
    from mpmc_tpu_torch import __main__ as port_main
    job_text = DECKS[deck] + "corrtime 10\n"
    polar_deck(tmp_path, job_text, numsteps=20)
    old = os.getcwd()
    os.chdir(tmp_path)
    buf = io.StringIO()
    try:
        import contextlib
        with contextlib.redirect_stdout(buf):
            port_main.main(["--cpu", str(tmp_path / "deck.inp")])
    finally:
        os.chdir(old)
    out = buf.getvalue()
    assert "batched scan chains (C=3)" in out and "B5 launch over" in out
    assert "WARNING" not in out and "fused_mc:" not in out
    assert out.count("\nstep ") == 2
    assert "aggregate (3 " in out
    su, _ = trun.run_mc(polar_deck(tmp_path, job_text, numsteps=20),
                        log=io.StringIO(), device="cpu")
    assert su.states.mu.shape == (3,) + su.state.pos.shape
    assert (su.states.energy.polar < 0).all()
    if deck == "pt":
        np.testing.assert_allclose(
            np.sort(to_np(su.thermo.temperature)),
            np.geomspace(77.0, 154.0, 3), rtol=1e-12)
    elif deck == "pt-fugacity":
        tot = to_np(su.thermo.fugacity).sum(1)
        np.testing.assert_allclose(np.sort(tot),
                                   tot.min() * np.geomspace(1, 10, 3),
                                   rtol=1e-12)


def test_polar_chains_fused_mc_takes_the_batched_route(tmp_path):
    """``chains 3`` with ``fused_mc on`` and polarization: the multi-chain
    gates refuse polarization, so the run logs the reference's WARNING
    and takes the batched polar route; polar_iters_per_step is reported
    per chain and averaged."""
    job = polar_deck(tmp_path, "chains 3\nfused_mc on\ncorrtime 10\n",
                     numsteps=10)
    buf = io.StringIO()
    su, avgs = trun.run(job, log=buf, device="cpu")
    out = buf.getvalue()
    assert "WARNING: fused_mc requested but unsupported" in out
    assert "batched scan chains (C=3)" in out
    assert avgs.mean("polar_iters_per_step") > 0
    assert su.states.e0.shape == su.states.pos.shape
