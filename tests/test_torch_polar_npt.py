"""The port's polar NPT (A8c: metropolis._volume_step through
polar_stage, B5 over chains with a header per chain) against the JAX
package in float64 on the CPU: a frameless polarizable H2 fluid's volume
candidate (every energy term, the new cell's static field, the SCF warm
started from mu with no initial residual, its CG count, the polar energy
and ln_bias; the delayed acceptance's surrogate) against the reference's
b_volume path, bookkeeping after move sequences with volume moves (plain,
delayed, wolf and ewald fields, culled CG), batched chains in different
boxes each equal to its lone run, plain B5 over chains with a box per
chain equal to per-chain calls (dense and culled) and the per-chain
header, and the CLI decks (scan, chains, fused_mc)."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig as JRunConfig  # noqa: E402
from mpmc_tpu.config import Thermo as JThermo  # noqa: E402
from mpmc_tpu.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import moves as jmoves  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import thole as jthole  # noqa: E402
from mpmc_tpu.state import build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.io import pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import thole as tt  # noqa: E402
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar")


def polar_fluid(n_mol=12, L=12.0, seed=11, **cfg_kw):
    """A frameless fluid of the polar 3-site H2 (h2_bss3: alpha 0.6938 on
    the centre) under Ewald with the derived cutoff, 77 K and 60 atm:
    (reference objects initialized by the reference, port objects)."""
    sp = jsystems.h2_bss3()
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    g = g[rng.permutation(len(g))[:n_mol]]
    coms = (g + 0.5) * (L / 3) + rng.uniform(-0.5, 0.5, (n_mol, 3))
    params, state = build_system(
        L * np.eye(3), species=(sp,), capacity=(n_mol,),
        initial_counts=(n_mol,),
        initial_pos={0: coms[:, None, :] + sp.pos[None]}, dtype=jnp.float64,
        seed=seed)
    cfg = JRunConfig(ensemble="npt", rd_potential="lj", coulomb="ewald",
                     ewald_kmax=4, polarization=True, dtype="float64",
                     ortho_box=True, use_pallas=False, pair_chunk=32,
                     **cfg_kw)
    thermo = JThermo.make(temperature=77.0, pressure=60.0,
                          volume_probability=0.3, volume_change_factor=0.08,
                          move_factor=0.6, rot_factor=0.8, n_species=1,
                          dtype=jnp.float64)
    state = jm.initialize(state, params, cfg, thermo)
    P, S, C, T = convert.from_jax(params, state, cfg, thermo)
    return (params, state, cfg, thermo), (P, tm.initialize(S, P, C, T), C, T)


def table(K, seed=1, C=None):
    shape = (K, 16) if C is None else (C, K, 16)
    return torch.as_tensor(np.random.default_rng(seed).random(shape))


@pytest.mark.parametrize("delayed", [False, True])
@pytest.mark.parametrize("d_lnv", [0.06, -0.05])
def test_volume_candidate_matches_reference(d_lnv, delayed):
    """For a given d ln V the port's polar volume candidate — its energy
    delta, ln_bias, the static field of the new positions in the new
    cell, the SCF from the state's mu with no initial residual (CG count
    too), the polar energy; under polar_delayed the surrogate delta —
    equals the reference's b_volume + common polar path
    (mpmc_tpu/mc/metropolis.py:566-595, :686-748): rel 1e-12, fields
    1e-12, dipoles 1e-10."""
    (jp, js, jc, jt), (P, S, C, T) = polar_fluid(polar_delayed=delayed)
    vcf = float(T.volume_change_factor)
    u = torch.zeros(16, dtype=torch.float64)
    u[1] = (d_lnv / vcf + 1.0) / 2.0
    u[4] = u[12] = 0.5
    c = tm._Chunk(S.box, P, C, T)
    carry = tm._carry(S, P, C)
    stats = tm.MCStats.zero(S.pos.device)
    trace = []
    tm._volume_step(carry, u, T, c, P, C, stats, trace)
    rec = trace[0]
    dl = (2.0 * jnp.asarray(float(u[1])) - 1.0) * jt.volume_change_factor
    jpos, jbox = jmoves.scale_volume(js.pos, js.box, jp, js.mol_alive, dl)
    cfg_np = dataclasses.replace(jc, polarization=False, cdvdw=False)
    e_new, _, _ = jenergy.total_energy(jpos, jbox, js.mol_alive, jp, cfg_np,
                                       jt, split_frozen=True)
    jd = e_new.sub(dataclasses.replace(js.energy, polar=jnp.zeros(()),
                                       vdw=jnp.zeros(())))
    for k in TERMS:
        assert float(getattr(rec["d"], k)) == pytest.approx(
            float(getattr(jd, k)), rel=1e-12, abs=1e-9), k
    alive = js.mol_alive[jp.mol_id] & jp.atom_ok
    e0 = jthole.static_field(jpos, jbox, alive, jp, jc)
    np.testing.assert_allclose(rec["e0"].numpy(), np.asarray(e0), rtol=0,
                               atol=1e-12)
    mu, it, _ = jthole.solve_scf(jpos, jbox, alive, jp, jc, e0, mu0=js.mu,
                                 r0=None)
    assert int(rec["iters"]) == int(it) > 0
    np.testing.assert_allclose(rec["mu"].numpy(), np.asarray(mu), rtol=0,
                               atol=1e-10)
    pol = float(jthole.polar_energy(mu, e0))
    assert float(rec["polar"]) == pytest.approx(pol, rel=1e-10)
    assert abs(pol - float(js.energy.polar)) > 1e-3
    n = jnp.sum(jm._movable_mask(jp, js.mol_alive)).astype(jnp.float64)
    j_bias = ((n + 1.0) * dl - jt.pressure * ATM2K_A3
              * (jnp.abs(jnp.linalg.det(jbox))
                 - jnp.abs(jnp.linalg.det(js.box))) / jt.temperature)
    assert float(rec["ln_bias"]) == pytest.approx(float(j_bias), rel=1e-12)
    if delayed:
        d_surr = (jthole.zodid_energy(e0, alive, jp)
                  - jthole.zodid_energy(js.e0, alive, jp))
        assert float(rec["d_surr"]) == pytest.approx(float(d_surr),
                                                     rel=1e-11)
    # an accepted attempt carries the new cell, field and dipoles
    if bool(rec["accept"]):
        assert torch.equal(carry["box"], rec["box"])
        assert torch.equal(carry["e0"], rec["e0"])
        assert float(carry["energy"].polar) == float(rec["polar"])


VARIANTS = {"plain": {}, "delayed": {"polar_delayed": True},
            "wolf": {"polar_wolf": True}, "ewald_field": {"polar_ewald": True},
            "culled": {"polar_cull": "on"}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_polar_npt_bookkeeping(variant):
    """60 steps with volume moves: volume attempts accepted and rejected,
    the carried total (polar term included) and static field equal a
    fresh initialize in the final cell, 1e-9 (the field 1e-12)."""
    _, (P, S, C, T) = polar_fluid(**VARIANTS[variant])
    st, stats = tm.run_chunk(S, P, C, T, 60, uniforms=table(60, seed=5))
    h = stats.host()
    assert h.attempts[tm.VOLUME] > 5
    assert 0 < h.accepts[tm.VOLUME] < h.attempts[tm.VOLUME]
    assert not torch.equal(st.box, S.box)
    fresh = tm.initialize(st, P, C, T)
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), abs=1e-9), k
    full = tt.static_field(st.pos, st.box, st.atom_alive(P), P, C)
    assert float((st.e0 - full).abs().max()) < 1e-12


def test_batched_polar_npt_chains_are_each_chain_alone():
    """C = 3 polar NPT chains (each its own cell after its first volume
    attempt): every chain ends in the box, positions, dipoles, energies,
    accept counts and CG iterations of a single-chain chunk over its own
    rows with chain 0's lane 8."""
    _, (P, S, C, T) = polar_fluid()
    K = 40
    u = table(K, seed=6, C=3)
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, C, T, K, uniforms=u)
    h = stats.host()
    assert len({float(torch.linalg.det(b)) for b in states.box}) == 3
    for c in range(3):
        uc = u[c].clone()
        uc[:, 8] = u[0, :, 8]
        one, st1 = tm.run_chunk(S, P, C, T, K, uniforms=uc)
        st1 = st1.host()
        sc = slice_chain(states, c)
        assert h.accepts[c].tolist() == st1.accepts.tolist()
        assert int(h.polar_iters[c]) == st1.polar_iters
        torch.testing.assert_close(sc.box, one.box, rtol=0, atol=1e-13)
        torch.testing.assert_close(sc.pos, one.pos, rtol=0, atol=1e-11)
        torch.testing.assert_close(sc.mu, one.mu, rtol=0, atol=1e-10)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(one.energy, k)), rel=1e-10, abs=1e-9), k
    # the batched refresh: each chain's static field in its own cell
    ref = multichain.initialize_batched(states, P, C, T)
    for c in range(3):
        sc = slice_chain(states, c)
        fresh = tm.initialize(sc, P, C, T)
        assert float(ref.energy.total[c]) == pytest.approx(
            float(fresh.energy.total), abs=1e-9)
        assert float(sc.energy.total) == pytest.approx(
            float(fresh.energy.total), abs=1e-9)


@pytest.mark.parametrize("mode", ["charge", "dipole"])
@pytest.mark.parametrize("culled", [False, True])
def test_plain_b5_with_a_box_per_chain(mode, culled):
    """Plain B5 over chains with a box and rc per chain equals the
    per-chain calls (1e-13), a shared box equals it repeated bit for bit,
    an active subset gives its chains and zeros; the per-chain header is
    each chain's scalars row bit for bit, and a plan of stacked boxes
    holds it."""
    rng = np.random.default_rng(3)
    C, n, L = 3, 150, 16.0
    box = torch.stack([torch.eye(3, dtype=torch.float64) * L * f
                       for f in (1.0, 0.95, 1.05)])
    pos = torch.as_tensor(rng.uniform(0, L, (C, n, 3)))
    ok = torch.as_tensor(rng.uniform(size=(C, n)) > 0.1)
    mol = torch.as_tensor(np.arange(n) // 3, dtype=torch.int32).expand(
        C, n).contiguous()
    src = (torch.as_tensor(rng.normal(size=(C, n))) * 0.3 if mode == "charge"
           else torch.as_tensor(rng.normal(size=(C, n, 3))) * 0.01)
    rc = 0.5 * torch.diagonal(box, dim1=-2, dim2=-1)[:, 0] - 1.0
    visit = None
    if culled:
        visit = tt.cull_visit(pos, ok, box, rc)
        assert visit.shape == (C, 2, 2)
        for c in range(C):
            assert torch.equal(visit[c], tt.cull_visit(pos[c], ok[c],
                                                        box[c], rc[c]))
    fn = (tk.charge_field_chains_plain if mode == "charge"
          else tk.dipole_field_chains_plain)
    one = (tk.charge_field_plain if mode == "charge"
           else tk.dipole_field_plain)
    out = fn(pos, box, ok, src, mol, rc, 2.1304, "exponential", visit=visit)
    for c in range(C):
        want = one(pos[c], box[c], ok[c], src[c], mol[c], rc[c], 2.1304,
                   "exponential", visit=None if visit is None else visit[c])
        torch.testing.assert_close(out[c], want, rtol=0, atol=1e-13)
    sub = fn(pos, box, ok, src, mol, rc, 2.1304, "exponential", visit=visit,
             active=(0, 2))
    torch.testing.assert_close(sub[[0, 2]], out[[0, 2]], rtol=0, atol=0)
    assert not sub[1].any()
    shared = fn(pos, box[1], ok, src, mol, rc[1], 2.1304, "exponential")
    rep = fn(pos, box[1].expand(C, 3, 3), ok, src, mol, rc[1].expand(C),
             2.1304, "exponential")
    assert torch.equal(shared, rep)
    scal = tk.scalars(box, rc, 2.1304)
    assert scal.shape == (C, 20)
    for c in range(C):
        assert torch.equal(scal[c], tk.scalars(box[c], rc[c], 2.1304))
    fplan = tk.plan_chains(box, rc, 2.1304, n, C, visit)
    assert torch.equal(fplan.scal, scal)
    tk.check_plan(fplan, box, rc, 2.1304, n, visit, C)


def test_solve_scf_chains_with_a_box_per_chain():
    """solve_scf_chains over chains in three cells (dense and culled CG):
    each chain's dipoles and CG count are its single-chain solve's."""
    _, (P, S, C, T) = polar_fluid()
    box = torch.stack([S.box, S.box * 1.04, S.box * 0.97])
    pos = torch.stack([S.pos, S.pos * 1.04, S.pos * 0.97])
    alive = S.atom_alive(P).expand(3, -1).contiguous()
    for cfg in (C, dataclasses.replace(C, polar_cull="on")):
        e0 = tt.static_field_chains(pos, box, alive, P, cfg)
        mu, iters, _ = tt.solve_scf_chains(pos, box, alive, P, cfg, e0,
                                           mu0=S.mu.expand(3, -1, -1))
        for c in range(3):
            e1 = tt.static_field(pos[c], box[c], alive[c], P, cfg)
            torch.testing.assert_close(e0[c], e1, rtol=0, atol=1e-13)
            m1, i1, _ = tt.solve_scf(pos[c], box[c], alive[c], P, cfg, e1,
                                     mu0=S.mu)
            assert int(iters[c]) == i1
            torch.testing.assert_close(mu[c], m1, rtol=0, atol=1e-12)


def _deck(tmp_path, *lines):
    _, (P, S, C, T) = polar_fluid()
    tpqr.write_state(str(tmp_path / "h2.pqr"), P, S, ["H2"])
    L = float(S.box[0, 0])
    text = "\n".join([
        "ensemble npt", "seed 3", "temperature 77", "pressure 60",
        "volume_probability 0.3", "volume_change_factor 0.08",
        "move_factor 0.6", "rot_factor 0.8", f"basis1 {L!r} 0 0",
        f"basis2 0 {L!r} 0", f"basis3 0 0 {L!r}", "precision float64",
        "ewald_kmax 4", "polarization on", "numsteps 60", "corrtime 30",
        f"pqr_input {tmp_path / 'h2.pqr'}",
        f"pqr_restart {tmp_path / 'restart.pqr'}", *lines]) + "\n"
    return input_script.parse(text)


@pytest.mark.parametrize("extra", [(), ("chains 2",), ("fused_mc on",),
                                   ("polar_delayed on", "fused_mc on")])
def test_polar_npt_decks(tmp_path, extra):
    """Polar NPT decks through run.run on the CPU: the scan path, batched
    chains (B5 over the chains, a header per chain), and under fused_mc
    the scan path with the log line saying so; volume moves accepted,
    the polar energy and the volume move in the block averages."""
    job = _deck(tmp_path, *extra)
    trun.check_supported(job)
    log = io.StringIO()
    su, avgs = trun.run(job, log=log, device="cpu")
    out = log.getvalue()
    if "fused_mc on" in extra:
        assert "WARNING" in out and "scan" in out
    if "chains 2" in extra:
        assert "one B5 launch over the chains" in out
        assert su.states.box.shape == (2, 3, 3)
    assert max(avgs.samples["acc_volume"]) > 0.0
    assert all(v < 0.0 for v in avgs.samples["energy_polar"])
    assert len(set(avgs.samples["volume"])) > 1


@pytest.mark.parametrize("cull", [False, True])
def test_chains_volume_candidates_match_jax_vmap(cull):
    """The batched volume step's polar candidates — three chains' rescaled
    configurations, each in its own new cell — against jax.vmap of the
    reference's static_field and solve_scf over (positions, box): the
    fields (1e-12), CG counts (equal), dipoles (1e-10) and polar energies
    (rel 1e-10); the culled CG (each chain's own cell order and table)
    against the reference's dense CG."""
    import jax
    kw = {"cutoff": 5.5, "polar_cull": "on"} if cull else {}
    (jp, js, jc, jt), (P, S, C, T) = polar_fluid(**kw)
    assert tt.cull_supported(C) == cull
    u = torch.zeros((3, 16), dtype=torch.float64)
    vcf = float(T.volume_change_factor)
    u[:, 1] = (torch.tensor([0.06, -0.04, 0.02]) / vcf + 1.0) / 2.0
    u[:, 4] = 0.5
    states = multichain.stack_states(S, 3)
    carry = tm._carry(states, P, C)
    c = tm._Chunk(states.box, P, C, T)
    stats = tm.MCStats(np.zeros((3, tm.N_MOVE_TYPES), np.int64),
                       torch.zeros((3, tm.N_MOVE_TYPES), dtype=torch.int64),
                       np.zeros(3, np.int64))
    trace = []
    tm._volume_step(carry, u, T, c, P, C, stats, trace)
    rec = trace[0]
    alive = js.mol_alive[jp.mol_id] & jp.atom_ok
    dl = (2.0 * jnp.asarray(u[:, 1].numpy()) - 1.0) * jt.volume_change_factor
    jpos, jbox = jax.vmap(lambda d: jmoves.scale_volume(
        js.pos, js.box, jp, js.mol_alive, d))(dl)

    def cand(pos, box):
        e0 = jthole.static_field(pos, box, alive, jp, jc)
        mu, it, _ = jthole.solve_scf(pos, box, alive, jp, jc, e0,
                                     mu0=js.mu, r0=None)
        return e0, mu, it, jthole.polar_energy(mu, e0)

    e0_j, mu_j, it_j, pol_j = jax.vmap(cand)(jpos, jbox)
    np.testing.assert_allclose(rec["box"].numpy(), np.asarray(jbox),
                               rtol=1e-13)
    np.testing.assert_allclose(rec["e0"].numpy(), np.asarray(e0_j), rtol=0,
                               atol=1e-12)
    assert rec["iters"].tolist() == np.asarray(it_j).tolist()
    np.testing.assert_allclose(rec["mu"].numpy(), np.asarray(mu_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(rec["polar"].numpy(), np.asarray(pol_j),
                               rtol=1e-10)


@pytest.mark.parametrize("variant", ["plain", "wolf", "ewald_field"])
@pytest.mark.parametrize("move", ["displace", "insert", "delete"])
def test_move_deltas_with_a_cell_per_chain(variant, move):
    """thole.move_deltas over 3 chains, each in its own cell (one batched
    call: the cutoff, field constants and k-vectors per chain), equals
    each chain's single-chain call (1e-12), field and residual."""
    _, (P, S, C, T) = polar_fluid(**VARIANTS[variant])
    box = torch.stack([S.box, S.box * 1.04, S.box * 0.97])
    pos = torch.stack([S.pos, S.pos * 1.04, S.pos * 0.97])
    alive = S.atom_alive(P).expand(3, -1).clone()
    mol = torch.tensor([0, 3, 7])
    if move == "insert":
        for k in range(3):
            alive[k, P.mol_id == mol[k]] = False
    rows = None if move == "delete" else torch.stack([
        pos[k, P.mol_atoms[mol[k]]] + torch.tensor([0.3, -0.2, 0.4],
                                                   dtype=torch.float64)
        for k in range(3)])
    e0 = tt.static_field_chains(pos, box, alive, P, C)
    mu = S.mu.expand(3, -1, -1).contiguous()
    r_old = torch.zeros_like(mu)
    kw = dict(insert=move == "insert", delete=move == "delete")
    got_e0, got_r = tt.move_deltas(pos, box, alive, P, C, mol, e0, mu,
                                   r_old, new_rows=rows, **kw)
    for k in range(3):
        e1, r1 = tt.move_deltas(pos[k], box[k], alive[k], P, C, mol[k],
                                e0[k], mu[k], r_old[k],
                                new_rows=None if rows is None else rows[k],
                                **kw)
        torch.testing.assert_close(got_e0[k], e1, rtol=0, atol=1e-12)
        torch.testing.assert_close(got_r[k], r1, rtol=0, atol=1e-12)
