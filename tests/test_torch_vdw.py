"""The port's coupled-dipole vdW (ops/vdw.py) and the cdvdw repulsions
(ops/potentials.py, routed through the plain pair passes of ops/pairs.py)
against the JAX package in float64 on the CPU: vdw_energy against the
reference's to rel 1e-11 (one chain, and a batched eigensolve over
chains, each chain its own box), the two-oscillator analytic dimer and
its London limit, dead sites, every repulsion's pair energy and tail
against the reference's functions, the reference's test_vdw.py cases on
the port, total_energy's vdw slot, the per-trial vdw of a scan chunk and
of batched chains, bookkeeping of MC runs with cdvdw (1e-9), and a CLI
deck."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig as JRunConfig  # noqa: E402
from mpmc_tpu.config import Thermo as JThermo  # noqa: E402
from mpmc_tpu.constants import HARTREE_K  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import potentials as jpot  # noqa: E402
from mpmc_tpu.ops import vdw as jvdw  # noqa: E402
from mpmc_tpu.state import Species, build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.io import pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops import potentials as tpot  # noqa: E402
from mpmc_tpu_torch.ops import vdw as tvdw  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402

torch.set_num_threads(1)


def drude_pair(r, alpha=1.0, omega=0.5):
    """Analytic coupled-Drude dimer energy [K] (undamped, isotropic)."""
    a = alpha / r ** 3
    modes = (np.sqrt(1 + 2 * a) + np.sqrt(1 - 2 * a)
             + 2 * np.sqrt(1 + a) + 2 * np.sqrt(1 - a) - 6.0)
    return 0.5 * HARTREE_K * omega * modes


def _drude_species(alpha=1.0, omega=0.5, eps=0.0, sig=0.0):
    return Species(name="DR", atom_names=("D",), pos=np.zeros((1, 3)),
                   mass=np.array([1.0]), charge=np.zeros(1),
                   polar=np.array([alpha]), eps=np.array([eps]),
                   sig=np.array([sig]), omega=np.array([omega]))


def _dimer(r, repulsion="none", rd="none", **sp_kw):
    """A Drude dimer at separation r in a 60 A box (the reference's
    test_vdw.py system), carried to the port: (P, S, C)."""
    cfg = JRunConfig(ensemble="nvt", rd_potential=rd, coulomb="none",
                     cdvdw=True, cdvdw_repulsion=repulsion,
                     polar_damp_type="none", dtype="float64", rd_lrc=False,
                     use_pallas=False)
    params, state = build_system(
        np.eye(3) * 60.0, species=(_drude_species(**sp_kw),),
        capacity=(2,), initial_counts=(2,),
        initial_pos={0: np.array([[[0., 0., 0.]], [[0., 0., r]]])},
        dtype=jnp.float64)
    thermo = JThermo.make(temperature=50.0, move_factor=0.3, rot_factor=0.0,
                          n_species=1, dtype=jnp.float64)
    P, S, C, T = convert.from_jax(params, state, cfg, thermo)
    return P, S, C, T


def _fluid(n_mol=8, L=11.0, seed=5, repulsion="none", ensemble="nvt",
           damp="exponential"):
    """A frameless fluid of 3-site polarizable Drude molecules (alpha,
    omega on every site, LJ on the centre, small charges) in float64:
    (reference objects initialized by the reference, port objects)."""
    sp = Species(name="PD", atom_names=("C", "A", "A"),
                 pos=np.array([[0, 0, 0], [0.6, 0, 0], [-0.6, 0, 0]]),
                 mass=np.array([4.0, 1.0, 1.0]),
                 charge=np.array([-0.2, 0.1, 0.1]),
                 polar=np.array([1.1, 0.4, 0.4]),
                 eps=np.array([40.0, 10.0, 10.0]),
                 sig=np.array([3.0, 2.4, 2.4]),
                 omega=np.array([0.45, 0.6, 0.6]))
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_mol]
    coms = (g + 0.5) * (L / 3) + rng.uniform(-0.4, 0.4, (n_mol, 3))
    params, state = build_system(
        L * np.eye(3), species=(sp,), capacity=(n_mol,),
        initial_counts=(n_mol,), initial_pos={0: coms[:, None, :]
                                              + sp.pos[None]},
        dtype=jnp.float64, seed=seed)
    cfg = JRunConfig(ensemble=ensemble, rd_potential="lj", coulomb="ewald",
                     ewald_kmax=4, cdvdw=True, cdvdw_repulsion=repulsion,
                     polar_damp_type=damp, dtype="float64", rd_lrc=False,
                     ortho_box=True, use_pallas=False, pair_chunk=32)
    thermo = JThermo.make(temperature=150.0, pressure=200.0,
                          volume_probability=0.2, volume_change_factor=0.05,
                          move_factor=0.5, rot_factor=0.5, n_species=1,
                          dtype=jnp.float64)
    state = jm.initialize(state, params, cfg, thermo)
    P, S, C, T = convert.from_jax(params, state, cfg, thermo)
    return (params, state, cfg, thermo), (P, tm.initialize(S, P, C, T), C, T)


def test_vdw_sites_are_the_references():
    """build_system's static site list: every atom with alpha > 0 and
    omega > 0, as the reference's params.vdw_sites."""
    (jp, _, _, _), (P, _, _, _) = _fluid()
    np.testing.assert_array_equal(P.vdw_sites.numpy(),
                                  np.asarray(jp.vdw_sites))
    assert P.vdw_sites.shape[0] == 24


@pytest.mark.parametrize("damp", ["exponential", "none"])
def test_vdw_energy_matches_reference(damp):
    """vdw_energy of the 24-site fluid (a 72 x 72 eigensolve) against the
    reference's, rel 1e-11, with a dead molecule decoupled too."""
    (jp, js, jc, _), (P, S, C, _) = _fluid(damp=damp)
    for kill in (None, 3):
        ma_j, ma_t = js.mol_alive, S.mol_alive.clone()
        if kill is not None:
            ma_j = ma_j.at[kill].set(False)
            ma_t[kill] = False
        ja = ma_j[jp.mol_id] & jp.atom_ok
        ta = ma_t[P.mol_id] & P.atom_ok
        want = float(jvdw.vdw_energy(js.pos, js.box, ja, jp, jc))
        got = float(tvdw.vdw_energy(S.pos, S.box, ta, P, C))
        assert abs(want) > 1.0
        assert got == pytest.approx(want, rel=1e-11)


def test_batched_vdw_is_each_chains():
    """Over chains (a batched eigensolve), each chain in its own box and
    configuration: chain c's energy is the single-chain call's, rel
    1e-12."""
    _, (P, S, C, _) = _fluid()
    pos = torch.stack([S.pos, S.pos * 1.02, S.pos + 0.3])
    box = torch.stack([S.box, S.box * 1.02, S.box])
    alive = S.atom_alive(P).expand(3, -1).clone()
    alive[2, :3] = False
    e = tvdw.vdw_energy(pos, box, alive, P, C)
    shared = tvdw.vdw_energy(pos, S.box, alive, P, C)
    for c in range(3):
        assert float(e[c]) == pytest.approx(float(tvdw.vdw_energy(
            pos[c], box[c], alive[c], P, C)), rel=1e-12)
        assert float(shared[c]) == pytest.approx(float(tvdw.vdw_energy(
            pos[c], S.box, alive[c], P, C)), rel=1e-12)


@pytest.mark.parametrize("r", [3.0, 4.0, 6.0, 10.0])
def test_two_oscillators_match_analytic(r):
    P, S, C, _ = _dimer(r)
    e = tvdw.vdw_energy(S.pos, S.box, S.atom_alive(P), P, C)
    assert float(e) == pytest.approx(drude_pair(r), rel=1e-7)


def test_london_limit_and_dead_sites():
    """r -> inf: -(3/4) hbar w alpha^2 / r^6; a dead partner: exactly 0."""
    r = 14.0
    P, S, C, _ = _dimer(r)
    e = float(tvdw.vdw_energy(S.pos, S.box, S.atom_alive(P), P, C))
    assert e == pytest.approx(-0.75 * HARTREE_K * 0.5 / r ** 6, rel=1e-3)
    P, S, C, _ = _dimer(4.0)
    ma = S.mol_alive.clone()
    ma[1] = False
    e = float(tvdw.vdw_energy(S.pos, S.box, ma[P.mol_id] & P.atom_ok, P,
                              C))
    assert e == pytest.approx(0.0, abs=1e-10)


@pytest.mark.parametrize("rep", ["sig", "9th", "exp"])
def test_repulsion_functions_match_reference(rep):
    """cdvdw_repulsion_energy, its tail and london_c6 on seeded broadcast
    columns against the reference's, rel 1e-13."""
    rng = np.random.default_rng(7)
    cols = [rng.uniform(lo, hi, (5, 1)) for lo, hi in
            ((10, 90), (2.5, 3.5), (0.1, 2.0), (0.2, 0.8))]
    colj = [rng.uniform(lo, hi, (1, 6)) for lo, hi in
            ((10, 90), (2.5, 3.5), (0.1, 2.0), (0.2, 0.8))]
    r = rng.uniform(2.0, 9.0, (5, 6))
    jc = JRunConfig(cdvdw_repulsion=rep)
    tc = convert.config_from(jc)
    (ei, si, ai, wi), (ej, sj, aj, wj) = cols, colj
    T = lambda x: torch.as_tensor(x)  # noqa: E731
    J = jnp.asarray
    want = np.asarray(jpot.cdvdw_repulsion_energy(
        J(r), J(ei), J(ej), J(si), J(sj), J(ai), J(aj), J(wi), J(wj), jc))
    got = tpot.cdvdw_repulsion_energy(T(r), T(ei), T(ej), T(si), T(sj),
                                      T(ai), T(aj), T(wi), T(wj), tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    rc = np.float64(8.5)
    want_t = np.asarray(jpot.cdvdw_repulsion_tail_coefficient(
        J(si), J(sj), J(ai), J(aj), J(wi), J(wj), J(rc), jc))
    got_t = tpot.cdvdw_repulsion_tail_coefficient(
        T(si), T(sj), T(ai), T(aj), T(wi), T(wj), T(rc), tc)
    np.testing.assert_allclose(np.broadcast_to(got_t.numpy(), (5, 6)),
                               np.broadcast_to(want_t, (5, 6)), rtol=1e-13,
                               atol=0)
    np.testing.assert_allclose(
        tpot.london_c6(T(ai), T(aj), T(wi), T(wj)).numpy(),
        np.asarray(jpot.london_c6(J(ai), J(aj), J(wi), J(wj))), rtol=1e-13)


def test_sig_repulsion_analytic_and_9th_at_contact():
    """The reference's analytic cases through the port's plain pair pass:
    sig C6 sig^6 / r^12; 9th equals sig at r = sig; exp A e^{-B r}."""
    r, sig, alpha, omega = 3.5, 3.0, 1.2, 0.6
    P, S, C, _ = _dimer(r, "sig", rd="lj", sig=sig, alpha=alpha,
                        omega=omega, eps=30.0)
    pt = tpairs.pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                          torch.tensor(300.0, dtype=torch.float64))
    c6 = 0.75 * HARTREE_K * omega * alpha ** 2
    assert float(pt.rd) == pytest.approx(c6 * sig ** 6 / r ** 12, rel=1e-10)
    rds = []
    for rep in ("sig", "9th"):
        P, S, C, _ = _dimer(3.1, rep, rd="lj", sig=3.1, eps=30.0)
        rds.append(float(tpairs.pair_pass(
            S.pos, S.box, S.atom_alive(P), P, C,
            torch.tensor(300.0, dtype=torch.float64)).rd))
    assert rds[1] == pytest.approx(rds[0], rel=1e-10)
    P, S, C, _ = _dimer(3.5, "exp", rd="lj", sig=3.0, eps=40000.0)
    pt = tpairs.pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                          torch.tensor(300.0, dtype=torch.float64))
    assert float(pt.rd) == pytest.approx(40000.0 * np.exp(-3.0 * 3.5),
                                         rel=1e-10)


def test_lrc_tail_matches_numeric_integral():
    import scipy.integrate as si
    sig, alpha, omega, rc = 3.0, 1.0, 0.5, 9.0
    c6 = 0.75 * HARTREE_K * omega * alpha ** 2
    for rep, f in (("sig", lambda r: c6 * sig ** 12 / r ** 12 / sig ** 6),
                   ("9th", lambda r: c6 * sig ** 3 / r ** 9)):
        cfg = convert.config_from(JRunConfig(cdvdw_repulsion=rep))
        x = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
        got = float(tpot.cdvdw_repulsion_tail_coefficient(
            x(sig), x(sig), x(alpha), x(alpha), x(omega), x(omega), x(rc),
            cfg))
        want = 4 * np.pi * si.quad(lambda r: f(r) * r * r, rc, np.inf)[0]
        assert got == pytest.approx(want, rel=1e-8), rep


@pytest.mark.parametrize("rep", ["none", "sig", "9th", "exp"])
def test_total_energy_matches_reference(rep):
    """total_energy of the fluid with cdvdw and each repulsion (rd_lrc on
    for sig and 9th: the repulsion's tail), every slot against the
    reference's, rel 1e-11."""
    (jp, js, jc, jt), (P, S, C, T) = _fluid(repulsion=rep)
    jc = dataclasses.replace(jc, rd_lrc=rep in ("sig", "9th"))
    C = convert.config_from(jc)
    je, _ = jenergy.total_energy(js.pos, js.box, js.mol_alive, jp, jc, jt)
    te, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T)
    for k in ("rd", "lrc", "es_real", "es_recip", "vdw"):
        assert float(getattr(te, k)) == pytest.approx(
            float(getattr(je, k)), rel=1e-11, abs=1e-9), k
    assert abs(float(te.vdw)) > 1.0
    if rep in ("sig", "9th"):
        assert float(te.lrc) != 0.0


def _table(K, seed=3, C=None):
    shape = (K, 16) if C is None else (C, K, 16)
    return torch.as_tensor(np.random.default_rng(seed).random(shape))


@pytest.mark.parametrize("rep", ["none", "sig"])
def test_scan_chunk_prices_every_trial_vdw(rep):
    """A 60-step scan chunk with cdvdw (displace moves): each step's
    trial vdw equals the reference's vdw_energy of the trial
    configuration (rel 1e-11), an accepted trial's vdw is carried, and
    the carried energy equals a fresh initialize (1e-9)."""
    (jp, _, jc, _), (P, S, C, T) = _fluid(repulsion=rep)
    trace = []
    step, carry, c, branch, stats = tm.chunk_setup(S, P, C, T, _table(60))
    for k in range(60):
        pos_before = carry["pos"].clone()
        step(carry, carry["u"][k], int(branch[k]), T, c, stats, trace)
        rec = trace[-1]
        trial = pos_before.clone()
        idx = P.mol_atoms[int(rec["mol"])]
        trial[idx] = rec["rows"]
        ja = jnp.asarray(carry["alive"].numpy())
        want = float(jvdw.vdw_energy(jnp.asarray(trial.numpy()),
                                     jnp.asarray(c.box.numpy()), ja, jp,
                                     jc))
        assert float(rec["vdw"]) == pytest.approx(want, rel=1e-11)
        if bool(rec["accept"]):
            assert float(carry["energy"].vdw) == float(rec["vdw"])
    st = tm._from_carry(S, carry, 60)
    fresh = tm.initialize(st, P, C, T)
    assert 0 < int(stats.accepts[0]) < 60
    assert float(st.energy.total) == pytest.approx(float(fresh.energy.total),
                                                   abs=1e-9)
    assert float(st.energy.vdw) == pytest.approx(float(fresh.energy.vdw),
                                                 abs=1e-9)


def test_batched_chains_with_cdvdw_make_the_single_chain_decisions():
    """C = 2 chains with cdvdw (the batched eigensolve): each chain ends in
    the state and energies of a single-chain chunk over its own rows."""
    _, (P, S, C, T) = _fluid(repulsion="sig")
    u = _table(30, seed=4, C=2)
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 2), P, C, T, 30, uniforms=u)
    for k in range(2):
        uk = u[k].clone()
        uk[:, 8] = u[0, :, 8]
        one, st1 = tm.run_chunk(S, P, C, T, 30, uniforms=uk)
        sc = slice_chain(states, k)
        torch.testing.assert_close(sc.pos, one.pos, rtol=0, atol=1e-12)
        assert float(sc.energy.vdw) == pytest.approx(float(one.energy.vdw),
                                                     rel=1e-11)
        assert stats.host().accepts[k].tolist() == \
            st1.host().accepts.tolist()
        fresh = tm.initialize(sc, P, C, T)
        assert float(sc.energy.total) == pytest.approx(
            float(fresh.energy.total), abs=1e-9)


@pytest.mark.parametrize("rep", ["none", "sig"])
def test_mc_bookkeeping_with_cdvdw(rep):
    """The reference's test_mc_with_cdvdw_accumulates_consistently and
    test_mc_bookkeeping_with_sig_repulsion on the port: 200 steps on the
    Drude dimer, carried total against a fresh initialize (1e-9)."""
    P, S, C, T = _dimer(5.0, rep, rd="lj" if rep != "none" else "none",
                        eps=30.0, sig=3.0)
    S = tm.initialize(S, P, C, T)
    assert float(S.energy.vdw) != 0.0
    g = torch.Generator().manual_seed(2)
    st, stats = tm.run_chunk(S, P, C, T, 200, generator=g)
    fresh = tm.initialize(st, P, C, T)
    assert float(st.energy.total) == pytest.approx(
        float(fresh.energy.total), abs=1e-9)
    assert int(stats.host().accepts[0]) > 0


def test_cdvdw_deck_runs_and_names_its_route(tmp_path):
    """A cdvdw + cdvdw_sig_repulsion deck through run.run on the CPU: the
    refusal is gone, the log names the plain tile pass (B2 and B4's gate
    refuses the repulsion) and the block energies carry a vdw term."""
    _, (P, S, C, T) = _fluid()
    tpqr.write_state(str(tmp_path / "pd.pqr"), P, S, ["PD"], extended=True)
    deck = input_script.parse(f"""
ensemble nvt
numsteps 40
corrtime 20
temperature 150
basis1 11 0 0
basis2 0 11 0
basis3 0 0 11
precision float64
rd_lrc off
ewald_kmax 4
polar_damp_type exponential
cdvdw on
cdvdw_sig_repulsion on
pqr_input {tmp_path / 'pd.pqr'}
""")
    assert deck.cfg.cdvdw and deck.cfg.cdvdw_repulsion == "sig"
    trun.check_supported(deck)
    log = io.StringIO()
    _, avgs = trun.run(deck, log=log, device="cpu")
    out = log.getvalue()
    assert "the cdvdw repulsions" in out
    assert all(v != 0.0 for v in avgs.samples["energy_vdw"])


def test_cdvdw_tail_trap_is_refused():
    """The reference's µVT trap: with a sig or 9th repulsion and rd_lrc,
    an insert adds the repulsion's self tail T_ii and the refresh the LJ
    one — shown on the reference's own functions — so the port refuses µVT
    there (CDVDW_LRC_TRAP) and takes it with rd_lrc off, or under NVT."""
    from mpmc_tpu.ops import pairs as jpairs
    (jp, js, jc, _), _ = _fluid(repulsion="sig")
    jc = dataclasses.replace(jc, rd_lrc=True)
    rc = jpairs.derived_cutoff(js.box, jc)
    full = float(jpairs.lrc_self_coefficient(
        js.mol_alive[jp.mol_id] & jp.atom_ok, jp, jc, rc))
    per_mol = sum(float(jpairs.mol_lrc_self_coefficient(jp, jc, rc, m))
                  for m in range(8))
    assert full < 0.0 < per_mol
    for line, ok in (("ensemble uvt\nrd_lrc on\n", False),
                     ("ensemble uvt\nrd_lrc off\n", True),
                     ("ensemble nvt\nrd_lrc on\n", True)):
        job = input_script.parse(f"{line}cdvdw on\ncdvdw_9th_repulsion on\n")
        if ok:
            trun.check_supported(job)
        else:
            with pytest.raises(ValueError, match="rd_lrc off$"):
                trun.check_supported(job)
    _, (P, _, C, _) = _fluid(repulsion="sig")
    with pytest.raises(ValueError, match="CDVDW|self term"):
        tm.make_step_fn(P, dataclasses.replace(C, ensemble="uvt",
                                               rd_lrc=True,
                                               insert_species=(0,)))
