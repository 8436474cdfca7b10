"""The port's batched scan chains (parallel/multichain.run_chunk_batched,
metropolis.make_batched_step_fn, B4 over a chain axis) against its own
single-chain scan path and the JAX package: plain B4 over chains, the
decisions of each chain against a single-chain run over the same rows,
bookkeeping, energies and observables against mpmc_tpu, the CLI decks
and the refusals."""
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig, Thermo  # noqa: E402
from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import run as jrun  # noqa: E402
from mpmc_tpu.parallel import multichain as jmulti  # noqa: E402
from mpmc_tpu.state import EnergyBreakdown as JEnergy  # noqa: E402
from mpmc_tpu.state import Species, build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script, pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl")


def _hcl(ensemble="uvt"):
    """Neutral 2-site GCMC with Ewald in f64 (tests/test_torch_mc.py's
    system); nvt and nve without insert species."""
    sp = Species(name="hcl", atom_names=("H", "Cl"),
                 pos=np.array([[0, 0, 0], [1.3, 0, 0]]),
                 mass=np.array([1.0, 35.5]), charge=np.array([0.2, -0.2]),
                 polar=np.zeros(2), eps=np.array([20.0, 120.0]),
                 sig=np.array([2.5, 3.4]))
    params, state = build_system(12.0 * np.eye(3), species=(sp,),
                                 capacity=(20,), initial_counts=(6,),
                                 dtype=jnp.float64, seed=7)
    cfg = RunConfig(ensemble=ensemble, coulomb="ewald", dtype="float64",
                    ewald_kmax=6, pair_chunk=32,
                    insert_species=(0,) if ensemble == "uvt" else ())
    thermo = Thermo.make(temperature=250.0, fugacity=(50.0,),
                         insert_probability=0.4, move_factor=0.6,
                         rot_factor=0.8, n_species=1, dtype=jnp.float64)
    return params, state, cfg, thermo


def _port(ensemble):
    """(jax (params, state, cfg, thermo), port P, S, C, T) with the port's
    state initialized; under nve a reservoir 300 K above U."""
    j = _hcl(ensemble)
    P, S, C, T = convert.from_jax(*j)
    S = tm.initialize(S, P, C, T)
    if ensemble == "nve":
        T = T.replace(nve_energy=S.reported_energy().total + 300.0)
    return j, P, S, C, T


def _table(C, K, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).random((C, K, 16)))


def test_plain_b4_over_chains_is_the_per_chain_plain_exactly():
    """mol_pair_chains (on the CPU, its plain version) and the batched
    mol_pair_pass give each chain's mol_pair_plain bits, for current and
    trial rows, including a chain whose rank pick found nothing (count 0:
    index 0, the move rejected by the caller)."""
    _, P, S, C, T = _port("uvt")
    states, _ = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, C, T, 40, uniforms=_table(3, 40))
    mask = tm._movable_mask(P, states.mol_alive)
    mask[2] = False                              # chain 2: nothing to pick
    u = torch.tensor([0.3, 0.9, 0.5], dtype=torch.float64)
    mol, cnt = tmoves.pick_by_rank(mask, u)
    assert int(cnt[2]) == 0 and int(mol[2]) == 0
    rows = tmoves.displace_rows(states.pos, P, mol,
                                _table(3, 1, seed=5)[:, 0], 0.6, 0.8)
    scal = tpairs.pair_scalars(states.box[0], C)
    alive = states.mol_alive[:, P.mol_id] & P.atom_ok
    for r in (None, rows):
        got = tpk.mol_pair_chains(states.pos, P.charge, P.eps, P.sig,
                                  P.mol_id32, alive, P.mol_atoms,
                                  P.mol_natoms, mol, r, scal, C)
        terms = tpairs.mol_pair_pass(states.pos, states.box[0], alive, P, C,
                                     T.temperature, mol, row_pos=r,
                                     scal=scal)
        for c in range(3):
            one = tpk.mol_pair_plain(states.pos[c], P.charge, P.eps, P.sig,
                                     P.mol_id32, alive[c], P.mol_atoms,
                                     P.mol_natoms, mol[c],
                                     None if r is None else r[c], scal, C)
            assert torch.equal(got[c], one)
            single = tpairs.mol_pair_pass(
                states.pos[c], states.box[0], alive[c], P, C, T.temperature,
                mol[c], row_pos=None if r is None else r[c], scal=scal)
            for k in ("rd", "es_real", "lrc_coeff", "min_r2"):
                assert torch.equal(getattr(terms, k)[c],
                                   getattr(single, k)), k
        # the other batched pieces of a move, per chain
        intra = tpairs.intra_terms(states.pos, states.box[0], P, C, mol,
                                   row_pos=r, scal=scal)
        for c in range(3):
            one = tpairs.intra_terms(states.pos[c], states.box[0], P, C,
                                     mol[c],
                                     row_pos=None if r is None else r[c],
                                     scal=scal)
            assert float(intra[c]) == pytest.approx(float(one), rel=1e-14,
                                                    abs=1e-14)
    for c in range(3):
        one = tmoves.displace_rows(states.pos[c], P, mol[c],
                                   _table(3, 1, seed=5)[c, 0], 0.6, 0.8)
        torch.testing.assert_close(rows[c], one, rtol=1e-14, atol=1e-13)


@pytest.mark.parametrize("ensemble", ["uvt", "nvt", "nve"])
def test_batched_chunk_makes_the_single_chain_decisions(ensemble):
    """C = 3 chains over an injected [3, K, 16] table: each chain ends in
    the state, energy and accept counts of a single-chain run_chunk over
    its own rows with chain 0's lane 8 (the shared move type), and its
    carried energy equals a fresh recompute to 1e-9 (f64)."""
    _, P, S, C, T = _port(ensemble)
    K = 120
    u = _table(3, K)
    trace = []
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, C, T, K, uniforms=u, trace=trace)
    assert len(trace) == K and trace[0]["accept"].shape == (3,)
    st_h = stats.host()
    assert (st_h.attempts == st_h.attempts[:1]).all()
    for c in range(3):
        uc = u[c].clone()
        uc[:, 8] = u[0, :, 8]
        one, st1 = tm.run_chunk(S, P, C, T, K, uniforms=uc)
        sc = slice_chain(states, c)
        assert st_h.accepts[c].tolist() == st1.host().accepts.tolist()
        assert torch.equal(sc.mol_alive, one.mol_alive)
        torch.testing.assert_close(sc.pos, one.pos, rtol=0, atol=1e-12)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(one.energy, k)), rel=1e-12, abs=1e-10), k
        fresh = tm.initialize(sc, P, C, T)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    assert int(stats.accepts.sum()) > 0
    if ensemble == "uvt":
        assert (st_h.accepts[:, tm.INSERT] > 0).all()


def test_final_energies_match_mpmc_tpu_initialize():
    """After a batched chunk and the per-chain refresh, each chain's
    energy terms equal mpmc_tpu's initialize of the same state (rel
    1e-12)."""
    (jp, js, jc, jt), P, S, C, T = _port("uvt")
    states, _ = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, C, T, 80, uniforms=_table(3, 80))
    states = multichain.initialize_batched(
        states, P, C, T, frozen_rows=tm.frozen_refresh_rows(P, C))
    for c in range(3):
        sc = slice_chain(states, c)
        ref = jm.initialize(js.replace(pos=jnp.asarray(sc.pos.numpy()),
                                       mol_alive=jnp.asarray(
                                           sc.mol_alive.numpy())),
                            jp, jc, jt).reported_energy()
        got = sc.reported_energy()
        for k in TERMS:
            assert float(getattr(got, k)) == pytest.approx(
                float(getattr(ref, k)), rel=1e-12, abs=1e-12), (c, k)


def _lj_deck(tmp_path, *extra, n=32):
    params, state, _, _ = tsystems.lj_fluid(n=n, device="cpu")
    tpqr.write_state(str(tmp_path / "fluid.pqr"), params, state, ["AR"])
    L = float(state.box[0, 0])
    deck = tmp_path / "fluid.inp"
    deck.write_text("\n".join([
        "numsteps 200", "corrtime 100", "seed 3", "temperature 120",
        f"basis1 {L} 0 0", f"basis2 0 {L} 0", f"basis3 0 0 {L}",
        "move_factor 0.5", "rot_factor 0", "coulomb off",
        "precision float64", "pqr_input fluid.pqr",
        "pqr_restart restart.pqr", *extra]) + "\n")
    return deck


def _h2_deck(tmp_path, *extra):
    text = (REPO / "examples" / "h2_sorption.inp").read_text()
    text = text.replace("numsteps         20000", "numsteps 200").replace(
        "corrtime         1000", "corrtime 100").replace(
        "examples/framework_h2.pqr",
        str(REPO / "examples" / "framework_h2.pqr"))
    deck = tmp_path / "deck.inp"
    deck.write_text(text + "\n".join(extra) + "\n")
    return deck


def _in(tmp_path, fn):
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        return fn()
    finally:
        os.chdir(old)


def _nve_deck(tmp_path):
    te = _lj_deck(tmp_path, "ensemble te")
    e0 = float(_in(tmp_path, lambda: trun.run(
        input_script.parse_file(str(te)), log=io.StringIO(),
        device="cpu")).total)
    return _lj_deck(tmp_path, "ensemble nve", "chains 3",
                    f"total_energy {e0 + 180.0 * 32!r}")


def _jax_stack(jsu, states):
    """The reference's stacked state holding the port's chains."""
    C = states.pos.shape[0]
    js = jmulti.stack_states(jm.initialize(jsu.state, jsu.params, jsu.cfg,
                                           jsu.thermo), C)

    def energy(e):
        return JEnergy(**{k: jnp.asarray(getattr(e, k).numpy())
                          for k in ("rd", "lrc", "es_real", "es_recip",
                                    "es_self", "es_excl", "polar", "vdw")})
    return dataclasses.replace(
        js, pos=jnp.asarray(states.pos.numpy()),
        mol_alive=jnp.asarray(states.mol_alive.numpy()),
        energy=energy(states.energy), e_frozen=energy(states.e_frozen))


@pytest.mark.parametrize("deck", ["uvt", "nve"])
def test_observables_batched_match_the_reference(tmp_path, deck):
    """observables_batched on the stacked chains of a run equals the
    reference's on the same states, key for key (rel 1e-12), with each
    chain's T_kinetic under nve."""
    path = (_nve_deck(tmp_path) if deck == "nve"
            else _h2_deck(tmp_path, "chains 3", "precision float64"))
    su, _ = _in(tmp_path, lambda: trun.run(
        input_script.parse_file(str(path)), log=io.StringIO(),
        device="cpu"))
    jsu = _in(tmp_path, lambda: jrun.setup(jinput.parse_file(str(path))))
    got = trun.observables_batched(su, su.states, 3)
    want = jrun.observables_batched(jsu, _jax_stack(jsu, su.states), 3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12, abs=1e-12), k
    if deck == "nve":
        assert all(g["T_kinetic"] > 0 for g in got)
        assert len({g["T_kinetic"] for g in got}) == 3


def test_cli_batched_chains_deck(tmp_path):
    """``python -m mpmc_tpu_torch --cpu`` on ``chains 3`` without fused_mc:
    the batched scan route, logged, one block line per corrtime, the
    aggregate rate, and a restart per chain under parallel_restarts."""
    deck = _h2_deck(tmp_path, "chains 3", "parallel_restarts on")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "mpmc_tpu_torch", "--cpu",
                        str(deck)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "batched scan chains (C=3)" in r.stdout
    assert "fused_mc:" not in r.stdout and "WARNING" not in r.stdout
    assert r.stdout.count("\nstep ") == 2
    assert "aggregate (3 chains x 200 steps" in r.stdout
    for k in range(3):
        assert (tmp_path / f"restart.pqr-r{k}").stat().st_size > 0


def test_nve_chains_deck(tmp_path):
    """``chains 3`` under nve (with fused_mc on: the fused NVT gate takes
    one chain only under nve) runs as batched scan chains, each with its
    reservoir positive."""
    path = _nve_deck(tmp_path)
    path.write_text(path.read_text() + "fused_mc on\n")
    buf = io.StringIO()
    su, avgs = _in(tmp_path, lambda: trun.run(
        input_script.parse_file(str(path)), log=buf, device="cpu"))
    out = buf.getvalue()
    assert "batched scan chains (C=3)" in out
    assert "WARNING: fused_mc requested but unsupported" in out
    total = float(su.thermo.nve_energy)
    u = su.states.reported_energy().total
    assert (u < total).all() and avgs.mean("T_kinetic") > 0


@pytest.mark.parametrize("lines,item", [
    # polar chains and npt chains run now (item None), on the batched
    # route: polar chains on the MOF deck, npt chains on the (frameless)
    # LJ fluid deck
    (("chains 3", "polarization on"), None),
    (("chains 3", "ensemble npt", "pressure 200",
      "volume_probability 0.2", "volume_change_factor 0.05"), None),
], ids=["polar-chains", "npt-chains"])
def test_batched_chain_refusals(tmp_path, lines, item):
    """Both once refused, now run: polar chains as batched polar chains,
    a few steps on the CPU, every chain with its dipoles; npt chains as
    batched scan chains with a box per chain, each chain's carried energy
    equal to a fresh recompute (f64)."""
    npt = "ensemble npt" in lines
    deck = (_lj_deck(tmp_path, *lines) if npt else _h2_deck(
        tmp_path, *lines, "numsteps 6", "corrtime 3"))
    job = input_script.parse_file(str(deck))
    buf = io.StringIO()
    su, avgs = _in(tmp_path, lambda: trun.run(job, log=buf, device="cpu"))
    assert "batched scan chains (C=3)" in buf.getvalue()
    if not npt:
        assert su.states.mu.shape == su.states.pos.shape
        return
    assert su.states.box.shape == (3, 3, 3)
    assert len({float(b[0, 0]) for b in su.states.box}) == 3
    assert 0 < avgs.mean("acc_volume") < 1
    for c in range(3):
        sc = slice_chain(su.states, c)
        fresh = tm.initialize(sc, su.params, su.cfg, su.thermo)
        assert float(sc.energy.total) == pytest.approx(
            float(fresh.energy.total), rel=1e-9)


def test_batched_step_refuses_polarization():
    """The batched step once refused polarization (A7b); now it runs the
    polar step over the chains: two steps of three polar chains keep
    their dipoles, fields and residuals per chain, with a [C] count of
    CG iterations."""
    _, P, S, C, T = _port("uvt")
    C = dataclasses.replace(C, polarization=True)
    S = tm.initialize(S, P, C, T)
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 3), P, C, T, 2, uniforms=_table(3, 2))
    assert states.mu.shape == states.e0.shape == (3,) + S.pos.shape
    assert states.r_pol.shape == states.mu.shape
    assert stats.polar_iters.shape == (3,)


@pytest.mark.parametrize("lines", [
    ("chains 3",), ("parallel_tempering on",), ("pt_fugacity on",)],
    ids=["chains", "pt", "pt-fugacity"])
def test_new_decks_need_cuda_without_cpu(tmp_path, lines):
    """Without --cpu the batched-chains and PT decks run on the CUDA
    device or fail: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mpmc_tpu_torch import __main__ as port_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main([str(_h2_deck(tmp_path, *lines))])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        _in(tmp_path, lambda: trun.run(input_script.parse_file(
            str(_h2_deck(tmp_path, *lines)))))
