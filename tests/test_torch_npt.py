"""The port's scan-path NPT volume move (metropolis._volume_trial /
_volume_step, moves.scale_volume) against the JAX package: the volume
candidate (scaled positions and box, every energy term, ln_bias) for a
given d ln V on an LJ fluid and on a frameless charged rigid-molecule
fluid under Ewald, the ideal-gas volume, bookkeeping after many volume
attempts, the move mix of lane 8, an exact resume, and the two reference
traps the port refuses."""
import dataclasses
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import free_atoms  # noqa: E402
from mpmc_tpu.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import moves as jmoves  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import ewald as jewald  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.parallel import replica as jreplica  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from torch_npt import (hcl_npt, ideal_npt, lj_npt, port, table,  # noqa: E402
                       write_deck)

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
SYSTEMS = {"lj": lj_npt, "hcl_ewald": hcl_npt}


@pytest.mark.parametrize("d_lnv", [0.07, -0.05])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_volume_candidate_matches_reference(system, d_lnv):
    """For a given d ln V (lane 1 = (d ln V / volume_change_factor + 1)
    / 2), the port's scaled positions and box, every term of the
    candidate's energy delta, ln_bias and the rebuilt box constants (rc,
    alpha, k-vectors) equal the reference's moves.scale_volume +
    total_energy(split_frozen=True) + the formula of
    mpmc_tpu/mc/metropolis.py:582-587, rel 1e-12 (f64)."""
    (jp, js, jc, jt), P, S, C, T = port(SYSTEMS[system]())
    vcf = float(T.volume_change_factor)
    u = torch.zeros(16, dtype=torch.float64)
    u[1] = (d_lnv / vcf + 1.0) / 2.0
    c = tm._Chunk(S.box, P, C, T)
    carry = tm._carry(S, P, C)
    new_pos, new_box, d, ln_bias, sk = tm._volume_trial(carry, u, T, c, P,
                                                        C)
    # the reference, with the same d ln V
    dl = (2.0 * jnp.asarray(float(u[1])) - 1.0) * jt.volume_change_factor
    assert float(dl) == pytest.approx(d_lnv, rel=1e-12)
    jpos, jbox = jmoves.scale_volume(js.pos, js.box, jp, js.mol_alive, dl)
    np.testing.assert_allclose(new_pos.numpy(), np.asarray(jpos),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(new_box.numpy(), np.asarray(jbox),
                               rtol=1e-12)
    cfg_np = dataclasses.replace(jc, polarization=False, cdvdw=False)
    e_new, _, aux = jenergy.total_energy(jpos, jbox, js.mol_alive, jp,
                                         cfg_np, jt, split_frozen=True)
    old_np = dataclasses.replace(js.energy, polar=jnp.zeros(()),
                                 vdw=jnp.zeros(()))
    jd = e_new.sub(old_np)
    for k in TERMS:
        assert float(getattr(d, k)) == pytest.approx(
            float(getattr(jd, k)), rel=1e-12, abs=1e-9), k
    assert abs(float(d.rd)) > 1.0
    v_old = jnp.abs(jnp.linalg.det(js.box))
    v_new = jnp.abs(jnp.linalg.det(jbox))
    n = jnp.sum(jm._movable_mask(jp, js.mol_alive)).astype(jnp.float64)
    j_bias = ((n + 1.0) * dl - jt.pressure * ATM2K_A3 * (v_new - v_old)
              / jt.temperature)
    assert float(ln_bias) == pytest.approx(float(j_bias), rel=1e-12)
    # the chunk constants of the new box, as a volume attempt rebuilds them
    c.rebuild(new_box)
    rc = jpairs.derived_cutoff(jbox, jc)
    assert float(c.rc) == pytest.approx(float(rc), rel=1e-12)
    assert float(c.rc) != pytest.approx(float(tm._Chunk(S.box, P, C,
                                                         T).rc), rel=1e-6)
    if jc.coulomb == "ewald":
        assert float(c.alpha) == pytest.approx(
            float(jpairs.derived_alpha(rc, jc)), rel=1e-12)
        np.testing.assert_allclose(
            c.kv.numpy(), np.asarray(jewald.kvectors(jbox, jc.ewald_kmax)),
            rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(sk[0].numpy(), np.asarray(aux["sk_re"]),
                                   rtol=1e-12, atol=1e-12)


def test_scale_volume_over_chains_is_each_chain_bit_for_bit():
    """moves.scale_volume over [C] chains with [C] d ln V: chain c equals
    the single-chain call bit for bit."""
    (_, _, _, _), P, S, C, T = port(hcl_npt())
    pos = torch.stack([S.pos, S.pos + 0.1, S.pos - 0.2])
    box = torch.stack([S.box, S.box * 1.01, S.box * 0.99])
    d = torch.tensor([0.05, -0.03, 0.0], dtype=torch.float64)
    new_pos, new_box = tmoves.scale_volume(pos, box, P, d)
    for c in range(3):
        p1, b1 = tmoves.scale_volume(pos[c], box[c], P, d[c])
        assert torch.equal(new_pos[c], p1) and torch.equal(new_box[c], b1)


def test_npt_ideal_gas_volume():
    """Ideal-gas NPT on the scan path: <V> = (N + 1) kT / P within 15 %
    (tests/test_mc.py::test_npt_ideal_gas_volume: 1,500 steps, then 150
    samples 20 steps apart)."""
    j, expect_v = ideal_npt()
    _, P, S, C, T = port(j)
    g = torch.Generator().manual_seed(9)
    S, _ = tm.run_chunk(S, P, C, T, 1500, generator=g)
    vols = []
    for _ in range(150):
        S, _ = tm.run_chunk(S, P, C, T, 20, generator=g)
        vols.append(float(torch.abs(torch.linalg.det(S.box))))
    assert np.mean(vols) == pytest.approx(expect_v, rel=0.15)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_npt_bookkeeping(system):
    """After 300 scan-path NPT steps with more than 20 volume attempts the
    carried energy equals a fresh recompute to 1e-9 (f64), term by term,
    and under Ewald the carried S(k) too (tests/test_mc.py::
    test_npt_lj_bookkeeping, here also on the charged fluid)."""
    _, P, S, C, T = port(SYSTEMS[system]())
    st, stats = tm.run_chunk(S, P, C, T, 300,
                             generator=torch.Generator().manual_seed(13))
    assert stats.attempts[tm.VOLUME] > 20
    assert 0 < int(stats.accepts[tm.VOLUME]) < stats.attempts[tm.VOLUME]
    assert int(stats.accepts[tm.DISPLACE]) > 0
    assert not torch.equal(st.box, S.box) and st.step == S.step + 300
    fresh = tm.initialize(st, P, C, T)
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    if C.coulomb == "ewald":
        np.testing.assert_allclose(st.sk_re.numpy(), fresh.sk_re.numpy(),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(st.sk_im.numpy(), fresh.sk_im.numpy(),
                                   rtol=1e-9, atol=1e-9)


def test_move_mix_from_lane_8():
    """The move type of each step is lane 8: a volume attempt where u8 <
    volume_probability, else a displacement; a volume attempt's box is
    scaled by exp(d ln V / 3), d ln V = (2 u1 - 1) volume_change_factor."""
    _, P, S, C, T = port(lj_npt(pv=0.3))
    K = 120
    u = table(K, seed=4)
    trace = []
    step, carry, c, branch, stats = tm.chunk_setup(S, P, C, T, u)
    for k in range(K):
        box0 = carry["box"]
        step(carry, carry["u"][k], int(branch[k]), T, c, stats, trace)
        if branch[k] == 1:
            s = np.exp((2.0 * float(u[k, 1]) - 1.0)
                       * float(T.volume_change_factor) / 3.0)
            torch.testing.assert_close(trace[-1]["box"], box0 * s,
                                       rtol=1e-14, atol=0)
    want = int((u[:, 8] < 0.3).sum())
    assert stats.attempts[tm.VOLUME] == want
    assert stats.attempts[tm.DISPLACE] == K - want
    assert (branch == (u[:, 8].numpy() < 0.3)).all()


def test_npt_resume_is_exact(tmp_path, monkeypatch):
    """An NPT deck (the charged Ewald fluid, scan path) of two corrtime
    blocks equals one block with checkpoint_output and one resumed with
    checkpoint_input, bit for bit: positions, box, every energy term."""
    monkeypatch.chdir(tmp_path)
    deck = write_deck(tmp_path, hcl_npt(), "corrtime 40", "ewald_kmax 5")

    def run(*lines, steps):
        text = deck.read_text() + "\n".join(
            (f"numsteps {steps}",) + lines) + "\n"
        path = tmp_path / "run.inp"
        path.write_text(text)
        buf = io.StringIO()
        su, _ = trun.run(input_script.parse_file(str(path)), log=buf,
                         device="cpu")
        return su.state, buf.getvalue()
    whole, _ = run(steps=80)
    run(f"checkpoint_output {tmp_path / 'ck'}", steps=40)
    resumed, text = run(f"checkpoint_input {tmp_path / 'ck'}", steps=40)
    assert "resumed exactly" in text and resumed.step == whole.step == 80
    assert torch.equal(resumed.pos, whole.pos)
    assert torch.equal(resumed.box, whole.box)
    for k in TERMS:
        assert torch.equal(getattr(resumed.energy, k),
                           getattr(whole.energy, k)), k


def _frozen_pair_system():
    """Two frozen one-atom molecules 3.9 A apart (their LJ pair inside the
    well) and four movable LJ atoms, NPT (reference objects)."""
    from mpmc_tpu.config import RunConfig, Thermo
    coords = np.array([[5.0, 5.0, 5.0], [8.9, 5.0, 5.0], [3.0, 3.0, 9.0],
                       [9.0, 3.0, 3.0], [3.0, 9.0, 9.0], [9.5, 9.5, 1.0]])
    params, state = free_atoms(12.0 * np.eye(3), coords, eps=100.0,
                               sig=3.2)
    params = dataclasses.replace(
        params, mol_frozen=params.mol_frozen.at[:2].set(True))
    cfg = RunConfig(ensemble="npt", coulomb="none", dtype="float64",
                    ortho_box=True)
    thermo = Thermo.make(temperature=200.0, pressure=50.0,
                         volume_probability=0.2, volume_change_factor=0.1,
                         n_species=1, dtype=jnp.float64)
    return params, state, cfg, thermo


def test_frozen_framework_trap_and_refusal(tmp_path):
    """The reference prices a volume move with split_frozen=True while
    moves.scale_volume moves the frozen molecules too
    (mpmc_tpu/mc/metropolis.py:572-581): on two frozen molecules the
    frozen-frozen energy changes with the cell and that change is missing
    from the reference's delta.  The port refuses NPT with a frozen
    molecule (ValueError naming the trap): make_step_fn,
    make_batched_step_fn, and so a deck of the example MOF."""
    jp, js, jc, jt = _frozen_pair_system()
    js = jm.initialize(js, jp, jc, jt)
    dl = jnp.asarray(0.1)
    jpos, jbox = jmoves.scale_volume(js.pos, js.box, jp, js.mol_alive, dl)
    e_act, e_ff, _ = jenergy.total_energy(jpos, jbox, js.mol_alive, jp, jc,
                                          jt, split_frozen=True)
    d_ff = float(e_ff.total) - float(js.e_frozen.total)
    assert float(js.e_frozen.rd) < -1.0          # the two frozen sites
    assert abs(d_ff) > 0.1 * abs(float(js.e_frozen.rd))
    # the full energy change has the frozen part the acceptance leaves out
    full_old, _ = jenergy.total_energy(js.pos, js.box, js.mol_alive, jp, jc,
                                       jt)
    full_new, _ = jenergy.total_energy(jpos, jbox, js.mol_alive, jp, jc, jt)
    d_ref = float(e_act.total) - float(js.energy.total)
    assert float(full_new.total) - float(full_old.total) == pytest.approx(
        d_ref + d_ff, rel=1e-9)
    P, S, C, T = convert.from_jax(jp, js, jc, jt)
    with pytest.raises(ValueError, match="frozen framework.*572-581"):
        tm.make_step_fn(P, C)
    with pytest.raises(ValueError, match="frozen framework"):
        tm.make_batched_step_fn(P, C)
    deck = tmp_path / "mof.inp"
    deck.write_text("ensemble npt\nbasis1 16 0 0\nbasis2 0 16 0\n"
                    "basis3 0 0 16\npqr_input "
                    + os.path.join(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))), "examples",
                        "framework_h2.pqr") + "\n")
    with pytest.raises(ValueError, match="frozen framework"):
        trun.run(input_script.parse_file(str(deck)), log=io.StringIO(),
                 device="cpu")


def test_parallel_tempering_trap_and_refusal():
    """The reference's temperature swap (_ladder_swap_core / host_swap,
    mpmc_tpu/parallel/replica.py:109-131, :370-398) has no P (V_i - V_j)
    term: two NPT replicas of equal energy and very different volumes
    always swap, while the isothermal-isobaric rule (b_i - b_j)[(E_i -
    E_j) + P (V_i - V_j)] rejects nearly always.  The port refuses NPT
    under parallel_tempering or pt_fugacity (ValueError naming the
    trap)."""
    temps = np.array([200.0, 300.0])
    energies = np.array([-500.0, -500.0])
    vols = np.array([2000.0, 8000.0])
    p_k = 100.0 * ATM2K_A3
    rng = np.random.default_rng(0)
    n_acc = sum(jreplica.host_swap(temps, energies, 0, rng)[1]
                for _ in range(20))
    assert n_acc == 20                              # always: ln P = 0
    ln_p = (1 / temps[0] - 1 / temps[1]) * (
        energies[0] - energies[1] + p_k * (vols[0] - vols[1]))
    assert ln_p < -5.0                              # e^-5: nearly never
    for line in ("parallel_tempering on", "pt_fugacity on"):
        job = input_script.parse(f"ensemble npt\n{line}\n")
        with pytest.raises(ValueError, match="P \\(V_i - V_j\\)"):
            trun.check_supported(job)


def test_npt_with_polarization_is_refused():
    """Polar NPT runs (tests/test_torch_polar_npt.py), but not where the
    reference's traps are: under a temperature ladder the run refuses it
    (NPT_PT_TRAP), and with a frozen framework the step (NPT_FROZEN_TRAP);
    without either both take it."""
    job = input_script.parse("ensemble npt\npolarization on\n")
    trun.check_supported(job)
    for line in ("parallel_tempering on", "pt_fugacity on"):
        with pytest.raises(ValueError, match="P \\(V_i - V_j\\)"):
            trun.check_supported(input_script.parse(
                f"ensemble npt\npolarization on\n{line}\n"))
    _, P, S, C, T = port(lj_npt())
    tm.make_step_fn(P, dataclasses.replace(C, polarization=True))
    P_f = P.replace(mol_frozen=torch.ones_like(P.mol_frozen))
    with pytest.raises(ValueError, match="frozen framework"):
        tm.make_step_fn(P_f, dataclasses.replace(C, polarization=True))


def test_npt_deck_runs_on_the_scan_path(tmp_path, monkeypatch):
    """An NPT LJ deck through run.run: one log line per corrtime, a
    volume acceptance, a restart whose CRYST1 record holds the final box,
    and a trajectory frame per block whose CRYST1 holds that block's box
    (the edge of each block's volume in the averages)."""
    monkeypatch.chdir(tmp_path)
    deck = write_deck(tmp_path, lj_npt(), "numsteps 200", "corrtime 100",
                      "coulomb off", "traj_output traj.pqr")
    buf = io.StringIO()
    su, avgs = trun.run(input_script.parse_file(str(deck)), log=buf,
                        device="cpu")
    out = buf.getvalue()
    assert "fused_mc" not in out
    assert sum(ln.startswith("step ") for ln in out.splitlines()) == 2
    assert 0 < avgs.mean("acc_volume") < 1
    L = float(su.state.box[0, 0])
    cryst = [ln for ln in (tmp_path / "restart.pqr").read_text()
             .splitlines() if ln.startswith("CRYST1")]
    assert cryst and float(cryst[0].split()[1]) == pytest.approx(L,
                                                                 abs=1e-3)
    frames = [float(ln.split()[1]) for ln in (tmp_path / "traj.pqr")
              .read_text().splitlines() if ln.startswith("CRYST1")]
    edges = [v ** (1 / 3) for v in avgs.samples["volume"]]
    assert frames == pytest.approx(edges, abs=1e-3) and len(frames) == 2
    assert frames[0] != pytest.approx(frames[1], abs=1e-3)
