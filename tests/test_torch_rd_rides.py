"""What rides on the RD forms' plain pass and tail, on the CPU: the NPT
volume candidate under disp_expansion (its tail follows the box) and sg
against the JAX package (rel 1e-12, as tests/test_torch_npt.py), NPT
bookkeeping with volume moves, replay's virial pressure against the
reference's run_replay, the rotor grid's potentials against
mpmc_tpu.ops.qrot, a polar scan chunk's bookkeeping, exact resume from a
checkpoint, and parallel tempering over batched chains and an isotherm
campaign under disp_expansion."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import moves as jmoves  # noqa: E402
from mpmc_tpu.mc import run as jrun  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import qrot as jq  # noqa: E402
from mpmc_tpu_torch import campaign, convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import qrot  # noqa: E402
from torch_npt import lj_npt, port  # noqa: E402
from torch_rd import jax_rd  # noqa: E402

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
DISP = {"damp_dispersion": True, "rd_lrc": True}


def _npt(form):
    p, s, c, t = lj_npt()
    p, c = jax_rd(p, c, form, **(DISP if form == "disp_expansion" else {}))
    return p, s, c, t


@pytest.mark.parametrize("form", ["disp_expansion", "sg"])
def test_volume_candidate_matches_reference(form):
    """The port's volume candidate (scaled positions and box, every term
    of the energy delta) against the reference's scale_volume +
    total_energy(split_frozen=True), rel 1e-12: under disp_expansion the
    tail's 1/V and its rc (L/2, derived) both move."""
    (jp, js, jc, jt), P, S, C, T = port(_npt(form))
    d_lnv = 0.07
    u = torch.zeros(16, dtype=torch.float64)
    u[1] = (d_lnv / float(T.volume_change_factor) + 1.0) / 2.0
    c = tm._Chunk(S.box, P, C, T)
    _, new_box, d, _, _ = tm._volume_trial(tm._carry(S, P, C), u, T, c, P,
                                            C)
    dl = (2.0 * jnp.asarray(float(u[1])) - 1.0) * jt.volume_change_factor
    jpos, jbox = jmoves.scale_volume(js.pos, js.box, jp, js.mol_alive, dl)
    np.testing.assert_allclose(new_box.numpy(), np.asarray(jbox),
                               rtol=1e-12)
    e_new, _, _ = jenergy.total_energy(jpos, jbox, js.mol_alive, jp, jc,
                                       jt, split_frozen=True)
    jd = e_new.sub(js.energy)
    for k in TERMS:
        assert float(getattr(d, k)) == pytest.approx(
            float(getattr(jd, k)), rel=1e-12, abs=1e-9), k
    assert (abs(float(d.lrc)) > 0) == (form == "disp_expansion")


def test_npt_bookkeeping_with_the_tail():
    """120 NPT steps under disp_expansion (volume moves accepted): the
    carried energy, the tail included, equals a fresh initialize in the
    final box to 1e-9 (f64)."""
    _, P, S, C, T = port(_npt("disp_expansion"))
    st, stats = tm.run_chunk(S, P, C, T, 120,
                             generator=torch.Generator().manual_seed(4))
    assert int(stats.host().accepts[tm.VOLUME]) > 0
    assert not torch.equal(st.box, S.box)
    fresh = tm.initialize(st, P, C, T)
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k


# dispersion-expansion argon: mass, charge, polar, then eps = A [K], sig
# = B [1/A], omega, C6, C8, C10
AR = "39.948 0.0 0.0 2.4e7 3.9 0.0 7.0e4 8.0e4 1.1e5"


def test_replay_virial_pressure_matches_the_reference(tmp_path):
    """Two 12-atom frames replayed under damped disp_expansion with its
    tail and calc_pressure: every frame's energy and pressure equal the
    reference's run_replay (rel 1e-9)."""
    L = 18.0
    rng = np.random.default_rng(3)
    lines = []
    for _ in range(2):
        for i, q in enumerate(rng.uniform(0, L, (12, 3))):
            lines.append(f"ATOM {i + 1} Ar AR {i + 1} M {q[0]:.5f} "
                         f"{q[1]:.5f} {q[2]:.5f} {AR}")
        lines.append("END")
    traj = tmp_path / "t.pqr"
    traj.write_text("\n".join(lines) + "\n")
    text = (f"ensemble replay\ntemperature 100\nbasis1 {L} 0 0\n"
            f"basis2 0 {L} 0\nbasis3 0 0 {L}\ncoulomb off\n"
            "disp_expansion on\ndamp_dispersion on\nrd_lrc on\n"
            f"calc_pressure on\nprecision float64\npqr_input {traj}\n")
    got = trun.run(input_script.parse(text), log=io.StringIO(),
                   device="cpu")
    want = jrun.run(jinput.parse(text), log=io.StringIO())
    for k in ("pressure_atm", "energy_total", "energy_lrc"):
        np.testing.assert_allclose(got.samples[k], want.samples[k],
                                   rtol=1e-9, err_msg=k)
    assert min(got.samples["energy_lrc"]) < 0


def test_rotor_grid_matches_reference():
    """qrot.potentials_on_grid (B4 at stride 0's plain version) under
    damped disp_expansion against mpmc_tpu.ops.qrot.potential_on_grid on a
    jittered MOF + H2 system, rel 1e-10 (f64)."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=6,
                                      dtype="float64")
    p, c = jax_rd(p, c, "disp_expansion", **DISP)
    mov = ~np.asarray(p.mol_frozen)[np.asarray(p.mol_id)]
    pos = np.asarray(s.pos) + np.where(
        mov[:, None], np.random.default_rng(5).uniform(
            -0.3, 0.3, np.asarray(s.pos).shape), 0.0)
    s = jm.initialize(s.replace(pos=jnp.asarray(pos)), p, c, t)
    P, S, C, T = convert.from_jax(p, s, c, t)
    th, ph, _ = jq.quadrature_grid()
    axes = jq.orientation_axes(th, ph)
    mols, _ = qrot.rotor_slots(S.mol_alive, P, [jsystems.h2_bss3()])
    v = qrot.potentials_on_grid(S.pos, S.box, S.atom_alive(P), P, C,
                                T.temperature, mols, axes).numpy()
    for i, m in enumerate(mols):
        want = jq.potential_on_grid(s.pos, s.box, s.atom_alive(p), p, c,
                                    t.temperature, m, axes)
        np.testing.assert_allclose(v[i], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def _deck(tmp_path, *lines, n_side=4, n_h2=4, polar=False):
    """A µVT deck (f64) on the MOF + H2 (polarizable with ``polar``) under
    damped disp_expansion with its tail, C10 from extrapolate_disp_coeffs,
    written by the port."""
    from mpmc_tpu_torch.io import pqr as pqr_io
    from mpmc_tpu_torch.models import systems
    P, S, C, T = systems.mof_h2_gcmc(n_side=n_side, n_h2=n_h2, capacity=8,
                                     polarization=polar, dtype="float64",
                                     device="cpu")
    P, C = systems.with_rd_form(P, C, "disp_expansion")
    P = P.replace(c10=torch.zeros_like(P.c10))
    pqr_io.write_state(str(tmp_path / "sys.pqr"), P, S, ["H2"],
                       extended=True)
    Lb = float(S.box[0, 0])
    text = ("ensemble uvt\nnumsteps 40\ncorrtime 20\ntemperature 77\n"
            f"pressure 20\nbasis1 {Lb} 0 0\nbasis2 0 {Lb} 0\n"
            f"basis3 0 0 {Lb}\ndisp_expansion on\ndamp_dispersion on\n"
            "extrapolate_disp_coeffs on\nrd_lrc on\nprecision float64\n"
            f"pqr_input {tmp_path / 'sys.pqr'}\n"
            + "".join(x + "\n" for x in lines))
    (tmp_path / "run.inp").write_text(text)
    return input_script.parse(text)


def test_polar_scan_bookkeeping(tmp_path):
    """The polar scan path (Thole over polarizable framework and H2 sites,
    PHAHST's shape) under disp_expansion: 10 steps through run.run, then a
    further 10-step chunk whose carried energy equals a fresh initialize
    to 1e-9, and its polar term within 1e-6 (f64; the CG stops at
    polar_precision 1e-10)."""
    su, _ = trun.run(_deck(tmp_path, "polarization on",
                           "polar_precision 1e-10", "numsteps 10",
                           "corrtime 10", "allow_charged_cell on",
                           n_side=3, n_h2=3, polar=True),
                     log=io.StringIO(), device="cpu")
    st, stats = tm.run_chunk(su.state, su.params, su.cfg, su.thermo, 10,
                             generator=torch.Generator().manual_seed(3))
    assert int(stats.host().accepts.sum()) > 0
    fresh = tm.initialize(st, su.params, su.cfg, su.thermo)
    assert float(fresh.energy.lrc) < 0 and float(fresh.energy.polar) < 0
    for k in TERMS:
        tol = 1e-6 if k == "polar" else 1e-9
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=tol, abs=tol), k


def test_checkpoint_resume_is_exact(tmp_path):
    """One corrtime block written with checkpoint_output, one resumed with
    checkpoint_input: the state and energies of a two-block run, bit for
    bit, under disp_expansion."""
    ck = tmp_path / "run.ck"
    whole, _ = trun.run(_deck(tmp_path), log=io.StringIO(), device="cpu")
    job = _deck(tmp_path, "numsteps 20", f"checkpoint_output {ck}")
    trun.run(job, log=io.StringIO(), device="cpu")
    log = io.StringIO()
    resumed, _ = trun.run(_deck(tmp_path, "numsteps 20",
                                f"checkpoint_input {ck}"),
                          log=log, device="cpu")
    assert "resumed exactly" in log.getvalue()
    assert resumed.state.step == whole.state.step == 40
    assert torch.equal(resumed.state.pos, whole.state.pos)
    for k in TERMS:
        assert torch.equal(getattr(resumed.state.energy, k),
                           getattr(whole.state.energy, k)), k


def test_pt_and_campaign_over_batched_chains(tmp_path):
    """Parallel tempering over two batched chains (no fused_mc: the
    batched scan route, B4 over chains) and a two-point campaign of two
    chains under disp_expansion: both run, their energies finite and the
    tail negative."""
    log = io.StringIO()
    su, avgs = trun.run(_deck(tmp_path, "parallel_tempering on",
                              "n_replicas 2", "max_temperature 120",
                              "ptemp_freq 10"), log=log, device="cpu")
    assert "batched scan chains (C=2)" in log.getvalue()
    assert (su.states.energy.lrc < 0).all()
    assert np.isfinite(avgs.mean("energy_total"))
    rows = campaign.run_isotherm(
        _deck(tmp_path), pressures=[5.0, 20.0], chains=2,
        target_rel_sem=0.5, min_steps=40, max_steps=40, equil_blocks=1,
        log=io.StringIO(), device="cpu")
    assert len(rows) == 2 and all(np.isfinite(r.n_mean) for r in rows)
