"""The RD forms sg, dreiding, b14_7, disp_expansion (damped, with its
tail) and coulomb gwp through the port's energy and Monte Carlo paths on
the CPU: total_energy against the JAX package's in float64 (plain, split
and the frozen-reuse refresh), the scan path's and the batched chains'
bookkeeping in float64 (disp_expansion's count-dependent tail delta on
every insert and delete), the batched chains' decisions against
single-chain runs over the same rows, and a command-line deck with
``disp_expansion on``, ``damp_dispersion on`` and
``extrapolate_disp_coeffs on`` (tests/test_io_run.py's extrapolation
check, mirrored)."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import potentials as jp  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402
from torch_rd import FORMS, mof  # noqa: E402

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
DISP = {"damp_dispersion": True, "rd_lrc": True}
# (form, gwp): every form under Ewald (disp_expansion with its tail), and
# coulomb gwp under LJ and under disp_expansion
CASES = [(f, False) for f in FORMS] + [(None, True), ("disp_expansion",
                                                      True)]
IDS = [f"{f or 'lj'}-{'gwp' if g else 'ewald'}" for f, g in CASES]


def _system(form, gwp, dtype="float64", **kw):
    return mof(form, dtype, gwp, **(DISP if form == "disp_expansion"
                                    else {}), **kw)


def _close(got, want):
    for k in TERMS:
        g, w = float(getattr(got, k)), float(np.asarray(getattr(want, k)))
        assert g == pytest.approx(w, rel=1e-10, abs=1e-8), (k, g, w)


@pytest.mark.parametrize("mode", ["plain", "split_frozen", "frozen_cached"])
@pytest.mark.parametrize("form,gwp", CASES, ids=IDS)
def test_total_energy_matches_jax_f64(form, gwp, mode):
    """total_energy term by term against mpmc_tpu's (rel 1e-10, as
    tests/test_torch_energy.py): the whole system, its active and frozen
    parts, and the per-corrtime refresh that reuses the frozen part (rows
    >= F only; the tail's self terms included)."""
    p, s, c, t = _system(form, gwp)
    P, S, C, T = convert.from_jax(p, s, c, t)
    if mode == "plain":
        want, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t)
        got, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T)
        _close(got, want)
        assert (float(got.lrc) < 0) == (form in (None, "disp_expansion"))
        return
    wa, wf, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t,
                                     split_frozen=True)
    ga, gf, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T,
                                     split_frozen=True)
    if mode == "split_frozen":
        _close(ga, wa)
        _close(gf, wf)
        return
    F = jm.frozen_refresh_rows(p, c)
    assert F > 0 and F == tm.frozen_refresh_rows(P, C)
    want, _, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t,
                                      split_frozen=True, frozen_cached=wf,
                                      active_row_start=F)
    got, same, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T,
                                        split_frozen=True, frozen_cached=gf,
                                        active_row_start=F)
    assert same is gf
    _close(got, want)


def _fresh_close(st, fresh):
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k


@pytest.mark.parametrize("form,gwp", [("disp_expansion", False),
                                      (None, True)], ids=["disp", "gwp"])
def test_scan_path_bookkeeping_f64(form, gwp):
    """The scan path for 150 µVT steps in float64 (20 atm: inserts and
    deletes accepted): every carried term equals a fresh initialize to
    1e-9 — under disp_expansion the tail's count-dependent delta of each
    insert and delete too."""
    p, s, c, t = _system(form, gwp, initialize=True)
    t = t.replace(fugacity=t.fugacity * 20.0)
    P, S, C, T = convert.from_jax(p, s, c, t)
    st, stats = tm.run_chunk(S, P, C, T, 150,
                             generator=torch.Generator().manual_seed(8))
    acc = stats.host().accepts
    assert acc[tm.INSERT] > 0 and acc[tm.DELETE] > 0, acc
    assert float(st.energy.lrc) != float(S.energy.lrc)   # N moved the tail
    _fresh_close(st, tm.initialize(st, P, C, T))


@pytest.mark.parametrize("form,gwp", [("disp_expansion", False),
                                      (None, True)], ids=["disp", "gwp"])
def test_batched_chains_make_the_single_chain_decisions(form, gwp):
    """C = 2 batched scan chains over an injected [2, 80, 16] table (B4
    over the chain axis, here its plain version): each chain ends in the
    state, energy and accept counts of a single-chain run_chunk over its
    own rows (with chain 0's move-type lane, which every chain shares),
    and its carried energy equals a fresh recompute to 1e-9 (f64)."""
    p, s, c, t = _system(form, gwp, initialize=True)
    t = t.replace(fugacity=t.fugacity * 20.0)
    P, S, C, T = convert.from_jax(p, s, c, t)
    K = 80
    u = torch.as_tensor(np.random.default_rng(6).random((2, K, 16)))
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(S, 2), P, C, T, K, uniforms=u)
    st_h = stats.host()
    assert (st_h.accepts[:, tm.INSERT] + st_h.accepts[:, tm.DELETE]
            > 0).all()
    for ch in range(2):
        uc = u[ch].clone()
        uc[:, 8] = u[0, :, 8]
        one, st1 = tm.run_chunk(S, P, C, T, K, uniforms=uc)
        sc = slice_chain(states, ch)
        assert st_h.accepts[ch].tolist() == st1.host().accepts.tolist()
        assert torch.equal(sc.mol_alive, one.mol_alive)
        torch.testing.assert_close(sc.pos, one.pos, rtol=0, atol=1e-12)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(one.energy, k)), rel=1e-12, abs=1e-10), k
        _fresh_close(sc, tm.initialize(sc, P, C, T))
    fresh = multichain.initialize_batched(states, P, C, T)
    np.testing.assert_allclose(states.energy.total.numpy(),
                               fresh.energy.total.numpy(), rtol=1e-9,
                               atol=1e-9)


# two dispersion-expansion sites 4 A apart: eps = A, sig = B, then omega,
# C6, C8, C10 (0: extrapolate_disp_coeffs fills it)
PAIR_PQR = ("ATOM 1 X XX 1 M 5.0 5.0 5.0 10.0 0.0 0.0 40000.0 3.2 "
            "0.0 100.0 900.0 0.0 0.0\n"
            "ATOM 2 X XX 2 M 9.0 5.0 5.0 10.0 0.0 0.0 40000.0 3.2 "
            "0.0 100.0 900.0 0.0 0.0\nEND\n")


def test_extrapolate_disp_coeffs_fills_c10(tmp_path):
    """tests/test_io_run.py's check through the port's run_te on the CPU:
    C10 = (49/40) C8^2 / C6 deepens the damped dispersion at r = 4 A by
    f_10(B r) C10 / r^10."""
    (tmp_path / "de.pqr").write_text(PAIR_PQR)
    base = ("ensemble te\ntemperature 300\nbasis1 40 0 0\nbasis2 0 40 0\n"
            "basis3 0 0 40\ncutoff 15.0\ncoulomb off\ndisp_expansion on\n"
            f"rd_lrc off\nprecision float64\npqr_input {tmp_path}/de.pqr\n")
    e1 = trun.run_te(input_script.parse(base), log=io.StringIO(),
                     device="cpu")
    e2 = trun.run_te(input_script.parse(base + "extrapolate_disp_coeffs on\n"),
                     log=io.StringIO(), device="cpu")
    c10 = 49.0 / 40.0 * 900.0 ** 2 / 100.0
    extra = -float(jp.tt_damping(np.float64(3.2 * 4.0), 10)) * c10 / 4.0 ** 10
    assert float(e2.rd) - float(e1.rd) == pytest.approx(extra, rel=1e-9)


def test_cli_deck_runs(tmp_path, capsys):
    """A µVT deck with disp_expansion, damp_dispersion,
    extrapolate_disp_coeffs and rd_lrc through the port's command-line
    main with --cpu: the pair passes on B2/B4's route (no plain-pass
    line), the tail negative, the energy output written."""
    from mpmc_tpu_torch import __main__ as port_main
    from mpmc_tpu_torch.io import pqr as pqr_io
    from mpmc_tpu_torch.models import systems
    P, S, C, T = systems.mof_h2_gcmc(n_side=4, n_h2=4, capacity=8,
                                     dtype="float64", device="cpu")
    P, C = systems.with_rd_form(P, C, "disp_expansion")
    P = P.replace(c10=torch.zeros_like(P.c10))     # extrapolated by the run
    pqr_io.write_state(str(tmp_path / "sys.pqr"), P, S, ["H2"],
                       extended=True)
    L = float(S.box[0, 0])
    deck = tmp_path / "run.inp"
    deck.write_text(
        "ensemble uvt\nnumsteps 40\ncorrtime 20\ntemperature 77\n"
        f"pressure 20\nbasis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
        "disp_expansion on\ndamp_dispersion on\nextrapolate_disp_coeffs on\n"
        f"rd_lrc on\nprecision float64\npqr_input {tmp_path / 'sys.pqr'}\n"
        f"pqr_restart {tmp_path / 'restart.pqr'}\n"
        f"energy_output {tmp_path / 'energy.csv'}\n")
    port_main.main(["--cpu", str(deck)])
    text = capsys.readouterr().out
    assert "steps/sec" in text and "pair passes" not in text, text
    assert (tmp_path / "energy.csv").exists()
    su = trun.setup(input_script.parse_file(str(deck)), device="cpu")
    assert float(su.params.c10.max()) > 0
    e, _ = tenergy.total_energy(su.state.pos, su.state.box,
                                su.state.mol_alive, su.params, su.cfg,
                                su.thermo)
    assert float(e.lrc) < 0
