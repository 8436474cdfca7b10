"""The RD forms and coulomb gwp on the port's routes: a µVT scan
trajectory of the port (float32) against the reference's fused µVT kernel
in interpret mode on one numpy-made uniform table (the same accepts and
the same molecule-count path, the disp_expansion tail's count-dependent
delta included), the fused gates of B1, B3 and B6 equal to the
reference's for each form, every fused route running the form's plain
B1, B3 or B6 with its log line where the reference's gate would take a
fused kernel, the scan path where the reference too takes it (float64,
polarization without delayed acceptance, with its WARNING), and the
library PT drivers over B1 and B3 under disp_expansion."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.parallel import replica  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402
from torch_rd import FORMS, mof  # noqa: E402

torch.set_num_threads(1)
DISP = {"damp_dispersion": True, "rd_lrc": True}


def _reference_kernel(params, state, cfg, thermo, u):
    """The reference's fused µVT kernel (interpret mode) over the table
    ``u``, set up as its metropolis._fused_chunk_uvt does: (sums, slot
    aliveness, positions, slots)."""
    slots, slot_start, species_idx, tmpl, A_list, rep_slots = (
        jm.uvt_fused_tables(params, cfg))
    rc = jpairs.derived_cutoff(state.box, cfg)
    alpha = jpairs.derived_alpha(rc, cfg)
    d_self, d_excl, c1, cx, lnfv, kv, kcoef = jm._uvt_chunk_consts(
        state.pos, state.box, params, thermo, cfg, A_list, rep_slots)
    thr = cfg.cavity_autoreject_absolute
    new_pos, slot_alive, sums, _, _, _, _ = jmk.run_steps_uvt(
        state.pos, params.eps, params.sig, params.charge, params.mass,
        state.atom_alive(params), slot_start, species_idx,
        state.mol_alive[slots], tmpl, state.box, rc, alpha,
        1.0 / thermo.temperature, thermo.move_factor, thermo.rot_factor,
        thr * thr, thermo.insert_probability, lnfv, d_self, d_excl, c1, cx,
        jnp.asarray(u), cfg, u.shape[0], state.pos.shape[0], A_list=A_list,
        interpret=True, kvecs=kv, kcoef=kcoef, sk_re=state.sk_re,
        sk_im=state.sk_im, c6=params.c6, c8=params.c8, c10=params.c10,
        gwp_alpha=params.gwp_alpha)
    return np.asarray(sums), np.asarray(slot_alive), np.asarray(new_pos), \
        np.asarray(slots)


@pytest.mark.parametrize("case", ["disp_expansion", "gwp"])
def test_scan_trajectory_matches_the_reference_kernel(case):
    """disp_expansion (damped, its tail on) under Ewald, and LJ under
    coulomb gwp: the port's scan run_chunk and the reference's fused µVT
    kernel over the same [100, 16] table make the same accepts, the same
    molecule count after 50 and after 100 steps, and end in the same
    aliveness, positions within 1e-4 A (float32).  The reference's gate
    admits both forms to its fused kernel, so its kernel is the
    reference's route under fused_mc; its scan path draws from a key, not
    from a table."""
    if case == "gwp":
        p, s, c, t = mof(None, "float32", gwp=True, initialize=True)
    else:
        p, s, c, t = mof(case, "float32", initialize=True, **DISP)
    assert jmk.supported_uvt(c, p)
    K = 100
    u = np.random.default_rng(21).random((K, 16)).astype(np.float32)
    P, S, C, T = convert.from_jax(p, s, c, t)
    n_path = []
    for k in (K // 2, K):
        sums, slot_alive, new_pos, slots = _reference_kernel(p, s, c, t,
                                                             u[:k])
        S2, stats = tm.run_chunk(S, P, C, T, k, uniforms=torch.as_tensor(
            u[:k]))
        np.testing.assert_array_equal(stats.accepts.numpy()[:3], sums[6:9])
        np.testing.assert_array_equal(stats.attempts[:3], sums[9:12])
        np.testing.assert_array_equal(S2.mol_alive.numpy()[slots],
                                      slot_alive)
        np.testing.assert_allclose(S2.pos.numpy(), new_pos, atol=1e-4)
        n_path.append(int(S2.n_molecules(P)))
    assert sums[7] > 0 and sums[8] > 0, sums       # inserts and deletes
    assert len(set(n_path)) == 2 or sums[7] != sums[8], n_path


GATES = ("supported_uvt", "supported", "supported_npt", "supported_multi",
         "supported_uvt_multi", "supported_uvt_polar_da")


@pytest.mark.parametrize("rd,coulomb", [(f, "ewald") for f in FORMS]
                         + [("lj", "gwp")])
def test_fused_gates_stay_closed(rd, coulomb):
    """Each fused gate of the port equals the reference's for every form:
    on the configuration (µVT, NVT, NVE, NPT, polar delayed acceptance)
    where it holds with LJ under Ewald, the port's gate and the
    reference's hold with the form too."""
    p, s, c, t = mof(None, "float32")
    P = convert.from_jax(p, s, c, t)[0]
    lj_frameless = mof(None, "float32", n_h2=8)
    cases = {"supported_uvt": {}, "supported_uvt_multi": {},
             "supported": {"ensemble": "nvt"},
             "supported_multi": {"ensemble": "nvt"},
             "supported_npt": {"ensemble": "npt"},
             "supported_uvt_polar_da": {"polarization": True,
                                        "polar_delayed": True}}
    for gate in GATES:
        base = dataclasses.replace(c, **cases[gate])
        params, tparams = p, P
        if gate == "supported_npt":
            # NPT needs no frozen molecule: the H2 alone
            params = _no_framework(lj_frameless[0])
            tparams = convert.from_jax(params, lj_frameless[1], c,
                                       lj_frameless[3])[0]
        fn = getattr(tmk, gate)
        assert fn(convert.config_from(base), tparams), gate
        new = dataclasses.replace(base, rd_potential=rd, coulomb=coulomb)
        assert fn(convert.config_from(new), tparams), (gate, rd)
        if gate != "supported_uvt_polar_da":
            ref = getattr(jmk, gate)
            assert ref(new, params), (gate, rd)
        # the physics surface itself, form by form
        assert (tmk._supported_physics(convert.config_from(new))
                == jmk._supported_physics(new)), (gate, rd)


def _no_framework(params):
    """``params`` with every molecule movable (the frozen flags cleared),
    for the NPT gate."""
    return dataclasses.replace(params, mol_frozen=jnp.zeros_like(
        params.mol_frozen))


def _deck(tmp_path, *lines, n_h2=4):
    """A µVT deck on the n_side 4 MOF + H2 (written by the port's writer)
    under disp_expansion, with ``lines``."""
    from mpmc_tpu_torch.io import pqr as pqr_io
    from mpmc_tpu_torch.models import systems
    P, S, C, T = systems.mof_h2_gcmc(n_side=4, n_h2=n_h2, capacity=8,
                                     dtype="float64", device="cpu")
    P, C = systems.with_rd_form(P, C, "disp_expansion")
    pqr = tmp_path / "sys.pqr"
    pqr_io.write_state(str(pqr), P, S, ["H2"], extended=True)
    L = float(S.box[0, 0])
    deck = tmp_path / "run.inp"
    deck.write_text(
        f"ensemble uvt\nnumsteps 4\ncorrtime 2\ntemperature 77\npressure 1\n"
        f"basis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
        "disp_expansion on\ndamp_dispersion on\n"
        f"pqr_input {pqr}\n" + "".join(x + "\n" for x in lines))
    return deck


# each route's log line and the plain kernel it runs
ROUTES = {"uvt": ("single-chain fused µVT kernel", "run_steps_uvt_plain"),
          "nvt": ("single-chain fused NVT kernel", "run_steps_plain"),
          "chains": ("chain-interleaved", "run_steps_uvt_plain"),
          "nvt-chains": ("chain-interleaved", "run_steps_plain"),
          "pt": ("on-device swaps (R=2)", "run_steps_uvt_plain"),
          "pt-fugacity": ("on-device swaps (R=2)", "run_steps_uvt_plain"),
          "pda": ("polar delayed-acceptance stage-1 kernel",
                  "run_steps_uvt_pda_plain")}


@pytest.mark.parametrize("lines", [
    ("fused_mc on",), ("fused_mc on", "ensemble nvt"),
    ("fused_mc on", "chains 2"), ("fused_mc on", "ensemble nvt", "chains 2"),
    ("fused_mc on", "parallel_tempering on", "n_replicas 2"),
    ("fused_mc on", "pt_fugacity on", "n_replicas 2"),
    ("fused_mc on", "polarization on", "polar_delayed on")],
    ids=list(ROUTES))
def test_fused_routes_refuse_naming_a12a2b(tmp_path, lines, monkeypatch,
                                          request):
    """Under fused_mc every route the reference would fuse with
    disp_expansion runs with --cpu on the plain B1, B3 or B6 of the form,
    the C6/C8/C10 columns passed, and logs its fused route and the form
    instances."""
    route = request.node.callspec.id
    want, plain = ROUTES[route]
    calls = []
    orig = getattr(tmk, plain)

    def counted(*a, **k):
        calls.append(k.get("disp") is not None)
        return orig(*a, **k)
    monkeypatch.setattr(tmk, plain, counted)
    deck = _deck(tmp_path, *lines)
    log = io.StringIO()
    trun.run(input_script.parse_file(str(deck)), log=log, device="cpu")
    text = log.getvalue()
    assert want in text and "WARNING" not in text, text
    assert "fused_mc: rd disp_expansion / coulomb ewald run in the fused " \
        "kernels' form instances (uvt_disp_kernel" in text
    assert calls and all(calls)


@pytest.mark.parametrize("lines,warning", [
    (("fused_mc on", "precision float64"), "fused_mc requested"),
    (("fused_mc on", "polarization on"), "fused_mc requested"),
    ((), None)], ids=["float64", "polar-plain", "scan"])
def test_scan_routes_run(tmp_path, lines, warning):
    """Where the reference's gate also refuses (float64; polarization
    without delayed acceptance) and without fused_mc the deck runs on the
    scan path, with the reference's WARNING where fused_mc was asked."""
    deck = _deck(tmp_path, *lines)
    log = io.StringIO()
    su, avgs = trun.run(input_script.parse_file(str(deck)), log=log,
                        device="cpu")
    text = log.getvalue()
    assert su.state.step == 4
    assert (warning in text) if warning else "WARNING" not in text
    assert "pair passes" not in text       # B2/B4's route, no plain pass


def test_library_pt_drivers_refuse_naming_a12a2b():
    """run_parallel_tempering_fused and _fused_multi run a disp_expansion
    µVT system as the reference's drivers would: two rounds of 4 steps
    over a 2-rung ladder on the plain B1 of the form, each replica's
    carried energy equal to a fresh initialize (rel 1e-4 in float32), the
    ladder kept."""
    p, s, c, t = mof("disp_expansion", "float32", initialize=True, **DISP)
    P, S, C, T = convert.from_jax(p, s, c, t)
    for fn in (replica.run_parallel_tempering_fused,
               replica.run_parallel_tempering_fused_multi):
        states, temps, _ = fn(P, S, C, T, [77.0, 90.0], 2, 4)
        assert sorted(np.asarray(temps).tolist()) == [77.0, 90.0]
        if fn is replica.run_parallel_tempering_fused_multi:
            states = [slice_chain(states, i) for i in range(2)]
        for st in states:
            assert int(st.step) == 8
            fresh = tm.initialize(st, P, C, T)
            for k in ("rd", "lrc", "es_real", "es_recip"):
                assert float(getattr(st.energy, k)) == pytest.approx(
                    float(getattr(fresh.energy, k)), rel=1e-4, abs=1e-3), k
