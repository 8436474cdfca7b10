"""The port's surf, surf_fit and surf_multi_fit drivers (mc/surface.py)
and the batched energies under them (ops/energy.total_energy_chains, plain
B2 over a batch of geometries, pair_kernel.pair_terms_chains_plain),
float64 on the CPU: the reference's cases against analytic LJ, the output
format, the SA path of a fit against mpmc_tpu on the same seed, refusals,
and the batched energies against lone calls and the reference's vmapped
total_energy."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import surface as jsurface  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as run_mod  # noqa: E402
from mpmc_tpu_torch.mc import surface  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk  # noqa: E402

torch.set_num_threads(1)

AR_PQR = """ATOM 1 Ar AR 1 M 0.0 0.0 0.0 39.948 0.0 0.0 119.8 3.405
ATOM 2 Ar AR 2 M 4.0 0.0 0.0 39.948 0.0 0.0 119.8 3.405
END
"""

BASE = """ensemble surf
temperature 100
basis1 40 0 0
basis2 0 40 0
basis3 0 0 40
rd_lrc off
precision float64
surf_min 3.0
surf_max 6.0
surf_inc 0.5
"""

# a charged, three-site H2 dimer (BSS-like: two H sites and a massless
# centre site), for the Ewald and polarization energies
H2_PQR = """ATOM 1 H2G H2 1 M 0.0 0.0 0.0 0.0 -0.846 0.6 12.76 3.06
ATOM 2 H2E H2 1 M 0.371 0.0 0.0 1.008 0.423 0.0 0.0 0.0
ATOM 3 H2E H2 1 M -0.371 0.0 0.0 1.008 0.423 0.0 0.0 0.0
ATOM 4 H2G H2 2 M 4.0 0.0 0.0 0.0 -0.846 0.6 12.76 3.06
ATOM 5 H2E H2 2 M 4.0 0.371 0.0 1.008 0.423 0.0 0.0 0.0
ATOM 6 H2E H2 2 M 4.0 -0.371 0.0 1.008 0.423 0.0 0.0 0.0
END
"""


def lj(r, eps=119.8, sig=3.405):
    s6 = (sig / r) ** 6
    return 4 * eps * s6 * (s6 - 1)


@pytest.fixture
def ar_pqr(tmp_path):
    p = tmp_path / "ar2.pqr"
    p.write_text(AR_PQR)
    return str(p)


def _run(fn, text):
    return fn(input_script.parse(text), log=io.StringIO(), device="cpu")


def test_surface_scan_matches_analytic_lj(ar_pqr):
    res = _run(surface.run_surface, BASE + f"pqr_input {ar_pqr}\n")
    assert len(res) == 7
    for row in res:
        assert row["min"] == pytest.approx(lj(row["r"]), rel=1e-9)
        assert row["mean"] == pytest.approx(lj(row["r"]), rel=1e-9)


def test_orientation_sweep_is_invariant_for_a_monatomic_pair(ar_pqr):
    res = _run(surface.run_surface, BASE + f"surf_ang 90\npqr_input "
               f"{ar_pqr}\n")
    for row in res:
        assert row["min"] == pytest.approx(row["mean"], rel=1e-12)
        assert row["min"] == pytest.approx(lj(row["r"]), rel=1e-9)


def test_surface_output_file_keeps_the_reference_format(tmp_path, ar_pqr):
    """The port's surf_output equals the reference's line for line (its
    numbers to the printed digits)."""
    text = BASE + f"surf_decomp on\npqr_input {ar_pqr}\n"
    out, ref = tmp_path / "pes.dat", tmp_path / "pes_ref.dat"
    log = io.StringIO()
    surface.run_surface(input_script.parse(text + f"surf_output {out}\n"),
                        log=log, device="cpu")
    jsurface.run_surface(jinput.parse(text + f"surf_output {ref}\n"),
                         log=io.StringIO())
    assert out.read_text() == ref.read_text()
    lines = [ln for ln in out.read_text().splitlines()
             if ln and not ln.startswith("#")]
    assert len(lines) == 7 and len(lines[0].split()) == 7
    assert f"surface scan written to {out}" in log.getvalue()


def test_surface_scan_both_orientations_h2_dimer(tmp_path):
    """The swept minimum lies at or below the fixed orientation's, the
    orientations spread, and both equal the reference's scan."""
    d = 0.35
    pqr = tmp_path / "d2.pqr"
    pqr.write_text(
        f"ATOM 1 A D2 1 M 0.0 0.0 {-d} 1.0 0.0 0.0 40.0 3.0\n"
        f"ATOM 2 A D2 1 M 0.0 0.0 {d} 1.0 0.0 0.0 40.0 3.0\n"
        f"ATOM 3 A D2 2 M 4.0 0.0 {-d} 1.0 0.0 0.0 40.0 3.0\n"
        f"ATOM 4 A D2 2 M 4.0 0.0 {d} 1.0 0.0 0.0 40.0 3.0\nEND\n")
    base = (f"ensemble surf\ntemperature 100\nbasis1 40 0 0\n"
            f"basis2 0 40 0\nbasis3 0 0 40\nrd_lrc off\ncoulomb off\n"
            f"precision float64\nsurf_min 3.2\nsurf_max 5.2\n"
            f"surf_inc 0.5\npqr_input {pqr}\n")
    fixed = _run(surface.run_surface, base)
    swept = _run(surface.run_surface, base + "surf_ang 90\n")
    ref = jsurface.run_surface(jinput.parse(base + "surf_ang 90\n"),
                               log=io.StringIO())
    for fr, sw, rf in zip(fixed, swept, ref):
        assert sw["min"] <= fr["min"] + 1e-9
        assert sw["mean"] != pytest.approx(sw["min"])
        for k in ("min", "mean"):
            assert sw[k] == pytest.approx(rf[k], rel=1e-10, abs=1e-9)


def _curve(tmp_path):
    eps_t, sig_t = 150.0, 3.2
    rs = np.arange(3.0, 6.01, 0.25)
    curve = tmp_path / "abinit.dat"
    curve.write_text("\n".join(
        f"{r:.4f} {lj(r, eps_t, sig_t):.8f}" for r in rs))
    return curve


def test_surface_fit_recovers_parameters_on_the_reference_path(tmp_path,
                                                               ar_pqr):
    """A float64 fit recovers the curve's parameters and takes the
    reference's SA path on the same seed: the same best chi^2 and
    parameters, and the same log lines."""
    text = (BASE.replace("ensemble surf", "ensemble surf_fit")
            + f"pqr_input {ar_pqr}\nfit_input {_curve(tmp_path)}\n"
            "numsteps 2000\nfit_schedule 0.998\nfit_boltzmann_weight 500\n")
    log, jlog = io.StringIO(), io.StringIO()
    result, chi2 = surface.run_surface_fit(input_script.parse(text),
                                           log=log, device="cpu")
    jres, jchi2 = jsurface.run_surface_fit(jinput.parse(text), log=jlog)
    fit = result["type0"]
    assert fit["eps"] == pytest.approx(150.0, rel=0.05)
    assert fit["sig"] == pytest.approx(3.2, rel=0.02)
    assert chi2 == pytest.approx(jchi2, rel=1e-9)
    for k in ("eps", "sig"):
        assert fit[k] == pytest.approx(jres["type0"][k], rel=1e-12)
    assert log.getvalue().splitlines()[0].split("chi2_0=")[0] == \
        jlog.getvalue().splitlines()[0].split("chi2_0=")[0]


@pytest.mark.parametrize("what", ["no_blocks", "atom_count", "no_input",
                                  "three_molecules"])
def test_malformed_input_is_refused(tmp_path, ar_pqr, what):
    fit = BASE.replace("ensemble surf", "ensemble surf_multi_fit")
    if what == "no_blocks":
        conf = tmp_path / "bad.dat"
        conf.write_text("0.0 0.0 0.0\n1.0 0.0 0.0\n")
        text, match = (fit + f"pqr_input {ar_pqr}\nfit_input {conf}\n",
                       "E <energy>")
    elif what == "atom_count":
        conf = tmp_path / "bad.dat"
        conf.write_text("E 1.0\n0 0 0\n1 0 0\n2 0 0\n")
        text, match = (fit + f"pqr_input {ar_pqr}\nfit_input {conf}\n",
                       "movable atoms")
    elif what == "no_input":
        text, match = fit + f"pqr_input {ar_pqr}\n", "fit_input"
    else:
        p = tmp_path / "ar3.pqr"
        p.write_text(AR_PQR.replace("END", "ATOM 3 Ar AR 3 M 8.0 0.0 0.0 "
                                    "39.948 0.0 0.0 119.8 3.405\nEND"))
        text, match = BASE + f"pqr_input {p}\n", "exactly 2 movable"
    with pytest.raises(ValueError, match=match):
        run_mod.run(input_script.parse(text), log=io.StringIO(),
                    device="cpu")


def _h2_system(tmp_path, extra=""):
    """(the reference's setup, the port's) of the charged H2 dimer deck."""
    p = tmp_path / "h2.pqr"
    p.write_text(H2_PQR)
    text = ("ensemble surf\ntemperature 77\nbasis1 25 0 0\nbasis2 0 25 0\n"
            "basis3 0 0 25\nprecision float64\nrd_lrc on\ncutoff 10\n"
            f"pqr_input {p}\n" + extra)
    from mpmc_tpu.mc import run as jrun
    jsu = jrun.setup(jinput.parse(text))
    su = run_mod.setup(input_script.parse(text), device="cpu")
    return jsu, su


def _geometries(su, C, seed=3):
    """C seeded dimer geometries of the port's setup: separations 3-6 A,
    random orientations of both molecules ([C, N, 3] float64)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, C, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    a, b = surface._dimer_slots(su.params, su.state.mol_alive)
    return surface.dimer_positions(
        su.params, su.state.pos, a, b,
        torch.as_tensor(rng.uniform(3.0, 6.0, C)),
        torch.as_tensor(q[1]), torch.as_tensor(q[0]))


@pytest.mark.parametrize("extra", ["", "coulomb wolf\n",
                                   "polarization on\npolar_precision 1e-10\n"
                                   "polar_max_iter 200\n",
                                   "feynman_hibbs on\n",
                                   "rd_crystal on\nrd_lrc off\n"],
                         ids=["ewald", "wolf", "polar", "fh", "rd_crystal"])
def test_batched_energy_equals_lone_calls_and_the_vmapped_reference(
        tmp_path, extra):
    """total_energy_chains of C = 5 geometries: each entry equals a lone
    total_energy of it (rel 1e-12) and the reference's total_energy under
    jax.vmap (rel 1e-10, the polar term within the solves' precision)."""
    jsu, su = _h2_system(tmp_path, extra)
    pos = _geometries(su, 5)
    e = tenergy.total_energy_chains(pos, su.state.box, su.state.mol_alive,
                                    su.params, su.cfg, su.thermo)
    ref = jax.vmap(lambda x: jenergy.total_energy(
        x, jsu.state.box, jsu.state.mol_alive, jsu.params, jsu.cfg,
        jsu.thermo)[0])(jnp.asarray(pos.numpy()))
    for c in range(pos.shape[0]):
        lone, _ = tenergy.total_energy(pos[c], su.state.box,
                                       su.state.mol_alive, su.params,
                                       su.cfg, su.thermo)
        for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
                  "polar", "vdw"):
            got = float(getattr(e, k)[c])
            tol = 1e-6 if k == "polar" else 1e-10
            assert got == pytest.approx(float(getattr(lone, k)), rel=1e-12
                                        if k != "polar" else 1e-8,
                                        abs=1e-9), (c, k)
            assert got == pytest.approx(float(np.asarray(getattr(ref, k))[c]),
                                        rel=tol, abs=1e-8), (c, k)


def test_plain_b2_over_geometries_equals_lone_plain_b2(tmp_path):
    """pair_terms_chains (on the CPU, its plain version) of C geometries:
    each entry the plain B2 of its positions, at row_start 0 and 2, C = 1
    included."""
    _, su = _h2_system(tmp_path)
    p = su.params
    pos = _geometries(su, 4, seed=8)
    frozen = p.mol_frozen[p.mol_id]
    alive = su.state.atom_alive(p)
    scal = tpairs.pair_scalars(su.state.box, su.cfg)
    for rs in (0, 2):
        for C in (1, 4):
            raw = tpk.pair_terms_chains(pos[:C].contiguous(), p.charge,
                                        p.eps, p.sig, p.mol_id32, alive,
                                        frozen, scal, su.cfg, row_start=rs)
            assert raw.shape == (C, 9)
            for c in range(C):
                lone = tpk.pair_terms_plain(pos[c], p.charge, p.eps, p.sig,
                                            p.mol_id32, alive, frozen, scal,
                                            su.cfg, row_start=rs)
                torch.testing.assert_close(raw[c], lone, rtol=1e-13,
                                           atol=1e-12)
