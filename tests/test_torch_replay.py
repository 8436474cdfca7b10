"""The port's ``ensemble replay`` (mc/run.py::run_replay, _frame_pressure),
its native trajectory reader (csrc/pqr_io.cpp through io/native.py::
stream_frames_arrays) and moves.scale_volume, against the JAX package and
analytic values, float64 on the CPU: two LJ frames, the ideal-gas and the
LJ virial pressure, the same-layout fast path against a fresh setup per
frame, a varying-N trajectory relayout against the reference's run_replay,
the reader against io/pqr.py::read_frames field by field, and a failing
g++ build."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import moves as jmoves  # noqa: E402
from mpmc_tpu.mc import run as jrun  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch.io import input_script, native, pqr  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import _build  # noqa: E402

torch.set_num_threads(1)

AR = "39.948 0.0 0.0 119.8 3.405"
ARGON_PQR = f"""\
! two argon atoms
ATOM 1 Ar AR 1 M 0.0 0.0 0.0 {AR}
ATOM 2 Ar AR 2 M 3.9 0.0 0.0 {AR}
END
"""
BASE = """
temperature 150
basis1 12 0 0
basis2 0 12 0
basis3 0 0 12
rd_lrc off
coulomb off
precision float64
"""


def _replay(text, traj):
    """The port's replay of ``traj`` under deck ``text`` (CPU)."""
    job = input_script.parse(f"ensemble replay\n{text}pqr_input {traj}\n")
    return trun.run(job, log=io.StringIO(), device="cpu")


def _ref_replay(text, traj):
    job = jinput.parse(f"ensemble replay\n{text}pqr_input {traj}\n")
    return jrun.run(job, log=io.StringIO())


def test_replay_two_lj_frames(tmp_path):
    traj = tmp_path / "traj.pqr"
    traj.write_text(ARGON_PQR + ARGON_PQR.replace("3.9", "4.5"))
    avgs = _replay("temperature 150\nbasis1 50 0 0\nbasis2 0 50 0\n"
                   "basis3 0 0 50\ncutoff 20\nrd_lrc off\ncoulomb off\n"
                   "precision float64\n", traj)
    assert avgs.count() == 2
    e1 = 4 * 119.8 * ((3.405 / 3.9) ** 12 - (3.405 / 3.9) ** 6)
    e2 = 4 * 119.8 * ((3.405 / 4.5) ** 12 - (3.405 / 4.5) ** 6)
    assert avgs.mean("energy_total") == pytest.approx((e1 + e2) / 2,
                                                      rel=1e-10)


def test_replay_ideal_gas_pressure(tmp_path):
    """Non-interacting frames: the virial pressure is N kT / V."""
    rng = np.random.default_rng(0)
    L, n = 12.0, 15
    lines = []
    for f in range(3):
        lines.append(f"REMARK frame {f}")
        for i in range(n):
            x, y, z = rng.uniform(0, L, 3)
            lines.append(f"ATOM {i+1} He HE {i+1} M {x:.4f} {y:.4f} "
                         f"{z:.4f} 4.0 0.0 0.0 0.0 0.0")
        lines.append("END")
    traj = tmp_path / "traj.pqr"
    traj.write_text("\n".join(lines) + "\n")
    avgs = _replay(f"temperature 200\nbasis1 {L} 0 0\nbasis2 0 {L} 0\n"
                   f"basis3 0 0 {L}\nrd_lrc off\ncoulomb off\n"
                   "calc_pressure on\nprecision float64\n", traj)
    expect = n * 200.0 / L ** 3 / ATM2K_A3
    assert avgs.mean("pressure_atm") == pytest.approx(expect, rel=1e-9)


def test_replay_lj_virial_pressure_matches_the_reference(tmp_path):
    """Interacting frames: the port's pressure equals the reference's
    _frame_pressure (rel 1e-9) and, for two atoms, the analytic virial
    (r/3) dU/dr (rel 1e-4, the central difference's truncation)."""
    L, r = 30.0, 4.0
    rng = np.random.default_rng(2)
    lines = [f"ATOM 1 Ar AR 1 M 10.0 10.0 10.0 {AR}",
             f"ATOM 2 Ar AR 2 M {10 + r} 10.0 10.0 {AR}", "END"]
    for _ in range(2):           # and two dense frames of 12 atoms
        for i, p in enumerate(rng.uniform(0, L, (12, 3))):
            lines.append(f"ATOM {i+1} Ar AR {i+1} M {p[0]:.5f} {p[1]:.5f} "
                         f"{p[2]:.5f} {AR}")
        lines.append("END")
    traj = tmp_path / "t.pqr"
    traj.write_text("\n".join(lines) + "\n")
    text = (f"temperature 100\nbasis1 {L} 0 0\nbasis2 0 {L} 0\n"
            f"basis3 0 0 {L}\nrd_lrc off\ncoulomb off\ncalc_pressure on\n"
            "precision float64\n")
    got = _replay(text, traj).samples["pressure_atm"]
    want = _ref_replay(text, traj).samples["pressure_atm"]
    np.testing.assert_allclose(got, want, rtol=1e-9)
    eps, sig = 119.8, 3.405
    s6 = (sig / r) ** 6
    du_dlnv = r / 3.0 * 4 * eps * (-12 * s6 * s6 + 6 * s6) / r
    expect = (2 * 100.0 - du_dlnv) / L ** 3 / ATM2K_A3
    assert got[0] == pytest.approx(expect, rel=1e-4)


def test_replay_fast_path_matches_full_setup(tmp_path):
    """Same-layout frames write their positions into the padded state;
    the energies equal an ``ensemble te`` run of each frame alone."""
    rng = np.random.default_rng(5)
    frames_xyz = [rng.uniform(1, 11, (4, 3)) for _ in range(3)]

    def frame(xyz):
        return "\n".join(f"ATOM {i+1} Ar AR {i+1} M {p[0]:.5f} {p[1]:.5f} "
                         f"{p[2]:.5f} {AR}" for i, p in enumerate(xyz))
    traj = tmp_path / "t.pqr"
    traj.write_text("".join(frame(x) + "\nEND\n" for x in frames_xyz))
    log = io.StringIO()
    job = input_script.parse(f"ensemble replay\n{BASE}pqr_input {traj}\n")
    avgs = trun.run(job, log=log, device="cpu")
    assert "3 frames, 1 setups, 0 laid out" in log.getvalue()
    want = []
    for k, xyz in enumerate(frames_xyz):
        single = tmp_path / f"f{k}.pqr"
        single.write_text(frame(xyz) + "\nEND\n")
        j2 = input_script.parse(f"ensemble te\n{BASE}pqr_input {single}\n")
        want.append(float(trun.run(j2, log=io.StringIO(),
                                   device="cpu").total))
    np.testing.assert_allclose(avgs.samples["energy_total"], want,
                               rtol=1e-12)


def test_replay_varying_n_relayout_matches_the_reference(tmp_path):
    """A GCMC-like trajectory over a frozen wall whose molecule count
    changes every frame: frames that fit are laid out into the existing
    slots (a new setup only when a count breaks the running maximum),
    and every frame's averages equal the reference's run_replay (rel
    1e-12)."""
    rng = np.random.default_rng(4)
    lines = []
    for n_mol in (1, 3, 2, 3, 1, 4, 2):
        lines.append("REMARK frame")
        for i in range(2):          # the frozen wall
            lines.append(f"ATOM {i+1} W WAL 1 F {2.0 + 6 * i} 6.0 6.0 "
                         "12.011 0.0 0.0 52.8 3.4")
        for i in range(n_mol):
            p = rng.uniform(1, 11, 3)
            lines.append(f"ATOM {i+3} Ar AR {i+2} M {p[0]:.5f} "
                         f"{p[1]:.5f} {p[2]:.5f} {AR}")
        lines.append("END")
    traj = tmp_path / "vary.pqr"
    traj.write_text("\n".join(lines) + "\n")
    log = io.StringIO()
    job = input_script.parse(f"ensemble replay\n{BASE}pqr_input {traj}\n")
    got = trun.run(job, log=log, device="cpu")
    assert "7 frames, 3 setups, 4 laid out" in log.getvalue()
    want = _ref_replay(BASE, traj)
    assert got.samples["N"] == [1.0, 3.0, 2.0, 3.0, 1.0, 4.0, 2.0]
    assert sorted(got.samples) == sorted(want.samples)
    for k in want.samples:
        np.testing.assert_allclose(got.samples[k], want.samples[k],
                                   rtol=1e-12, atol=1e-300, err_msg=k)


def test_native_reader_equals_the_python_reader(tmp_path):
    """Every field of every frame the native reader hands over equals
    io/pqr.py::read_frames: comments, CRYST1 cells, HETATM, the extended
    columns, frozen/movable flags, names cut to 7 characters."""
    traj = tmp_path / "mix.pqr"
    traj.write_text(
        "# comment\nREMARK one\nCRYST1 10.0 11.0 12.0 90.0 80.0 100.0\n"
        "ATOM 1 C1 FRAMEWK 1 F 1.0 2.0 3.0 12.011 0.25 1.5 50.0 3.4\n"
        "HETATM 2 H2G H2 2 M 4.5 5.25 -6.0 0.0 -0.9 0.0 36.7 2.958 "
        "0.1 2.5 30.25 700.125 0.5\n"
        "ATOM 3 H2E H2 2 m 4.6 5.25 -6.0 1.008 0.45 0.0 0.0 0.0\nEND\n"
        "! second frame, no cell\n"
        "ATOM 1 C1 FRAMEWK 1 F 1.5 2.0 3.0 12.011 0.25 1.5 50.0 3.4\n"
        "ATOM 2 Ne NE 7 M 9.0 9.0 9.0 20.18 0.0 0.0 0.0 0.0 0.2\nENDMDL\n")
    ref = pqr.read_frames(str(traj))
    got = list(native.stream_frames_arrays(str(traj)))
    assert len(got) == len(ref) == 2
    for arr, fr in zip(got, ref):
        obj = native.frame_from_arrays(arr)
        if fr.box is None:
            assert arr["box"] is None and obj.box is None
        else:
            np.testing.assert_array_equal(arr["box"], fr.box)
        assert len(obj.atoms) == len(fr.atoms) == arr["num"].shape[0]
        for a, b in zip(obj.atoms, fr.atoms):
            for f in ("serial", "name", "mol_name", "mol_id", "mass",
                      "charge", "polar", "eps", "sig", "omega", "c6", "c8",
                      "c10", "gwp_alpha"):
                assert getattr(a, f) == getattr(b, f), f
            assert a.flag == b.flag[0]
            np.testing.assert_array_equal(a.xyz, b.xyz)


def test_native_reader_raises_on_a_bad_line(tmp_path):
    traj = tmp_path / "bad.pqr"
    traj.write_text(f"ATOM 1 Ar AR 1 M 0 0 0 {AR}\nEND\nATOM 1 Ar AR 1 M 0\n")
    frames = native.stream_frames_arrays(str(traj))
    assert next(frames)["num"].shape == (1, 13)
    with pytest.raises(ValueError, match="line 3: ATOM needs >=14 fields"):
        next(frames)
    with pytest.raises(FileNotFoundError):
        native.stream_frames_arrays(str(tmp_path / "missing.pqr"))


def test_failed_gxx_build_raises_for_the_reader(tmp_path, monkeypatch):
    """g++ failing raises; replay does not fall back to the Python
    reader."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_build._libs, "pqr_io", raising=False)
    monkeypatch.setattr(_build, "gxx", lambda: "false")
    traj = tmp_path / "t.pqr"
    traj.write_text(ARGON_PQR)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on pqr_io.cpp"):
        _replay(BASE, traj)


@pytest.mark.parametrize("d_lnv", [3e-3, -0.2])
def test_scale_volume_matches_the_reference(d_lnv):
    """moves.scale_volume on the MOF + H2 system (rigid H2 shifted by
    their COM, the cell scaled) equals the reference's at 1e-12."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8,
                                      dtype="float64")
    P, S, _, _ = convert.from_jax(p, s, c, t)
    want_pos, want_box = jmoves.scale_volume(s.pos, s.box, p, s.mol_alive,
                                             jnp.asarray(d_lnv))
    got_pos, got_box = tmoves.scale_volume(S.pos, S.box, P, d_lnv)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box),
                               rtol=1e-12, atol=1e-12)
