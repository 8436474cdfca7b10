"""The port's geometry analyzers (mpmc_tpu_torch/analyze.py: pore, asa)
on the CPU against the reference's numpy twins and native library at
shared points, against the reference's numpy route at the same seed, and
the analytic single-sphere, empty-selection, isolated and buried-atom
cases of the reference's tests/test_analyze.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as ref  # noqa: E402
from mpmc_tpu.io import native as ref_native  # noqa: E402
from mpmc_tpu.io import pqr as ref_pqr  # noqa: E402
from mpmc_tpu_torch import analyze  # noqa: E402
from mpmc_tpu_torch.io import pqr  # noqa: E402
from torch_analyze import (gcmc_traj, sphere_struct,  # noqa: E402
                           triclinic_traj)

torch.set_num_threads(1)
CPU = "cpu"
has_native = ref_native.available()


@pytest.mark.parametrize("which", ["triclinic", "gcmc"])
def test_pore_matches_reference(tmp_path, which):
    """Shared sample and center points, triclinic cells: the port equals
    the numpy twin and the native kernel on both outputs."""
    path = (triclinic_traj(tmp_path, n_frames=1)[0] if which == "triclinic"
            else gcmc_traj(tmp_path)[0])
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 1, (400, 3))
    ctr = rng.uniform(0, 1, (150, 3))
    d, r = analyze.pore_samples(path, "*", "*", frac_pts=pts, frac_ctr=ctr,
                                device=CPU)
    d_p, r_p = ref.pore_python(ref_pqr.read_frames(path), "*", "*",
                               frac_pts=pts, frac_ctr=ctr)
    np.testing.assert_allclose(d, d_p, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r, r_p, rtol=1e-12, atol=1e-12)
    assert np.all(r >= d - 1e-12)
    if has_native:
        d_n, r_n = ref_native.traj_pore(path, "*", "*", n_points=400,
                                        n_centers=150, frac_pts=pts,
                                        frac_ctr=ctr)
        np.testing.assert_allclose(d, d_n, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r, r_n, rtol=1e-12, atol=1e-12)


def test_pore_single_sphere_analytic(tmp_path):
    """One sig = 3 atom in a 20 Å cube: void fraction 1 - (4/3) pi 1.5³ /
    8000, cap 10."""
    path, _ = sphere_struct(tmp_path, [("C", [10.0, 10.0, 10.0], 3.0)])
    res = analyze.pore(path, n_points=20000, n_centers=64, seed=5,
                       device=CPU)
    vf_exact = 1.0 - (4.0 / 3.0) * np.pi * 1.5 ** 3 / 8000.0
    assert abs(res["void_fraction"] - vf_exact) < 5e-3
    assert res["cap"] == pytest.approx(10.0)
    assert res["d_max"] <= 10.0 + 1e-12
    assert res["volume"] == pytest.approx(8000.0)


def test_pore_seeded_equals_numpy_route(tmp_path):
    """With a seed, pore's dict is the reference numpy route's (same
    points, same histogram)."""
    path, _, _ = gcmc_traj(tmp_path)
    kw = dict(probe_sigma=2.0, n_points=3000, n_centers=300, seed=4,
              nbins=30)
    got = analyze.pore(path, "*", "F", device=CPU, **kw)
    want = ref.pore(path, "*", "F", use_native=False, **kw)
    for k in ("void_fraction", "coverable_fraction", "d_max", "cap",
              "volume"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    for k in ("psd_r", "psd", "psd_cumulative"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)
    assert got["n_points"] == want["n_points"] == 3000


def test_pore_empty_selection_is_all_void(tmp_path):
    """No atom selected: every point at the cap, void fraction 1."""
    path, _, _ = triclinic_traj(tmp_path, n_frames=1)
    rng = np.random.default_rng(1)
    d, r = analyze.pore_samples(path, "XX", "F",
                                frac_pts=rng.uniform(0, 1, (64, 3)),
                                frac_ctr=rng.uniform(0, 1, (8, 3)),
                                device=CPU)
    cap = analyze._half_min_width(
        analyze._frame_box(pqr.read_first_frame(path), None))
    assert cap == pytest.approx(ref._half_min_width(ref._frame_box(
        ref_pqr.read_first_frame(path), None)), rel=1e-12)
    np.testing.assert_allclose(d, cap, rtol=1e-12)
    np.testing.assert_allclose(r, cap, rtol=1e-12)


def test_asa_isolated_atom_analytic(tmp_path):
    """A lone atom's accessible area is 4 pi R², R = (sig + probe)/2."""
    path, _ = sphere_struct(tmp_path, [("C", [10.0, 10.0, 10.0], 3.0)])
    res = analyze.asa(path, probe_sigma=2.0, n_sphere=128, device=CPU)
    assert res["area_A2"] == pytest.approx(4.0 * np.pi * 2.5 ** 2,
                                           rel=1e-12)
    assert res["volume_A3"] == pytest.approx(8000.0)
    assert res["mass_amu"] == pytest.approx(12.0)
    assert res["area_m2_g"] == pytest.approx(
        res["area_A2"] * 1e-20 / (12.0 * 1.66053906660e-24), rel=1e-9)


@pytest.mark.parametrize("which", ["triclinic", "gcmc"])
def test_asa_matches_reference(tmp_path, which):
    """Shared sphere directions on overlapping atoms in a triclinic cell:
    the port's (area, volume, mass) equals the numpy twin's and the
    native kernel's."""
    path = (triclinic_traj(tmp_path, n_frames=1)[0] if which == "triclinic"
            else gcmc_traj(tmp_path)[0])
    v = np.random.default_rng(7).normal(size=(96, 3))
    u = v / np.linalg.norm(v, axis=1, keepdims=True)
    got = analyze.asa_area(path, "*", "*", probe_sigma=1.0, unit_pts=u,
                           device=CPU)
    want = ref.asa_python(ref_pqr.read_frames(path), "*", "*",
                          probe_sigma=1.0, unit_pts=u)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if has_native:
        a_n = ref_native.traj_asa(path, "*", "*", probe_sigma=1.0,
                                  n_sphere=96, unit_pts=u)
        np.testing.assert_allclose(got, a_n, rtol=1e-12)
    counts, _ = analyze.asa_counts(path, "*", "*", probe_sigma=1.0,
                                   unit_pts=u, device=CPU)
    some, _ = analyze.asa_counts(path, "*", "*", probe_sigma=1.0,
                                 unit_pts=u, atoms=[0, 5, 7], device=CPU)
    np.testing.assert_array_equal(some, counts[[0, 5, 7]])


def test_asa_seeded_equals_numpy_route(tmp_path):
    path, _, _ = gcmc_traj(tmp_path)
    got = analyze.asa(path, "*", "F", probe_sigma=3.64, n_sphere=200,
                      seed=2, device=CPU)
    want = ref.asa(path, "*", "F", probe_sigma=3.64, n_sphere=200, seed=2,
                   use_native=False)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_asa_buried_atom_contributes_nothing(tmp_path):
    """An atom inside a larger concentric sphere adds no area; the big
    sphere stays fully exposed."""
    path, _ = sphere_struct(tmp_path, [("BIG", [10.0, 10.0, 10.0], 10.0),
                                       ("SML", [10.0, 10.0, 10.0], 3.0)])
    res = analyze.asa(path, probe_sigma=0.0, n_sphere=256, seed=2,
                      device=CPU)
    assert res["area_A2"] == pytest.approx(4.0 * np.pi * 5.0 ** 2,
                                           rel=1e-12)


def test_pore_asa_cli(tmp_path, capsys):
    path, _ = sphere_struct(tmp_path, [("C", [10.0, 10.0, 10.0], 3.0)])
    out_csv = tmp_path / "psd.csv"
    assert analyze.main(["pore", path, "--points", "2000", "--centers",
                         "64", "--out", str(out_csv), "--cpu"]) == 0
    assert "void fraction" in capsys.readouterr().out
    lines = out_csv.read_text().splitlines()
    assert lines[0] == "r,psd,cumulative" and len(lines) > 10
    assert analyze.main(["asa", path, "--probe", "2.0", "--sphere-points",
                         "64", "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "m^2/g" in text and "accessible area" in text
