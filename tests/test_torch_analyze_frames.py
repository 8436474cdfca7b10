"""The port's frame analyzers (mpmc_tpu_torch/analyze.py: rdf, density,
loading, msd, orient, sq, cluster) on the CPU against the reference's
numpy twins and its native library on the same trajectories, written
with the port's writer; the analytic cases of the reference's
tests/test_analyze.py on the port alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as ref  # noqa: E402
from mpmc_tpu.io import native as ref_native  # noqa: E402
from mpmc_tpu.io import pqr as ref_pqr  # noqa: E402
from mpmc_tpu_torch import analyze  # noqa: E402
from mpmc_tpu_torch.utils.histogram import read_dx  # noqa: E402
from torch_analyze import (atom, cluster_frame, dimer_traj,  # noqa: E402
                           drift_traj, gcmc_traj, triclinic_traj,
                           write_traj)

torch.set_num_threads(1)
CPU = "cpu"
has_native = ref_native.available()


def frames_of(path):
    return ref_pqr.read_frames(path)


@pytest.mark.parametrize("sel", [("AR", "AR", "*", "*"),
                                 ("AR", "HE", "*", "*"),
                                 ("*", "*", "M", "M"),
                                 ("AR", "AR", "M", "F")])
def test_rdf_matches_reference(tmp_path, sel):
    path, box, _ = triclinic_traj(tmp_path)
    a, b, fa, fb = sel
    _, got = analyze.rdf(path, a, b, fa, fb, rmax=5.5, nbins=64,
                         device=CPU)
    want = ref.rdf_python(frames_of(path), a, b, fa, fb, rmax=5.5,
                          nbins=64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if has_native:
        gn = ref_native.traj_rdf(path, a, b, fa, fb, rmax=5.5, nbins=64)
        np.testing.assert_allclose(got, gn, rtol=1e-12, atol=1e-12)
    hist, _, near, n_frames = analyze.rdf_counts(path, a, b, fa, fb,
                                                 rmax=5.5, nbins=64,
                                                 device=CPU)
    assert hist.dtype == np.int64 and near == 0 and n_frames == 4


def test_rdf_ideal_gas_is_unity(tmp_path):
    """Uniform random points give g(r) = 1 (the normalization)."""
    box = np.eye(3) * 16.0
    rng = np.random.default_rng(11)
    frames = [[atom(i + 1, "ID", "ID", i + 1, "M", rng.uniform(0, 16, 3))
               for i in range(150)] for _ in range(24)]
    path = tmp_path / "ideal.pqr"
    write_traj(path, frames, box)
    _, g = analyze.rdf(str(path), "ID", "ID", rmax=7.0, nbins=14,
                       device=CPU)
    assert abs(np.mean(g[3:]) - 1.0) < 0.03
    assert np.all(np.abs(g[3:] - 1.0) < 0.2)


def test_rdf_varying_n_matches_reference(tmp_path):
    """H2 centres of a GCMC trajectory (N changing between frames): the
    per-frame ideal pair density, against both reference routes."""
    path, _, _ = gcmc_traj(tmp_path)
    _, got = analyze.rdf(path, "H2G", "H2G", rmax=6.0, nbins=48,
                         device=CPU)
    want = ref.rdf_python(frames_of(path), "H2G", "H2G", rmax=6.0,
                          nbins=48)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if has_native:
        np.testing.assert_allclose(
            got, ref_native.traj_rdf(path, "H2G", "H2G", rmax=6.0,
                                     nbins=48), rtol=1e-12, atol=1e-12)


def test_density_matches_reference(tmp_path):
    path, box, frames_in = triclinic_traj(tmp_path)
    dims = (9, 8, 7)
    grid, nf, near = analyze.density_grid(path, "AR", "M", dims, box=box,
                                          device=CPU)
    grid_p, nf_p = ref.density_python(frames_of(path), "AR", "M", dims,
                                      box=box)
    assert nf == nf_p == len(frames_in) and near == 0
    np.testing.assert_array_equal(grid, grid_p)
    assert grid.sum() == 40 * len(frames_in)
    if has_native:
        grid_n, _ = ref_native.traj_density(path, "AR", "M", dims, box=box)
        np.testing.assert_array_equal(grid, grid_n)


def test_density_multisite_com_binning(tmp_path):
    """A 2-site molecule straddling the boundary bins at its unwrapped
    COM (x = 9.9 -> bin 9), not at the in-cell mass mean (bin 7); and a
    3-site rigid molecule grid equals the reference's."""
    box = np.eye(3) * 10.0
    atoms = [atom(1, "A", "D2", 1, "M", [9.8, 5.2, 5.2], mass=3.0),
             atom(2, "B", "D2", 1, "M", [0.2, 5.2, 5.2], mass=1.0)]
    path = tmp_path / "d.pqr"
    write_traj(path, [atoms], box)
    grid, nf, _ = analyze.density_grid(str(path), "D2", "M", (10, 10, 10),
                                       box=box, device=CPU)
    assert nf == 1
    assert grid[9, 5, 5] == 1.0 and grid.sum() == 1.0
    gpath, _, _ = gcmc_traj(tmp_path)
    got, _, _ = analyze.density_grid(gpath, "H2", "M", (11, 10, 9),
                                     device=CPU)
    want, _ = ref.density_python(frames_of(gpath), "H2", "M", (11, 10, 9))
    np.testing.assert_array_equal(got, want)


def test_rdf_and_density_main(tmp_path):
    """The port's main writes the reference's rdf CSV and .dx grid."""
    path, _, _ = triclinic_traj(tmp_path)
    out_csv = tmp_path / "rdf.csv"
    assert analyze.main(["rdf", path, "--a", "AR", "--b", "AR", "--rmax",
                         "5", "--bins", "40", "--out", str(out_csv),
                         "--cpu"]) == 0
    rows = out_csv.read_text().strip().splitlines()
    assert rows[0] == "r,g" and len(rows) == 41
    out_dx = tmp_path / "dens.dx"
    assert analyze.main(["density", path, "--mol", "AR", "--resolution",
                         "1.5", "--out", str(out_dx), "--cpu"]) == 0
    assert read_dx(str(out_dx)).sum() == pytest.approx(40.0)


def test_rdf_matches_native_route(tmp_path):
    """The reference's default (native) rdf route equals the port's."""
    path, _, _ = triclinic_traj(tmp_path)
    _, g1 = ref.rdf(path, "AR", "AR", rmax=5.0, nbins=50,
                    use_native=has_native)
    _, g2 = analyze.rdf(path, "AR", "AR", rmax=5.0, nbins=50, device=CPU)
    np.testing.assert_allclose(g1, g2, atol=1e-12)


def test_msd_drifting_particle_analytic(tmp_path):
    """A particle moving v per frame across the boundary: msd[t] = |v t|²
    (wrong unwrapping would fold it back)."""
    path, box, _ = drift_traj(tmp_path)
    m, c = analyze.msd(path, mol_name="AR", box=box, device=CPU)
    for t in range(1, 6):
        assert m[t] == pytest.approx((0.9 * t) ** 2, rel=1e-9), t
        assert c[t] == 6 - t


def test_msd_segments_close_on_disappearance(tmp_path):
    """The vanishing HE (frames 0-2) and the late one (4-5) are separate
    stationary segments."""
    path, box, _ = drift_traj(tmp_path)
    m, c = analyze.msd(path, mol_name="HE", box=box, device=CPU)
    assert m[1] == pytest.approx(0.0, abs=1e-12)
    assert c[1] == 2 + 1
    assert c[2] == 1
    assert c[3] == 0


@pytest.mark.parametrize("which", ["triclinic", "gcmc"])
def test_msd_matches_reference(tmp_path, which):
    if which == "triclinic":
        path, box, _ = triclinic_traj(tmp_path)
        mol = "AR"
    else:
        path, box, _ = gcmc_traj(tmp_path)
        mol = "H2"
    m, c = analyze.msd(path, mol, "M", box=box, device=CPU)
    mp, cp = ref.msd_python(frames_of(path), mol, "M", box=box)
    np.testing.assert_allclose(m, mp, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(c, cp)
    if has_native:
        mn, cn = ref_native.traj_msd(path, mol, "M", box=box)
        np.testing.assert_allclose(m, mn, rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(c, cn)


def test_loading_series(tmp_path):
    path, _, _ = drift_traj(tmp_path)
    counts = analyze.loading(path, mol_name="HE", device=CPU)
    np.testing.assert_array_equal(counts, [1, 1, 1, 0, 1, 1])
    np.testing.assert_array_equal(
        counts, ref.loading_python(frames_of(path), "HE", "M"))
    path2, _, _ = triclinic_traj(tmp_path)
    np.testing.assert_array_equal(
        analyze.loading(path2, mol_name="AR", device=CPU), [40] * 4)
    gpath, _, _ = gcmc_traj(tmp_path)
    got = analyze.loading(gpath, "H2", "M", device=CPU)
    np.testing.assert_array_equal(
        got, ref.loading_python(frames_of(gpath), "H2", "M"))
    if has_native:
        np.testing.assert_array_equal(
            got, ref_native.traj_loading(gpath, "H2", "M"))


def test_msd_cli(tmp_path, capsys):
    path, _, _ = drift_traj(tmp_path)
    analyze.main(["msd", path, "--mol", "AR", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "lag,msd,samples" and len(lines) == 7
    analyze.main(["loading", path, "--mol", "HE", "--cpu"])
    assert capsys.readouterr().out.strip().splitlines()[0] == "frame,n"


def test_orient_rotating_dimer_analytic(tmp_path):
    """A dimer rotating th per frame: C1(t) = cos(t th), C2(t) =
    P2(cos(t th)); the static dimer of frames 0-2 adds to lags 0-2."""
    dth = 2 * np.pi / 12
    path, _, _ = dimer_traj(tmp_path, n_frames=12, dtheta=dth)
    c1, c2, cnt = analyze.orientation(path, mol_name="H2", max_lag=8,
                                      device=CPU)
    for t in range(3, 9):
        assert c1[t] == pytest.approx(np.cos(t * dth), abs=1e-4), t
        p2 = 1.5 * np.cos(t * dth) ** 2 - 0.5
        assert c2[t] == pytest.approx(p2, abs=1e-4), t
        assert cnt[t] == 12 - t
    assert c1[0] == pytest.approx(1.0) and c2[0] == pytest.approx(1.0)
    assert cnt[0] == 12 + 3
    expect1 = (11 * np.cos(dth) + 2 * 1.0) / 13
    assert c1[1] == pytest.approx(expect1, abs=1e-4)


@pytest.mark.parametrize("which", ["dimer", "gcmc"])
def test_orient_matches_reference(tmp_path, which):
    if which == "dimer":
        path, _, _ = dimer_traj(tmp_path)
        axis = "*"
    else:
        path, _, _ = gcmc_traj(tmp_path)
        axis = "H2E"
    got = analyze.orientation(path, "H2", "M", axis, max_lag=9, device=CPU)
    want = ref.orient_python(frames_of(path), "H2", "M", axis, max_lag=9)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2][0] > 0
    if has_native:
        cn = ref_native.traj_orient(path, "H2", "M", axis, max_lag=9)
        np.testing.assert_allclose(got[0], cn[0], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(got[2], cn[2])


def test_orient_axis_name_selection(tmp_path):
    """The axis ignores sites whose name does not match (a COM ghost
    first)."""
    box = np.eye(3) * 10.0
    atoms = [atom(1, "COM", "N2", 1, "M", [5.0, 5.0, 5.0], mass=0.0),
             atom(2, "N", "N2", 1, "M", [5.0, 5.0, 4.45]),
             atom(3, "N", "N2", 1, "M", [5.0, 5.0, 5.55])]
    path = tmp_path / "n2.pqr"
    write_traj(path, [atoms, atoms], box)
    c1, _, cnt = analyze.orientation(str(path), mol_name="N2",
                                     axis_name="N", device=CPU)
    assert cnt[1] == 1 and c1[1] == pytest.approx(1.0)
    want = ref.orient_python(frames_of(str(path)), "N2", "M", "N")
    np.testing.assert_allclose(c1, want[0], atol=1e-12)


def test_sq_two_atom_analytic(tmp_path):
    """Two atoms at d (a bin centre): S(q) = 1 + sin(qd)/(qd)."""
    dr = 0.005
    d = (600 + 0.5) * dr
    box = np.eye(3) * 25.0
    atoms = [atom(1, "AR", "AR", 1, "M", [5.0, 5.0, 5.0]),
             atom(2, "AR", "AR", 2, "M", [5.0 + d, 5.0, 5.0])]
    path = tmp_path / "two.pqr"
    write_traj(path, [atoms], box)
    q = np.linspace(0.3, 12.0, 40)
    s, nf = analyze.sq(str(path), q, name="AR", dr_bin=dr, device=CPU)
    assert nf == 1
    np.testing.assert_allclose(s, 1.0 + np.sin(q * d) / (q * d), atol=1e-9)


@pytest.mark.parametrize("which", ["triclinic", "gcmc"])
def test_sq_matches_reference(tmp_path, which):
    path, _, frames = (triclinic_traj(tmp_path) if which == "triclinic"
                       else gcmc_traj(tmp_path))
    q = np.linspace(0.5, 10.0, 25)
    s, nf = analyze.sq(path, q, "*", "M", dr_bin=0.01, device=CPU)
    sp, nfp = ref.sq_python(frames_of(path), q, "*", "M", dr_bin=0.01)
    assert nf == nfp == len(frames)
    np.testing.assert_allclose(s, sp, rtol=1e-10, atol=1e-10)
    if has_native:
        sn, _ = ref_native.traj_sq(path, q, "*", "M", dr_bin=0.01)
        np.testing.assert_allclose(s, sn, rtol=1e-10, atol=1e-10)
    _, total, _, near = analyze.sq_hist(path, "*", "M", dr_bin=0.01,
                                        device=CPU)
    n = 52 if which == "triclinic" else None
    if n:
        assert total.sum() == len(frames) * n * (n - 1) // 2
    assert near == 0


def test_sq_rejects_nonpositive_q(tmp_path):
    path, _, _ = triclinic_traj(tmp_path, n_frames=1)
    with pytest.raises(ValueError):
        analyze.sq(path, [0.0, 1.0], device=CPU)


def test_cluster_analytic_pbc(tmp_path):
    path = cluster_frame(tmp_path)
    series, hist = analyze.cluster(path, "HE", "M", rc=2.0, max_size=8,
                                   device=CPU)
    assert series.shape == (1, 3)
    n_cl, mean_sz, frac = series[0]
    assert n_cl == 2 and mean_sz == pytest.approx(2.0)
    assert frac == pytest.approx(3.0 / 4.0)
    assert hist[0] == 1 and hist[2] == 1 and hist.sum() == 2
    series, _ = analyze.cluster(path, "HE", "M", rc=0.5, max_size=8,
                                device=CPU)
    assert series[0][0] == 4 and series[0][2] == pytest.approx(0.25)


@pytest.mark.parametrize("rc", [2.5, 5.0])
def test_cluster_matches_reference(tmp_path, rc):
    path, _, _ = triclinic_traj(tmp_path)
    s, h = analyze.cluster(path, "*", "M", rc=rc, max_size=16, device=CPU)
    s_py, h_py = ref.cluster_python(frames_of(path), "*", "M", rc=rc,
                                    max_size=16)
    np.testing.assert_allclose(s, s_py, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(h, h_py)
    if has_native:
        s_n, h_n = ref_native.traj_cluster(path, "*", "M", rc=rc,
                                           max_size=16)
        np.testing.assert_allclose(s, s_n, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(h, h_n)
    gpath, _, _ = gcmc_traj(tmp_path)
    s, h = analyze.cluster(gpath, "H2", "M", rc=rc, max_size=16,
                           device=CPU)
    s_py, h_py = ref.cluster_python(frames_of(gpath), "H2", "M", rc=rc,
                                    max_size=16)
    np.testing.assert_allclose(s, s_py, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(h, h_py)


def test_cluster_cli(tmp_path, capsys):
    path = cluster_frame(tmp_path)
    out_csv = tmp_path / "clu.csv"
    assert analyze.main(["cluster", path, "--mol", "HE", "--rc", "2.0",
                         "--max-size", "8", "--out", str(out_csv),
                         "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "pooled cluster-size histogram" in text
    assert "<largest fraction>: 0.75" in text
    rows = out_csv.read_text().splitlines()
    assert rows[0] == "frame,n_clusters,mean_size,largest_fraction"
    assert rows[1].startswith("0,2,2,0.75")
