"""The port's Widom insertion analyzers (mpmc_tpu_torch/analyze.py:
widom, widom_mol, template_sites, _widom_post) on the CPU against the
reference's numpy twins and native library at shared trial points, and
against the reference's numpy route at the same seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as ref  # noqa: E402
from mpmc_tpu.io import native as ref_native  # noqa: E402
from mpmc_tpu.io import pqr as ref_pqr  # noqa: E402
from mpmc_tpu_torch import analyze  # noqa: E402
from mpmc_tpu_torch.constants import ATM2K_A3, KE  # noqa: E402
from mpmc_tpu_torch.io import pqr  # noqa: E402
from torch_analyze import (atom, charged_traj, gcmc_traj,  # noqa: E402
                           h2_template, posquat, triclinic_traj,
                           write_traj)

torch.set_num_threads(1)
CPU = "cpu"
has_native = ref_native.available()


def test_widom_matches_reference(tmp_path):
    """Shared fractional points: the port equals the numpy twin and the
    native kernel to rounding."""
    path, _, frames = triclinic_traj(tmp_path)
    fp = np.random.default_rng(5).uniform(0, 1, (64, 3))
    e, ue, nf = analyze.widom_means(path, 30.0, 3.1, 120.0, fp, rc=5.5,
                                    device=CPU)
    ep, uep, npf = ref.widom_python(ref_pqr.read_frames(path), 30.0, 3.1,
                                    120.0, fp, rc=5.5)
    assert nf == npf == len(frames)
    assert e == pytest.approx(ep, rel=1e-12)
    assert ue == pytest.approx(uep, rel=1e-12)
    assert 0.0 < e < 1.5 and ue != 0.0
    if has_native:
        en, uen, _ = ref_native.traj_widom(path, eps=30.0, sig=3.1,
                                           temperature=120.0, n_try=64,
                                           frac_pos=fp, rc=5.5)
        assert e == pytest.approx(en, rel=1e-12)
        assert ue == pytest.approx(uen, rel=1e-12)


def test_widom_empty_framework_is_ideal(tmp_path):
    """No LJ sites: U = 0 everywhere, <exp(-bU)> = 1, and K_H is the
    ideal-gas V / (kT m)."""
    box = np.eye(3) * 12.0
    atoms = [pqr.PqrAtom(serial=1, name="X", mol_name="MOF", mol_id=1,
                         flag="F", xyz=np.array([6.0, 6.0, 6.0]),
                         mass=10.0, charge=0.0, polar=0.0, eps=0.0,
                         sig=0.0)]
    path = tmp_path / "empty.pqr"
    write_traj(path, [atoms], box)
    res = analyze.widom(str(path), eps=30.0, sig=3.0, temperature=100.0,
                        n_try=16, device=CPU)
    assert res["boltzmann"] == pytest.approx(1.0)
    assert res["u0"] == pytest.approx(0.0, abs=1e-12)
    kh_ideal = 1e3 * ATM2K_A3 * 12.0 ** 3 / (100.0 * 10.0)
    assert res["kh_mol_kg_atm"] == pytest.approx(kh_ideal, rel=1e-12)


def test_widom_seeded_equals_numpy_route(tmp_path):
    """With a seed, the port's dict is the reference's numpy route's
    (use_native=False) at the same seed."""
    path, _, _ = gcmc_traj(tmp_path)
    got = analyze.widom(path, 30.0, 3.1, 77.0, n_try=200, seed=7, rc=6.0,
                        device=CPU)
    want = ref.widom(path, 30.0, 3.1, 77.0, n_try=200, seed=7, rc=6.0,
                     use_native=False)
    assert got["n_frames"] == want["n_frames"]
    for k in ("boltzmann", "mu_ex", "u0", "kh_mol_kg_atm"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_widom_cli(tmp_path, capsys):
    path, _, _ = triclinic_traj(tmp_path)
    analyze.main(["widom", path, "--eps", "30", "--sig", "3.1", "-T",
                  "120", "--tries", "32", "--rc", "5.0", "--cpu"])
    out = capsys.readouterr().out
    assert "K_H (mol/kg/atm)" in out and "mu_excess" in out


def test_widom_mol_single_site_reduces_to_widom(tmp_path):
    """A 1-site uncharged template at the origin reproduces the
    single-site result (the rotation acts trivially)."""
    path, _, _ = triclinic_traj(tmp_path)
    pq = posquat(48)
    e, ue, nf = analyze.widom_means(path, 30.0, 3.1, 120.0, pq[:, :3],
                                    rc=5.5, device=CPU)
    em, uem, nfm = analyze.widom_mol_means(
        path, [[0.0, 0.0, 0.0]], [30.0], [3.1], [0.0], 120.0, pq, rc=5.5,
        device=CPU)
    assert nf == nfm
    assert em == pytest.approx(e, rel=1e-12)
    assert uem == pytest.approx(ue, rel=1e-12)


@pytest.mark.parametrize("which", ["charged", "gcmc"])
def test_widom_mol_matches_reference(tmp_path, which):
    """Shared (position, quaternion) trials on a charged 3-site template:
    the port equals the numpy twin and the native kernel."""
    path = (charged_traj(tmp_path)[0] if which == "charged"
            else gcmc_traj(tmp_path)[0])
    pq = posquat(32, seed=7)
    sx = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -0.74], [0.0, 0.0, 0.74]])
    se = np.array([34.2, 0.0, 0.0])
    ss = np.array([3.0, 0.0, 0.0])
    sq2 = np.array([-0.84, 0.42, 0.42])
    e, ue, nf = analyze.widom_mol_means(path, sx, se, ss, sq2, 150.0, pq,
                                        rc=5.9, device=CPU)
    ep, uep, nfp = ref.widom_mol_python(ref_pqr.read_frames(path), sx, se,
                                        ss, sq2, 150.0, pq, rc=5.9)
    assert nf == nfp
    assert e == pytest.approx(ep, rel=1e-12)
    assert ue == pytest.approx(uep, rel=1e-12)
    assert ue != 0.0
    if has_native:
        en, uen, _ = ref_native.traj_widom_mol(path, sx, se, ss, sq2, 150.0,
                                               n_try=32, posquat=pq, rc=5.9)
        assert e == pytest.approx(en, rel=1e-12)
        assert ue == pytest.approx(uen, rel=1e-12)


def test_widom_mol_charged_analytic(tmp_path):
    """One framework charge Q and a ghost of charge q at r = 3 with no
    LJ: U = KE q Q / r."""
    box = np.eye(3) * 20.0
    a = atom(1, "Q", "ION", 1, "F", [10.0, 10.0, 10.0], mass=10.0)
    a.charge = 0.5
    a.eps = 0.0
    path = tmp_path / "ion.pqr"
    write_traj(path, [[a]], box)
    pq = np.array([[13.0 / 20.0, 0.5, 0.5, 1.0, 0.0, 0.0, 0.0]])
    u_expect = KE * (-0.2) * 0.5 / 3.0
    e, ue, _ = analyze.widom_mol_means(str(path), [[0.0, 0.0, 0.0]], [0.0],
                                       [0.0], [-0.2], 100.0, pq, rc=8.0,
                                       device=CPU)
    w = np.exp(-u_expect / 100.0)
    assert e == pytest.approx(w, rel=1e-9)
    assert ue == pytest.approx(u_expect * w, rel=1e-9)
    ep, uep, _ = ref.widom_mol_python(
        ref_pqr.read_frames(str(path)), [[0.0, 0.0, 0.0]], [0.0], [0.0],
        [-0.2], 100.0, pq, rc=8.0)
    assert e == pytest.approx(ep, rel=1e-12)
    assert ue == pytest.approx(uep, rel=1e-12)


def test_widom_mol_seeded_equals_numpy_route(tmp_path):
    """template_sites and the seeded trials: the port's widom_mol equals
    the reference's numpy route at the same seed."""
    path, _ = charged_traj(tmp_path)
    tpl = h2_template(tmp_path)
    for t, r in zip(analyze.template_sites(tpl), ref.template_sites(tpl)):
        np.testing.assert_array_equal(t, r)
    got = analyze.widom_mol(path, tpl, 77.0, n_try=64, seed=3, rc=6.0,
                            device=CPU)
    want = ref.widom_mol(path, tpl, 77.0, n_try=64, seed=3, rc=6.0,
                         use_native=False)
    for k in ("boltzmann", "mu_ex", "u0", "kh_mol_kg_atm"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_widom_mol_cli(tmp_path, capsys):
    path, _ = charged_traj(tmp_path)
    tpl = h2_template(tmp_path)
    assert analyze.main(["widom", path, "--insert-pqr", tpl, "-T", "77",
                         "--tries", "16", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "mu_excess" in out and "K_H" in out
    with pytest.raises(SystemExit):
        analyze.main(["widom", path, "-T", "77", "--cpu"])
