"""The port's isotherm campaigns (mpmc_tpu_torch/campaign.py), on the CPU,
at a smaller scale than the reference's tests/test_campaign.py (fewer
chains, steps and pressures): the ideal-gas isotherm, the SEM target
setting a point's length, a restart that skips finished points and gives
the rows of an uninterrupted campaign (through the CLI's main), write_csv
and its mixed-row header, mixture selectivities, the sample streams read
by the reference's analyze.gcmc_mbar, and manifests read across the two
packages."""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze  # noqa: E402
from mpmc_tpu import campaign as jcampaign  # noqa: E402
from mpmc_tpu_torch import campaign  # noqa: E402
from mpmc_tpu_torch.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402

torch.set_num_threads(1)

L = 40.0          # box edge [A]: <N> = f V / kT = 4.7 per atm at 100 K
HE = "ATOM 1 He HE 1 M 5.0 5.0 5.0 4.0026 0.0 0.0 0.0 0.0\n"
NE = "ATOM 2 Ne NE 2 M 15.0 15.0 15.0 20.18 0.0 0.0 0.0 0.0\n"


def _deck(tmp_path, atoms=HE, corrtime=100, max_molecules=64):
    p = tmp_path / "gas.pqr"
    p.write_text(atoms + "END\n")
    text = (f"ensemble uvt\nnumsteps 400\ncorrtime {corrtime}\n"
            "temperature 100\npressure 1.0\n"
            f"basis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
            "cutoff 8.0\ncoulomb off\nrd_lrc off\ninsert_probability 0.6\n"
            f"max_molecules {max_molecules}\npqr_input {p}\n")
    (tmp_path / "gas.inp").write_text(text)
    return input_script.parse(text)


def _ideal_n(f_atm):
    return f_atm * ATM2K_A3 * L ** 3 / 100.0


def _tol(expect, sem, blocks):
    """4 standard errors of a point's <N>: the chain spread's, or — the
    chains share the move-type schedule, which drives an ideal gas's N
    in all of them alike, so the independent samples are nearer the
    block count than blocks x chains — the Poisson sigma sqrt(<N>) over
    the sampled blocks, whichever is larger."""
    return 4 * max(sem, np.sqrt(expect / blocks))


def test_ideal_gas_isotherm_is_linear(tmp_path):
    log = io.StringIO()
    rows = campaign.run_isotherm(
        _deck(tmp_path, corrtime=50), pressures=[1.0, 3.0], chains=2,
        target_rel_sem=0.05, min_steps=1000, max_steps=1000,
        equil_blocks=2, log=log, device="cpu")
    assert len(rows) == 2
    for r in rows:
        # ideal gas: <N> = f V / k T
        expect = _ideal_n(r.fugacity_atm)
        assert r.n_mean == pytest.approx(
            expect, abs=_tol(expect, r.n_sem, 1000 // 50 - 2)), r
    assert rows[0].n_mean < rows[1].n_mean
    assert log.getvalue().count("point done:") == 2


def test_uncertainty_target_controls_length(tmp_path):
    job = _deck(tmp_path)
    loose = campaign.run_isotherm(
        job, pressures=[1.0], chains=2, target_rel_sem=0.5, min_steps=200,
        max_steps=2000, equil_blocks=1, device="cpu")
    tight = campaign.run_isotherm(
        job, pressures=[1.0], chains=2, target_rel_sem=1e-6, min_steps=200,
        max_steps=500, equil_blocks=1, device="cpu")
    assert loose[0].steps < tight[0].steps
    assert tight[0].steps == 500             # hit the cap


def test_restart_gives_the_uninterrupted_rows(tmp_path):
    """Two points with a checkpoint directory, then the same campaign with
    a third pressure: the finished points come back verbatim from the
    manifest, only the new one runs, and all three rows equal an
    uninterrupted campaign's (python -m mpmc_tpu_torch.campaign's main),
    bit for bit; the manifest reads back through the reference's
    PointResult.from_row."""
    job = _deck(tmp_path)
    ck = str(tmp_path / "ckpt")
    kw = dict(chains=3, target_rel_sem=0.5, min_steps=200, max_steps=200,
              equil_blocks=1, checkpoint_dir=ck, device="cpu")
    first = campaign.run_isotherm(job, pressures=[0.5, 1.0], **kw)
    assert len(first) == 2
    log = io.StringIO()
    resumed = campaign.run_isotherm(job, pressures=[0.5, 1.0, 2.0],
                                    log=log, **kw)
    assert "resuming: 2 points done" in log.getvalue()
    assert log.getvalue().count("point done:") == 1
    for a, b in zip(resumed[:2], first):
        np.testing.assert_equal(a.row(), b.row())
    whole = campaign.main([
        str(tmp_path / "gas.inp"), "--pressures", "0.5", "1", "2",
        "--chains", "3", "--target-rel-sem", "0.5", "--min-steps", "200",
        "--max-steps", "200", "--equil-blocks", "1", "--cpu", "-o",
        str(tmp_path / "iso.csv")])
    np.testing.assert_equal([r.row() for r in resumed],
                            [r.row() for r in whole])
    with open(f"{ck}/manifest.json") as f:
        rows = json.load(f)["rows"]
    back = [jcampaign.PointResult.from_row(r) for r in rows]
    np.testing.assert_equal([b.row() for b in back],
                            [r.row() for r in resumed])
    assert (tmp_path / "iso.csv").read_text().startswith("pressure_atm,")


def test_write_csv(tmp_path):
    r = campaign.PointResult(1.0, 1.0, 5.0, 0.1, 0.5, 4.0, 1000)
    out = tmp_path / "iso.csv"
    campaign.write_csv([r], str(out))
    text = out.read_text()
    assert "pressure_atm" in text and "qst_kj_mol" in text


def test_write_csv_mixed_rows_union_header(tmp_path):
    """Rows with and without per-species keys: the header is the union and
    the missing cells are blank."""
    r_old = campaign.PointResult(1.0, 1.0, 5.0, 0.1, 0.5, 4.0, 1000)
    r_new = campaign.PointResult(2.0, 2.0, 8.0, 0.1, 0.7, 4.0, 1000,
                                 extra={"n_HE": 5.0, "n_NE": 3.0,
                                        "S_HE_NE": 1.1})
    out = tmp_path / "mixed.csv"
    campaign.write_csv([r_old, r_new], str(out))
    lines = out.read_text().strip().splitlines()
    assert "S_HE_NE" in lines[0]
    assert lines[1].endswith(",,,")
    assert lines[2].split(",")[-1] == "1.1"


def test_mixture_campaign_per_species_and_selectivity(tmp_path):
    """Two ideal-gas sorbates at equal fugacity: each loads to f V / kT
    and the adsorption selectivity is 1 in expectation."""
    rows = campaign.run_isotherm(
        _deck(tmp_path, HE + NE), pressures=[2.0], chains=4,
        target_rel_sem=0.05, min_steps=600, max_steps=600, equil_blocks=1,
        device="cpu")
    r = rows[0]
    ex = r.extra
    assert set(ex) == {"n_HE", "n_HE_sem", "f_HE", "n_NE", "n_NE_sem",
                       "f_NE", "S_HE_NE"}
    expect = _ideal_n(r.pressure_atm)
    for nm in ("HE", "NE"):
        assert ex[f"f_{nm}"] == pytest.approx(r.pressure_atm)
        assert ex[f"n_{nm}"] == pytest.approx(
            expect, abs=_tol(expect, ex[f"n_{nm}_sem"], 600 // 100 - 1)
        ), (nm, r)
    assert ex["n_HE"] + ex["n_NE"] == pytest.approx(r.n_mean, rel=1e-9)
    rel = np.sqrt((ex["n_HE_sem"] / ex["n_HE"]) ** 2
                  + (ex["n_NE_sem"] / ex["n_NE"]) ** 2)
    assert ex["S_HE_NE"] == pytest.approx(1.0, abs=4 * rel)
    out = tmp_path / "mix.csv"
    campaign.write_csv(rows, str(out))
    header = out.read_text().splitlines()[0]
    assert "S_HE_NE" in header and "n_HE" in header
    assert campaign.PointResult.from_row(r.row()) == r


def test_samples_feed_the_reference_gcmc_mbar(tmp_path):
    """The port's point_NNN.jsonl streams are read by the reference's
    analyze.gcmc_mbar: the reweighted ideal-gas isotherm follows
    <N> = f V / kT (rtol 0.3, the reference test's bound for shared
    move-type schedules) and is monotone, with Poisson-like var(N)."""
    sdir = tmp_path / "samples"
    campaign.run_isotherm(
        _deck(tmp_path, corrtime=25), pressures=[2.0, 6.0], chains=2,
        target_rel_sem=0.03, min_steps=1000, max_steps=1000,
        equil_blocks=4, samples_dir=str(sdir), device="cpu")
    files = sorted(str(p) for p in sdir.glob("point_*.jsonl"))
    assert len(files) == 2
    res = analyze.gcmc_mbar(files, n_f=5)
    assert res["converged"]
    np.testing.assert_allclose(res["n_mean"], _ideal_n(res["f_grid"]),
                               rtol=0.3)
    assert np.all(np.diff(res["n_mean"]) > 0)
    ratio = res["var_n"] / res["n_mean"]
    assert np.all(ratio > 0.4) and np.all(ratio < 1.8)


def test_manifest_rows_read_across_the_packages():
    """A row written by either package reads back through the other's
    PointResult.from_row (plain and mixture rows, through JSON)."""
    plain = dict(pressure_atm=1.0, fugacity_atm=0.98, n_mean=5.5,
                 n_sem=0.25, wt_pct=1.5, qst_kj_mol=4.75, steps=1200)
    extra = {"n_HE": 3.0, "n_HE_sem": 0.5, "f_HE": 1.0, "S_HE_NE": 1.25}
    for ex in ({}, extra):
        t = campaign.PointResult(**plain, extra=dict(ex))
        j = jcampaign.PointResult(**plain, extra=dict(ex))
        assert json.loads(json.dumps(t.row())) == j.row()
        assert jcampaign.PointResult.from_row(
            json.loads(json.dumps(t.row()))) == j
        assert campaign.PointResult.from_row(
            json.loads(json.dumps(j.row()))) == t
