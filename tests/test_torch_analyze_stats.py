"""The port's host statistics (mpmc_tpu_torch/analyze.py: blocking, qst,
qst_clausius_clapeyron, isotherm_fit, iast_binary and the MBAR family)
against the reference's on the same inputs, the analytic cases of the
reference's tests/test_analyze.py, and the port's campaign point streams
through its own gcmc_mbar (the reference's
tests/test_campaign.py::test_campaign_samples_feed_gcmc_mbar)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as ref  # noqa: E402
from mpmc_tpu_torch import analyze, campaign  # noqa: E402
from mpmc_tpu_torch.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from torch_analyze import dimer_traj, gc_jsonl, pt_ladder_jsonl  # noqa: E402

torch.set_num_threads(1)


def _same(got, want, rtol=1e-12):
    """Recursive equality of result dicts / tuples / arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)) and not np.isscalar(want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol)
    elif isinstance(want, (str, bool)) or want is None:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _ar1(n=1 << 15, phi=0.9, seed=12):
    rng = np.random.default_rng(seed)
    x = np.empty(n)
    x[0] = rng.standard_normal()
    eps = rng.standard_normal(n)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + eps[i]
    return x


def test_blocking_ar1_statistical_inefficiency():
    """An AR(1) series: tau = (1+phi)/(1-phi) at the plateau, ~1 for
    white noise; equal to the reference's."""
    x = _ar1()
    out = analyze.blocking(x)
    assert out[3] == pytest.approx(19.0, rel=0.3)
    _same(out, ref.blocking(x))
    rng = np.random.default_rng(12)
    _, _, _, tau_iid = analyze.blocking(rng.standard_normal(4096))
    assert tau_iid == pytest.approx(1.0, abs=0.35)


def test_blocking_cli_csv_and_jsonl(tmp_path, capsys):
    csv = tmp_path / "energy.csv"
    csv.write_text("step,energy_total\n" + "\n".join(
        f"{i},{np.sin(i)}" for i in range(64)) + "\n")
    analyze.main(["blocking", str(csv), "--column", "energy_total"])
    out = capsys.readouterr().out
    assert out.startswith("block_size,sem,sem_err") and "tau_int" in out
    ref.main(["blocking", str(csv), "--column", "energy_total"])
    assert capsys.readouterr().out == out
    jl = tmp_path / "obs.jsonl"
    jl.write_text("\n".join(json.dumps({"step": i, "N": float(i % 5)})
                            for i in range(64)) + "\n")
    analyze.main(["blocking", str(jl), "--column", "N"])
    assert "tau_int" in capsys.readouterr().out


def test_qst_fluctuation_recovery():
    """U = u0 N + noise: Qst -> T - u0 within the jackknife error; equal
    to the reference's; var(N) = 0 refused."""
    rng = np.random.default_rng(7)
    t, u0, n_s = 77.0, -900.0, 1 << 13
    n = rng.poisson(25.0, n_s).astype(float)
    u = u0 * n + rng.standard_normal(n_s) * 40.0
    res = analyze.qst(n, u, temperature=t)
    assert res["qst"] == pytest.approx(t - u0, rel=0.01)
    assert abs(res["qst"] - (t - u0)) < 5 * res["qst_sem"]
    assert res["n_mean"] == pytest.approx(25.0, rel=0.02)
    _same(res, ref.qst(n, u, temperature=t))
    with pytest.raises(ValueError):
        analyze.qst(np.full(64, 3.0), np.arange(64.0), 77.0)


@pytest.mark.parametrize("model,params", [
    ("langmuir", {"qm": 12.0, "k": 0.8}),
    ("toth", {"qm": 9.0, "k": 1.4, "t": 0.62}),
    ("dsl", {"qm1": 6.0, "k1": 4.0, "qm2": 10.0, "k2": 0.05}),
])
def test_isofit_parameter_recovery(model, params):
    p = np.geomspace(0.01, 60.0, 24)
    names, fn = analyze._ISO_MODELS[model]
    y = fn(p, *[params[k] for k in names])
    res = analyze.isotherm_fit(p, y, model=model)
    assert res["rmse"] < 1e-8 * y.max()
    for k in names:
        assert res["params"][k] == pytest.approx(params[k], rel=1e-4), k
    henry_true = {"langmuir": params.get("qm", 0) * params.get("k", 0),
                  "toth": params.get("qm", 0) * params.get("k", 0),
                  "dsl": params.get("qm1", 0) * params.get("k1", 0)
                  + params.get("qm2", 0) * params.get("k2", 0)}[model]
    assert res["henry"] == pytest.approx(henry_true, rel=1e-3)
    _same(res, ref.isotherm_fit(p, y, model=model))


def test_isofit_validates_inputs():
    with pytest.raises(ValueError):
        analyze.isotherm_fit([1.0, 2.0], [1.0, 2.0], model="bogus")
    with pytest.raises(ValueError):
        analyze.isotherm_fit([0.0, 2.0], [1.0, 2.0])
    with pytest.raises(ValueError):
        analyze.isotherm_fit([1.0, 2.0, 3.0], [1.0, 2.0, 2.5], model="dsl")


def test_new_cli_commands(tmp_path, capsys):
    """orient, sq, qst and isofit through the port's main."""
    path, _, _ = dimer_traj(tmp_path)
    out_csv = tmp_path / "c.csv"
    assert analyze.main(["orient", path, "--mol", "H2", "--max-lag", "6",
                         "--out", str(out_csv), "--cpu"]) == 0
    rows = out_csv.read_text().strip().splitlines()
    assert rows[0] == "lag,c1,c2,samples" and len(rows) == 8
    assert analyze.main(["sq", path, "--a", "H", "--qmin", "0.5", "--qmax",
                         "8", "--nq", "16", "--out", str(out_csv),
                         "--cpu"]) == 0
    rows = out_csv.read_text().strip().splitlines()
    assert rows[0] == "q,sq" and len(rows) == 17
    jl = tmp_path / "obs.jsonl"
    nn = np.random.default_rng(1).poisson(12.0, 512).astype(float)
    jl.write_text("\n".join(
        json.dumps({"step": i, "N": v, "energy_total": -500.0 * v})
        for i, v in enumerate(nn)) + "\n")
    assert analyze.main(["qst", str(jl), "-T", "77"]) == 0
    out = capsys.readouterr().out
    assert "Qst (K):" in out and "577" in out
    iso = tmp_path / "iso.csv"
    p = np.geomspace(0.1, 30, 12)
    iso.write_text("pressure_atm,n_mean,n_sem\n" + "\n".join(
        f"{pi},{8.0 * 0.5 * pi / (1 + 0.5 * pi)},0.05" for pi in p) + "\n")
    assert analyze.main(["isofit", str(iso), "--model", "langmuir",
                         "--sem-column", "n_sem"]) == 0
    out = capsys.readouterr().out
    assert "qm = 8" in out and "henry" in out


def test_qst_clausius_clapeyron_recovery(tmp_path, capsys):
    """Langmuir isotherms with K(T) = K0 exp(Qst/T): the CC construction
    recovers Qst at every loading, equal to the reference's."""
    qst_true, qm, k0 = 1100.0, 10.0, 2e-4
    t1, t2 = 77.0, 97.0

    def iso(t, p):
        k = k0 * np.exp(qst_true / t)
        return qm * k * p / (1 + k * p)

    p = np.geomspace(0.05, 80.0, 30)
    th, qk = analyze.qst_clausius_clapeyron(p, iso(t1, p), t1,
                                            p, iso(t2, p), t2)
    np.testing.assert_allclose(qk, qst_true, rtol=5e-3)
    _same((th, qk), ref.qst_clausius_clapeyron(p, iso(t1, p), t1,
                                               p, iso(t2, p), t2))
    for name, t in (("i1.csv", t1), ("i2.csv", t2)):
        (tmp_path / name).write_text("pressure_atm,n_mean\n" + "\n".join(
            f"{pi},{iso(t, pi)}" for pi in p) + "\n")
    assert analyze.main(["qst-cc", str(tmp_path / "i1.csv"),
                         str(tmp_path / "i2.csv"), "--t1", "77", "--t2",
                         "97"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("loading,qst_K,qst_kJ_mol")
    vals = [float(r.split(",")[1]) for r in out.strip().splitlines()[1:]]
    assert all(abs(v - qst_true) < 5.0 for v in vals)
    with pytest.raises(ValueError):
        analyze.qst_clausius_clapeyron(p, iso(t1, p), 77.0,
                                       p, iso(t1, p), 77.0)


def test_iast_extended_langmuir_anchor(tmp_path, capsys):
    """Two Langmuir isotherms of equal qm: IAST is the extended-Langmuir
    mixture isotherm, S12 = K1/K2."""
    qm, k1, k2 = 9.0, 1.3, 0.2
    f1 = {"model": "langmuir", "params": {"qm": qm, "k": k1}}
    f2 = {"model": "langmuir", "params": {"qm": qm, "k": k2}}
    y1, pt = 0.3, 5.0
    r = analyze.iast_binary(f1, f2, y1, pt)
    a = pt * (k1 * y1 + k2 * (1 - y1))
    assert r["x1"] == pytest.approx(k1 * y1 / (k1 * y1 + k2 * (1 - y1)),
                                    abs=1e-10)
    assert r["q1"] == pytest.approx(qm * k1 * y1 * pt / (1 + a), rel=1e-9)
    assert r["q2"] == pytest.approx(qm * k2 * (1 - y1) * pt / (1 + a),
                                    rel=1e-9)
    assert r["q_total"] == pytest.approx(qm * a / (1 + a), rel=1e-9)
    assert r["selectivity"] == pytest.approx(k1 / k2, rel=1e-9)
    _same(r, ref.iast_binary(f1, f2, y1, pt))
    p = np.geomspace(0.01, 50, 20)
    for name, k in (("a.csv", k1), ("b.csv", k2)):
        (tmp_path / name).write_text("pressure_atm,n_mean\n" + "\n".join(
            f"{pi},{qm * k * pi / (1 + k * pi)}" for pi in p) + "\n")
    assert analyze.main(["iast", str(tmp_path / "a.csv"),
                         str(tmp_path / "b.csv"), "--y1", "0.3",
                         "--pressures", "5.0"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "p_total,q1,q2,q_total,selectivity"
    got = [float(v) for v in out[1].split(",")]
    assert got[1] == pytest.approx(qm * k1 * y1 * pt / (1 + a), rel=1e-4)
    assert got[4] == pytest.approx(k1 / k2, rel=1e-4)


def test_iast_toth_numeric_spreading_pressure():
    """A Tóth component takes the numeric spreading-pressure integral."""
    f1 = {"model": "toth", "params": {"qm": 8.0, "k": 1.1, "t": 0.7}}
    f2 = {"model": "langmuir", "params": {"qm": 6.0, "k": 0.15}}
    r = analyze.iast_binary(f1, f2, 0.5, 2.0)
    assert 0 < r["x1"] < 1
    assert r["q1"] > 0 and r["q2"] > 0
    assert np.isfinite(r["q_total"])
    assert r["selectivity"] > 1.0
    _same(r, ref.iast_binary(f1, f2, 0.5, 2.0))
    with pytest.raises(ValueError):
        analyze.iast_binary(f1, f2, 1.5, 2.0)


def test_isofit_rejects_nonfinite_sem():
    p = np.geomspace(0.1, 10, 8)
    y = 5.0 * 0.5 * p / (1 + 0.5 * p)
    with pytest.raises(ValueError, match="sem"):
        analyze.isotherm_fit(p, y, sem=np.full_like(p, np.inf))
    with pytest.raises(ValueError, match="sem"):
        analyze.isotherm_fit(p, y, sem=np.zeros_like(p))


def test_qst_cli_reads_energy_output_csv(tmp_path, capsys):
    """The energy_output CSV's total / n_molecules columns serve qst."""
    nn = np.random.default_rng(3).poisson(10.0, 256).astype(float)
    csv = tmp_path / "energy.csv"
    csv.write_text(
        "step,rd,lrc,es_real,es_recip,es_self,es_excl,polar,vdw,"
        "total,n_molecules,volume\n" + "\n".join(
            f"{i},0,0,0,0,0,0,0,0,{-300.0 * v},{v},8000"
            for i, v in enumerate(nn)) + "\n")
    assert analyze.main(["qst", str(csv), "-T", "77", "--blocks", "8"]) == 0
    out = capsys.readouterr().out
    assert "Qst (K):" in out and "377" in out


def test_mbar_harmonic_ladder_analytic():
    """U = x²/2 sampled at each ladder state: f_i - f_0 = ln(beta_i /
    beta_0) / 2, and at an unsampled temperature <U> = T/2, Cv/kB = 1/2;
    equal to the reference's fit and reweight."""
    rng = np.random.default_rng(0)
    betas = np.array([1.25, 1.0, 0.8, 0.64])
    u_by = [0.5 * rng.normal(0.0, 1.0 / np.sqrt(b), 6000) ** 2
            for b in betas]
    fit = analyze.mbar_fit(betas, u_by)
    assert fit["converged"]
    np.testing.assert_allclose(fit["f"], 0.5 * np.log(betas / betas[0]),
                               atol=0.03)
    r = analyze.mbar_reweight(fit, 0.9)
    assert abs(r["u_mean"] - 1.0 / (2 * 0.9)) < 0.02
    assert abs(0.9 ** 2 * r["u_var"] - 0.5) < 0.05
    assert r["ess"] > 1000.0
    rfit = ref.mbar_fit(betas, u_by)
    _same(fit, rfit, rtol=1e-10)
    _same(r, ref.mbar_reweight(rfit, 0.9), rtol=1e-10)


def test_mbar_reweight_reproduces_sampled_state():
    rng = np.random.default_rng(4)
    betas = np.array([1.0, 0.5])
    u_by = [0.5 * rng.normal(0.0, 1.0 / np.sqrt(b), 8000) ** 2
            for b in betas]
    fit = analyze.mbar_fit(betas, u_by)
    for b, u in zip(betas, u_by):
        assert abs(analyze.mbar_reweight(fit, b)["u_mean"] - u.mean()) < 0.02


def test_mbar_validates_inputs():
    with pytest.raises(ValueError, match="lengths"):
        analyze.mbar_fit([1.0, 0.5], [np.ones(4)])
    with pytest.raises(ValueError, match="sample"):
        analyze.mbar_fit([1.0, 0.5], [np.ones(4), np.array([])])


def test_pt_mbar_cli(tmp_path, capsys):
    """Synthetic PT ladder records -> the mbar CLI: <U>(T) = T/2, N = 2;
    pt_mbar equals the reference's."""
    path = tmp_path / "obs.jsonl"
    pt_ladder_jsonl(path)
    out_csv = tmp_path / "mbar.csv"
    assert analyze.main(["mbar", str(path), "--nt", "9", "--out",
                         str(out_csv)]) == 0
    text = capsys.readouterr().out
    assert "ladder: 4 states" in text and "delta_f" in text
    rows = out_csv.read_text().splitlines()
    assert rows[0] == "T,u_mean,cv_kb,n_mean,ess" and len(rows) == 10
    t, u = np.array([[float(r.split(",")[0]), float(r.split(",")[1])]
                     for r in rows[1:]]).T
    np.testing.assert_allclose(u, t / 2.0, rtol=0.06)
    n_mean = np.array([float(r.split(",")[3]) for r in rows[1:]])
    np.testing.assert_allclose(n_mean, 2.0, atol=1e-9)
    _same(analyze.pt_mbar(str(path), n_t=9, skip=0.1),
          ref.pt_mbar(str(path), n_t=9, skip=0.1), rtol=1e-10)


def test_gcmc_mbar_lattice_gas_exact(tmp_path):
    """Grand-canonical MBAR over three states of the U = -eps N lattice
    gas: <N>(f) = c f exp(eps/T), Qst = (T + eps) R, Poisson var(N) =
    <N>, grand-potential differences; equal to the reference's."""
    T, eps = 77.0, 120.0
    fs = [0.05, 0.2, 0.8]
    paths, lams = [], {}
    for i, f in enumerate(fs):
        p = tmp_path / f"run{i}.jsonl"
        lams[f] = gc_jsonl(p, T, f, 4000, 100 + i, eps)
        paths.append(str(p))
    res = analyze.gcmc_mbar(paths, n_f=9)
    assert res["converged"] and res["temperature"] == T
    np.testing.assert_allclose(res["n_mean"],
                               5.0 * res["f_grid"] * np.exp(eps / T),
                               rtol=0.05)
    np.testing.assert_allclose(res["var_n"], res["n_mean"], rtol=0.12)
    np.testing.assert_allclose(res["qst_kj_mol"],
                               (T + eps) * 8.314462618e-3, rtol=1e-6)
    lam_k = np.array([lams[f] for f in fs])
    np.testing.assert_allclose(res["delta_f"], -(lam_k - lam_k[0]),
                               atol=0.35)
    np.testing.assert_allclose(res["n_species"]["H2"], res["n_mean"])
    _same(res, ref.gcmc_mbar(paths, n_f=9), rtol=1e-10)


def test_gcmc_mbar_validates_states(tmp_path):
    p1 = tmp_path / "a.jsonl"
    p2 = tmp_path / "b.jsonl"
    gc_jsonl(p1, 77.0, 0.1, 50, 1, 50.0)
    with pytest.raises(ValueError, match=">= 2 runs"):
        analyze.gcmc_mbar([str(p1)])
    gc_jsonl(p2, 90.0, 0.4, 50, 2, 50.0)
    with pytest.raises(ValueError, match="different temperatures"):
        analyze.gcmc_mbar([str(p1), str(p2)])
    p3 = tmp_path / "c.jsonl"
    p3.write_text('{"step": 1, "energy_total": 0.0, "N": 1.0}\n')
    with pytest.raises(ValueError, match="run_meta"):
        analyze.gcmc_mbar([str(p1), str(p3)])


def test_gcmc_mbar_cli(tmp_path, capsys):
    paths = []
    for i, f in enumerate([0.1, 0.4]):
        p = tmp_path / f"run{i}.jsonl"
        gc_jsonl(p, 77.0, f, 800, 7 + i, 80.0)
        paths.append(str(p))
    out_csv = tmp_path / "iso.csv"
    assert analyze.main(["gcmc-mbar", *paths, "--nf", "7", "--out",
                         str(out_csv)]) == 0
    text = capsys.readouterr().out
    assert "ladder: 2 states at T=77" in text and "delta_f" in text
    rows = out_csv.read_text().splitlines()
    assert rows[0] == "f_atm,n_mean,u_mean,var_n,qst_kJ_mol,ess,n_H2"
    assert len(rows) == 8
    fcol = np.array([float(r.split(",")[0]) for r in rows[1:]])
    ncol = np.array([float(r.split(",")[1]) for r in rows[1:]])
    assert np.all(np.diff(fcol) > 0) and np.all(np.diff(ncol) > 0)
    np.testing.assert_allclose(ncol[-1] / ncol[0], 4.0, rtol=0.1)


def test_campaign_samples_feed_gcmc_mbar(tmp_path):
    """The port's campaign point_NNN.jsonl streams through the port's
    gcmc_mbar: the ideal-gas line <N> = f V / kT (rtol 0.3, the
    reference test's bound for chains sharing the move-type schedule),
    monotone, Poisson-like var(N), and the reference's gcmc_mbar on the
    same files."""
    L = 40.0
    p = tmp_path / "gas.pqr"
    p.write_text("ATOM 1 He HE 1 M 5.0 5.0 5.0 4.0026 0.0 0.0 0.0 0.0\n"
                 "END\n")
    job = input_script.parse(
        "ensemble uvt\nnumsteps 400\ncorrtime 25\ntemperature 100\n"
        f"pressure 1.0\nbasis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
        "cutoff 8.0\ncoulomb off\nrd_lrc off\ninsert_probability 0.6\n"
        f"max_molecules 64\npqr_input {p}\n")
    sdir = tmp_path / "samples"
    campaign.run_isotherm(job, pressures=[2.0, 6.0], chains=2,
                          target_rel_sem=0.03, min_steps=1000,
                          max_steps=1000, equil_blocks=4,
                          samples_dir=str(sdir), device="cpu")
    files = sorted(str(f) for f in sdir.glob("point_*.jsonl"))
    assert len(files) == 2
    res = analyze.gcmc_mbar(files, n_f=5)
    assert res["converged"]
    np.testing.assert_allclose(res["n_mean"],
                               res["f_grid"] * ATM2K_A3 * L ** 3 / 100.0,
                               rtol=0.3)
    assert np.all(np.diff(res["n_mean"]) > 0)
    ratio = res["var_n"] / res["n_mean"]
    assert np.all(ratio > 0.4) and np.all(ratio < 1.8)
    _same(res, ref.gcmc_mbar(files, n_f=5), rtol=1e-10)
