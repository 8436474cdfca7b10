"""Transition-matrix Monte Carlo in the port against the JAX package: the
analysis functions against the reference's on seeded matrices, the
command-line analysis, and the reference's tests/test_tmmc.py on the
port — the ideal-gas lnΠ links exact, the refresh keeping the matrix,
the gates, the run drivers (scan, fused, chains) with the host flush,
the exact resume, the polar delayed acceptance's estimator on the scan
and fused routes — and tests/test_fused_mc.py's TMMC kernel tests (each
chain's collection equal to the chain alone; the bias moves the walker,
not the estimator)."""
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as janalyze  # noqa: E402
from mpmc_tpu_torch import analyze as tanalyze  # noqa: E402
from mpmc_tpu_torch.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.io import output as output_io  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402
from torch_tmmc import attempt_line, deck, ideal_gas  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matrices(seed):
    """Seeded collection matrices: a well-sampled window, a smaller
    disconnected fragment, zero rows."""
    rng = np.random.default_rng(seed)
    c = np.zeros((30, 4))
    for lo, hi, scale in ((2, 5, 10.0), (9, 22, 200.0)):
        n = np.floor(rng.uniform(0.5, 1.0, hi - lo) * scale) + 1
        c[lo:hi, 0] = n
        c[lo:hi, 1] = n * rng.uniform(0.05, 1.0, hi - lo)
        c[lo + 1:hi + 1, 2] = n
        c[lo + 1:hi + 1, 3] = n * rng.uniform(0.05, 1.0, hi - lo)
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_functions_match_reference(seed):
    """tmmc_lnpi (with its disconnected-window warning), tmmc_eta,
    tmmc_reweight and tmmc_isotherm of the port equal the reference's to
    rel 1e-12 on seeded matrices."""
    c = _matrices(seed)
    with pytest.warns(UserWarning, match="disconnected"):
        got = tanalyze.tmmc_lnpi(c)
    with pytest.warns(UserWarning, match="disconnected"):
        want = janalyze.tmmc_lnpi(c)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=1e-12)
    assert ok.sum() >= 10
    with pytest.warns(UserWarning):
        np.testing.assert_allclose(tanalyze.tmmc_eta(c),
                                   janalyze.tmmc_eta(c), rtol=1e-12,
                                   atol=1e-12)
    for f in (0.3, 1.0, 4.0):
        np.testing.assert_allclose(tanalyze.tmmc_reweight(got, 1.0, f),
                                   janalyze.tmmc_reweight(want, 1.0, f),
                                   rtol=1e-12)
    with pytest.warns(UserWarning):
        rows_t = tanalyze.tmmc_isotherm(c, 2.0, [1.0, 2.0, 5.0])
    with pytest.warns(UserWarning):
        rows_j = janalyze.tmmc_isotherm(c, 2.0, [1.0, 2.0, 5.0])
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-12)
    assert tanalyze.tmmc_eta(np.zeros((5, 4))) is None
    with pytest.raises(ValueError, match="no connected"):
        tanalyze.tmmc_lnpi(np.zeros((5, 4)))


def test_tmmc_load_and_cli_match_reference(tmp_path):
    """tmmc_load sums same-state files and refuses another state (the
    reference's test at tests/test_tmmc.py:244); ``python -m
    mpmc_tpu_torch.analyze tmmc`` writes the reference CLI's isotherm and
    lnΠ CSVs."""
    c = _matrices(5)[:, :]
    c[2:6] = 0.0                                 # one window only
    c[6, 2:] = 0.0
    kw = dict(temperature=77.0, fugacities=[2.0, 5.0], volume=1000.0,
              species=["H2", "CO2"], insert_species=0)
    p1 = output_io.write_tmmc(str(tmp_path / "a.json"), c, **kw)
    p2 = output_io.write_tmmc(str(tmp_path / "b.json"),
                              c, **dict(kw, temperature=80.0))
    with pytest.raises(ValueError, match="same thermodynamic state"):
        tanalyze.tmmc_load([p1, p2])
    summed, meta = tanalyze.tmmc_load([p1, p1])
    np.testing.assert_array_equal(summed, 2 * c)
    assert meta["f_sim_atm"] == 2.0
    outs = {}
    for tag, mod in (("port", "mpmc_tpu_torch.analyze"),
                     ("ref", "mpmc_tpu.analyze")):
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "-m", mod, "tmmc", p1, "--fugacities",
             "0.5,2,8", "--out", str(tmp_path / f"{tag}.csv"),
             "--lnpi-out", str(tmp_path / f"{tag}_lnpi.csv")],
            env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs[tag] = r.stdout
    for name in ("{}.csv", "{}_lnpi.csv"):
        assert ((tmp_path / name.format("port")).read_text()
                == (tmp_path / name.format("ref")).read_text())
    assert outs["port"].splitlines()[0] == outs["ref"].splitlines()[0]


def test_tmmc_ideal_gas_lnpi_exact():
    """tests/test_tmmc.py:47 on the port's scan path: every insert/delete
    attempt lands in one counter and lnΠ(N+1) - lnΠ(N) = ln(fV/kT/(N+1))
    to 1e-12."""
    params, state, cfg, thermo, fv_kt = ideal_gas()
    state, _ = tm.run_chunk(state, params, cfg, thermo, 3000,
                            generator=torch.Generator().manual_seed(3))
    c = state.tmmc_c.numpy()
    n_att = c[:, 0].sum() + c[:, 2].sum()
    assert 0 < n_att <= 3000 and n_att == int(n_att)
    lnpi = tanalyze.tmmc_lnpi(c)
    idx = np.flatnonzero(np.isfinite(lnpi))
    assert idx.size >= 8
    d = lnpi[idx[1:]] - lnpi[idx[:-1]]
    np.testing.assert_allclose(d, np.log(fv_kt / idx[1:]), rtol=0,
                               atol=1e-12)


def test_tmmc_refresh_preserves_collection():
    """tests/test_tmmc.py:109: a refresh keeps the accumulated matrix."""
    params, state, cfg, thermo, _ = ideal_gas()
    state, _ = tm.run_chunk(state, params, cfg, thermo, 300,
                            generator=torch.Generator().manual_seed(4))
    before = float(state.tmmc_c.sum())
    assert before > 0
    state = tm.initialize(state, params, cfg, thermo)
    assert float(state.tmmc_c.sum()) == before
    state, _ = tm.run_chunk(state, params, cfg, thermo, 150,
                            generator=torch.Generator().manual_seed(5))
    assert float(state.tmmc_c.sum()) > before


def test_tmmc_gates():
    """tests/test_tmmc.py:121 and :298 on the port: the fused µVT gate
    takes single-species TMMC in float32 (float64 fails on the physics
    surface, not on tmmc) and refuses it with two insert species; the
    parser refuses tmmc outside µVT, under parallel tempering and under
    simulated annealing; spinflip rides along where every insert species
    is a rotor (refused on the monatomic ideal gas, taken beside TMMC on
    the MOF + H2 system)."""
    params, state, cfg, _, _ = ideal_gas()
    cfg_f = dataclasses.replace(cfg, fused_mc=True)
    assert not tmk.supported_uvt(cfg_f, params)
    assert tmk.supported_uvt(dataclasses.replace(cfg_f, dtype="float32"),
                             params)
    from mpmc_tpu.models import systems as jsystems
    from mpmc_tpu_torch import convert
    P, _, C, _ = convert.from_jax(*jsystems.mof_h2_ch4_gcmc(
        n_side=3, n_h2=2, n_ch4=2, capacity=4))
    C = dataclasses.replace(C, fused_mc=True, coulomb="wolf")
    assert tmk.supported_uvt(C, P)
    assert not tmk.supported_uvt(dataclasses.replace(C, tmmc=True), P)
    with pytest.raises(ValueError, match="requires ensemble uvt"):
        input_script.parse("ensemble nvt\ntmmc on\n")
    with pytest.raises(ValueError, match="parallel tempering"):
        input_script.parse("ensemble uvt\ntmmc on\nparallel_tempering on\n")
    with pytest.raises(ValueError, match="simulated_annealing"):
        input_script.parse("ensemble uvt\ntemperature 150\npressure 1.0\n"
                           "numsteps 100\ncorrtime 10\ntmmc on\n"
                           "simulated_annealing on\n"
                           "simulated_annealing_schedule 0.99\n")
    tmk._refuse_cfg(dataclasses.replace(cfg, quantum_rotation=True))
    assert not tmk.supported_uvt(dataclasses.replace(
        cfg_f, dtype="float32", quantum_rotation=True), params)
    P1, _, C1, _ = convert.from_jax(*jsystems.mof_h2_gcmc(
        n_side=3, n_h2=2, capacity=4))
    assert tmk.supported_uvt(dataclasses.replace(
        C1, fused_mc=True, tmmc=True, quantum_rotation=True), P1)


def test_tmmc_needs_one_insert_species(tmp_path):
    """Two insert species are refused at set-up (the reference's
    mpmc_tpu/mc/run.py:164-167)."""
    pqr = tmp_path / "two.pqr"
    pqr.write_text(
        "ATOM 1 He HEL 1 M 3.0 3.0 3.0 4.0 0.0 0.0 0.0 0.0\n"
        "ATOM 2 Ne NEO 2 M 6.0 6.0 6.0 20.0 0.0 0.0 0.0 0.0\nEND\n")
    job = input_script.parse(
        "ensemble uvt\nbasis1 14 0 0\nbasis2 0 14 0\nbasis3 0 0 14\n"
        f"tmmc on\ncoulomb off\npqr_input {pqr}\n")
    with pytest.raises(ValueError, match="exactly one insert species"):
        trun.setup(job, device="cpu")


@pytest.mark.parametrize("route", ["scan", "fused", "chains", "batched"])
def test_tmmc_run_driver_host_flush(route, tmp_path):
    """tests/test_tmmc.py:317 and :366 on the port, on the scan path, the
    fused µVT kernel, two fused chains and two batched scan chains: the
    matrix written after three corrtime flushes holds every insert and
    delete attempt (chains: summed) and its insert rows keep the ideal-gas
    acceptance exactly, a_ins(N) = min(1, fV/kT/(N+1))."""
    extra = {"scan": "precision float64", "fused": "fused_mc on",
             "chains": "fused_mc on\nchains 2",
             "batched": "precision float64\nchains 2"}[route]
    job = deck(tmp_path, extra)
    log = io.StringIO()
    trun.run(job, log=log, device="cpu")
    text = log.getvalue()
    if route in ("fused", "chains"):
        assert "fused_mc: " in text and "unsupported" not in text
    if route == "batched":
        assert "batched scan chains (C=2)" in text
    rec = json.loads((tmp_path / "t.json").read_text())
    c = np.asarray(rec["c"])
    assert rec["f_sim_atm"] == pytest.approx(0.3)
    n_att = c[:, 0].sum() + c[:, 2].sum()
    lo = 250 * (2 if route in ("chains", "batched") else 1)
    assert lo < n_att < 3 * lo and n_att == int(n_att)
    assert attempt_line(text) == (int(n_att), int(n_att))
    fv_kt = 0.3 * ATM2K_A3 * 8000.0 / 300.0
    rel = 1e-12 if route in ("scan", "batched") else 5e-5
    for n in range(c.shape[0]):
        if c[n, 0] > 0:
            a = min(1.0, fv_kt / (n + 1.0))
            assert c[n, 1] / c[n, 0] == pytest.approx(a, rel=rel), n


def test_tmmc_cli_roundtrip(tmp_path):
    """tests/test_tmmc.py:142 on the port: a tmmc run, then ``python -m
    mpmc_tpu_torch.analyze tmmc``: the isotherm CSV gives the Poisson mean
    of the resolved window at 0.5 f and f, and about fV/kT at f."""
    L, T, target_n = 14.0, 150.0, 6.0
    f_atm = target_n * T / L ** 3 / ATM2K_A3
    pqr = tmp_path / "he.pqr"
    pqr.write_text(
        "ATOM 1 He HE 1 M 3.0 3.0 3.0 4.0 0.0 0.0 0.0 0.0\nEND\n")
    out = tmp_path / "run.tmmc.json"
    job = input_script.parse(f"""
ensemble uvt
numsteps 4000
corrtime 500
temperature {T}
fugacities {f_atm}
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
insert_probability 0.5
rd_lrc off
coulomb off
precision float64
max_molecules 30
tmmc on
tmmc_output {out}
pqr_input {pqr}
pqr_restart {tmp_path / 'restart.pqr'}
""")
    log = io.StringIO()
    trun.run(job, log=log, device="cpu")
    assert "tmmc collection matrix written" in log.getvalue()
    c, meta = tanalyze.tmmc_load([str(out)])
    assert meta["temperature"] == pytest.approx(T)
    assert c[:, 0].sum() + c[:, 2].sum() > 1000
    csv = tmp_path / "iso.csv"
    tanalyze.main(["tmmc", str(out), "--fugacities",
                   f"{0.5 * f_atm},{f_atm}", "--out", str(csv),
                   "--lnpi-out", str(tmp_path / "lnpi.csv")])
    rows = [ln.split(",") for ln in csv.read_text().strip().splitlines()[1:]]
    fv_kt = f_atm * ATM2K_A3 * L ** 3 / T
    window = np.flatnonzero(np.isfinite(tanalyze.tmmc_lnpi(c)))
    for row, ratio in zip(rows, (0.5, 1.0)):
        n = window.astype(np.float64)
        w = n * np.log(ratio * fv_kt) - np.array(
            [np.sum(np.log(np.arange(1, v + 1))) for v in window])
        p = np.exp(w - w.max())
        assert float(row[1]) == pytest.approx((n * p).sum() / p.sum(),
                                              abs=1e-6)
    assert float(rows[1][1]) == pytest.approx(fv_kt, abs=0.5)
    assert (tmp_path / "lnpi.csv").exists()


@pytest.mark.parametrize("route", ["scan", "fused_bias"])
def test_tmmc_checkpoint_resume_exact(route, tmp_path):
    """tests/test_tmmc.py:417 on the port: a run checkpointed after two
    blocks and resumed for one writes the collection matrix of a straight
    three-block run, bit for bit — on the scan path (float64) and on the
    fused µVT kernel under tmmc_bias (the checkpoint carries the host
    matrix and eta)."""
    extra = ("precision float64" if route == "scan"
             else "fused_mc on\ntmmc_bias on")

    def run(n, more):
        job = deck(tmp_path, extra + "\n" + more, numsteps=n)
        trun.run(job, log=io.StringIO(), device="cpu")
        return np.asarray(json.loads((tmp_path / "t.json").read_text())["c"])

    straight = run(900, "")
    run(600, f"checkpoint_output {tmp_path / 'ck.pt'}")
    resumed = run(300, f"checkpoint_input {tmp_path / 'ck.pt'}")
    assert straight[:, 0].sum() + straight[:, 2].sum() > 200
    np.testing.assert_array_equal(resumed, straight)


def test_uvt_tmmc_fused_multi_equals_single_chain():
    """tests/test_fused_mc.py:1911 on the port: each chain of a C = 2
    launch collects the TMMC delta of the chain alone on its rows, bit
    for bit."""
    params, state, cfg, thermo, _ = ideal_gas(dtype="float32",
                                               fused_mc=True)
    C, K = 2, 300
    u = torch.rand((C, K, 16), generator=torch.Generator().manual_seed(7))
    states = multichain.stack_states(state, C)
    out, _ = tm.run_chunk_fused_uvt_multi(states, params, cfg, thermo, K,
                                          uniforms=u)
    for ch in range(C):
        one, _ = tm.run_chunk_fused_uvt(slice_chain(states, ch), params, cfg,
                                        thermo, K, uniforms=u[ch])
        assert torch.equal(out.tmmc_c[ch], one.tmmc_c)
    assert float(out.tmmc_c.sum()) > 0


def test_uvt_tmmc_bias_fused_shifts_walker_not_estimator():
    """tests/test_fused_mc.py:1955 on the port: an eta rising 0.9 per
    molecule drags the fused walker above the unbiased Poisson mean (8)
    while every collected insert row stays the unbiased
    min(1, fV/kT/(N+1)) to rel 5e-5."""
    params, state, cfg, thermo, fv_kt = ideal_gas(
        dtype="float32", fused_mc=True, tmmc_bias=True)
    thermo = thermo.replace(tmmc_eta=torch.as_tensor(
        0.9 * np.arange(41), dtype=torch.float32))
    st, _ = tm.run_chunk_fused_uvt(state, params, cfg, thermo, 2500,
                                   generator=torch.Generator().manual_seed(3))
    assert int(st.mol_alive.sum()) > 13
    c = st.tmmc_c.double().numpy()
    for n in range(c.shape[0]):
        if c[n, 0] > 0:
            a = min(1.0, fv_kt / (n + 1.0))
            assert c[n, 1] / c[n, 0] == pytest.approx(a, rel=5e-5), n
