"""The port's fugacity-ladder parallel tempering on an ideal gas (a port
of the reference's tests/test_parallel.py::test_pt_fugacity_ladder_ideal_gas
through mpmc_tpu_torch.mc.run on the CPU, its ladder records reweighted by
the port's analyze.pt_gcmc_mbar)."""
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as janalyze  # noqa: E402
from mpmc_tpu.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch import analyze as tanalyze  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402

torch.set_num_threads(1)


def test_pt_fugacity_ladder_ideal_gas(tmp_path):
    """Fugacity-ladder PT of an ideal gas (the reference's
    tests/test_parallel.py::test_pt_fugacity_ladder_ideal_gas): each rung
    holds its own <N> = f V / kT, read from the JSONL ladder records, the
    ladder's multiset is conserved, and the port's pt_gcmc_mbar turns the
    one run into the continuous linear isotherm (the reference's
    pt_gcmc_mbar on the same stream equal to it), while pt_mbar refuses
    the stream."""
    pqr = tmp_path / "he.pqr"
    pqr.write_text(
        "ATOM 1 He HE 1 M 5.0 5.0 5.0 4.0026 0.0 0.0 0.0 0.0\nEND\n")
    job = input_script.parse(f"""
ensemble uvt
numsteps 6000
corrtime 300
temperature 100
pressure 2.0
max_pressure 16.0
pt_fugacity on
n_replicas 4
ptemp_freq 75
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
cutoff 8.0
coulomb off
rd_lrc off
insert_probability 0.6
max_molecules 96
precision float64
pqr_input {pqr}
""")
    log = io.StringIO()
    jsonl = tmp_path / "obs.jsonl"
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        _, avgs = trun.run(job, log=log, jsonl_path=str(jsonl),
                           device="cpu")
    finally:
        os.chdir(old)
    text = log.getvalue()
    assert "fugacity-ladder PT: 4 replicas" in text
    assert "swap acceptance:" in text
    assert 0.0 < avgs.mean("swap_acceptance") <= 1.0
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    recs = [r for r in recs if "pt_fug" in r]
    fugs = np.array([r["pt_fug"] for r in recs])
    ns = np.array([r["pt_N"] for r in recs])
    assert fugs.shape == ns.shape == (20, 4)
    np.testing.assert_allclose(
        np.sort(fugs, axis=1),
        np.broadcast_to(np.sort(fugs[0]), fugs.shape))
    v, T = 20.0 ** 3, 100.0
    skip = 1
    for fv in np.sort(fugs[0]):
        sel = np.abs(fugs[skip:] - fv) < 1e-9
        mean_n = ns[skip:][sel].mean()
        expect = fv * ATM2K_A3 * v / T
        assert mean_n == pytest.approx(expect, rel=0.35), fv
    res = tanalyze.pt_gcmc_mbar(str(jsonl), n_f=6, skip=0.2)
    assert res["converged"] and res["temperature"] == T
    np.testing.assert_allclose(res["n_mean"],
                               res["f_grid"] * ATM2K_A3 * v / T, rtol=0.35)
    assert np.all(np.diff(res["n_mean"]) > 0)
    want = janalyze.pt_gcmc_mbar(str(jsonl), n_f=6, skip=0.2)
    for k in ("f_grid", "n_mean", "u_mean", "var_n", "ess", "ladder_f",
              "delta_f"):
        np.testing.assert_allclose(res[k], want[k], rtol=1e-10, atol=0)
    with pytest.raises(ValueError, match="pt_gcmc_mbar"):
        tanalyze.pt_mbar(str(jsonl))
