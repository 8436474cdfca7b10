"""The TMMC estimator of the polar delayed acceptance in the port
(tests/test_tmmc.py:505-645 of the reference): on the ideal polar gas the
collection's columns against the accept and attempt counts, the bias's
importance weight keeping the collection unbiased, on the scan path and
through B6, and the fused polar run driver."""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from torch_tmmc import attempt_line, deck, ideal_polar_gas  # noqa: E402

torch.set_num_threads(1)


def _check_exact_sums(c, stats, tol):
    att, acc = stats.attempts, stats.host().accepts
    assert c[:, 0].sum() == att[tm.INSERT]
    assert c[:, 2].sum() == att[tm.DELETE]
    assert c[:, 1].sum() == pytest.approx(acc[tm.INSERT], abs=tol)
    assert c[:, 3].sum() == pytest.approx(acc[tm.DELETE], abs=tol)
    assert (c[:, 1] <= c[:, 0] + tol).all()
    assert (c[:, 3] <= c[:, 2] + tol).all()


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_tmmc_polar_delayed_estimator_exact_sums(route):
    """tests/test_tmmc.py:505 and :564 on the port: on the ideal polar gas
    a2 = 1, so the delayed acceptance's estimator 1{stage-1 accept}
    min(1, a2) is the realized stage-1 accept — the probability columns
    equal the accept counts and the attempt columns the attempt counts,
    on the scan path (float64) and through B6 (float32)."""
    if route == "scan":
        params, state, cfg, thermo = ideal_polar_gas("float64")
        st, stats = tm.run_chunk(state, params, cfg, thermo, 300,
                                 generator=torch.Generator().manual_seed(7))
        tol = 1e-9
    else:
        params, state, cfg, thermo = ideal_polar_gas("float32",
                                                      fused_mc=True)
        assert tmk.supported_uvt_polar_da(cfg, params)
        st, stats = tm.run_chunk_fused_uvt_polar_da(
            state, params, cfg, thermo, 256,
            generator=torch.Generator().manual_seed(7))
        tol = 1e-5
    _check_exact_sums(st.tmmc_c.double().numpy(), stats, tol)
    assert stats.attempts[tm.INSERT] + stats.attempts[tm.DELETE] > 60


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_tmmc_polar_delayed_bias_collection_unbiased(route):
    """tests/test_tmmc.py:533 and :645 on the port: under tmmc_bias with a
    strong downhill eta the tilt acts on the stage-1 test while the
    importance-weighted collection still estimates the unbiased ideal-gas
    insert acceptance min(1, fV/kT/(N+1)) within 0.15 on rows of at least
    150 insert attempts, and the walker sits below the unbiased mean
    (~9.7).  Every step is an insert or a delete (insert_probability 1,
    no displacements, which an ideal gas does not need), so 2,500-3,000
    steps give the reference's 8,000 steps' attempts."""
    dtype = "float64" if route == "scan" else "float32"
    kw = {} if route == "scan" else {"fused_mc": True}
    params, state, cfg, thermo = ideal_polar_gas(dtype, tmmc_bias=True,
                                                  p_ins=1.0, **kw)
    eta = -0.6 * np.arange(params.n_mols_max + 1)
    thermo = thermo.replace(tmmc_eta=torch.as_tensor(eta,
                                                     dtype=cfg.tdtype))
    g = torch.Generator().manual_seed(9)
    if route == "scan":
        st, stats = tm.run_chunk(state, params, cfg, thermo, 2500,
                                 generator=g)
    else:
        st, stats = tm.run_chunk_fused_uvt_polar_da(state, params, cfg,
                                                    thermo, 3000,
                                                    generator=g)
    c = st.tmmc_c.double().numpy()
    assert c[:, 0].sum() == stats.attempts[tm.INSERT]
    assert c[:, 2].sum() == stats.attempts[tm.DELETE]
    fv_kt = 30.0 * ATM2K_A3 * 20.0 ** 3 / 300.0
    checked = 0
    for n in range(c.shape[0]):
        if c[n, 0] >= 150:
            a = min(1.0, fv_kt / (n + 1.0))
            assert abs(c[n, 1] / c[n, 0] - a) < 0.15, (n, c[n])
            checked += 1
    assert checked >= 2
    assert int(st.mol_alive.sum()) <= 6


def test_port_tmmc_polar_delayed_run_driver(tmp_path):
    """tests/test_tmmc.py:593 on the port: polarization + polar_delayed +
    tmmc + fused_mc runs B6's route and writes a matrix whose insert
    ratios track the ideal gas within 0.2 on well-visited rows."""
    pqr = tmp_path / "hep.pqr"
    pqr.write_text("ATOM 1 He HEL 1 M 10.0 10.0 10.0 4.0026 0.0 0.3 "
                   "0.0 0.0\nEND\n")
    job = deck(tmp_path, f"fused_mc on\npolarization on\npolar_delayed on\n"
                f"pqr_input {pqr}", numsteps=600, corrtime=200, fug=30.0)
    log = io.StringIO()
    trun.run(job, log=log, device="cpu")
    assert "polar delayed-acceptance stage-1 kernel" in log.getvalue()
    c = np.asarray(json.loads((tmp_path / "t.json").read_text())["c"])
    n_att = c[:, 0].sum() + c[:, 2].sum()
    assert n_att > 120 and n_att == int(n_att)
    assert attempt_line(log.getvalue()) == (int(n_att), int(n_att))
    fv_kt = 30.0 * ATM2K_A3 * 8000.0 / 300.0
    for n in range(c.shape[0]):
        if c[n, 0] >= 120:
            a = min(1.0, fv_kt / (n + 1.0))
            assert abs(c[n, 1] / c[n, 0] - a) < 0.2, (n, c[n])
