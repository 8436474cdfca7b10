"""The port's surf_multi_fit driver (mc/surface.py) in float64 on the
CPU: the reference's multi-configuration case — parameters recovered from
40 random 3-D dimer geometries — on the reference's simulated-annealing
path with the same seed (a file of its own: 4,000 annealing steps of the
port and of the reference)."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import surface as jsurface  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as run_mod  # noqa: E402

torch.set_num_threads(1)

AR_PQR = """ATOM 1 Ar AR 1 M 0.0 0.0 0.0 39.948 0.0 0.0 119.8 3.405
ATOM 2 Ar AR 2 M 4.0 0.0 0.0 39.948 0.0 0.0 119.8 3.405
END
"""

BASE = """ensemble surf_multi_fit
temperature 100
basis1 40 0 0
basis2 0 40 0
basis3 0 0 40
rd_lrc off
precision float64
"""


def lj(r, eps=119.8, sig=3.405):
    s6 = (sig / r) ** 6
    return 4 * eps * s6 * (s6 - 1)


@pytest.fixture
def ar_pqr(tmp_path):
    p = tmp_path / "ar2.pqr"
    p.write_text(AR_PQR)
    return str(p)


def _configs(tmp_path):
    eps_t, sig_t = 150.0, 3.2
    rng = np.random.default_rng(5)
    lines = []
    for _ in range(40):
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        r = rng.uniform(3.0, 6.0)
        b = u * r
        lines += [f"E {lj(r, eps_t, sig_t):.8f}", "0.0 0.0 0.0",
                  f"{b[0]:.6f} {b[1]:.6f} {b[2]:.6f}"]
    conf = tmp_path / "configs.dat"
    conf.write_text("\n".join(lines))
    return conf


def test_multi_fit_recovers_parameters_on_the_reference_path(tmp_path,
                                                             ar_pqr):
    """surf_multi_fit through run.run: the parameters of 40 random 3-D
    geometries' energies recovered, on the reference's SA path."""
    text = (BASE
            + f"pqr_input {ar_pqr}\nfit_input {_configs(tmp_path)}\n"
            "numsteps 4000\nfit_schedule 0.999\nfit_boltzmann_weight 500\n")
    result, chi2 = run_mod.run(input_script.parse(text), log=io.StringIO(),
                               device="cpu")
    jres, jchi2 = jsurface.run_surface_multi_fit(jinput.parse(text),
                                                 log=io.StringIO())
    fit = result["type0"]
    assert fit["eps"] == pytest.approx(150.0, rel=0.05)
    assert fit["sig"] == pytest.approx(3.2, rel=0.02)
    assert chi2 == pytest.approx(jchi2, rel=1e-9)
    assert fit["eps"] == pytest.approx(jres["type0"]["eps"], rel=1e-12)
