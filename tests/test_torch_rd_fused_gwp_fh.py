"""Coulomb gwp under a quantum correction in the fused kernels: rd lj with
the GWP-smeared charges and Feynman-Hibbs or Feynman-Kleinert, which the
reference's fused gate admits (the corrections need rd lj only).  The
plain B1, B3 and B6 of gwp's form library with the molecule-mass column
against the JAX package's Pallas kernels in interpret mode on one
numpy-made uniform table each (the tolerances of
tests/test_torch_rd_fused_uvt.py, _nvt.py and _pda.py); the gate, the
library, the slice's planes and the CLI's fused µVT route; the fused
chunk's float64 bookkeeping."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from torch_fh import QUANTUM  # noqa: E402
from torch_rd import gwp_widths  # noqa: E402
from torch_rdf import (POS_ATOL, assert_sums, check_b6,  # noqa: E402
                       check_fused_bookkeeping_f64, mof_system, pallas_b1,
                       pallas_b3, port_b1, port_b3)

torch.set_num_threads(1)


def test_plain_b1_under_gwp_fh2_matches_pallas():
    """C = 2 on the MOF + H2 system with coulomb gwp and FH2, a [2, 32,
    16] table: equal move counts and slot aliveness, positions within
    1e-4 A, energy sums within the f32 tolerance, the mass column passed."""
    j = mof_system("gwp", **QUANTUM["fh2"])
    u = np.random.default_rng(31).random((2, 32, 16)).astype(np.float32)
    w_pos, w_sa, w_sums, _ = pallas_b1(*j, u)
    pos, sa, sums, kw = port_b1(*convert.from_jax(*j), u)
    assert kw["gwp"] is not None and kw["mol_mass"] is not None
    assert_sums(sums, w_sums, list(range(6, 14)))
    assert w_sums[:, 6].sum() > 0
    np.testing.assert_array_equal(sa, w_sa)
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


def test_plain_b3_under_gwp_fk_matches_pallas():
    """One chain under nvt with coulomb gwp and FK, a [1, 32, 16] table:
    equal accepts, positions within 1e-4 A, sums within the f32
    tolerance."""
    j = mof_system("gwp", "nvt", **QUANTUM["fk"])
    u = np.random.default_rng(37).random((1, 32, 16)).astype(np.float32)
    w_pos, w_sums = pallas_b3(*j, u)
    pos, sums = port_b3(*convert.from_jax(*j), u)
    assert_sums(sums, w_sums, [3])
    assert 3 < w_sums[0, 3] < 32
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


def test_plain_b6_under_gwp_fh4_matches_pallas():
    """B6 on the polar MOF + H2 system with coulomb gwp and FH4: forced
    and natural survivors give the reference's records
    (torch_rdf.check_b6)."""
    check_b6("gwp", **QUANTUM["fh4"])


@pytest.mark.parametrize("q", ["fh2", "fk"])
def test_gwp_fh_takes_the_fused_route(tmp_path, monkeypatch, q):
    """The gates equal the reference's and hold; the deck takes gwp's
    library with the mass plane (eight planes: six, the mass, the width)
    and, through the CLI with --cpu, the fused µVT route on the plain B1
    with the width and mass columns, WARNING-free."""
    p, s, c, t = mof_system("gwp", **QUANTUM[q])
    C = convert.config_from(c)
    assert tmk._supported_physics(C) == jmk._supported_physics(c) is True
    assert tmk.form_stem(C) == "gwp" and tmk.quantum_option(C) > 0
    assert tmk.slice_planes(C) == 8
    from mpmc_tpu_torch.io import pqr as pqr_io
    from mpmc_tpu_torch.models import systems
    P, S, _, _ = systems.mof_h2_gcmc(n_side=4, n_h2=4, capacity=8,
                                     dtype="float64", device="cpu")
    P = P.replace(gwp_alpha=torch.as_tensor(gwp_widths(P.charge.numpy())))
    pqr = tmp_path / "sys.pqr"
    pqr_io.write_state(str(pqr), P, S, ["H2"], extended=True)
    L = float(S.box[0, 0])
    extra = ("feynman_kleinert on\n" if q == "fk" else
             "feynman_hibbs on\n")
    deck = tmp_path / "run.inp"
    deck.write_text(
        f"ensemble uvt\nnumsteps 4\ncorrtime 2\ntemperature 77\npressure 1\n"
        f"basis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\ngwp on\n{extra}"
        f"fused_mc on\npqr_input {pqr}\n")
    calls = []
    orig = tmk.run_steps_uvt_plain

    def counted(*a, **k):
        calls.append(k.get("gwp") is not None
                     and k.get("mol_mass") is not None)
        return orig(*a, **k)
    monkeypatch.setattr(tmk, "run_steps_uvt_plain", counted)
    log = io.StringIO()
    trun.run(input_script.parse_file(str(deck)), log=log, device="cpu")
    text = log.getvalue()
    assert "single-chain fused µVT kernel" in text and "WARNING" not in text
    assert "uvt_gwp_kernel" in text, text
    assert calls and all(calls)


def test_fused_bookkeeping_f64_under_gwp_fh2():
    """The fused µVT chunk on the plain B1 in float64 with coulomb gwp and
    FH2: every carried term equals a fresh initialize to 1e-9."""
    check_fused_bookkeeping_f64(
        mof_system("gwp", "uvt", "float64", **QUANTUM["fh2"]), "uvt")
