"""The port's fused µVT kernel under the RD forms and coulomb gwp — the
plain B1 (ops/cuda/mc_kernel.py on CPU tensors, fed the C6/C8/C10 and GWP
width columns) — against the JAX package's fused µVT Pallas kernel in
interpret mode on one numpy-made uniform table each: the same decisions,
positions within the f32 tolerance, energy sums within the tolerances of
the classical comparisons (tests/test_torch_fused_uvt.py).  Systems: the
reference's own fused-kernel H2 fluids (tests/test_fused_mc.py:
_altrd_h2 for sg / dreiding / b14_7, _dispexp_h2 for disp_expansion
with its tail, _gwp_h2 for gwp with disp_expansion).  B1's XT instance
under a form: tests/test_torch_rd_fused_runs.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch import convert  # noqa: E402
from torch_rdf import (FORMS, POS_ATOL, assert_sums, h2_system,  # noqa: E402
                       pallas_b1, port_b1)

torch.set_num_threads(1)


@pytest.mark.parametrize("form", FORMS)
def test_plain_b1_matches_pallas(form):
    """One chain, a [1, 32, 16] table on the reference's H2 fluid of the
    form: equal move counts and slot aliveness, positions within 1e-4 A,
    energy sums within the f32 tolerance (the disp_expansion tail's
    count-dependent delta among them), inserts or deletes accepted."""
    j = h2_system(form, "uvt")
    u = np.random.default_rng(5).random((1, 32, 16)).astype(np.float32)
    w_pos, w_sa, w_sums, _ = pallas_b1(*j, u)
    pos, sa, sums, kw = port_b1(*convert.from_jax(*j), u)
    assert (kw["disp"] is not None) == (j[2].rd_potential ==
                                        "disp_expansion")
    assert (kw["gwp"] is not None) == (form == "gwp")
    assert_sums(sums, w_sums, list(range(6, 14)))
    assert w_sums[0, 7:9].sum() > 0
    np.testing.assert_array_equal(sa, w_sa)
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)
