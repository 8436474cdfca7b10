"""The port's fused NVT kernel under the RD forms and coulomb gwp — the
plain B3 (ops/cuda/mc_kernel.py on CPU tensors, fed the C6/C8/C10 and GWP
width columns) — against the JAX package's fused NVT Pallas kernel in
interpret mode (run_steps_multi) on one numpy-made uniform table each:
the same accepts, positions within the f32 tolerance, energy sums within
the tolerances of the classical comparisons
(tests/test_torch_fused_nvt.py).  Systems: the reference's fused-kernel
H2 fluids under nvt (tests/test_fused_mc.py) and the MOF + H2 system with
its LJ sites mapped to disp_expansion (damped, its tail on), on two
chains."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch import convert  # noqa: E402
from torch_rdf import (FORMS, POS_ATOL, assert_sums, h2_system,  # noqa: E402
                       mof_system, pallas_b3, port_b3)

torch.set_num_threads(1)


@pytest.mark.parametrize("form", FORMS)
def test_plain_b3_matches_pallas(form):
    """One chain, a [1, 32, 16] table on the reference's H2 fluid of the
    form under nvt: equal accepts, positions within 1e-4 A, sums within
    the f32 tolerance."""
    j = h2_system(form, "nvt")
    u = np.random.default_rng(7).random((1, 32, 16)).astype(np.float32)
    w_pos, w_sums = pallas_b3(*j, u)
    pos, sums = port_b3(*convert.from_jax(*j), u)
    assert_sums(sums, w_sums, [3])
    assert 3 < w_sums[0, 3] < 32
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


def test_plain_b3_two_chains_on_the_mof():
    """C = 2 on the MOF + H2 system under disp_expansion (damped, its tail
    on; systems.rd_form_columns): each chain as the reference's."""
    j = mof_system("disp_expansion", "nvt")
    u = np.random.default_rng(3).random((2, 24, 16)).astype(np.float32)
    w_pos, w_sums = pallas_b3(*j, u)
    pos, sums = port_b3(*convert.from_jax(*j), u)
    assert_sums(sums, w_sums, [3])
    assert (w_sums[:, 3] > 3).all()
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)
