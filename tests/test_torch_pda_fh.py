"""The port's B6 (the fused polar delayed acceptance's stage 1) under the
Feynman-Hibbs (order 2 and 4) and Feynman-Kleinert corrections: the plain
B6 (ops/cuda/mc_kernel.run_steps_uvt_pda on CPU tensors) against the JAX
package's B6 in Pallas interpret mode on the polar MOF + H2 system of
tests/torch_pda.py, float32, with the record tolerances there."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from torch_fh import QUANTUM  # noqa: E402
from torch_pda import SEG, assert_records_match, jax_rec  # noqa: E402
from torch_pda import jax_system as pda_system  # noqa: E402
from torch_pda import port_rec  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("q,lanes", [("fh2", (0.9, 0.1)), ("fh4", (0.1, 0.4)),
                                     ("fk", (0.4, 0.9))])
def test_plain_b6_matches_pallas(q, lanes):
    """B6 on the polar MOF + H2 system (tests/torch_pda.py) under each
    correction: tables whose step 0 is a forced stage-1 survivor of two
    move types each (lane 8: 0.9 displace, 0.1 insert, 0.4 delete) give
    the records of the reference's B6 in interpret mode."""
    p, s, c, t = pda_system("direct")
    c = dataclasses.replace(c, **QUANTUM[q])
    s = jm.initialize(s, p, c, t)
    P, S, C, T = convert.from_jax(p, s, c, t)
    rng = np.random.default_rng(17)
    for lane8 in lanes:
        u = rng.random((SEG, 16)).astype(np.float32)
        u[0, 4], u[0, 8] = 1e-30, lane8
        want = jax_rec(p, s, c, t, u)
        assert_records_match(port_rec(P, S, C, T, u), want)
