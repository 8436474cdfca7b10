"""The port's B6 (the fused polar delayed acceptance's stage 1) under the
RD forms and coulomb gwp: the plain B6 (ops/cuda/mc_kernel.
run_steps_uvt_pda on CPU tensors, fed the C6/C8/C10 and GWP width
columns) against the JAX package's B6 in Pallas interpret mode, on the
polar MOF + H2 system of tests/torch_pda.py with its LJ sites mapped to
the form (disp_expansion damped with its tail: PHAHST's shape with Thole
polarization), float32, with the record tolerances of
tests/torch_pda.py."""
import pytest

torch = pytest.importorskip("torch")

from torch_rdf import FORMS, check_b6  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("form", FORMS[:3])
def test_plain_b6_matches_pallas(form):
    """sg, dreiding, b14_7 (torch_rdf.check_b6); disp_expansion and gwp:
    tests/test_torch_rd_fused_pda_disp.py."""
    check_b6(form)
