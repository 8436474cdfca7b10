"""The port's B6 under disp_expansion (damped, its tail on: PHAHST's shape
with Thole polarization) and under coulomb gwp, against the JAX package's
B6 in Pallas interpret mode (tests/torch_rdf.py check_b6)."""
import pytest

torch = pytest.importorskip("torch")

from torch_rdf import check_b6  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("form", ["disp_expansion", "gwp"])
def test_plain_b6_matches_pallas(form):
    check_b6(form)
