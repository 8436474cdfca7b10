"""Kernel B6's plain version against mpmc_tpu's run_steps_uvt_pda
(interpret=True), float32, for the screened field variants polar_wolf and
polar_ewald (the direct field and ensemble nvt: tests/test_torch_pda.py):
tables whose stage-1 coin forces a survivor at step 0 for each move type,
and tables of natural coins that must freeze at the same step."""
import pytest

torch = pytest.importorskip("torch")

from torch_pda import check_forced_survivor, check_natural_freeze  # noqa

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["wolf", "ewald"])
def test_plain_b6_matches_pallas_forced_survivor(variant):
    check_forced_survivor(variant)


@pytest.mark.parametrize("variant", ["wolf", "ewald"])
def test_plain_b6_natural_freeze_matches_pallas(variant):
    check_natural_freeze(variant)
