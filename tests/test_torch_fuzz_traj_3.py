"""The parity fuzz tier's check (e), file 3 of 4: the reference's fused
kernels (B1, B3, B6) in Pallas interpret mode against the port's plain
twins on the corpus entries' numpy tables (tests/torch_fuzz.py
check_trajectory).  Two entries of each file run in tier-1
(torch_fuzz.TRAJ_TIER1); the others are marked slow (~5-50 s each in
interpret mode): `python -m pytest tests/test_torch_fuzz_traj_*.py -m slow`."""
import pytest

torch = pytest.importorskip("torch")

import torch_fuzz as fz  # noqa: E402

globals().update(fz.traj_tests(3))
