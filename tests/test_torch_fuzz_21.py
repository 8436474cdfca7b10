"""The parity fuzz tier, shard 21 of 24 of the corpus
(tests/torch_fuzz_corpus.json): checks (a)-(d) on each entry of the shard
and (f) on its fused ones, tests/torch_fuzz.py shard_tests."""
import pytest

torch = pytest.importorskip("torch")

import torch_fuzz as fz  # noqa: E402

globals().update(fz.shard_tests(21))
