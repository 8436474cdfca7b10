"""The parity fuzz corpus itself (tests/torch_fuzz_corpus.json): at least
64 entries, every axis value of tools/make_fuzz_corpus.AXES in at least
two, the refusals named after the port's traps, and the committed file
equal to a regeneration from its seed."""
import pytest

torch = pytest.importorskip("torch")

import torch_fuzz as fz  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from tools import make_fuzz_corpus as fc  # noqa: E402


def test_corpus_covers_every_axis_value_twice():
    entries = fz.CORPUS["entries"]
    assert len(entries) >= 64
    assert fz.CORPUS["seed"] == fc.SEED
    cov = fc.coverage(entries)
    thin = {a: {v: n for v, n in vals.items() if n < 2}
            for a, vals in cov.items()}
    assert not any(thin.values()), thin
    for e in entries:
        if e["refusal"]:
            assert hasattr(tm, e["refusal"])
    # every shard and every fused entry is run somewhere
    ids = sorted(i for k in range(fz.N_SHARDS) for i in fz.shard(k))
    assert ids == sorted(fz.ENTRIES)
    assert set(fz.TRAJ_TIER1) <= set(fz.fused_ids(ids))


def test_corpus_regenerates_from_its_seed():
    """tools/make_fuzz_corpus.py from the committed seed writes the
    committed file byte for byte (~15 s: every draw is built by the
    reference and its fused gate asked)."""
    with open(fc.CORPUS) as f:
        assert f.read() == fc.dumps(fc.corpus(fz.CORPUS["seed"]))
