"""B2's work list (ops/cuda/pair_kernel.py::tiles_with_pairs and
work_list), pure Python: the kernel evaluates exactly the pairs of the
listed PT x PT tiles, so the list must hold every tile with a pair B2
counts (i >= row_start, and j > i or j < row_start) and no other, once
each, in row-major order; and the list kept per (n, row_start, device)
serves only its own key."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.ops.cuda import pair_kernel as pk  # noqa: E402

PT = pk.PT
SIZES = [0, 1, 127, 128, 129, 300, 1000, 10797]
ROW_STARTS = [0, 1, 127, 128, 9261, "n"]


def _pairs_per_tile(n, row_start):
    """[nt, nt] count of the counted pairs in each tile, row by row:
    columns j > i plus columns j < row_start (disjoint, as j < row_start
    <= i), per column tile."""
    nt = -(-n // PT)
    count = np.zeros((nt, nt), np.int64)
    i = np.arange(row_start, n)[:, None]
    jlo = np.arange(nt)[None, :] * PT
    jhi = np.minimum(jlo + PT, n) - 1
    above = np.clip(jhi - np.maximum(i + 1, jlo) + 1, 0, None)
    below = np.clip(np.minimum(jhi + 1, row_start) - jlo, 0, None)
    np.add.at(count, i[:, 0] // PT, above + below)
    return count


@pytest.mark.parametrize("row_start", ROW_STARTS)
@pytest.mark.parametrize("n", SIZES)
def test_every_counted_pair_lies_in_one_listed_tile(n, row_start):
    """The listed tiles are exactly those holding a counted pair (so none
    is empty), each once, row-major; and their pairs add up to all the
    pairs B2 counts: each row i >= row_start pairs with the n - 1 - i
    columns above it and the row_start columns below row_start."""
    rs = n if row_start == "n" else row_start
    wl = pk.tiles_with_pairs(n, rs)
    assert wl.dtype == np.int32
    assert np.all(np.diff(wl) > 0)              # row-major, no repeat
    count = _pairs_per_tile(n, rs).reshape(-1)
    assert np.array_equal(np.flatnonzero(count), wl)
    assert np.all(count[wl] > 0)
    total = sum(n - 1 - i + rs for i in range(rs, n))
    assert int(count[wl].sum()) == total


@pytest.mark.parametrize("n,row_start", [(1, 0), (2, 0), (129, 0), (129, 5),
                                         (129, 128), (300, 77), (300, 256),
                                         (300, 300), (301, 129)])
def test_work_list_against_every_pair(n, row_start):
    """Small n: every counted pair enumerated, its tile (i // PT, j // PT)
    listed, and every listed tile holding one of them."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    counted = (i >= row_start) & ((j > i) | (j < row_start))
    nt = -(-n // PT)
    tiles = np.unique((i[counted] // PT) * nt + j[counted] // PT)
    assert np.array_equal(pk.tiles_with_pairs(n, row_start), tiles)


def test_work_list_kept_per_key():
    """work_list builds a key's list once and returns that tensor again;
    another n or row_start gets its own list, which leaves the first as it
    was."""
    pk._lists.clear()
    a = pk.work_list(1000, 0, "cpu")
    assert a.dtype == torch.int32 and a.device.type == "cpu"
    assert np.array_equal(a.numpy(), pk.tiles_with_pairs(1000, 0))
    assert pk.work_list(1000, 0, torch.device("cpu")) is a
    b = pk.work_list(1000, 300, "cpu")
    c = pk.work_list(1001, 0, "cpu")
    assert b is not a and c is not a and b is not c
    assert np.array_equal(b.numpy(), pk.tiles_with_pairs(1000, 300))
    assert np.array_equal(c.numpy(), pk.tiles_with_pairs(1001, 0))
    assert pk.work_list(1000, 0, "cpu") is a
    assert np.array_equal(a.numpy(), pk.tiles_with_pairs(1000, 0))
    assert len(pk._lists) == 3


def test_work_list_of_the_bench_refresh():
    """The 10.8k bench system's refresh (row_start F = 9,261): row tiles
    72..84, each with the column tiles from its own and the 73 below F;
    the full pass lists the upper triangle, 85 x 86 / 2 tiles."""
    nt = -(-10797 // PT)
    assert nt == 85
    wl = pk.tiles_with_pairs(10797, 9261)
    I, J = wl // nt, wl % nt
    assert set(I.tolist()) == set(range(72, 85))
    for r in range(72, 85):
        assert set(J[I == r].tolist()) == set(range(73)) | set(range(r, 85))
    assert len(pk.tiles_with_pairs(10797, 0)) == nt * (nt + 1) // 2
