"""What B5's wrapper (mpmc_tpu_torch/ops/cuda/thole_kernel.py) computes in
Python for the kernel: the work list of a visit table, the tile order the
kernel sums a row in (the same cuts with and without a table), and the
per-solve plan of solve_scf, against the JAX package's solve."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.ops import thole as jt  # noqa: E402
from mpmc_tpu_torch.ops import thole as tt  # noqa: E402
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk  # noqa: E402
from torch_polar import cloud, mof_polar, to_np  # noqa: E402

torch.set_num_threads(1)


def _tables():
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 2, (7, 5))
    rand[2, :] = 0                           # an empty row tile
    rand[:, 0] = 0                           # an empty column tile
    return {"random": rand, "empty": np.zeros((4, 4), int),
            "full": np.ones((3, 6), int), "one": np.ones((1, 1), int),
            "sparse": np.eye(6, dtype=int) * 3}


@pytest.mark.parametrize("name", list(_tables()))
def test_work_list_covers_each_visited_tile_once(name):
    """work_list: W, the row offsets and the tiles are the table's nonzero
    tiles exactly once each, row-major (column order within a row tile),
    and the entries past W are 0."""
    visit = _tables()[name]
    ni, nj = visit.shape
    wl = to_np(tk.work_list(torch.as_tensor(visit, dtype=torch.int32)))
    assert wl.dtype == np.int32 and wl.shape == (2 + ni + ni * nj,)
    W, rowoff, tiles = wl[0], wl[1:2 + ni], wl[2 + ni:]
    want = np.flatnonzero(visit.reshape(-1))
    assert W == len(want)
    np.testing.assert_array_equal(tiles[:W], want)
    assert not tiles[W:].any()
    np.testing.assert_array_equal(
        rowoff, np.concatenate([[0], np.cumsum((visit != 0).sum(1))]))
    for i in range(ni):
        row = tiles[rowoff[i]:rowoff[i + 1]]
        np.testing.assert_array_equal(row // nj, i)
        np.testing.assert_array_equal(row % nj, np.flatnonzero(visit[i]))


def test_plan_carries_the_header_and_list():
    """plan: the scalar header of the box, rc and damping width, the work
    list of the table (None without one) and its length — the partial
    slots a call takes: every tile dense, the visited tiles culled —, and
    a refusal of a table of another grid."""
    pos, ok, _, _, _, L = cloud(n=300)
    box = torch.eye(3, dtype=torch.float64) * L
    n_pad, ni, nj = tk.grid_shape(300)
    dense = tk.plan(box, torch.tensor(9.0), 2.1304, 300)
    assert dense.n == 300 and dense.wl is None and dense.slots == ni * nj
    np.testing.assert_array_equal(to_np(dense.scal),
                                  to_np(tk.scalars(box, 9.0, 2.1304)))
    visit = torch.ones((ni, nj), dtype=torch.int32)
    culled = tk.plan(box, torch.tensor(9.0), 2.1304, 300, visit)
    assert torch.equal(culled.wl, tk.work_list(visit))
    assert culled.slots == ni * nj
    visit[0, 1:] = 0
    part = tk.plan(box, torch.tensor(9.0), 2.1304, 300, visit)
    assert part.slots == int(visit.sum()) == ni * nj - (nj - 1)
    with pytest.raises(ValueError):
        tk.plan(box, 9.0, 2.1304, 300, torch.ones((ni + 1, nj),
                                                  dtype=torch.int32))


PLAN_MISMATCH = ["n", "box", "rc", "lam", "visit", "no visit",
                 "visit added"]


@pytest.mark.parametrize("what", PLAN_MISMATCH)
def test_check_plan_refuses_another_call(what):
    """check_plan passes a plan for the call it was built for (the same
    box, rc and visit tensors, or equal numbers) and refuses one built
    for another site count, box, rc, damping width or visit table, even
    of equal values: the kernel reads the header and the list from the
    plan alone."""
    box = torch.eye(3, dtype=torch.float64) * 30.0
    rc = torch.tensor(9.0, dtype=torch.float64)
    _, ni, nj = tk.grid_shape(300)
    visit = torch.ones((ni, nj), dtype=torch.int32)
    call = {"box": box, "rc": rc, "lam": 2.1304, "n": 300, "visit": visit}
    fplan = tk.plan(box, rc, 2.1304, 300, visit)
    tk.check_plan(fplan, **call)
    tk.check_plan(tk.plan(box, 9.0, 2.1304, 300), **dict(
        call, rc=9.0, visit=None))
    other = {"n": 290, "box": box.clone(), "rc": rc.clone(), "lam": 2.0,
             "visit": visit.clone(), "no visit": None}
    if what == "visit added":
        fplan = tk.plan(box, rc, 2.1304, 300)
    else:
        call[what if what != "no visit" else "visit"] = other[what]
    with pytest.raises(ValueError, match="another call"):
        tk.check_plan(fplan, **call)


def _tile_sums(wl, partial, ni, nj):
    """The kernel's summation over a work list (dense: wl None): each
    listed tile's partial in its slot, then each row tile's slots added in
    list order into a float64 sum that starts at 0."""
    if wl is None:
        order = np.arange(ni * nj)
        rowoff = np.arange(ni + 1) * nj
    else:
        wl = to_np(wl)
        order, rowoff = wl[2 + ni:2 + ni + wl[0]], wl[1:2 + ni]
    out = np.zeros((ni * tk.TI, 3))
    for i in range(ni):
        for a in range(rowoff[i], rowoff[i + 1]):
            out[i * tk.TI:(i + 1) * tk.TI] += partial[order[a]]
    return out, order


@pytest.mark.parametrize("mode", ["charge", "dipole"])
def test_row_sums_are_cut_where_the_table_does_not_decide(mode):
    """The row sums the kernel forms are cut at tile boundaries: the
    culled list (thole.cull_visit at rc 9 A on cell-sorted sites) is the
    dense list with the skipped tiles left out, in the same order; every
    skipped tile's partial is exactly zero; so the culled sums equal the
    dense ones bit for bit, and both equal the plain field (float64, rel
    1e-12 of max |E|)."""
    pos, ok, q, mu, mol, L = cloud(n=700, L=40.0, seed=3)
    box = torch.eye(3, dtype=torch.float64) * L
    rc = torch.tensor(9.0, dtype=torch.float64)
    perm, _ = tt.cull_perm(torch.as_tensor(pos), box, torch.as_tensor(ok),
                           rc)
    perm = to_np(perm)
    args = [torch.as_tensor(x) for x in (pos[perm], ok[perm],
                                         (q if mode == "charge" else mu)[perm],
                                         mol[perm].astype(np.int32))]
    pos_s, ok_s, src, mol_s = args
    plain = (tk.charge_field_plain if mode == "charge"
             else tk.dipole_field_plain)
    n_pad, ni, nj = tk.grid_shape(700)
    visit = tt.cull_visit(pos_s, ok_s, box, rc)
    assert 0 < float(visit.float().mean()) < 1
    # each tile's partial: the plain field with that tile alone visited
    partial = np.zeros((ni * nj, tk.TI, 3))
    for t in range(ni * nj):
        one = torch.zeros((ni, nj), dtype=torch.int32)
        one.view(-1)[t] = 1
        f = to_np(plain(pos_s, box, ok_s, src, mol_s, rc, 2.1304,
                        "exponential", visit=one))
        i = t // nj
        rows = f[i * tk.TI:(i + 1) * tk.TI]
        partial[t, :len(rows)] = rows
    skipped = to_np(visit).reshape(-1) == 0
    assert not partial[skipped].any()
    dense, d_order = _tile_sums(None, partial, ni, nj)
    culled, c_order = _tile_sums(tk.work_list(visit), partial, ni, nj)
    np.testing.assert_array_equal(c_order, d_order[~skipped])
    np.testing.assert_array_equal(dense, culled)
    want = to_np(plain(pos_s, box, ok_s, src, mol_s, rc, 2.1304,
                       "exponential"))
    np.testing.assert_allclose(dense[:700], want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("case", ["cg", "cg-cull"])
def test_solve_scf_builds_one_plan_per_solve(monkeypatch, case):
    """solve_scf builds B5's plan (header and work list) once per solve
    and hands the same plan to every matvec; its dipoles and iteration
    count equal the JAX package's solve (float64, 1e-9), as
    test_torch_thole_scf holds them."""
    kw = {"polar_solver": "cg", "polar_precision": 1e-9}
    sys_kw = {}
    if case == "cg-cull":
        sys_kw = dict(n_side=7, n_h2=20, capacity=40)
        kw["cutoff"] = 7.0
    (p, s, c, t), (P, S, C, T) = mof_polar(**sys_kw, **kw)
    assert tt.cull_supported(C) == (case == "cg-cull")
    plans, seen = [], []
    make, field = tk.plan, tk.dipole_field

    def counting_plan(*a, **k):
        plans.append(make(*a, **k))
        return plans[-1]

    def recording_field(*a, **k):
        seen.append(k.get("plan"))
        return field(*a, **k)

    monkeypatch.setattr(tk, "plan", counting_plan)
    monkeypatch.setattr(tk, "dipole_field", recording_field)
    mu_t, it_t, r_t = tt.solve_scf(S.pos, S.box, S.atom_alive(P), P, C,
                                   S.e0)
    assert len(plans) == 1
    assert (plans[0].wl is not None) == (case == "cg-cull")
    assert len(seen) == it_t + 1          # the cold start's b - A x0
    assert all(x is plans[0] for x in seen)
    mu_j, it_j, r_j = jt.solve_scf(s.pos, s.box, s.atom_alive(p), p, c, s.e0)
    assert it_t == int(it_j) and 0 < it_t < C.polar_max_iter
    np.testing.assert_allclose(to_np(mu_t), np.asarray(mu_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(to_np(r_t), np.asarray(r_j), rtol=0,
                               atol=1e-9)
