"""B4's summation order (csrc/pair_kernel.cuh, mol_pair_grid_kernel and
mol_pair_cluster_kernel), emulated in torch float64 on the CPU.

Both regimes must give every chain the bits of the order the one-launch
kernel before them summed in: each column's rows in T, then per chunk of
256 columns a 256-thread tree in double (partner offsets 128 .. 1, the
lower index first), then the chunk sums read by 256 threads in chunk
order (u_t = 0 + S_t + S_(t+256) + ...) and the same tree over them.
Regime 1 (position stride 0, many chains) walks the chunks with one warp
per chain, 8 columns a lane: offsets 128 .. 32 are register adds and
16 .. 1 shuffles; its chunk sums go to slot b mod 256.  Regime 2 gives a
chunk to a team of 4 warps, 2 columns a lane: offset 128 in registers, 64
and 32 over the team's warps, then shuffles; the chunks of a chain spread
over the teams of a cluster of G CTAs.  The emulations below follow the
kernels' index maps and trees, and must equal the reference's bits for
ragged column counts, chain counts and float32 or float64 column sums.
The kernels' coverage of (chain, column) pairs is checked from the same
index maps, and ``qrot.potentials_on_grid``, now one B4 call per refresh,
against the 64-rotor calls it made before.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.mc import metropolis  # noqa: E402
from mpmc_tpu_torch.models import systems  # noqa: E402
from mpmc_tpu_torch.ops import pairs, qrot  # noqa: E402

MT, KC, P2, TM2, NW4, CPW = 256, 8, 4, 4, 8, 4   # pair_kernel.cuh


def _columns(C, n, rows, dtype, seed):
    """[C, n, 3] float64 column sums: each column's ``rows`` pair values
    (wide magnitudes and both signs, some columns dead) summed in
    ``dtype`` in row order from 0, then cast to double, as column_pair."""
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal((C, n, 3, rows))
            * 10.0 ** rng.uniform(-6, 4, (C, n, 3, rows)))
    v = torch.as_tensor(vals, dtype=dtype)
    acc = torch.zeros((C, n, 3), dtype=dtype)
    for a in range(rows):
        acc = acc + v[..., a]
    dead = torch.as_tensor(rng.random((C, n)) < 0.15)
    return torch.where(dead[..., None], 0.0, acc.double())


def _padded(v):
    """[C, nb, 256, 3]: the columns in chunks, zero past n."""
    C, n, _ = v.shape
    nb = -(-n // MT)
    out = torch.zeros((C, nb * MT, 3), dtype=torch.float64)
    out[:, :n] = v
    return out.reshape(C, nb, MT, 3)


def _tree_halving(x, dim):
    """The 256-thread tree: x[t] += x[t + w], w = 128 .. 1, along dim."""
    while x.shape[dim] > 1:
        w = x.shape[dim] // 2
        x = x.narrow(dim, 0, w) + x.narrow(dim, w, w)
    return x.squeeze(dim)


def reference(v):
    """[C, 3]: block_partials' tree per chunk, then reduce_body's reads
    (thread t sums chunks t, t + 256, ... from 0) and its tree."""
    S = _tree_halving(_padded(v), 2)                      # [C, nb, 3]
    C, nb, _ = S.shape
    u = torch.zeros((C, MT, 3), dtype=torch.float64)
    for b in range(nb):
        u[:, b % MT] = u[:, b % MT] + S[:, b]
    return _tree_halving(u, 1)


def _reg_tree(leaf, k0, s, nk):
    """reg_tree<K0, S, NK>: depth first, slots k0 and k0 + s paired last."""
    if s >= nk:
        return leaf(k0)
    return _reg_tree(leaf, k0, 2 * s, nk) + _reg_tree(leaf, k0 + s, 2 * s, nk)


_LANE = torch.arange(32)


def _lane_tree(x):
    """lane_tree over the lane axis (-2 of [..., 32, 3]): xor shuffles at
    offsets 16 .. 1, each lane adding its partner's value; lane 0's."""
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., _LANE ^ off, :]
    return x[..., 0, :]


def _chunk_tree(S):
    """chunk_tree over chunk sums S [C, ns, 3]: lane l, slot k reads u at
    t = l + 32 k (chunks t, t + 256, ... from 0), reg_tree over k, then
    the shuffles."""
    C, ns, _ = S.shape
    u = torch.zeros((C, MT, 3), dtype=torch.float64)
    for b in range(ns):
        u[:, b % MT] = u[:, b % MT] + S[:, b]
    u = u.reshape(C, KC, 32, 3)                           # t = l + 32 k
    return _lane_tree(_reg_tree(lambda k: u[:, k], 0, 1, KC))


def regime1(v):
    """mol_pair_grid_kernel: per chunk, lane l of the chain's warp holds
    columns l + 32 k (k < 8); reg_tree over k, the shuffles; slot b mod
    256 stored, or added past 256 chunks; then chunk_tree over the
    slots."""
    x = _padded(v)
    C, nb = x.shape[:2]
    slots = torch.zeros((C, min(nb, MT), 3), dtype=torch.float64)
    for b in range(nb):
        col = x[:, b].reshape(C, KC, 32, 3)               # [C, k, lane]
        s = _lane_tree(_reg_tree(lambda k: col[:, k], 0, 1, KC))
        if b < MT:
            slots[:, b] = s
        else:
            slots[:, b % MT] = slots[:, b % MT] + s
    return _chunk_tree(slots)


def regime2(v, G):
    """mol_pair_cluster_kernel with clusters of G CTAs: chunk b goes to
    team b mod (G TM2); lane l of its warp p holds columns l + 32 (4 k +
    p) (k < 2); reg_tree over k, then over the team's warps p, the
    shuffles; rank 0's slot b; then chunk_tree over the nb slots."""
    x = _padded(v)
    C, nb = x.shape[:2]
    slots = torch.zeros((C, nb, 3), dtype=torch.float64)
    for gt in range(G * TM2):
        for b in range(gt, nb, G * TM2):
            col = x[:, b].reshape(C, KC // P2, P2, 32, 3)   # [C, k, p, l]
            per_warp = _reg_tree(lambda k: col[:, k], 0, 1, KC // P2)
            s = _lane_tree(_reg_tree(lambda p: per_warp[:, p], 0, 1, P2))
            slots[:, b] = s
    return _chunk_tree(slots)


@pytest.mark.parametrize("n", [0, 1, 37, 256, 300, 10843, 70000],
                         ids=lambda n: f"n{n}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_both_regimes_give_the_reference_bits(n, dtype):
    """Regime 1 and regime 2 at every cluster size sum each chain to the
    reference's bits, for ragged n (none, one column, past one chunk, the
    bench system's 10,843, past 256 chunks) and an odd chain count."""
    C = 3 if n < 20000 else 1
    v = _columns(C, n, 3, dtype, seed=n + 7)
    want = reference(v)
    assert torch.equal(regime1(v), want)
    for G in (1, 2, 3, 5, 8, 16):
        assert torch.equal(regime2(v, G), want)


def test_the_emulation_sees_the_order():
    """The data is wide enough that another order changes the bits: a
    plain left-to-right sum, and the reference's tree with the chunks
    combined in index order, both differ from the reference."""
    v = _columns(2, 10843, 3, torch.float32, seed=5)
    want = reference(v)
    assert not torch.equal(v.sum(dim=1), want)
    left = torch.zeros((2, 3), dtype=torch.float64)
    for j in range(v.shape[1]):
        left = left + v[:, j]
    assert not torch.equal(left, want)
    S = _tree_halving(_padded(v), 2)
    seq = torch.zeros((2, 3), dtype=torch.float64)
    for b in range(S.shape[1]):
        seq = seq + S[:, b]
    assert not torch.equal(seq, want)


def _cover_regime1(n, C, cpw):
    """[C, n] counts of (chain, column) pairs the grid kernel evaluates:
    CTA x, warp w, its chain i, chunk b, lane l, slot k."""
    cnt = np.zeros((C, n), np.int64)
    CG = NW4 * cpw
    nb = -(-n // MT)
    for x in range(-(-C // CG)):
        for w in range(NW4):
            for i in range(cpw):
                c = x * CG + w * cpw + i
                if c >= C:
                    break
                for b in range(nb):
                    j = b * MT + _LANE.numpy()[:, None] + 32 * np.arange(KC)
                    j = j[j < n]
                    np.add.at(cnt[c], j, 1)
    return cnt


def _cover_regime2(n, C, G):
    """[C, n] counts of the cluster kernel: chain c = CTA / G, rank,
    team, its chunks, warp p, lane l, slot k."""
    cnt = np.zeros((C, n), np.int64)
    nb = -(-n // MT)
    lane = _LANE.numpy()
    for cta in range(C * G):
        c, rank = divmod(cta, G)
        for team in range(TM2):
            for b in range(rank * TM2 + team, nb, G * TM2):
                for p in range(P2):
                    for k in range(KC // P2):
                        j = b * MT + lane + 32 * (k * P2 + p)
                        np.add.at(cnt[c], j[j < n], 1)
    return cnt


@pytest.mark.parametrize("n,C", [(37, 5), (300, 33), (1000, 70)])
def test_every_pair_covered_once(n, C):
    """Each (chain, column) pair is evaluated exactly once by both
    regimes: at every chains-a-warp count of regime 1 (C not a multiple
    of the CTA's chains) and every cluster size of regime 2."""
    for cpw in (1, 2, 4):
        assert (_cover_regime1(n, C, cpw) == 1).all()
    for G in (1, 3, 8, 16):
        assert (_cover_regime2(n, C, G) == 1).all()


def test_potentials_on_grid_one_call_equals_64_rotor_calls():
    """qrot.potentials_on_grid prices all 70 rotors in one B4 call; on the
    CPU (B4's plain version, its chains in blocks) that equals, bit for
    bit, the calls of at most 64 rotors it made before."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=5, n_h2=70, capacity=72, dtype="float64", device="cpu")
    state = metropolis.initialize(state, params, cfg, thermo)
    mols = qrot.rotor_slots(state.mol_alive, params, [systems.h2_bss3()])[0]
    assert len(mols) == 70
    axes = torch.as_tensor(qrot._basis(4, 16, 32)[3][::61])
    G = axes.shape[0]
    alive = state.atom_alive(params)
    one = qrot.potentials_on_grid(state.pos, state.box, alive, params, cfg,
                                  thermo.temperature, mols, axes)
    parts = []
    for r0 in range(0, len(mols), 64):
        mt = torch.as_tensor([int(m) for m in mols[r0:r0 + 64]])
        rows = qrot.grid_rows(state.pos, params, mt, axes)
        t = pairs.mol_pair_pass(
            state.pos, state.box, alive, params, cfg, thermo.temperature,
            mt.repeat_interleave(G),
            row_pos=rows.reshape(-1, rows.shape[2], 3).contiguous(),
            scal=pairs.pair_scalars(state.box, cfg), shared=True)
        parts.append((t.rd + t.es_real).reshape(len(mt), G))
    assert one.shape == (70, G)
    assert torch.equal(one, torch.cat(parts))
    assert torch.isfinite(one).all() and (one != 0).any()
