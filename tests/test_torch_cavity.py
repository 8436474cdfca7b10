"""Cavity-biased insertion in the port against the JAX package: the open-
cell grid, the plain B1 (one chain and two) and B6 with cavity bias, TMMC
and its flat-histogram bias against the Pallas kernels in interpret mode on
injected uniforms, and the scan path against the plain B1 on the same
rows.  The runs of the reference's cavity tests are in
tests/test_torch_cavity_runs.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import moves as jmoves  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops import thole as jthole  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.state import stack_chains  # noqa: E402

torch.set_num_threads(1)
# cavity bias, TMMC and its bias on the 16 A test box: 5^3 cells of 3.2 A,
# radius 2 A (the framework closes some cells, the pores stay open)
XT = dict(cavity_bias=True, cavity_grid=5, cavity_radius=2.0, tmmc=True,
          tmmc_bias=True)
# plain B1 (f64 sums, exact erfc) against the Pallas kernel (f32 sums, the
# A&S erfc): tests/test_torch_fused_uvt.py's rule for the energy sums
F32_SUM_ATOL, F32_SUM_RTOL = 5e-2, 1e-4


def _eta(n, seed=4):
    """A seeded random bias table: a wrong row of it changes decisions."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n).astype(
        np.float32)


def _jax_xt_system(pressure=20.0):
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      pressure=pressure)
    c = dataclasses.replace(c, fused_mc=True, **XT)
    s = jm.initialize(s, p, c, t)
    t = t.replace(tmmc_eta=jnp.asarray(_eta(p.n_mols_max + 1)))
    return p, s, c, t


def _sum_a_tol(n, beta):
    """The rule for the Sigma a columns, plain against Pallas: a =
    min(1, e^{ln t}) moves by at most beta |d du| per attempt, |d du| <=
    F32_SUM_ATOL (the energy sums' rule), plus the float32 rounding of
    ln t itself (1e-6)."""
    return n * (beta * F32_SUM_ATOL + 1e-6)


def _grids(dtype, grid, radius):
    """(the port's grid, the reference's, a float64 numpy one) on a
    jittered MOF + H2 state (no centre at an exact tie)."""
    P, S, _, _ = tsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      dtype=dtype, device="cpu")
    S = tsystems.jittered(P, S, 3)
    alive = S.atom_alive(P)
    got = tmoves.cavity_open_grid(S.pos, S.box, alive, grid, radius)
    want = np.asarray(jmoves.cavity_open_grid(
        jnp.asarray(S.pos.numpy()), jnp.asarray(S.box.numpy()),
        jnp.asarray(alive.numpy()), grid,
        jnp.asarray(radius, S.pos.numpy().dtype)))
    ii = np.arange(grid)
    fr = (np.stack(np.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(
        -1, 3) + 0.5) / grid
    box = S.box.numpy().astype(np.float64)
    dr = (fr @ box)[:, None, :] - S.pos.numpy().astype(np.float64)[None]
    f = dr @ np.linalg.inv(box)
    dr = (f - np.round(f)) @ box
    near = ((dr ** 2).sum(-1) < radius ** 2) & alive.numpy()[None]
    return got, want, ~near.any(1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("grid,radius", [(5, 2.0), (6, 2.0), (8, 1.5)])
def test_cavity_grid_matches_reference(dtype, grid, radius):
    """moves.cavity_open_grid of the port equals the reference's bool for
    bool, and a float64 numpy grid, on a jittered MOF + H2 state: grids of
    125, 216 and 512 cells, which the reference's 256-cell blocks tile."""
    got, want, exact = _grids(dtype, grid, radius)
    assert got.dtype == torch.bool and got.shape == (grid ** 3,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exact)
    assert 0 < want.sum() < grid ** 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cavity_grid_of_1000_cells_fixes_the_reference_last_block(dtype):
    """The default grid (10^3 cells): the port equals the float64 numpy
    grid cell for cell.  The reference's last 256-cell block starts at
    768, past 1000 - 256, so jax's dynamic_slice clamps it to 744 and
    cells 768..999 get the flags of 744..975 (ROADMAP, reference traps):
    the port keeps the reference's first 768 cells and not that shift."""
    got, want, exact = _grids(dtype, 10, 2.5)
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(want[:768], exact[:768])
    np.testing.assert_array_equal(want[768:], exact[744:976])
    assert (want[768:] != exact[768:]).any()


def test_pack_cavity_lists_open_cells_in_order():
    m = torch.zeros((2, 27), dtype=torch.bool)
    m[0, [3, 5, 26]] = True
    lst, n = tmk.pack_cavity(m)
    assert n.tolist() == [3, 0] and lst.dtype == torch.int32
    assert lst[0, :3].tolist() == [3, 5, 26]
    assert lst[0, 3:].abs().sum() == 0 and lst[1].abs().sum() == 0


def _pallas_b1(p, s, c, t, u):
    """The reference B1 (interpret mode) on u [C, K, 16]: (pos, slot
    alive, sums, d_tmmc), one chain or run_steps_uvt_multi's C."""
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, c)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, c, A_list, rep)
    thr = c.cavity_autoreject_absolute
    C, K = u.shape[0], u.shape[1]
    common = dict(A_list=A_list, interpret=True, kvecs=k[5], kcoef=k[6],
                  tmmc_eta=t.tmmc_eta)
    if C == 1:
        out = jmk.run_steps_uvt(
            s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start,
            spidx, s.mol_alive[slots], tmpl, s.box, rc, alpha,
            1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
            t.insert_probability, k[4], k[0], k[1], k[2], k[3],
            jnp.asarray(u[0]), c, K, s.pos.shape[0], sk_re=s.sk_re,
            sk_im=s.sk_im, cav_open=s.cavity_open, **common)
        return [np.asarray(x)[None] for x in (out[0], out[1], out[2],
                                              out[6])]
    b = lambda x: jnp.broadcast_to(x, (C,) + x.shape)  # noqa: E731
    out = jmk.run_steps_uvt_multi(
        b(s.pos), p.eps, p.sig, p.charge, p.mass, b(s.atom_alive(p)), start,
        spidx, b(s.mol_alive[slots]), tmpl, s.box, rc, alpha,
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u.reshape(C * K, 16)), c, K, s.pos.shape[0],
        sk_re=b(s.sk_re), sk_im=b(s.sk_im), cav_open=b(s.cavity_open),
        **common)
    return [np.asarray(x) for x in (out[0], out[1], out[2], out[6])]


@pytest.mark.parametrize("chains", [1, 2])
def test_plain_b1_cavity_tmmc_matches_pallas(chains):
    """Numpy-made [C, 200, 16] tables through the reference's B1 in
    interpret mode (cavity bias, TMMC, tmmc_bias with a random eta) and
    the port's plain B1: equal move counts, slot aliveness and TMMC
    attempt counts, positions within 4e-6 A, the energy sums within the
    f32 rule, the Sigma a columns within _sum_a_tol."""
    p, s, c, t = _jax_xt_system()
    K = 200
    u = np.random.default_rng(20 + chains).random(
        (chains, K, 16)).astype(np.float32)
    pos, sa, sums, d_tm = _pallas_b1(p, s, c, t, u)
    P, S, C, T = convert.from_jax(p, s, c, t)
    assert int(S.cavity_open.sum()) == int(np.asarray(s.cavity_open).sum())
    states = stack_chains([S] * chains)
    args, kw = tm.fused_uvt_launch_args(states, P, C, T, torch.as_tensor(u),
                                        tm.uvt_fused_tables(P, C))
    g_pos, g_sa, g_sums, _, _ = tmk.run_steps_uvt(*args, **kw)
    got_tm = kw["tmmc_out"].numpy()
    beta = 1.0 / float(T.temperature)
    R = got_tm.shape[1]
    for ch in range(chains):
        g, w = g_sums[ch].numpy(), sums[ch]
        np.testing.assert_array_equal(g[6:12], w[6:12])
        np.testing.assert_allclose(g[:6], w[:6], rtol=F32_SUM_RTOL,
                                   atol=F32_SUM_ATOL)
        np.testing.assert_array_equal(g_sa[ch].numpy(), sa[ch])
        np.testing.assert_allclose(g_pos[ch].numpy(), pos[ch], rtol=0,
                                   atol=4e-6)
        want_tm = np.zeros((R, 4))
        want_tm[:min(R, d_tm.shape[1])] = d_tm[ch][:R]
        np.testing.assert_array_equal(got_tm[ch][:, [0, 2]],
                                      want_tm[:, [0, 2]])
        assert np.all(np.abs(got_tm[ch][:, [1, 3]] - want_tm[:, [1, 3]])
                      <= _sum_a_tol(want_tm[:, [0, 2]], beta))
        # every insert and delete attempt is collected, some accepted
        assert got_tm[ch][:, [0, 2]].sum() == g[10:12].sum()
        assert g[7] + g[8] > 0 and got_tm[ch][:, [1, 3]].sum() > 0.5


def _jax_polar_xt():
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=10,
                                      polarization=True, pressure=20.0)
    c = dataclasses.replace(c, polar_delayed=True, fused_mc=True, **XT)
    s = jm.initialize(s, p, c, t)
    t = t.replace(tmmc_eta=jnp.asarray(_eta(p.n_mols_max + 1, 7)))
    return p, s, c, t


def _pallas_b6(p, s, c, t, u):
    """The reference B6 (interpret mode) on u [K, 16] with cavity bias and
    the tilts eta(N +- 1) - eta(N) at the state's N."""
    cfg = jmk.pda_effective_cfg(c, p)
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, cfg)
    rc = jpairs.derived_cutoff(s.box, cfg)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, cfg, A_list, rep)
    paf, pkrc = jthole._field_variant_consts(s.box, cfg, cfg.jdtype)
    thr = cfg.cavity_autoreject_absolute
    eta = np.asarray(t.tmmc_eta)
    n = int(np.asarray(s.mol_alive & (p.mol_species == 0)).sum())
    de = [eta[min(max(n + d, 0), len(eta) - 1)] - eta[n] for d in (1, -1)]
    return np.asarray(jmk.run_steps_uvt_pda(
        s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start, spidx,
        s.mol_alive[slots], tmpl, s.box, rc, jpairs.derived_alpha(rc, cfg),
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u, jnp.float32), cfg, u.shape[0], s.pos.shape[0],
        A_list=A_list, e0=s.e0, polar=p.polar, polar_damp=cfg.polar_damp,
        interpret=True, kvecs=k[5], kcoef=k[6], sk_re=s.sk_re, sk_im=s.sk_im,
        polar_field_alpha=0.0 if paf is None else paf,
        polar_field_krc=0.0 if pkrc is None else pkrc,
        cav_open=s.cavity_open, d_eta_ins=de[0], d_eta_del=de[1]),
        np.float64)


def test_plain_b6_cavity_matches_pallas():
    """B6 with cavity bias and the tmmc_bias tilt: tables whose step 0
    survives (each move type) and tables of natural coins, through the
    reference's kernel in interpret mode and the port's plain B6 — equal
    records (tests/torch_pda.py's rule), an insert's trial rows inside an
    open cell of the grid."""
    from torch_pda import LANE8, SEG, assert_records_match
    p, s, c, t = _jax_polar_xt()
    P, S, C, T = convert.from_jax(p, s, c, t)
    cfg = tmk.pda_effective_cfg(C, P)
    tables = tm.uvt_fused_tables(P, cfg)
    rng = np.random.default_rng(31)
    g = C.cavity_grid
    open_mask = S.cavity_open.numpy()
    binv = np.linalg.inv(S.box.numpy())

    def both(u):
        args, kw = tm.pda_launch_args(S, P, cfg, T, torch.as_tensor(u),
                                      tables)
        got = tmk.run_steps_uvt_pda(*args, **kw).numpy()
        want = _pallas_b6(p, s, c, t, u)
        assert_records_match(got, want)
        return got

    for mt, lane8 in LANE8.items():
        for _ in range(12):
            u = rng.random((SEG, 16)).astype(np.float32)
            u[0, 4], u[0, 8] = 1e-30, lane8
            rec = both(u)
            if rec[0, 1] > 0.5:
                break
        assert rec[0, 1] > 0.5 and rec[0, 2] == mt
        if mt == 1:
            com = rec[2:5, :2].mean(1)              # H2's two H sites
            frac = com @ binv % 1.0
            ijk = np.minimum((frac * g).astype(int), g - 1)
            assert open_mask[(ijk[0] * g + ijk[1]) * g + ijk[2]]
    froze = [int(both(rng.random((SEG, 16)).astype(np.float32))[0, 0])
             for _ in range(4)]
    assert max(froze) > 1


def test_scan_path_makes_plain_b1_decisions_f64():
    """The scan path's cavity-biased insert, its +-ln(n_open/G^3) and the
    TMMC collection with its tilt read the uniform lanes as B1 does: on
    one [300, 16] table in float64 the scan chunk and the plain B1 chunk
    end with the same aliveness, positions within 1e-9 A and TMMC
    matrices within 1e-9."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      dtype="float64", pressure=20.0,
                                      device="cpu")
    C = dataclasses.replace(C, **XT)
    S = tm.initialize(tsystems.jittered(P, S, 5), P, C, T)
    T = T.replace(tmmc_eta=torch.as_tensor(_eta(P.n_mols_max + 1),
                                           dtype=torch.float64))
    u = torch.as_tensor(np.random.default_rng(8).random((300, 16)))
    a, sa = tm.run_chunk(S, P, C, T, 300, uniforms=u)
    b, sb = tm.run_chunk_fused_uvt(S, P, C, T, 300, uniforms=u)
    assert torch.equal(a.mol_alive, b.mol_alive)
    np.testing.assert_array_equal(sa.attempts, sb.attempts)
    np.testing.assert_array_equal(sa.host().accepts, sb.host().accepts)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-9)
    np.testing.assert_allclose(a.tmmc_c.numpy(), b.tmmc_c.numpy(),
                               atol=1e-9)
    acc = sa.host().accepts
    assert acc[tm.INSERT] > 0 and acc[tm.DELETE] > 0
    assert a.tmmc_c[:, [0, 2]].sum() == sa.attempts[1:3].sum()
