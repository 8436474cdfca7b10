"""What rides on the fused kernels' form instances, on the CPU: B1's XT
instance under a form (cavity bias, TMMC and its bias) against the
reference's B1 in interpret mode; the fused chunks' float64 bookkeeping
on the plain kernels under disp_expansion with its tail (µVT: its
count-dependent delta; NVT; the hybrid NPT with volume moves) and under
coulomb gwp; C chains of one launch each equal to its chain alone; and
the cluster size of a slice that holds the form's planes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.state import stack_chains  # noqa: E402
from torch_npt import lj_npt  # noqa: E402
from torch_rd import jax_rd  # noqa: E402
from torch_rdf import (DISP, POS_ATOL, assert_sums,  # noqa: E402
                       check_fused_bookkeeping_f64, h2_system, mof_system,
                       pallas_b1, port_b1)

torch.set_num_threads(1)
# cavity bias, TMMC and its bias on the 18 A H2 box: 5^3 cells of 3.6 A,
# radius 2 A
XT = dict(cavity_bias=True, cavity_grid=5, cavity_radius=2.0, tmmc=True,
          tmmc_bias=True)
# clusters of G CTAs an H100 SXM holds at once (tests/test_torch_fused_nvt.py)
H100_RESIDENT = {16: 7, 8: 15, 4: 30, 2: 66}


def test_plain_b1_xt_under_a_form_matches_pallas():
    """B1's XT instance carries a form's chains too: sg with cavity bias,
    TMMC and tmmc_bias (a seeded random eta), C = 2, a [2, 48, 16] table:
    the move counts, slot aliveness and TMMC attempt counts equal,
    positions within 1e-4 A, the energy sums within the f32 tolerance."""
    p, s, c, t = h2_system("sg", "uvt")
    c = dataclasses.replace(c, **XT)
    s = jm.initialize(s, p, c, t)
    eta = np.random.default_rng(4).uniform(-1.0, 1.0, p.n_mols_max + 1)
    t = t.replace(tmmc_eta=jnp.asarray(eta, jnp.float32))
    u = np.random.default_rng(23).random((2, 48, 16)).astype(np.float32)
    w_pos, w_sa, w_sums, out = pallas_b1(
        p, s, c, t, u, cav_open=jnp.broadcast_to(s.cavity_open, (2,) +
                                                 s.cavity_open.shape),
        tmmc_eta=t.tmmc_eta)
    pos, sa, sums, kw = port_b1(*convert.from_jax(p, s, c, t), u)
    assert_sums(sums, w_sums, list(range(6, 14)))
    np.testing.assert_array_equal(sa, w_sa)
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)
    d_tm = np.asarray(out[6])
    got_tm = kw["tmmc_out"].numpy()
    R = min(got_tm.shape[1], d_tm.shape[1])
    np.testing.assert_array_equal(got_tm[:, :R, [0, 2]], d_tm[:, :R, [0, 2]])
    assert got_tm[..., [0, 2]].sum() == sums[:, 10:12].sum() > 0


@pytest.mark.parametrize("kind,form", [("uvt", "disp_expansion"),
                                       ("nvt", "disp_expansion"),
                                       ("uvt", "gwp")])
def test_fused_bookkeeping_f64(kind, form):
    """The fused µVT (plain B1) and NVT (plain B3) chunks in float64 on the
    MOF + H2 system under disp_expansion (damped, its tail on: under µVT
    the tail's count-dependent delta) and µVT under coulomb gwp: every
    carried term equals a fresh initialize to 1e-9 after 150 steps; the
    µVT chunks accept inserts or deletes, and the tail (disp_expansion's,
    or LJ's under gwp) is not 0."""
    st, stats = check_fused_bookkeeping_f64(
        mof_system(form, kind, "float64"), kind)
    acc = stats.host().accepts
    if kind == "uvt":
        assert acc[tm.INSERT] + acc[tm.DELETE] > 0
    assert float(st.energy.lrc) != 0.0


def test_fused_npt_bookkeeping_f64():
    """The hybrid fused NPT chunk (plain B3 segments and scan-path volume
    moves) on the LJ fluid mapped to disp_expansion (damped, its tail on)
    in float64: volume moves accepted, the box changed, every carried term
    (the tail in the new box among them) equal to a fresh initialize to
    1e-9."""
    p, s, c, t = lj_npt(pv=0.1)
    p, c = jax_rd(p, c, "disp_expansion", fused_mc=True, **DISP)
    j = (p, jm.initialize(s, p, c, t), c, t)
    st, stats = check_fused_bookkeeping_f64(j, "npt", steps=200)
    assert int(stats.host().accepts[tm.VOLUME]) > 0
    assert not np.array_equal(st.box.numpy(), np.asarray(j[1].box))
    assert float(st.energy.lrc) != 0.0


@pytest.mark.parametrize("kind", ["uvt", "nvt"])
def test_multi_chain_equals_single_chain(kind):
    """C = 3 chains of one plain B1 / B3 launch under sg on the MOF + H2
    system (the reference's tests/test_fused_mc.py:1302 with rd sg): each
    chain's positions and sums equal, bit for bit, its own C = 1 launch on
    its rows of the table."""
    P, S, C, T = convert.from_jax(*mof_system("sg", kind))
    u = torch.as_tensor(np.random.default_rng(31).random((3, 100, 16)),
                        dtype=torch.float32)
    states = stack_chains([S] * 3)
    if kind == "uvt":
        tables = tm.uvt_fused_tables(P, C)

        def launch(st, uu):
            a, kw = tm.fused_uvt_launch_args(st, P, C, T, uu, tables)
            out = tmk.run_steps_uvt(*a, **kw)
            return out[0], out[2]
    else:
        tables = tm.nvt_fused_tables(P, S.mol_alive)

        def launch(st, uu):
            a, kw = tm.fused_nvt_launch_args(st, P, C, T, uu, tables)
            out = tmk.run_steps(*a, **kw)
            return out[0], out[1]
    pos3, sums3 = launch(states, u)
    moved = 0
    for c in range(3):
        pos1, sums1 = launch(stack_chains([S]), u[c:c + 1])
        assert torch.equal(pos1[0], pos3[c]) and torch.equal(sums1[0],
                                                            sums3[c])
        moved += int(not torch.equal(pos3[c], S.pos))
    assert moved == 3


def test_cluster_size_moves_disp_gwp_to_four():
    """disp_expansion with coulomb gwp holds ten column planes: at the
    10.8k bench system in float32 (709 k-vectors, 512 slots) and C = 32,
    G = 2's slice (~235 KB) exceeds the 224 KB allowed, so cluster_size
    takes G = 4 where the classical six planes (~148 KB) fit at G = 2;
    cluster=2 is refused."""
    P, S, C, T = convert.from_jax(*mof_system("disp_expansion"))
    cfg = dataclasses.replace(C, coulomb="gwp")
    assert tmk.slice_planes(cfg) == 10
    assert tmk.slice_planes(dataclasses.replace(cfg, rd_potential="lj",
                                                coulomb="ewald")) == 6
    n, nk, ms = 10797, 709, 512
    f32 = torch.float32
    assert 147e3 < tmk.slice_bytes(n, f32, 2, nk, ms) < 150e3
    assert tmk.slice_bytes(n, f32, 2, nk, ms, planes=10) > 230e3
    assert tmk.cluster_size(32, n, f32, H100_RESIDENT, nk, ms) == 2
    assert tmk.cluster_size(32, n, f32, H100_RESIDENT, nk, ms,
                            planes=10) == 4
    assert tmk.fitting_cluster_sizes(n, f32, nk, ms, planes=10) == [4, 8, 16]
    with pytest.raises(ValueError, match="cluster=2 needs"):
        tmk._check_cluster(2, n, f32, nk, ms, "run_steps_uvt", planes=10)
