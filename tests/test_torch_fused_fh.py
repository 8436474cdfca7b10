"""The port's fused µVT kernel under the Feynman-Hibbs (order 2 and 4) and
Feynman-Kleinert corrections — the plain B1 (ops/cuda/mc_kernel.py on
CPU tensors) — against the JAX package's fused µVT Pallas kernel in
interpret mode, on one numpy-made uniform table each: the same
decisions, positions within the f32 tolerance, energy sums within the
tolerances of the classical comparisons (tests/test_torch_fused_uvt.py),
at 77 K on the MOF + H2 system (mof_h2_gcmc(n_side=4), a frozen
framework partner of huge molecular mass included): FH2 and FK on one
chain, FH4 on two chains at two temperatures; then the fused chunk's
float64 bookkeeping.  B3 under the corrections:
tests/test_torch_fused_nvt_fh.py; B6: tests/test_torch_fh.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.state import stack_chains  # noqa: E402
from torch_fh import (POS_ATOL, TEMPS, assert_sums,  # noqa: E402
                      check_fused_bookkeeping_f64, jax_system)

torch.set_num_threads(1)


def _b1(p, s, c, t, u, temps=None):
    """Reference B1 (interpret) and the port's plain B1 on u [C,K,16]:
    ((pos, slot_alive, sums) of each)."""
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, c)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, c, A_list, rep)
    thr = c.cavity_autoreject_absolute
    Cn, K = u.shape[0], u.shape[1]
    bc = lambda x: jnp.broadcast_to(x, (Cn,) + x.shape)  # noqa: E731
    betas = None if temps is None else 1.0 / jnp.asarray(temps, jnp.float32)
    want = jmk.run_steps_uvt_multi(
        bc(s.pos), p.eps, p.sig, p.charge, p.mass, bc(s.atom_alive(p)),
        start, spidx, bc(s.mol_alive[slots]), tmpl, s.box, rc, alpha,
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u.reshape(Cn * K, 16)), c, K, s.pos.shape[0],
        A_list=A_list, interpret=True, kvecs=k[5], kcoef=k[6],
        sk_re=bc(s.sk_re), sk_im=bc(s.sk_im),
        mol_mass_atom=jm._fh_mol_mass_atom(p, c), betas=betas)
    P, S, C, T = convert.from_jax(p, s, c, t)
    if temps is not None:
        T = T.replace(temperature=torch.tensor(temps, dtype=torch.float32))
    args, kw = tm.fused_uvt_launch_args(stack_chains([S] * Cn), P, C, T,
                                        torch.as_tensor(u),
                                        tm.uvt_fused_tables(P, C))
    assert kw["mol_mass"] is P.mol_mass_atom
    got = tmk.run_steps_uvt(*args, **kw)
    return ((got[0].numpy(), got[1].numpy(), got[2].numpy()),
            tuple(np.asarray(x) for x in want[:3]))


@pytest.mark.parametrize("q", ["fh2", "fk"])
def test_plain_b1_matches_pallas(q):
    """One chain, a [1, 32, 16] table: equal move counts and slot
    aliveness, positions within 1e-4 A, energy sums within the f32
    tolerance — with insertions and deletions among the accepted moves."""
    u = np.random.default_rng(5).random((1, 32, 16)).astype(np.float32)
    (pos, sa, sums), (w_pos, w_sa, w_sums) = _b1(*jax_system("uvt", q), u)
    assert_sums(sums, w_sums, list(range(6, 14)))
    assert w_sums[0, 6:9].sum() > 3 and w_sums[0, 7:9].sum() > 0
    np.testing.assert_array_equal(sa, w_sa)
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


def test_plain_b1_two_chains_at_two_temperatures():
    """FH4, C = 2 at 77 and 120 K (a beta per chain, which the quantum
    terms take): each chain as the reference's."""
    u = np.random.default_rng(9).random((2, 24, 16)).astype(np.float32)
    (pos, sa, sums), (w_pos, w_sa, w_sums) = _b1(*jax_system("uvt", "fh4"), u,
                                                 temps=TEMPS)
    assert_sums(sums, w_sums, list(range(6, 14)))
    np.testing.assert_array_equal(sa, w_sa)
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


@pytest.mark.parametrize("q", ["fh4", "fk"])
def test_fused_bookkeeping_f64(q):
    """Float64 bookkeeping of the fused chunk under the correction
    (torch_fh.check_fused_bookkeeping_f64)."""
    check_fused_bookkeeping_f64("uvt", q)
