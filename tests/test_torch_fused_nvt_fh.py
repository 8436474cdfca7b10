"""The port's fused NVT kernel under the Feynman-Hibbs (order 2 and 4) and
Feynman-Kleinert corrections — the plain B3 (ops/cuda/mc_kernel.py on
CPU tensors) — against the JAX package's fused NVT Pallas kernel in
interpret mode (run_steps_multi), on one numpy-made uniform table each:
the same accepts, positions within the f32 tolerance, energy sums within
the tolerances of the classical comparisons
(tests/test_torch_fused_nvt.py), at 77 K on the MOF + H2 system under
nvt: FH2 and FH4 on one chain, FK on two chains at two temperatures;
then the fused chunk's float64 bookkeeping."""
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


def _b3(p, s, c, t, u, temps=None):
    """Reference B3 (interpret, run_steps_multi) and the port's plain B3
    on u [C,K,16]: ((pos, sums [C,4]) of each)."""
    mov, mova, a_max, _ = jmk.movable_mols(p, np.asarray(s.mol_alive))
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    kv, kcoef = jm._fused_ktable(s.box, c, alpha)
    thr = c.cavity_autoreject_absolute
    Cn, K = u.shape[0], u.shape[1]
    temps = temps or (float(t.temperature),) * Cn
    betas = 1.0 / jnp.asarray(temps, jnp.float32)
    bc = lambda x: jnp.broadcast_to(x, (Cn,) + x.shape)  # noqa: E731
    w_pos, w_sums, _, _, _ = jmk.run_steps_multi(
        bc(s.pos), p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
        mova, s.box, rc, alpha, betas, t.move_factor, t.rot_factor,
        thr * thr, jnp.asarray(u[..., :8].reshape(Cn * K, 8)), c, K,
        s.pos.shape[0], a_max=a_max, interpret=True, kvecs=kv, kcoef=kcoef,
        sk_re=bc(s.sk_re), sk_im=bc(s.sk_im),
        mol_mass_atom=jm._fh_mol_mass_atom(p, c))
    P, S, C, T = convert.from_jax(p, s, c, t)
    T = T.replace(temperature=torch.tensor(temps, dtype=torch.float32))
    args, kw = tm.fused_nvt_launch_args(stack_chains([S] * Cn), P, C, T,
                                        torch.as_tensor(u),
                                        tm.nvt_fused_tables(P, S.mol_alive))
    pos, sums, _, _ = tmk.run_steps(*args, **kw)
    assert not sums[:, 4:].any()            # no spinflip without the move
    return (pos.numpy(), sums.numpy()[:, :4]), (np.asarray(w_pos),
                                         np.asarray(w_sums)[:, :4])


@pytest.mark.parametrize("q", ["fh2", "fh4"])
def test_plain_b3_matches_pallas(q):
    """Fused NVT, one chain, a [1, 32, 16] table: equal accepts, positions
    within 1e-4 A, sums within the f32 tolerance."""
    u = np.random.default_rng(7).random((1, 32, 16)).astype(np.float32)
    (pos, sums), (w_pos, w_sums) = _b3(*jax_system("nvt", q), u)
    assert_sums(sums, w_sums, [3])
    assert 3 < w_sums[0, 3] < 32
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


def test_plain_b3_two_chains_at_two_temperatures():
    """FK, C = 2 at 77 and 120 K through run_steps_multi's per-chain
    betas."""
    u = np.random.default_rng(3).random((2, 24, 16)).astype(np.float32)
    (pos, sums), (w_pos, w_sums) = _b3(*jax_system("nvt", "fk"), u,
                                       temps=TEMPS)
    assert_sums(sums, w_sums, [3])
    np.testing.assert_allclose(pos, w_pos, rtol=0, atol=POS_ATOL)


@pytest.mark.parametrize("q", ["fh2", "fk"])
def test_fused_bookkeeping_f64(q):
    """Float64 bookkeeping of the fused chunk under the correction
    (torch_fh.check_fused_bookkeeping_f64)."""
    check_fused_bookkeeping_f64("uvt", q)
