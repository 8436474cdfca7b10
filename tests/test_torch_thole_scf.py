"""The port's SCF solve (mpmc_tpu_torch/ops/thole.py solve_scf) against the
JAX package in float64: CG in residual and dipole mode, Jacobi, the
direct solve, warm starts and the tile-culled CG, with equal iteration
counts; the dipole-mode do-while; the zodid surrogate and the
polarizability tensor."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.ops import thole as jt  # noqa: E402
from mpmc_tpu.state import mol_rows as jmol_rows  # noqa: E402
from mpmc_tpu_torch.ops import thole as tt  # noqa: E402
from torch_polar import mof_polar, to_np  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# SCF solvers
# ---------------------------------------------------------------------------

SCF_CASES = ("cg", "cg-dipole", "jacobi", "direct", "cg-warm",
             "cg-dipole-warm", "cg-cull")


@pytest.mark.parametrize("case", SCF_CASES)
def test_solve_scf_matches_jax(case):
    """solve_scf against JAX's: Jacobi-preconditioned CG in residual and
    dipole mode, relaxed Jacobi and the direct solve, cold and warm
    (mu0 and the move's r0 from move_deltas), and the tile-culled CG
    (explicit 7 A cutoff on a 463-site system, cell-sorted with a visit
    table) against JAX's dense CG: equal iteration counts, mu and the
    residual to 1e-9."""
    kw = {"polar_solver": case.split("-")[0] if case != "cg-cull" else "cg",
          "polar_precision": 1e-9}
    if "dipole" in case:
        kw.update(polar_precision_mode="dipole", polar_precision=1e-7)
    if case == "jacobi":
        kw.update(polar_max_iter=12, polar_gamma=0.9)
    sys_kw = {}
    if case == "cg-cull":
        sys_kw = dict(n_side=7, n_h2=20, capacity=40)
        kw["cutoff"] = 7.0
    (p, s, c, t), (P, S, C, T) = mof_polar(**sys_kw, **kw)
    if case == "cg-cull":
        assert tt.cull_supported(C) and not jt._cull_enabled(c)
        pol_ok = S.atom_alive(P) & (P.polar > 0)
        perm, _ = tt.cull_perm(S.pos, S.box, pol_ok, torch.tensor(7.0))
        visit = tt.cull_visit(S.pos[perm], pol_ok[perm], S.box,
                              torch.tensor(7.0))
        assert 0 < float(visit.float().mean()) < 1
    alive, A = s.atom_alive(p), S.atom_alive(P)
    e0_j, e0_t = s.e0, S.e0
    mu0_j = mu0_t = r0_j = r0_t = None
    if "warm" in case:
        mol = int(np.asarray(p.mol_frozen).argmin())
        rows = np.asarray(jmol_rows(s.pos, p, mol)) + [[0.3, -0.2, 0.15]]
        e0_j, r0_j = jt.move_deltas(s.pos, s.box, alive, p, c, mol, s.e0,
                                    s.mu, s.r_pol, new_rows=jnp.asarray(rows))
        e0_t, r0_t = tt.move_deltas(S.pos, S.box, A, P, C, mol, S.e0, S.mu,
                                    S.r_pol, new_rows=torch.as_tensor(rows))
        mu0_j, mu0_t = s.mu, S.mu
    mu_j, it_j, r_j = jt.solve_scf(s.pos, s.box, alive, p, c, e0_j, mu0_j,
                                   r0_j)
    mu_t, it_t, r_t = tt.solve_scf(S.pos, S.box, A, P, C, e0_t, mu0_t, r0_t)
    assert it_t == int(it_j)
    if case == "jacobi":
        assert it_t == 12
    elif case != "direct":
        assert 0 < it_t < C.polar_max_iter
    assert np.abs(np.asarray(mu_j)).max() > 1e-4
    np.testing.assert_allclose(to_np(mu_t), np.asarray(mu_j), rtol=0,
                               atol=1e-9)
    if r_j is None:
        assert r_t is None
    else:
        np.testing.assert_allclose(to_np(r_t), np.asarray(r_j), rtol=0,
                                   atol=1e-9)


def test_dipole_mode_applies_one_iteration_when_converged():
    """Dipole mode is a do-while: a warm start at the fixed point still
    takes one iteration; residual mode takes none (as in JAX)."""
    for mode, want in (("dipole", 1), ("residual", 0)):
        (p, s, c, t), (P, S, C, T) = mof_polar(
            polar_precision_mode=mode, polar_precision=1e-3)
        _, it_j, _ = jt.solve_scf(s.pos, s.box, s.atom_alive(p), p, c, s.e0,
                                  s.mu, s.r_pol)
        _, it_t, _ = tt.solve_scf(S.pos, S.box, S.atom_alive(P), P, C, S.e0,
                                  S.mu, S.r_pol)
        assert it_t == int(it_j) == want


def test_zodid_and_polarizability_tensor_match_jax():
    """The delayed-acceptance surrogate and the system polarizability
    tensor against JAX: rel 1e-10."""
    (p, s, c, t), (P, S, C, T) = mof_polar(polar_precision=1e-10)
    alive, A = s.atom_alive(p), S.atom_alive(P)
    assert float(tt.zodid_energy(S.e0, A, P)) == pytest.approx(
        float(jt.zodid_energy(s.e0, alive, p)), rel=1e-10)
    want = np.asarray(jt.polarizability_tensor(s.pos, s.box, alive, p, c))
    got = to_np(tt.polarizability_tensor(S.pos, S.box, A, P, C))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert np.trace(want) > 0


