"""The port's Thole static fields and per-move deltas
(mpmc_tpu_torch/ops/thole.py) against the JAX package in float64: the
Wolf and Ewald field variants, move_deltas for every move type and
variant, the tile-cull tables, and total_energy with the polar term."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import thole as jt  # noqa: E402
from mpmc_tpu.state import mol_rows as jmol_rows  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402
from mpmc_tpu_torch.ops import thole as tt  # noqa: E402
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk  # noqa: E402
from mpmc_tpu_torch.state import mol_rows_update  # noqa: E402
from torch_polar import cloud, mof_polar, to_np  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["wolf", "ewald"])
def test_static_field_variants_match_jax(variant):
    """The Wolf-shifted and the full-Ewald static fields (plain PyTorch in
    the port, as in the reference) against JAX: rel 1e-12 of max |E|."""
    kw = {"polar_wolf": True} if variant == "wolf" else {"polar_ewald": True}
    (p, s, c, t), (P, S, C, T) = mof_polar(**kw)
    want = np.asarray(jt.static_field(s.pos, s.box, s.atom_alive(p), p, c))
    got = to_np(tt.static_field(S.pos, S.box, S.atom_alive(P), P, C))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# ---------------------------------------------------------------------------
# per-move deltas
# ---------------------------------------------------------------------------

MOVE_CASES = [(v, m, r) for v in ("direct", "wolf", "ewald")
              for m in ("displace", "insert", "delete") for r in (True, False)]


@pytest.mark.parametrize("variant,move,resid", MOVE_CASES,
                         ids=[f"{v}-{m}-{'resid' if r else 'field'}"
                              for v, m, r in MOVE_CASES])
def test_move_deltas_matches_jax(variant, move, resid):
    """thole.move_deltas (the O(A N) static field and initial CG residual
    of a trial) against JAX's for a displacement, an insertion and a
    deletion, with and without the residual, for the three field
    variants: abs 1e-10.  The fused form equals the port's sequential
    field_delta + residual_delta, and the field equals a full rebuild of
    the post-move configuration."""
    kw = {"direct": {}, "wolf": {"polar_wolf": True},
          "ewald": {"polar_ewald": True}}[variant]
    (p, s, c, t), (P, S, C, T) = mof_polar(**kw)
    mol = int(np.asarray(p.mol_frozen).argmin())
    if move == "insert":
        mol = int(np.asarray(~s.mol_alive & (p.mol_species == 0)).argmax())
        rows = np.broadcast_to([4.1, 5.2, 6.3],
                               jmol_rows(s.pos, p, mol).shape).copy()
    else:
        rows = np.asarray(jmol_rows(s.pos, p, mol)) + [[0.3, -0.2, 0.15]]
    mkw = ({"new_rows": rows} if move == "displace"
           else {"new_rows": rows, "insert": True} if move == "insert"
           else {"delete": True})
    jkw = {k: (jnp.asarray(v) if k == "new_rows" else v)
           for k, v in mkw.items()}
    tkw = {k: (torch.as_tensor(v) if k == "new_rows" else v)
           for k, v in mkw.items()}
    alive, A = s.atom_alive(p), S.atom_alive(P)
    e0_j, r_j = jt.move_deltas(s.pos, s.box, alive, p, c, mol, s.e0, s.mu,
                               s.r_pol, with_residual=resid,
                               sk=(s.sk_re, s.sk_im), **jkw)
    e0_t, r_t = tt.move_deltas(S.pos, S.box, A, P, C, torch.tensor(mol),
                               S.e0, S.mu, S.r_pol, with_residual=resid,
                               sk=(S.sk_re, S.sk_im), **tkw)
    np.testing.assert_allclose(to_np(e0_t), np.asarray(e0_j), rtol=0,
                               atol=1e-10)
    e0_seq = tt.field_delta(S.pos, S.box, A, P, C, mol, S.e0, **tkw)
    np.testing.assert_allclose(to_np(e0_t), to_np(e0_seq), rtol=0,
                               atol=1e-12)
    if resid:
        np.testing.assert_allclose(to_np(r_t), np.asarray(r_j), rtol=0,
                                   atol=1e-10)
        r_seq = tt.residual_delta(S.pos, S.box, A, P, C, mol, S.mu,
                                  S.r_pol, S.e0, e0_seq, **tkw)
        np.testing.assert_allclose(to_np(r_t), to_np(r_seq), rtol=0,
                                   atol=1e-12)
    else:
        assert r_t is None
    # the field of the post-move configuration, rebuilt in full
    pos_new, alive_new = S.pos.clone(), A.clone()
    own = (P.mol_id == mol) & P.atom_ok
    if move == "delete":
        alive_new &= ~own
    else:
        pos_new = mol_rows_update(pos_new, P, mol, tkw["new_rows"])
        alive_new |= own
    full = tt.static_field(pos_new, S.box, alive_new, P, C)
    keep = to_np(alive_new)
    np.testing.assert_allclose(to_np(e0_t)[keep], to_np(full)[keep],
                               rtol=0, atol=1e-10)


def test_cull_tables_match_jax_and_are_conservative():
    """cull_perm equals JAX's; cull_visit at the port's 128 x 128 tiles
    equals JAX's table for the same tiles on this input (the port's rc is
    inflated by a few units in the last place, so it may only visit
    more), and every tile it skips holds no pair inside rc (brute force,
    float64)."""
    pos, ok, _, _, _, L = cloud(n=700, L=40.0, seed=1)
    box, rc = np.eye(3) * L, 9.0
    perm_j, inv_j = jt.cull_perm(jnp.asarray(pos), jnp.asarray(box),
                                 jnp.asarray(ok), jnp.asarray(rc))
    perm_t, inv_t = tt.cull_perm(torch.as_tensor(pos), torch.as_tensor(box),
                                 torch.as_tensor(ok), torch.tensor(rc))
    np.testing.assert_array_equal(to_np(perm_t), np.asarray(perm_j))
    np.testing.assert_array_equal(to_np(inv_t), np.asarray(inv_j))
    pos_s, ok_s = pos[to_np(perm_t)], ok[to_np(perm_t)]
    n_pad, ni, nj = tk.grid_shape(len(pos))
    want = np.asarray(jt.cull_visit(jnp.asarray(pos_s), jnp.asarray(ok_s),
                                    jnp.asarray(box), jnp.asarray(rc),
                                    tk.TI, tk.TJ, n_pad))
    got = to_np(tt.cull_visit(torch.as_tensor(pos_s),
                              torch.as_tensor(ok_s), torch.as_tensor(box),
                              torch.tensor(rc)))
    assert got.shape == (ni, nj) and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)
    p = np.concatenate([pos_s, np.zeros((n_pad - len(pos), 3))])
    o = np.concatenate([ok_s, np.zeros(n_pad - len(pos), bool)])
    d = p[:, None, :] - p[None, :, :]
    d -= L * np.round(d / L)
    inside = ((d * d).sum(-1) < rc * rc) & o[:, None] & o[None, :]
    np.fill_diagonal(inside, False)
    blocks = inside.reshape(ni, tk.TI, nj, tk.TJ).any(axis=(1, 3))
    assert not (blocks & (got == 0)).any()


# ---------------------------------------------------------------------------
# the polar energy term
# ---------------------------------------------------------------------------

ENERGY_CASES = (("direct", "cg"), ("direct", "jacobi"), ("direct", "direct"),
                ("wolf", "cg"), ("ewald", "cg"))


@pytest.mark.parametrize("variant,solver", ENERGY_CASES,
                         ids=[f"{v}-{s}" for v, s in ENERGY_CASES])
def test_total_energy_polar_matches_jax(variant, solver):
    """total_energy with polarization against JAX's, every term rel 1e-10,
    with aux's mu, e0, polar_iters and the re-grounded residual r_pol."""
    kw = {"direct": {}, "wolf": {"polar_wolf": True},
          "ewald": {"polar_ewald": True}}[variant]
    (p, s, c, t), (P, S, C, T) = mof_polar(polar_solver=solver,
                                          polar_precision=1e-10, **kw)
    e_j, aux_j = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t)
    e_t, aux_t = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T)
    assert float(e_j.polar) < 0
    for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
              "polar", "vdw"):
        assert float(getattr(e_t, k)) == pytest.approx(
            float(getattr(e_j, k)), rel=1e-10, abs=1e-9), k
    assert aux_t["polar_iters"] == int(aux_j["polar_iters"])
    for k in ("mu", "e0", "r_pol"):
        if k not in aux_j:
            assert k not in aux_t
            continue
        np.testing.assert_allclose(to_np(aux_t[k]), np.asarray(aux_j[k]),
                                   rtol=0, atol=1e-10)
    assert ("r_pol" in aux_t) == (solver == "cg")
