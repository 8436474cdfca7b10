"""The plain version of B5, the Thole field kernel
(mpmc_tpu_torch/ops/cuda/thole_kernel.py), against the JAX package: the
Pallas kernel in interpret mode and the jnp fields of mpmc_tpu/ops/thole.py,
in both modes, for the three damping types, in orthorhombic and skewed
cells, with and without a tile-visit table."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.ops import thole as jt  # noqa: E402
from mpmc_tpu.ops.pallas import thole_kernel as ptk  # noqa: E402
from mpmc_tpu_torch.ops import thole as tt  # noqa: E402
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk  # noqa: E402
from torch_polar import cell, cloud, mof_polar, to_np  # noqa: E402

torch.set_num_threads(1)

LAM = 2.1304


B5_CASES = [(m, d, tri) for m in ("charge", "dipole")
            for d in ("exponential", "linear", "none")
            for tri in (False, True)]


@pytest.mark.parametrize("mode,damp,tri", B5_CASES,
                         ids=[f"{m}-{d}-{'tri' if t else 'ortho'}"
                              for m, d, t in B5_CASES])
def test_b5_plain_matches_pallas_interpret(mode, damp, tri):
    """B5's plain version against the Pallas kernel in interpret mode, on
    the same float32 inputs and the same 128 x 128 tiles, with and without
    a visit table: the cell-sorted cull table at rc 9 A (orthorhombic) or a
    random table (triclinic; the kernel skips the same tiles either way).
    The Pallas kernel computes in float32 with rsqrt-derived reciprocals;
    the plain version runs in float64 on the float32-rounded inputs, so
    they agree to a few float32 roundings of the largest pair term:
    |d| <= 2e-5 x max |E|.  Orthorhombic: the culled plain field equals
    the dense one bit for bit."""
    pos, ok, q, mu, mol, L = cloud()
    box = cell(L, tri)
    rc = 9.0
    f32 = lambda a: np.asarray(a, np.float32)
    src = q if mode == "charge" else mu
    n_pad, ni, nj = tk.grid_shape(len(pos))
    if tri:
        visit = np.random.default_rng(4).integers(0, 2, (ni, nj))
    else:
        perm, _ = tt.cull_perm(torch.as_tensor(f32(pos)).double(),
                               torch.as_tensor(box), torch.as_tensor(ok),
                               torch.tensor(rc))
        perm = perm.numpy()
        pos, ok, src, mol = pos[perm], ok[perm], src[perm], mol[perm]
        visit = tt.cull_visit(torch.as_tensor(f32(pos)), torch.as_tensor(ok),
                              torch.as_tensor(f32(box)),
                              torch.tensor(rc)).numpy()
        assert 0 < visit.mean() < 1
    pallas = ptk.charge_field if mode == "charge" else ptk.dipole_field
    plain = (tk.charge_field_plain if mode == "charge"
             else tk.dipole_field_plain)
    outs = []
    for vis in (None, visit):
        want = np.asarray(pallas(
            jnp.asarray(f32(pos)), jnp.asarray(f32(box)), jnp.asarray(ok),
            jnp.asarray(f32(src)), jnp.asarray(mol, jnp.int32),
            jnp.asarray(rc, jnp.float32), jnp.asarray(LAM, jnp.float32),
            damp, interpret=True, ortho=not tri,
            visit=None if vis is None else jnp.asarray(vis, jnp.int32),
            ti_size=tk.TI, tj_size=tk.TJ), np.float64)
        got = plain(torch.as_tensor(f32(pos)).double(),
                    torch.as_tensor(f32(box)).double(), torch.as_tensor(ok),
                    torch.as_tensor(f32(src)).double(),
                    torch.as_tensor(mol, dtype=torch.int32),
                    torch.tensor(rc), LAM, damp, ortho=not tri,
                    visit=None if vis is None
                    else torch.as_tensor(vis, dtype=torch.int32)).numpy()
        scale = np.abs(got).max()
        assert scale > 0
        assert np.abs(got - want).max() <= 2e-5 * scale
        outs.append(got)
    if not tri:
        np.testing.assert_array_equal(outs[0], outs[1])
    else:
        assert not np.array_equal(outs[0], outs[1])


JNP_CASES = [(d, tri) for d in ("exponential", "linear", "none")
             for tri in (False, True)]


@pytest.mark.parametrize("damp,tri", JNP_CASES,
                         ids=[f"{d}-{'tri' if t else 'ortho'}"
                              for d, t in JNP_CASES])
def test_b5_plain_matches_jnp_fields(damp, tri):
    """static_field_direct (B5 charge mode) and dipole_matvec (B5 dipole
    mode) of the port against the JAX package's jnp path, on the polar MOF
    system in an orthorhombic or a skewed cell: rel 1e-12 of max |E|."""
    (p, s, c, t), (P, S, C, T) = mof_polar(polar_damp_type=damp,
                                          ortho_box=not tri)
    box = cell(float(s.box[0, 0]), tri)
    mu = np.random.default_rng(2).normal(size=s.pos.shape) * 0.01
    alive = s.atom_alive(p)
    A = S.atom_alive(P)
    want_e = np.asarray(jt.static_field_direct(s.pos, jnp.asarray(box),
                                               alive, p, c))
    got_e = to_np(tt.static_field_direct(S.pos, torch.as_tensor(box), A,
                                         P, C))
    want_t = np.asarray(jt.dipole_matvec(s.pos, jnp.asarray(box), alive, p,
                                         c, jnp.asarray(mu)))
    got_t = to_np(tt.dipole_matvec(S.pos, torch.as_tensor(box), A, P, C,
                                   torch.as_tensor(mu)))
    for got, want in ((got_e, want_e), (got_t, want_t)):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


