"""The plain B2 and B4 (the pair kernels' twins, mpmc_tpu_torch/ops/cuda/
pair_kernel.py) under the RD forms sg, dreiding, b14_7 and
disp_expansion (damped, with its tail) and the plain pass under coulomb
gwp, against the JAX package: in float32 against the Pallas kernels in
interpret mode with the reference's own tolerances
(tests/test_pallas.py::test_pair_kernel_matches_jnp_rd_variants: rd rel
1e-3 / abs 1e-2 for B2, rel 2e-4 / abs 1e-3 for B4), in float64 against
the jnp pair passes at rel 1e-12; B4 over chains and at position stride 0
against the one-chain plain version.  The MOF + H2 system of
tests/torch_rd.py (n_side 4), its LJ wells mapped to each form."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import pair_kernel as jpk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk  # noqa: E402
from test_torch_pair_kernel import _es_bound, _mol_case  # noqa: E402
from torch_rd import FORMS, mof  # noqa: E402

torch.set_num_threads(1)
# the forms' cfg fields: disp_expansion damped and with its tail
KW = {"sg": {}, "dreiding": {}, "b14_7": {},
      "disp_expansion": {"damp_dispersion": True, "rd_lrc": True}, None: {}}
# (form, gwp) of the float64 cases: every form under Ewald; gwp (the plain
# pass whatever the form) under disp_expansion and under LJ (form None)
F64 = [(form, False) for form in FORMS] + [("disp_expansion", True),
                                           (None, True)]
F64_IDS = [f"{f or 'lj'}-{'gwp' if g else 'ewald'}" for f, g in F64]


def _f32_close(got, want, rel, abs_, es_scale, es_slots, min_slot):
    """rd and the tail within (rel, abs_); es within 2e-5 rel + the
    Pallas A&S erfc's 2e-7 x es_scale; min_r2 rel 1e-6."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == min_slot:
            assert g == pytest.approx(w, rel=1e-6), (i, g, w)
        elif i in es_slots:
            tol = 2e-5 * abs(w) + 1e-6 + 2e-7 * es_scale
            assert abs(g - w) <= tol, (i, g, w, tol)
        else:
            assert g == pytest.approx(w, rel=rel, abs=abs_), (i, g, w)


def _disp(P, C):
    return tpairs.site_columns(P, C)[0]


@pytest.mark.parametrize("full", [True, False], ids=["rows0", "rowsF"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_b2_f32_matches_pallas_interpret(form, full):
    """Plain B2 at row_start 0 and F against pair_terms_tiles."""
    p, s, c, t = mof(form, "float32", **KW[form])
    rs = 0 if full else jm.frozen_refresh_rows(p, c)
    assert full or rs > 0
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    alive = s.atom_alive(p)
    want = jpk.pair_terms_tiles(
        s.pos, p.charge, p.eps, p.sig, p.c6, p.c8, p.c10, p.mol_id, alive,
        p.mol_frozen[p.mol_id], s.box, rc, alpha, c, s.pos.shape[0],
        interpret=True, row_start=rs)
    P, S, C, _ = convert.from_jax(p, s, c, t)
    got = tpk.pair_terms(
        S.pos, P.charge, P.eps, P.sig, P.mol_id32, S.atom_alive(P),
        P.mol_frozen[P.mol_id], tpairs.pair_scalars(S.box, C), C,
        row_start=rs, disp=_disp(P, C)).numpy()
    assert got[0] != 0.0 and (form != "disp_expansion" or got[3] < 0)
    scale = _es_bound(s.pos, s.box, p.charge, np.asarray(alive))
    _f32_close(got, want, 1e-3, 1e-2, scale, (1, 2, 5, 6), 8)


@pytest.mark.parametrize("which", ["current", "trial"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_b4_f32_matches_pallas_interpret(form, which):
    """Plain B4 on an H2's own rows and on a trial beside the framework
    against mol_pair_tiles."""
    p, s, c, t = mof(form, "float32", **KW[form])
    mol, rows = _mol_case(p, s, c, which)
    idx = np.asarray(p.mol_atoms[mol])
    rows_j = s.pos[idx] if rows is None else jnp.asarray(rows, jnp.float32)
    na = int(p.mol_natoms[mol])
    valid = jnp.arange(idx.shape[0]) < na
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    col_alive = s.atom_alive(p) & (p.mol_id != mol)
    want = jpk.mol_pair_tiles(
        rows_j, p.charge[idx], p.eps[idx], p.sig[idx], p.c6[idx],
        p.c8[idx], p.c10[idx], valid, s.pos, p.charge, p.eps, p.sig, p.c6,
        p.c8, p.c10, col_alive, s.box, rc, alpha, c, s.pos.shape[0],
        interpret=True)
    want = np.asarray(want)[[0, 1, 3, 8]]
    P, S, C, _ = convert.from_jax(p, s, c, t)
    got = tpk.mol_pair(
        S.pos, P.charge, P.eps, P.sig, P.mol_id32, S.atom_alive(P),
        P.mol_atoms, P.mol_natoms, torch.tensor(mol),
        None if rows is None else torch.as_tensor(rows, dtype=torch.float32),
        tpairs.pair_scalars(S.box, C), C, disp=_disp(P, C)).numpy()
    assert got[0] != 0.0
    rows_q = np.asarray(p.charge, np.float64)[idx] * (np.arange(len(idx))
                                                      < na)
    scale = _es_bound(s.pos, s.box, p.charge, np.asarray(col_alive),
                      rows=np.asarray(rows_j), rows_q=rows_q)
    _f32_close(got, want, 2e-4, 1e-3, scale, (1,), 3)


def _terms_close(got, want):
    """rel 1e-12, or 1e-9 K where a sum cancels (the es sums of the
    charged lattice net a few K of terms of either sign: the reference
    applies the Coulomb constant per pair, the port per sum)."""
    for f in ("rd", "es_real", "es_excl", "lrc_coeff", "min_r2"):
        g, w = float(getattr(got, f)), float(getattr(want, f))
        assert g == pytest.approx(w, rel=1e-12, abs=1e-9), (f, g, w)


@pytest.mark.parametrize("form,gwp", F64, ids=F64_IDS)
@pytest.mark.parametrize("full", [True, False], ids=["rows0", "rowsF"])
def test_pair_pass_f64_matches_jnp(form, full, gwp):
    """pairs.pair_pass (plain B2, or the plain pass that gwp takes) at
    row_start 0 (split) and F against the jnp pass, rel 1e-12."""
    p, s, c, t = mof(form, "float64", gwp, **KW[form])
    P, S, C, T = convert.from_jax(p, s, c, t)
    assert tpk.supported(C) == (not gwp)
    if full:
        want = jpairs.pair_pass(s.pos, s.box, s.atom_alive(p), p, c,
                                t.temperature, split_frozen=True)
        got = tpairs.pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                               T.temperature, split_frozen=True)
        for g, w in zip(got, want):
            _terms_close(g, w)
        return
    rs = jm.frozen_refresh_rows(p, c)
    want = jpairs.pair_pass(s.pos, s.box, s.atom_alive(p), p, c,
                            t.temperature, row_start=rs)
    got = tpairs.pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                           T.temperature, row_start=rs)
    _terms_close(got, want)


@pytest.mark.parametrize("form,gwp", F64, ids=F64_IDS)
@pytest.mark.parametrize("which", ["current", "trial"])
def test_mol_pair_pass_f64_matches_jnp(form, which, gwp):
    """pairs.mol_pair_pass (plain B4) against the jnp pass, rel 1e-12."""
    p, s, c, t = mof(form, "float64", gwp, **KW[form])
    mol, rows = _mol_case(p, s, c, which)
    want = jpairs.mol_pair_pass(
        s.pos, s.box, s.atom_alive(p), p, c, t.temperature, mol,
        row_pos=None if rows is None else jnp.asarray(rows))
    P, S, C, T = convert.from_jax(p, s, c, t)
    got = tpairs.mol_pair_pass(
        S.pos, S.box, S.atom_alive(P), P, C, T.temperature,
        torch.tensor(mol), row_pos=None if rows is None
        else torch.as_tensor(rows))
    _terms_close(got, want)


@pytest.mark.parametrize("form,gwp", F64, ids=F64_IDS)
def test_plain_b4_over_chains_and_stride0_are_the_one_chain_plain(form, gwp):
    """B4's plain version over C = 3 chains (positions per chain, a [C,
    20] header per chain) and at position stride 0 (trial rows of three
    placements against one system) equals the one-chain plain version of
    each chain, float64 (the stride-0 form sums its [C, A, N] block in
    another order: rel 1e-12)."""
    p, s, c, t = mof(form, "float64", gwp, **KW[form])
    P, S, C, T = convert.from_jax(p, s, c, t)
    disp, g = tpairs.site_columns(P, C)
    alive = S.atom_alive(P)
    mol, rows = _mol_case(p, s, c, "trial")
    rows = torch.as_tensor(rows)
    shifts = torch.tensor([[0.0, 0.0, 0.0], [0.4, -0.3, 0.2],
                           [-1.1, 0.6, 0.9]], dtype=torch.float64)
    trial = rows[None] + shifts[:, None, :]
    mols = torch.full((3,), mol, dtype=torch.int64)
    common = (P.charge, P.eps, P.sig, P.mol_id32)
    tail = (P.mol_atoms, P.mol_natoms, mols, trial)
    scal = tpairs.pair_scalars(S.box, C)
    box3 = S.box[None] * torch.tensor([1.0, 1.02, 0.99],
                                      dtype=torch.float64)[:, None, None]
    scal3 = tpairs.pair_scalars(box3, C)
    pos3 = S.pos[None].expand(3, -1, -1).contiguous()
    alive3 = alive[None].expand(3, -1).contiguous()
    kw = dict(disp=disp, gwp=g)
    chains = tpk.mol_pair_chains_plain(pos3, *common, alive3, *tail, scal3,
                                       C, **kw)
    shared = tpk.mol_pair_chains_plain(S.pos, *common, alive, *tail, scal,
                                       C, **kw)
    for k in range(3):
        one = tpk.mol_pair_plain(S.pos, *common, alive, P.mol_atoms,
                                 P.mol_natoms, torch.tensor(mol), trial[k],
                                 scal3[k], C, **kw)
        assert torch.equal(chains[k], one)
        one = tpk.mol_pair_plain(S.pos, *common, alive, P.mol_atoms,
                                 P.mol_natoms, torch.tensor(mol), trial[k],
                                 scal, C, **kw)
        np.testing.assert_allclose(shared[k].numpy(), one.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_disp_expansion_needs_its_columns():
    """disp_expansion without the C6/C8/C10 columns raises (plain B2 and
    B4), as does coulomb gwp without the widths."""
    p, s, c, t = mof("disp_expansion", "float64", **KW["disp_expansion"])
    P, S, C, _ = convert.from_jax(p, s, c, t)
    args = (S.pos, P.charge, P.eps, P.sig, P.mol_id32, S.atom_alive(P))
    scal = tpairs.pair_scalars(S.box, C)
    with pytest.raises(ValueError, match="C6/C8/C10"):
        tpk.pair_terms(*args, P.mol_frozen[P.mol_id], scal, C)
    with pytest.raises(ValueError, match="C6/C8/C10"):
        tpk.mol_pair(*args, P.mol_atoms, P.mol_natoms,
                     torch.tensor(_mol_case(p, s, c, "current")[0]), None,
                     scal, C)
    p, s, c, t = mof(None, "float64", gwp=True)
    P, S, C, _ = convert.from_jax(p, s, c, t)
    with pytest.raises(ValueError, match="GWP widths"):
        tpk.pair_terms_plain(S.pos, P.charge, P.eps, P.sig, P.mol_id32,
                             S.atom_alive(P), P.mol_frozen[P.mol_id],
                             tpairs.pair_scalars(S.box, C), C)
