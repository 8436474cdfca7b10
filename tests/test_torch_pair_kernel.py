"""The port's pair-kernel plain versions (mpmc_tpu_torch/ops/cuda/
pair_kernel.py) against the JAX package: in float32 against the Pallas
kernels run in interpret mode, in float64 against the jnp pair passes.

Same inputs for both: systems built by the JAX builders (numpy-seeded),
carried over with mpmc_tpu_torch.convert.from_jax.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig  # noqa: E402
from mpmc_tpu.models import systems  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import pair_kernel as jpk  # noqa: E402
from mpmc_tpu.state import build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk  # noqa: E402

torch.set_num_threads(1)

CASES = [("lb", "ewald"), ("lb", "wolf"), ("lb", "cutoff"), ("lb", "none"),
         ("waldman_hagler", "ewald")]


def _system(mixing, coulomb, dtype):
    """n_side=4 MOF lattice + H2 (lb); for Waldman-Hagler the sorbate is
    a one-site LJ atom — H2's zero-sigma sites make the reference's f32
    Waldman-Hagler mix 0/0 (see ROADMAP §C)."""
    if mixing == "lb":
        p, s, c, t = systems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                         dtype=dtype)
    else:
        fpos, fp, L = systems._framework_lattice(4, 4.0)
        sp = systems.lj_atom()
        rng = np.random.default_rng(2)
        com = (rng.permutation(64)[:8, None] // np.array([16, 4, 1]) % 4
               + 1.0) * 4.0
        c = RunConfig(ensemble="uvt", insert_species=(0,), ortho_box=True,
                      cavity_autoreject_absolute=1.0, dtype=dtype)
        p, s = build_system(np.eye(3) * L, frozen_pos=fpos, frozen_params=fp,
                            species=(sp,), capacity=(16,),
                            initial_counts=(8,),
                            initial_pos={0: com[:, None, :]},
                            dtype=c.jdtype)
        _, _, _, t = systems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                         dtype=dtype)
    c = dataclasses.replace(c, mixing_rule=mixing, coulomb=coulomb)
    return p, s, c, t


def _frozen_rows(p):
    af = np.asarray(p.mol_frozen)[np.asarray(p.mol_id)] & np.asarray(
        p.atom_ok)
    return int(af.sum())


def _es_bound(pos, box, q, ok, rows=None, rows_q=None):
    """sum |q_i q_j| / r over all pairs of alive atoms (or of ``rows``
    with charges ``rows_q`` against them), f64: the scale of the Pallas
    A&S erfc/erf gap (|error| <= 1.5e-7 per pair)."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64)
    q = np.asarray(q, np.float64) * ok
    a = pos if rows is None else np.asarray(rows, np.float64)
    qa = q if rows is None else rows_q
    d = a[:, None, :] - pos[None, :, :]
    f = d @ np.linalg.inv(box)
    d = (f - np.round(f)) @ box
    r = np.sqrt(np.maximum((d * d).sum(-1), 1e-12))
    return float(np.sum(np.abs(qa[:, None] * q[None, :]) / r))


def _assert_raw(got, want, es_scale, es_slots, min_slot):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == min_slot:
            assert g == pytest.approx(w, rel=1e-6), (i, g, w)
            continue
        tol = 2e-5 * abs(w) + 1e-6
        if i in es_slots:
            tol += 2e-7 * es_scale
        assert abs(g - w) <= tol, (i, g, w, tol)


def _raw_port(P, S, C, row_start):
    alive = S.atom_alive(P)
    return tpk.pair_terms(
        S.pos, P.charge, P.eps, P.sig, P.mol_id32, alive,
        P.mol_frozen[P.mol_id], tpairs.pair_scalars(S.box, C), C,
        row_start=row_start).numpy()


@pytest.mark.parametrize("full", [True, False], ids=["rows0", "rowsF"])
@pytest.mark.parametrize("mixing,coulomb", CASES)
def test_pair_terms_f32_matches_pallas_interpret(mixing, coulomb, full):
    p, s, c, t = _system(mixing, coulomb, "float32")
    rs = 0 if full else _frozen_rows(p)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    alive = s.atom_alive(p)
    want = jpk.pair_terms_tiles(
        s.pos, p.charge, p.eps, p.sig, p.c6, p.c8, p.c10, p.mol_id, alive,
        p.mol_frozen[p.mol_id], s.box, rc, alpha, c, s.pos.shape[0],
        interpret=True, row_start=rs)
    P, S, C, _ = convert.from_jax(p, s, c, t)
    got = _raw_port(P, S, C, rs)
    scale = _es_bound(s.pos, s.box, p.charge, np.asarray(alive))
    _assert_raw(got, want, scale, (1, 2, 5, 6), 8)


def _terms_close(got, want):
    for f in ("rd", "es_real", "es_excl", "lrc_coeff", "min_r2"):
        g, w = float(getattr(got, f)), float(getattr(want, f))
        assert g == pytest.approx(w, rel=1e-10, abs=1e-8), (f, g, w)


@pytest.mark.parametrize("full", [True, False], ids=["rows0", "rowsF"])
@pytest.mark.parametrize("mixing,coulomb", CASES)
def test_pair_pass_f64_matches_jnp(mixing, coulomb, full):
    p, s, c, t = _system(mixing, coulomb, "float64")
    P, S, C, T = convert.from_jax(p, s, c, t)
    if full:
        want = jpairs.pair_pass(s.pos, s.box, s.atom_alive(p), p, c,
                                t.temperature, split_frozen=True)
        got = tpairs.pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                               T.temperature, split_frozen=True)
        for g, w in zip(got, want):
            _terms_close(g, w)
    else:
        rs = _frozen_rows(p)
        want = jpairs.pair_pass(s.pos, s.box, s.atom_alive(p), p, c,
                                t.temperature, row_start=rs)
        got = tpairs.pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                               T.temperature, row_start=rs)
        _terms_close(got, want)


def _mol_case(p, s, c, which):
    """(mol, trial rows or None): an alive H2's own rows, or a trial
    insert of a dead slot 2.2 A from a framework atom."""
    spec = np.asarray(p.mol_species)
    alive = np.asarray(s.mol_alive)
    if which == "current":
        return int(np.flatnonzero((spec >= 0) & alive)[0]), None
    mol = int(np.flatnonzero((spec >= 0) & ~alive)[0])
    a = p.mol_atoms.shape[1]
    tmpl = np.asarray(p.species_pos[0], np.float64)[:a]
    rows = np.asarray(s.pos[0], np.float64) + np.array([2.2, 0.3, 0.1]) + tmpl
    return mol, rows


@pytest.mark.parametrize("which", ["current", "trial"])
@pytest.mark.parametrize("coulomb", ["ewald", "wolf", "cutoff", "none"])
def test_mol_pair_f32_matches_pallas_interpret(coulomb, which):
    p, s, c, t = _system("lb", coulomb, "float32")
    mol, rows = _mol_case(p, s, c, which)
    idx = np.asarray(p.mol_atoms[mol])
    rows_j = (s.pos[idx] if rows is None
              else jnp.asarray(rows, jnp.float32))
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
        tpairs.pair_scalars(S.box, C), C).numpy()
    rows_q = np.asarray(p.charge, np.float64)[idx] * (np.arange(len(idx))
                                                      < na)
    scale = _es_bound(s.pos, s.box, p.charge, np.asarray(col_alive),
                      rows=np.asarray(rows_j), rows_q=rows_q)
    _assert_raw(got, want, scale, (1,), 3)


@pytest.mark.parametrize("which", ["current", "trial"])
@pytest.mark.parametrize("coulomb", ["ewald", "wolf", "cutoff", "none"])
def test_mol_pair_pass_f64_matches_jnp(coulomb, which):
    p, s, c, t = _system("lb", coulomb, "float64")
    mol, rows = _mol_case(p, s, c, which)
    want = jpairs.mol_pair_pass(
        s.pos, s.box, s.atom_alive(p), p, c, t.temperature, mol,
        row_pos=None if rows is None else jnp.asarray(rows))
    P, S, C, T = convert.from_jax(p, s, c, t)
    got = tpairs.mol_pair_pass(
        S.pos, S.box, S.atom_alive(P), P, C, T.temperature,
        torch.tensor(mol),
        row_pos=None if rows is None else torch.as_tensor(rows))
    _terms_close(got, want)


def test_wrappers_refuse_other_devices_and_count_only_launches():
    """A CPU tensor takes the plain version (no launch counted); a tensor
    on a device with no kernel raises instead of falling back."""
    p, s, c, t = _system("lb", "ewald", "float32")
    P, S, C, _ = convert.from_jax(p, s, c, t)
    tpk.reset_counts()
    _raw_port(P, S, C, 0)
    assert tpk.pair_terms.launches == 0
    meta = S.pos.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpk.pair_terms(meta, P.charge, P.eps, P.sig, P.mol_id32,
                       S.atom_alive(P), P.mol_frozen[P.mol_id],
                       tpairs.pair_scalars(S.box, C), C)
