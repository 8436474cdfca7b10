"""The port's framework cell lists (ops/celllist.py, ``cell_list``) against
its own dense pass and the JAX package, float64 on the CPU: the index
against the reference's, the culled per-move pass against the dense one
and the reference's culled pass (boundary molecules and an asymmetric
template included), the degrade rules of attach, GCMC bookkeeping with the
index, the culled pass over chains and at position stride 0, batched
chains against their lone runs, and the decks (scan path, and fused µVT,
whose kernel ignores the index)."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import celllist as jcl  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.config import RunConfig  # noqa: E402
from mpmc_tpu_torch.io import input_script, pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops import celllist, pairs  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import (Species, build_system,  # noqa: E402
                                  slice_chain, stack_chains)

torch.set_num_threads(1)
SLOTS = ("rd", "es_real", "lrc_coeff", "min_r2")


def _mof(cutoff=6.0, **cfg_kw):
    """The reference's tiny MOF + H2 system (float64) with the reference's
    index forced (min_reduction None: exactness, not profit, is tested),
    and the port's copy of both."""
    params, state, cfg, thermo = jsystems.mof_h2_gcmc(
        n_side=6, spacing=4.0, n_h2=12, capacity=24, temperature=77.0,
        pressure=2.0, dtype="float64")
    cfg = dataclasses.replace(cfg, cutoff=cutoff, cell_list=True,
                              use_pallas=False, **cfg_kw)
    jp = jcl.attach(params, state.pos, state.box, cfg, min_reduction=None)
    assert jp.cell_index is not None
    return (jp, state, cfg, thermo), convert.from_jax(jp, state, cfg, thermo)


def _dense(cfg):
    return dataclasses.replace(cfg, cell_list=False)


def test_index_equals_the_reference_index():
    """attach builds the reference's tables: the same grid, offsets,
    cell-major framework columns and validity, and the framework tail
    table to rel 1e-12."""
    _, (P, S, C, T) = _mof()
    mine = celllist.attach(P.replace(cell_index=None), S.pos, S.box, C,
                           min_reduction=None).cell_index
    ref = P.cell_index
    assert mine.grid == ref.grid and mine.n_frozen == ref.n_frozen
    assert mine.columns == ref.columns
    for f in dataclasses.fields(celllist.CellIndex):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name == "lrc_fw":
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-9)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b.to(a.dtype)), f.name


def _terms(t):
    return [float(getattr(t, k)) for k in SLOTS]


@pytest.mark.parametrize("variant", [{}, {"feynman_hibbs": True},
                                     {"coulomb": "wolf"}],
                         ids=["classical", "fh", "wolf"])
def test_culled_equals_dense_and_the_reference(variant):
    """The first six alive molecules, at their rows and at trial rows 1.7 A
    away: the culled pass equals the port's dense pass and the reference's
    culled pass (rd, es_real, lrc, min_r2) to rel 1e-12."""
    (jp, js, jc, jt), (P, S, C, T) = _mof(**variant)
    jc2 = dataclasses.replace(jc, **variant)
    alive, jalive = S.atom_alive(P), js.atom_alive(jp)
    shift = torch.tensor([1.7, -0.4, 0.9], dtype=torch.float64)
    n = 0
    for m in range(1, P.n_mols_max):
        if not bool(S.mol_alive[m]) or n == 12:
            continue
        rows = S.pos[P.mol_atoms[m]] + shift
        for rp in (None, rows):
            mt = torch.tensor(m)
            c = pairs.mol_pair_pass(S.pos, S.box, alive, P, C,
                                    T.temperature, mt, row_pos=rp)
            d = pairs.mol_pair_pass(S.pos, S.box, alive, P, _dense(C),
                                    T.temperature, mt, row_pos=rp)
            r = jpairs.mol_pair_pass(
                js.pos, js.box, jalive, jp, jc2, jt.temperature, m,
                row_pos=None if rp is None else jnp.asarray(rp.numpy()))
            for a, b, e in zip(_terms(c), _terms(d), _terms(r)):
                assert a == pytest.approx(b, rel=1e-12, abs=1e-10)
                assert a == pytest.approx(float(np.asarray(e)), rel=1e-12,
                                          abs=1e-10)
            n += 1
    assert n == 12


def test_culled_covers_boundary_molecules():
    """A molecule at a cell corner gathers wrapped cells: equal to the
    dense pass and the reference's."""
    (jp, js, jc, jt), (P, S, C, T) = _mof()
    na = int(P.mol_natoms[1])
    idx = P.mol_atoms[1][:na]
    pos = S.pos.clone()
    pos[idx] = P.species_pos[0][:na] + torch.tensor(
        [0.05, 0.02, -0.03], dtype=torch.float64)
    alive = S.atom_alive(P)
    c = pairs.mol_pair_pass(pos, S.box, alive, P, C, T.temperature,
                            torch.tensor(1))
    d = pairs.mol_pair_pass(pos, S.box, alive, P, _dense(C), T.temperature,
                            torch.tensor(1))
    r = jpairs.mol_pair_pass(jnp.asarray(pos.numpy()), js.box,
                             js.atom_alive(jp), jp, jc, jt.temperature, 1)
    for a, b, e in zip(_terms(c), _terms(d), _terms(r)):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-10)
        assert a == pytest.approx(float(np.asarray(e)), rel=1e-12,
                                  abs=1e-10)


def test_asymmetric_template_coverage():
    """A species whose mass COM is off its site centroid: the reach is
    measured from the unweighted centroid the query centres on, and the
    culled pass equals the dense one at the reference's worst case and a
    random sweep of placements."""
    n_side, spacing = 7, 5.0
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    fpos = (ijk + 0.5) * spacing
    F = len(fpos)
    z = np.zeros(F)
    fp = {"charge": z, "mass": np.full(F, 12.0), "polar": z,
          "eps": np.full(F, 40.0), "sig": np.full(F, 3.0), "omega": z,
          "c6": z, "c8": z, "c10": z, "gwp_alpha": z}
    sp = Species(
        name="AS", atom_names=("A", "L1", "L2", "L3", "L4"),
        pos=np.array([[0.0, 0, 0], [-2, 0, 0], [-2, 0.1, 0],
                      [-2, -0.1, 0], [2.5, 0, 0]]),
        mass=np.array([16.0, 1e-6, 1e-6, 1e-6, 1e-6]),
        charge=np.zeros(5), polar=np.zeros(5), eps=np.full(5, 25.0),
        sig=np.full(5, 2.8))
    params, state = build_system(
        np.eye(3) * (n_side * spacing), frozen_pos=fpos, frozen_params=fp,
        species=(sp,), capacity=(2,), initial_counts=(1,),
        dtype=torch.float64, device="cpu")
    cfg = RunConfig(ensemble="nvt", cutoff=6.0, cell_list=True,
                    dtype="float64", coulomb="none")
    params = celllist.attach(params, state.pos, state.box, cfg,
                             min_reduction=None)
    assert params.cell_index is not None
    tmpl = params.species_pos[0][:5].numpy()
    cen = tmpl.mean(axis=0)
    want = float(np.linalg.norm(tmpl - cen, axis=1).max())
    assert celllist._species_reach(params) == pytest.approx(want, abs=1e-6)
    assert want > float(np.linalg.norm(tmpl, axis=1).max()) + 0.5
    t = torch.tensor(300.0, dtype=torch.float64)
    alive = state.atom_alive(params)
    idx = params.mol_atoms[1][:5]
    rng = np.random.default_rng(3)
    bases = [np.array([8.70, 2.5, 2.5]) - cen]
    bases += list(rng.uniform(0.0, n_side * spacing, (40, 3)))
    for base in bases:
        pos = state.pos.clone()
        pos[idx] = torch.as_tensor(base + tmpl)
        c = pairs.mol_pair_pass(pos, state.box, alive, params, cfg, t,
                                torch.tensor(1))
        d = pairs.mol_pair_pass(pos, state.box, alive, params, _dense(cfg),
                                t, torch.tensor(1))
        assert float(c.rd) == pytest.approx(float(d.rd), rel=1e-12,
                                            abs=1e-10), base


@pytest.mark.parametrize("case", ["npt", "frameless", "no_cutoff",
                                  "cdvdw_repulsion", "no_reduction"])
def test_attach_refuses_npt_and_degrades_as_the_reference(case):
    """npt raises; no frozen framework, no cutoff, a cdvdw repulsion, or
    too little reduction (the default min_reduction on the tiny MOF) leave
    the params unchanged — the reference's decision in each case."""
    if case in ("npt", "frameless"):
        P, S, C, _ = tsystems.lj_fluid(n=32, dtype="float64", device="cpu")
        C = dataclasses.replace(C, cutoff=4.0, cell_list=True)
        if case == "npt":
            with pytest.raises(ValueError, match="fixed box"):
                celllist.build_cell_index(
                    P, S.pos, S.box, dataclasses.replace(C, ensemble="npt"))
            return
        assert celllist.attach(P, S.pos, S.box, C).cell_index is None
        return
    (jp, js, jc, _), (P, S, C, _) = _mof()
    P = P.replace(cell_index=None)
    kw = {"no_cutoff": {"cutoff": None},
          "cdvdw_repulsion": {"cdvdw_repulsion": "sig"},
          "no_reduction": {}}[case]
    C2 = dataclasses.replace(C, **kw)
    mine = celllist.attach(P, S.pos, S.box, C2)
    ref = jcl.attach(jp.replace(cell_index=None) if hasattr(jp, "replace")
                     else dataclasses.replace(jp, cell_index=None),
                     js.pos, js.box, dataclasses.replace(jc, **kw))
    assert mine.cell_index is None and ref.cell_index is None
    assert mine is P


def test_gcmc_bookkeeping_with_cell_list():
    """300 culled-delta GCMC steps (inserts, deletes, displacements):
    the carried energy equals a dense full recompute to 1e-9."""
    _, (P, S, C, T) = _mof()
    S = tm.initialize(S, P, C, T)
    u = torch.as_tensor(np.random.default_rng(4).random((300, 16)))
    st, stats = tm.run_chunk(S, P, C, T, 300, uniforms=u)
    stats = stats.host()
    assert stats.attempts[1] > 0 and stats.attempts[2] > 0
    assert stats.accepts.sum() > 0
    fresh = tm.initialize(st, P, C, T)
    for k in ("rd", "es_real", "es_recip", "es_self", "es_excl", "lrc"):
        a, b = float(getattr(st.energy, k)), float(getattr(fresh.energy, k))
        assert a == pytest.approx(b, rel=1e-9, abs=1e-7), k
    # the dense path from the same table gives the same chain
    dn, _ = tm.run_chunk(tm.initialize(S, P, _dense(C), T), P, _dense(C),
                         T, 300, uniforms=u)
    torch.testing.assert_close(st.pos, dn.pos, rtol=0, atol=1e-9)


def _three_states(P, S, C, T):
    """Three states of the system, two moved by short seeded chunks."""
    S = tm.initialize(S, P, C, T)
    out = [S]
    for seed in (5, 6):
        u = torch.as_tensor(np.random.default_rng(seed).random((40, 16)))
        out.append(tm.run_chunk(S, P, C, T, 40, uniforms=u)[0])
    return stack_chains(out)


def test_culled_pass_over_chains_and_at_stride_0():
    """The culled pass over 3 chains (pos [C, N, 3]) equals each chain's
    lone pass, and at position stride 0 (one system, C trial rows) each
    row's lone pass with those rows."""
    _, (P, S, C, T) = _mof()
    st = _three_states(P, S, C, T)
    alive = st.mol_alive[:, P.mol_id] & P.atom_ok
    mol = torch.tensor([1, 3, 5])
    rows = st.pos[torch.arange(3)[:, None], P.mol_atoms[mol]] + 0.6
    for rp in (None, rows):
        b = pairs.mol_pair_pass(st.pos, S.box, alive, P, C, T.temperature,
                                mol, row_pos=rp)
        for c in range(3):
            one = pairs.mol_pair_pass(st.pos[c], S.box, alive[c], P, C,
                                      T.temperature, mol[c],
                                      row_pos=None if rp is None else rp[c])
            for k in SLOTS:
                assert float(getattr(b, k)[c]) == pytest.approx(
                    float(getattr(one, k)), rel=1e-13, abs=1e-11), (c, k)
    shared = pairs.mol_pair_pass(st.pos[0], S.box, alive[0], P, C,
                                 T.temperature, mol, row_pos=rows,
                                 shared=True)
    for c in range(3):
        one = pairs.mol_pair_pass(st.pos[0], S.box, alive[0], P, C,
                                  T.temperature, mol[c], row_pos=rows[c])
        for k in SLOTS:
            assert float(getattr(shared, k)[c]) == pytest.approx(
                float(getattr(one, k)), rel=1e-13, abs=1e-11), (c, k)


def test_batched_chains_equal_their_lone_runs():
    """Batched scan chains under cell_list (the culled pass over the
    chains): each chain's decisions, positions and energies equal the
    chain run alone over its own rows (the move type shared from chain
    0's lanes), and its bookkeeping closes."""
    _, (P, S, C, T) = _mof()
    st = _three_states(P, S, C, T)
    u = torch.as_tensor(np.random.default_rng(9).random((3, 120, 16)))
    u[:, :, 8] = u[0, :, 8]
    u[:, :, 11] = u[0, :, 11]
    b, stats = multichain.run_chunk_batched(st, P, C, T, 120, uniforms=u)
    stats = stats.host()
    for c in range(3):
        one, s1 = tm.run_chunk(slice_chain(st, c), P, C, T, 120,
                               uniforms=u[c])
        assert (stats.accepts[c] == s1.host().accepts).all()
        torch.testing.assert_close(b.pos[c], one.pos, rtol=0, atol=1e-9)
        assert float(b.energy.total[c]) == pytest.approx(
            float(one.energy.total), rel=1e-10, abs=1e-8)
        fresh = tm.initialize(slice_chain(b, c), P, C, T)
        assert float(b.energy.total[c]) == pytest.approx(
            float(fresh.energy.total), rel=1e-9, abs=1e-7)


def _deck(tmp_path, extra):
    """The tiny MOF written to PQR and run as a GCMC deck on the CPU."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=6, n_h2=12, capacity=24,
                                      dtype="float64", device="cpu")
    tpqr.write_state(str(tmp_path / "mof.pqr"), P, S, ["H2"])
    L = float(S.box[0, 0])
    text = (f"ensemble uvt\nnumsteps 200\ncorrtime 100\nseed 3\n"
            f"temperature 77\npressure 2\nbasis1 {L} 0 0\nbasis2 0 {L} 0\n"
            f"basis3 0 0 {L}\ninsert_probability 0.5\nmax_molecules 12\n"
            f"cutoff 6\nprecision float64\npqr_input {tmp_path}/mof.pqr\n"
            + extra)
    job = input_script.parse(text)
    job = dataclasses.replace(job, pqr_restart=None)
    log = io.StringIO()
    su, _ = trun.run(job, log=log, device="cpu")
    return su, log.getvalue()


def test_cell_list_deck_on_the_scan_path(tmp_path):
    """A GCMC deck with ``cell_list on``: the index attached (the tiny
    MOF's default reduction refuses it, so the degrade line is logged),
    and the deck's energies close."""
    su, text = _deck(tmp_path, "cell_list on\n")
    assert "cell_list: no index" in text
    fresh = tm.initialize(su.state, su.params, su.cfg, su.thermo)
    assert float(su.state.energy.total) == pytest.approx(
        float(fresh.energy.total), rel=1e-9, abs=1e-7)


def test_fused_uvt_ignores_the_index():
    """Fused µVT (plain B1) with the index attached: with rd_lrc off its
    per-chunk constants equal the reference's (mpmc_tpu's
    _uvt_chunk_consts on the same index) and it runs the trajectory it
    runs without the option (B1 reads no index); with the tail on it
    refuses the reference's trap (its culled cx carries the framework
    tail: CELL_LIST_FUSED_LRC_TRAP)."""
    from mpmc_tpu.mc import metropolis as jm
    (jp, js, jc, jt), (P, S, C, T) = _mof(rd_lrc=False)
    C = dataclasses.replace(C, fused_mc=True)
    tabs = tm.uvt_fused_tables(P, C)
    ref = jm._uvt_chunk_consts(js.pos, js.box, jp, jt, jc,
                               *jm.uvt_fused_tables(jp, jc)[4:6])
    mine = tm._uvt_chunk_consts(S.pos, S.box, P, T, C, tabs[5], tabs[6])
    for name, x, y in zip(("d_self", "d_excl", "c1", "cx", "lnfv", "kvecs",
                           "kcoef"), mine, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    u = torch.as_tensor(np.random.default_rng(2).random((80, 16)))
    S0 = tm.initialize(S, P, C, T)
    a, _ = tm.run_chunk_fused_uvt(S0, P, C, T, 80, uniforms=u, tables=tabs)
    Pd, Cd = P.replace(cell_index=None), _dense(C)
    b, _ = tm.run_chunk_fused_uvt(tm.initialize(S, Pd, Cd, T), Pd, Cd, T, 80,
                                  uniforms=u, tables=tabs)
    assert torch.equal(a.pos, b.pos)
    assert torch.equal(a.mol_alive, b.mol_alive)
    assert float(a.energy.total) == float(b.energy.total)
    Cl = dataclasses.replace(C, rd_lrc=True)
    with pytest.raises(ValueError, match="fused_mc µVT under cell_list"):
        tm.run_chunk_fused_uvt(S0, P, Cl, T, 80, uniforms=u, tables=tabs)
    tm.check_cell_list_fused(Pd, Cl)        # no index: nothing to refuse
