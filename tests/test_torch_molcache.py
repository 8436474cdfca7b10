"""The port's molecule-pair energy cache (``mol_cache``: ops/pairs.
pair_matrix, mol_pair_partials, per_molecule_sums and the cache mode of
mc/metropolis.py) against the JAX package and its own uncached path,
float64 on the CPU: the matrix and the partials against the reference's
and against mol_pair_pass, the cache never drifting over a GCMC run, the
start of a trajectory against the uncached one on the same uniforms, the
gate, the FH/FK rebuild, the chains' [C, M, M] caches and a deck run with
the option set through RunConfig."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig as JRunConfig  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.config import RunConfig  # noqa: E402
from mpmc_tpu_torch.io import input_script, pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops import pairs  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain, stack_chains  # noqa: E402

torch.set_num_threads(1)
CACHE = ("cache_rd", "cache_es", "cache_lrc")


def _sys(**cfg_kw):
    """The reference's small MOF + H2 GCMC system in float64 with the
    cache on, and the port's copy."""
    params, state, cfg, thermo = jsystems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, dtype="float64")
    cfg = dataclasses.replace(cfg, mol_cache=True, use_pallas=False,
                              **cfg_kw)
    return (params, state, cfg, thermo), convert.from_jax(params, state,
                                                          cfg, thermo)


def _np(x):
    return torch.as_tensor(np.array(x))


def test_pair_matrix_equals_the_reference():
    """pair_matrix (index_add segment sums) against the reference's
    (cumulative-sum differences): rel 1e-12 of each matrix's scale, and
    symmetric."""
    (jp, js, jc, jt), (P, S, C, T) = _sys()
    mine = pairs.pair_matrix(S.pos, S.box, S.atom_alive(P), P, C,
                             T.temperature)
    ref = jpairs.pair_matrix(js.pos, js.box, js.atom_alive(jp), jp, jc,
                             jt.temperature)
    for a, b in zip(mine, ref):
        scale = float(a.abs().max())
        assert scale > 0
        assert float((a - _np(b)).abs().max()) <= 1e-12 * scale
        assert float((a - a.T).abs().max()) <= 1e-13 * scale


def test_pair_matrix_rows_and_total_match_the_passes():
    """Each alive row sums to mol_pair_pass of its molecule; the matrix
    total is twice the active part of the full pass."""
    _, (P, S, C, T) = _sys()
    alive = S.atom_alive(P)
    c_rd, c_es, c_lrc = pairs.pair_matrix(S.pos, S.box, alive, P, C,
                                          T.temperature)
    for m in range(1, 9):
        if not bool(S.mol_alive[m]):
            continue
        t = pairs.mol_pair_pass(S.pos, S.box, alive, P, C, T.temperature,
                                torch.tensor(m))
        assert float(c_rd[m].sum()) == pytest.approx(float(t.rd), abs=1e-9)
        assert float(c_es[m].sum()) == pytest.approx(float(t.es_real),
                                                     abs=1e-9)
        assert float(c_lrc[m].sum()) == pytest.approx(float(t.lrc_coeff),
                                                      rel=1e-10)
    act, _ = pairs.pair_pass(S.pos, S.box, alive, P, C, T.temperature,
                             split_frozen=True)
    assert float(c_rd.sum()) / 2 == pytest.approx(float(act.rd), abs=1e-8)
    assert float(c_es.sum()) / 2 == pytest.approx(float(act.es_real),
                                                  abs=1e-8)


@pytest.mark.parametrize("variant", [{}, {"feynman_hibbs": True}],
                         ids=["classical", "fh"])
def test_partials_with_trial_rows_match(variant):
    """mol_pair_partials of trial rows: its sums equal mol_pair_pass, its
    columns the reference's partials (rel 1e-12), and per_molecule_sums
    the reference's."""
    (jp, js, jc, jt), (P, S, C, T) = _sys(**variant)
    alive = S.atom_alive(P)
    for m in (2, 5):
        rows = S.pos[P.mol_atoms[m]] + torch.tensor([0.9, -0.3, 0.4],
                                                    dtype=torch.float64)
        p = pairs.mol_pair_partials(S.pos, S.box, alive, P, C,
                                    T.temperature, torch.tensor(m),
                                    row_pos=rows)
        t = pairs.mol_pair_pass(S.pos, S.box, alive, P, C, T.temperature,
                                torch.tensor(m), row_pos=rows)
        assert float(p.rd.sum()) == pytest.approx(float(t.rd), abs=1e-9)
        assert float(p.es_real.sum()) == pytest.approx(float(t.es_real),
                                                       abs=1e-9)
        assert float(p.lrc.sum()) == pytest.approx(float(t.lrc_coeff),
                                                   rel=1e-10)
        assert float(p.min_r2) == pytest.approx(float(t.min_r2), rel=1e-12)
        r = jpairs.mol_pair_partials(js.pos, js.box, js.atom_alive(jp), jp,
                                     jc, jt.temperature, jnp.asarray(m),
                                     row_pos=jnp.asarray(rows.numpy()))
        for a, b in ((p.rd, r.rd), (p.es_real, r.es_real), (p.lrc, r.lrc)):
            torch.testing.assert_close(a, _np(b), rtol=1e-12,
                                       atol=1e-12 * float(a.abs().max()))
    v = torch.as_tensor(np.random.default_rng(0).normal(
        size=P.n_atoms_max))
    torch.testing.assert_close(
        pairs.per_molecule_sums(v, P),
        _np(jpairs.per_molecule_sums(jnp.asarray(v.numpy()), jp)),
        rtol=1e-12, atol=1e-12)


def _table(K, seed=1, C=None):
    shape = (K, 16) if C is None else (C, K, 16)
    return torch.as_tensor(np.random.default_rng(seed).random(shape))


def test_gcmc_cache_never_drifts():
    """After 400 GCMC steps the carried cache equals a fresh pair_matrix
    to 1e-9 and the carried energy a full recompute to 1e-9."""
    _, (P, S, C, T) = _sys()
    S = tm.initialize(S, P, C, T)
    assert S.cache_rd is not None and S.cache_rd.shape == (P.n_mols_max,
                                                           P.n_mols_max)
    st, stats = tm.run_chunk(S, P, C, T, 400, uniforms=_table(400))
    acc = stats.host().accepts
    assert acc[0] > 0 and (acc[1] > 0 or acc[2] > 0)
    fresh = pairs.pair_matrix(st.pos, st.box, st.atom_alive(P), P, C,
                              T.temperature)
    for k, f in zip(CACHE, fresh):
        assert float((getattr(st, k) - f).abs().max()) < 1e-9, k
    st2 = tm.initialize(st, P, C, T)
    assert float(st.energy.total) == pytest.approx(float(st2.energy.total),
                                                   rel=1e-9, abs=1e-8)


def test_cached_trajectory_start_equals_the_uncached_one():
    """The cached and the uncached scan path over one injected table:
    every decision, position and energy the same."""
    _, (P, S, C, T) = _sys()
    Cn = dataclasses.replace(C, mol_cache=False)
    a, sa = tm.run_chunk(tm.initialize(S, P, C, T), P, C, T, 200,
                         uniforms=_table(200, 3))
    b, sb = tm.run_chunk(tm.initialize(S, P, Cn, T), P, Cn, T, 200,
                         uniforms=_table(200, 3))
    assert (sa.host().accepts == sb.host().accepts).all()
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-9)
    assert torch.equal(a.mol_alive, b.mol_alive)
    assert float(a.energy.total) == pytest.approx(float(b.energy.total),
                                                  rel=1e-10, abs=1e-8)
    assert b.cache_rd is None


@pytest.mark.parametrize("kw", [{}, {"ensemble": "npt"},
                                {"ensemble": "nvt"}, {"ensemble": "nve"},
                                {"polarization": True}, {"cdvdw": True},
                                {"rd_crystal": True, "rd_lrc": False},
                                {"cell_list": True}, {"pallas_delta": True},
                                {"spectre": True}, {"mol_cache": False},
                                {"feynman_hibbs": True}],
                         ids=lambda kw: "-".join(f"{k}" for k in kw) or "uvt")
def test_cache_gate_equals_the_reference(kw):
    """cache_eligible's every condition, spectre among them, against the
    reference's gate."""
    kw_all = {"ensemble": "uvt", "mol_cache": True, **kw}
    mine = tm.cache_eligible(RunConfig(**kw_all))
    ref = jm.cache_eligible(JRunConfig(**kw_all))
    assert mine == ref
    assert mine == (not kw or kw in ({"ensemble": "nvt"},
                                     {"ensemble": "nve"},
                                     {"feynman_hibbs": True}))


def test_fh_refresh_rebuilds_the_cache():
    """Under Feynman-Hibbs the pair values depend on T: a refresh at a new
    temperature rebuilds the cache (the other refreshes keep it)."""
    _, (P, S, C, T) = _sys(feynman_hibbs=True)
    S = tm.initialize(S, P, C, T)
    keep = tm.initialize(S, P, dataclasses.replace(C, feynman_hibbs=False,
                                                   mol_cache=True), T)
    assert keep.cache_rd is S.cache_rd
    T2 = T.replace(temperature=T.temperature * 2)
    st = tm.initialize(S, P, C, T2)
    fresh = pairs.pair_matrix(S.pos, S.box, S.atom_alive(P), P, C,
                              T2.temperature)
    torch.testing.assert_close(st.cache_rd, fresh[0])
    assert float((st.cache_rd - S.cache_rd).abs().max()) > 1e-3


def test_chains_caches_behave_the_same_way():
    """Batched scan chains with the cache: [C, M, M] caches, each chain
    equal to the uncached batched run on the same table and to its lone
    cached run, its cache a fresh pair_matrix to 1e-9."""
    _, (P, S, C, T) = _sys()
    Cn = dataclasses.replace(C, mol_cache=False)
    S0 = tm.initialize(S, P, C, T)
    u = _table(150, 7, C=3)
    u[:, :, 8] = u[0, :, 8]
    u[:, :, 11] = u[0, :, 11]
    st = multichain.initialize_batched(stack_chains([S0] * 3), P, C, T)
    assert st.cache_rd.shape == (3, P.n_mols_max, P.n_mols_max)
    a, sa = multichain.run_chunk_batched(st, P, C, T, 150, uniforms=u)
    stn = multichain.initialize_batched(
        stack_chains([tm.initialize(S, P, Cn, T)] * 3), P, Cn, T)
    b, sb = multichain.run_chunk_batched(stn, P, Cn, T, 150, uniforms=u)
    assert (sa.host().accepts == sb.host().accepts).all()
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-9)
    for c in range(3):
        one, s1 = tm.run_chunk(S0, P, C, T, 150, uniforms=u[c])
        assert (sa.host().accepts[c] == s1.host().accepts).all()
        torch.testing.assert_close(a.cache_rd[c], one.cache_rd, rtol=0,
                                   atol=1e-9)
        sc = slice_chain(a, c)
        fresh = pairs.pair_matrix(sc.pos, sc.box, sc.atom_alive(P), P, C,
                                  T.temperature)
        for k, f in zip(CACHE, fresh):
            assert float((getattr(sc, k) - f).abs().max()) < 1e-9, (c, k)


@pytest.mark.parametrize("chains", [1, 3])
def test_deck_with_the_cache_set_through_runconfig(tmp_path, chains):
    """A GCMC deck run through run.run with RunConfig(mol_cache=True) (no
    deck keyword): the route logged, the cache carried and exact at the
    end, the energy closed."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      dtype="float64", device="cpu")
    tpqr.write_state(str(tmp_path / "mof.pqr"), P, S, ["H2"])
    L = float(S.box[0, 0])
    job = input_script.parse(
        f"ensemble uvt\nnumsteps 200\ncorrtime 100\nseed 3\ntemperature 77\n"
        f"pressure 2\nbasis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
        f"insert_probability 0.5\nmax_molecules 8\nprecision float64\n"
        f"chains {chains}\npqr_input {tmp_path}/mof.pqr\n")
    job = dataclasses.replace(job, cfg=dataclasses.replace(job.cfg,
                                                           mol_cache=True))
    log = io.StringIO()
    su, _ = trun.run(job, log=log, device="cpu")
    assert "mol_cache: the molecule-pair cache" in log.getvalue()
    st = su.states if chains > 1 else su.state
    states = [slice_chain(st, c) for c in range(chains)] if chains > 1 \
        else [st]
    for s in states:
        fresh = pairs.pair_matrix(s.pos, s.box, s.atom_alive(su.params),
                                  su.params, su.cfg, su.thermo.temperature)
        assert float((s.cache_rd - fresh[0]).abs().max()) < 1e-9
        full = tm.initialize(s, su.params, su.cfg, su.thermo)
        assert float(s.energy.total) == pytest.approx(
            float(full.energy.total), rel=1e-9, abs=1e-8)
