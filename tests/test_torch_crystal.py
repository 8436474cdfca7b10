"""The port's rd_crystal (ops/crystal.py, routed by ops/pairs.py) against
the JAX package in float64 on the CPU: the image shifts, the simple-cubic
LJ lattice sums A12 = 6.2021888 and A6 = 8.4019238 and the order
convergence, the full and per-molecule image sums (split frozen, trial
rows, batched chains and one system at stride 0) against the reference's
rd_crystal_full / mol_rd_crystal, pair_pass and mol_pair_pass routing
(ES from the rd-none pass), the refused row-restricted pass and rd_lrc,
bookkeeping of NVT and µVT runs, and a CLI deck."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import free_atoms  # noqa: E402
from mpmc_tpu.config import RunConfig as JRunConfig  # noqa: E402
from mpmc_tpu.config import Thermo as JThermo  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import crystal as jcrystal  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.io import pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import crystal as tcrystal  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.state import Species  # noqa: E402

torch.set_num_threads(1)
A12_SC = 6.2021888
A6_SC = 8.4019238


def sc_lattice(m, a):
    g = np.arange(m) * a
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def _thermo(T=100.0):
    return JThermo.make(temperature=T, move_factor=0.7, rot_factor=0.4,
                        n_species=1, dtype=jnp.float64)


def crystal_energy(order, m=3, a=3.6, eps=100.0, sig=3.2):
    params, state = free_atoms(m * a * np.eye(3), sc_lattice(m, a), eps=eps,
                               sig=sig)
    cfg = JRunConfig(ensemble="nvt", coulomb="none", dtype="float64",
                     rd_crystal=True, rd_crystal_order=order, rd_lrc=False,
                     pair_chunk=32, use_pallas=False)
    P, S, C, T = convert.from_jax(params, state, cfg, _thermo())
    e, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T)
    return float(e.rd), m ** 3, eps, sig, a


def test_image_shifts_are_the_references():
    for order in (1, 2, 3):
        np.testing.assert_array_equal(tcrystal.image_shifts(order),
                                      jcrystal.image_shifts(order))


def test_sc_lj_lattice_sum_and_convergence():
    """U/N = 2 eps [A12 (sig/a)^12 - A6 (sig/a)^6] at order 3 (2e-3), and
    the error falls with the order."""
    u2, n, eps, sig, a = crystal_energy(order=2)
    u3, *_ = crystal_energy(order=3)
    u4, *_ = crystal_energy(order=4)
    expected = 2.0 * eps * (A12_SC * (sig / a) ** 12 - A6_SC * (sig / a) ** 6)
    assert u3 / n == pytest.approx(expected, rel=2e-3)
    assert abs(u3 - expected * n) < abs(u2 - expected * n)
    assert abs(u4 - expected * n) < 0.6 * abs(u2 - expected * n)


def _molecular(order=2, rd="lj", **kw):
    """The reference's small MOF + CO2-like 3-site system: a frozen
    framework (n_side 3) and charged rigid H2, float64 (reference objects
    and the port's)."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=5, capacity=8,
                                      dtype="float64")
    c = dataclasses.replace(c, rd_crystal=True, rd_crystal_order=order,
                            rd_lrc=False, use_pallas=False, rd_potential=rd,
                            **kw)
    return (p, s, c, t), convert.from_jax(p, s, c, t)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_rd_crystal_full_matches_reference(order, split):
    (jp, js, jc, jt), (P, S, C, T) = _molecular(order)
    ja = js.mol_alive[jp.mol_id] & jp.atom_ok
    ta = S.atom_alive(P)
    want = jcrystal.rd_crystal_full(js.pos, js.box, ja, jp, jc,
                                    jt.temperature, split_frozen=split)
    got = tcrystal.rd_crystal_full(S.pos, S.box, ta, P, C, T.temperature,
                                   split_frozen=split)
    for w, g in zip(want if split else [want], got if split else [got]):
        assert float(g) == pytest.approx(float(w), rel=1e-11)
    assert abs(float(want[0] if split else want)) > 1.0


@pytest.mark.parametrize("trial", [False, True])
def test_mol_rd_crystal_matches_reference(trial):
    """The per-molecule term (one-sided rows over every image and half the
    own images) of each sorbate, current or trial rows, rel 1e-11; the
    batched and stride-0 layouts give each chain's single call."""
    (jp, js, jc, jt), (P, S, C, T) = _molecular(2)
    ja = js.mol_alive[jp.mol_id] & jp.atom_ok
    ta = S.atom_alive(P)
    mols = [int(m) for m in np.nonzero(np.asarray(
        js.mol_alive & ~jp.mol_frozen))[0]][:3]
    rng = np.random.default_rng(2)
    rows_all = []
    for m in mols:
        rows = None
        if trial:
            rows = np.asarray(js.pos)[np.asarray(jp.mol_atoms[m])] + \
                rng.uniform(-0.7, 0.7, 3)
        rows_all.append(rows)
        want = jcrystal.mol_rd_crystal(
            js.pos, js.box, ja, jp, jc, jt.temperature, m,
            row_pos=None if rows is None else jnp.asarray(rows))
        got = tcrystal.mol_rd_crystal(
            S.pos, S.box, ta, P, C, T.temperature, torch.tensor(m),
            row_pos=None if rows is None else torch.as_tensor(rows))
        assert float(got) == pytest.approx(float(want), rel=1e-11)
    mt = torch.as_tensor(mols)
    rt = None if not trial else torch.as_tensor(np.stack(rows_all))
    shared = tcrystal.mol_rd_crystal_any(S.pos, S.box, ta, P, C,
                                         T.temperature, mt, row_pos=rt,
                                         shared=True)
    batched = tcrystal.mol_rd_crystal_any(
        S.pos.expand(3, -1, -1), S.box.expand(3, 3, 3), ta.expand(3, -1),
        P, C, T.temperature, mt, row_pos=rt)
    for k, m in enumerate(mols):
        one = tcrystal.mol_rd_crystal(S.pos, S.box, ta, P, C, T.temperature,
                                      mt[k], row_pos=None if rt is None
                                      else rt[k])
        assert float(shared[k]) == pytest.approx(float(one), rel=1e-13)
        assert float(batched[k]) == pytest.approx(float(one), rel=1e-13)


def test_pair_passes_route_like_the_reference():
    """pair_pass (split) and mol_pair_pass under rd_crystal: RD the image
    sum, ES and min r^2 from the rd-none cutoff pass — every field
    against the reference's, rel 1e-11; row_start and rd_lrc refused."""
    (jp, js, jc, jt), (P, S, C, T) = _molecular(2)
    ja = js.mol_alive[jp.mol_id] & jp.atom_ok
    ta = S.atom_alive(P)
    want = jpairs.pair_pass(js.pos, js.box, ja, jp, jc, jt.temperature,
                            split_frozen=True)
    got = tpairs.pair_pass(S.pos, S.box, ta, P, C, T.temperature,
                           split_frozen=True)
    for w, g in zip(want, got):
        for k in ("rd", "es_real", "es_excl"):
            assert float(getattr(g, k)) == pytest.approx(
                float(getattr(w, k)), rel=1e-11, abs=1e-9), k
    assert float(got[0].min_r2) == pytest.approx(float(want[0].min_r2),
                                                 rel=1e-12)
    m = int(np.nonzero(np.asarray(js.mol_alive & ~jp.mol_frozen))[0][0])
    wm = jpairs.mol_pair_pass(js.pos, js.box, ja, jp, jc, jt.temperature, m)
    gm = tpairs.mol_pair_pass(S.pos, S.box, ta, P, C, T.temperature,
                              torch.tensor(m))
    for k in ("rd", "es_real", "min_r2"):
        assert float(getattr(gm, k)) == pytest.approx(
            float(getattr(wm, k)), rel=1e-11), k
    with pytest.raises(ValueError, match="row-restricted"):
        tpairs.pair_pass(S.pos, S.box, ta, P, C, T.temperature, row_start=8)
    with pytest.raises(ValueError, match="rd_lrc off"):
        tpairs.pair_pass(S.pos, S.box, ta, P,
                         dataclasses.replace(C, rd_lrc=True), T.temperature)
    assert tm.frozen_refresh_rows(P, C) == 0


def _argon(ensemble, cap, n0, seed):
    rng = np.random.default_rng(seed)
    L = 10.0
    sp = Species(name="Ar", atom_names=("Ar",), pos=np.zeros((1, 3)),
                 mass=np.array([39.9]), charge=np.array([0.0]),
                 polar=np.array([0.0]), eps=np.array([90.0]),
                 sig=np.array([3.1]))
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.state import build_system
    params, state = build_system(
        L * np.eye(3), species=(sp,), capacity=(cap,), initial_counts=(n0,),
        initial_pos={0: rng.uniform(0, L, (n0, 1, 3))},
        dtype=torch.float64, device="cpu")
    cfg = RunConfig(ensemble=ensemble, coulomb="none", dtype="float64",
                    rd_crystal=True, rd_crystal_order=1, rd_lrc=False,
                    insert_species=(0,) if ensemble == "uvt" else (),
                    pair_chunk=16)
    thermo = Thermo.make(temperature=200.0, fugacity=[2.0], move_factor=0.7,
                         rot_factor=0.4, insert_probability=0.5,
                         n_species=1, dtype=torch.float64, device="cpu")
    return params, tm.initialize(state, params, cfg, thermo), cfg, thermo


@pytest.mark.parametrize("ensemble", ["nvt", "uvt"])
def test_rd_crystal_bookkeeping(ensemble):
    """The reference's test_rd_crystal_mc_bookkeeping and _gcmc_ on the
    port: 250 steps (inserts and deletes under µVT), the carried RD
    against a fresh initialize, rel 1e-9."""
    P, S, C, T = _argon(ensemble, 16 if ensemble == "uvt" else 12,
                        6 if ensemble == "uvt" else 12, 3)
    g = torch.Generator().manual_seed(1)
    st, stats = tm.run_chunk(S, P, C, T, 250, generator=g)
    fresh = tm.initialize(st, P, C, T)
    assert float(st.energy.rd) == pytest.approx(float(fresh.energy.rd),
                                                rel=1e-9, abs=1e-7)
    h = stats.host()
    assert 0 < h.accepts[0] < 250
    if ensemble == "uvt":
        assert h.attempts[1] > 0 and h.attempts[2] > 0


def test_rd_crystal_deck(tmp_path):
    """An rd_crystal deck through run.run: rd_lrc forced off by the
    parser, the log names the image-sum route, the run completes."""
    P, S, C, T = _argon("nvt", 12, 12, 5)
    tpqr.write_state(str(tmp_path / "ar.pqr"), P, S, ["Ar"])
    job = input_script.parse(f"""
ensemble nvt
numsteps 40
corrtime 20
temperature 150
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
precision float64
coulomb none
rd_crystal on
rd_crystal_order 2
pqr_input {tmp_path / 'ar.pqr'}
""")
    assert job.cfg.rd_crystal and not job.cfg.rd_lrc
    log = io.StringIO()
    su, avgs = trun.run(job, log=log, device="cpu")
    assert "periodic-image lattice sum (order 2" in log.getvalue()
    assert all(np.isfinite(v) and v != 0.0
               for v in avgs.samples["energy_rd"])
    fresh = tm.initialize(su.state, su.params, su.cfg, su.thermo)
    assert float(su.state.energy.rd) == pytest.approx(
        float(fresh.energy.rd), rel=1e-9)
