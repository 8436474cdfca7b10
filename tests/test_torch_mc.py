"""The port's scan-path Monte Carlo (mpmc_tpu_torch/mc) against the JAX
package: energy bookkeeping, one-move deltas, an injected-uniform
trajectory against the fused µVT kernel, and the ideal-gas anchor."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig, Thermo  # noqa: E402
from mpmc_tpu.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.models import systems  # noqa: E402
from mpmc_tpu.ops import ewald as jewald  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel  # noqa: E402
from mpmc_tpu.state import Species, build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402

torch.set_num_threads(1)


def _hcl_gcmc():
    """Neutral 2-site molecule GCMC with Ewald in f64 (the system of
    tests/test_mc.py::test_gcmc_ewald_bookkeeping)."""
    sp = Species(name="hcl", atom_names=("H", "Cl"),
                 pos=np.array([[0, 0, 0], [1.3, 0, 0]]),
                 mass=np.array([1.0, 35.5]), charge=np.array([0.2, -0.2]),
                 polar=np.zeros(2), eps=np.array([20.0, 120.0]),
                 sig=np.array([2.5, 3.4]))
    params, state = build_system(12.0 * np.eye(3), species=(sp,),
                                 capacity=(20,), initial_counts=(6,),
                                 dtype=jnp.float64, seed=7)
    cfg = RunConfig(ensemble="uvt", coulomb="ewald", dtype="float64",
                    ewald_kmax=6, insert_species=(0,), pair_chunk=32)
    thermo = Thermo.make(temperature=250.0, fugacity=(50.0,),
                         insert_probability=0.4, move_factor=0.6,
                         rot_factor=0.8, n_species=1, dtype=jnp.float64)
    return params, state, cfg, thermo


def test_gcmc_ewald_bookkeeping():
    """After 400 GCMC steps the carried energy equals a fresh refresh."""
    P, S, C, T = convert.from_jax(*_hcl_gcmc())
    S = tm.initialize(S, P, C, T)
    S2, stats = tm.run_chunk(S, P, C, T, 400,
                             generator=torch.Generator().manual_seed(3))
    fresh = tm.initialize(S2, P, C, T)
    assert int(stats.accepts[tm.INSERT]) > 0
    assert int(stats.accepts[tm.DELETE]) > 0
    for k in ("rd", "es_real", "es_recip", "es_self", "es_excl", "lrc"):
        assert float(getattr(S2.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-8, abs=1e-6), k
    # the caller's state is untouched by the in-place chunk commit
    assert torch.equal(S.pos, convert.from_jax(*_hcl_gcmc())[1].pos)


def _one_step(P, S, C, T, u, branch):
    """One step of the port with an injected uniform row and a forced
    branch; returns (carry after the step, stats)."""
    step, carry, c, _, stats = tm.chunk_setup(S, P, C, T, u[None])
    step(carry, u, branch, T, c, stats)
    return carry, stats


@pytest.mark.parametrize("move", ["displace", "insert", "delete"])
def test_one_move_delta_matches_jax_f64(move):
    """The port's energy delta of one accepted move equals the JAX scan
    path's pieces: mol_pair_pass, intra_terms, the S(k) delta and the
    molecule self energy (f64, rel 1e-10)."""
    p, s, c, t = _hcl_gcmc()
    s = jm.initialize(s, p, c, t)
    P, S, C, T = convert.from_jax(p, s, c, t)
    u = torch.full((16,), 0.5, dtype=torch.float64)
    u[4] = 0.0                    # coin: accept unless hard-rejected
    u[1:4] = torch.tensor([0.81, 0.23, 0.57], dtype=torch.float64)
    u[5:8] = torch.tensor([0.37, 0.71, 0.29], dtype=torch.float64)
    if move == "insert":
        u[1:4] = 0.5              # the cell centre, 5.2 A from any molecule
    branch = {"displace": 0, "insert": 1, "delete": 2}[move]
    mask = S.mol_alive if move != "insert" else ~S.mol_alive
    mask = mask & (P.mol_species == 0)
    mol, _ = tmoves.pick_by_rank(mask, u[0])
    mol = int(mol)
    if move == "displace":
        rows = tmoves.displace_rows(S.pos, P, torch.tensor(mol), u,
                                    T.move_factor, T.rot_factor)
    elif move == "insert":
        rows = tmoves.place_rows(P, torch.tensor(mol), torch.tensor(0), u,
                                 S.box)
    carry, stats = _one_step(P, S, C, T, u, branch)
    assert int(stats.accepts[branch]) == 1
    d_port = {k: float(getattr(carry["energy"], k) - getattr(S.energy, k))
              for k in ("rd", "es_real", "es_recip", "es_self", "es_excl",
                        "lrc")}

    alive = s.atom_alive(p)
    kw = dict(row_pos=jnp.asarray(rows.numpy())) if move != "delete" else {}
    new = jpairs.mol_pair_pass(s.pos, s.box, alive, p, c, t.temperature,
                               mol, **kw)
    vol = float(np.abs(np.linalg.det(np.asarray(s.box))))
    rc = jpairs.derived_cutoff(s.box, c)
    kv, pw = jewald.ktable(s.box, c)

    def recip(d_re, d_im):
        e = jewald.recip_energy_from_sk(s.sk_re + d_re, s.sk_im + d_im,
                                        s.box, jpairs.derived_alpha(rc, c),
                                        kv, pw)
        return float(e - s.energy.es_recip)

    if move == "displace":
        old = jpairs.mol_pair_pass(s.pos, s.box, alive, p, c,
                                   t.temperature, mol)
        want = {"rd": float(new.rd - old.rd),
                "es_real": float(new.es_real - old.es_real),
                "es_recip": recip(*jm._mol_sf_delta(
                    s.pos, jnp.asarray(rows.numpy()), s.box, p, c, mol)),
                "es_self": 0.0, "es_excl": 0.0, "lrc": 0.0}
    else:
        sign = 1.0 if move == "insert" else -1.0
        own = jpairs.mol_lrc_self_coefficient(p, c, rc, mol)
        if move == "insert":
            sf = jm._mol_sf_rows(jnp.asarray(rows.numpy()), s.box, p, c, mol)
            intra = jpairs.intra_terms(s.pos, s.box, p, c, mol,
                                       row_pos=jnp.asarray(rows.numpy()))
        else:
            sf = tuple(-x for x in jm._mol_structure_factor(
                s.pos, s.box, p, c, mol))
            intra = jpairs.intra_terms(s.pos, s.box, p, c, mol)
        want = {"rd": sign * float(new.rd),
                "es_real": sign * float(new.es_real),
                "es_recip": recip(*sf),
                "es_self": sign * float(jm._mol_self_energy(p, c, s.box,
                                                            mol)),
                "es_excl": sign * float(intra),
                "lrc": sign * float((new.lrc_coeff + 0.5 * own) / vol)}
    for k, w in want.items():
        assert d_port[k] == pytest.approx(w, rel=1e-10, abs=1e-9), k


def test_trajectory_matches_fused_uvt_kernel():
    """The same numpy-made [200, 16] uniform table through JAX's fused
    µVT kernel (interpret mode, set up as metropolis._fused_chunk_uvt
    does) and through the port's run_chunk: identical accept/attempt
    counts and final aliveness, positions within 1e-4 A (f32)."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, dtype="float32")
    state = jm.initialize(state, params, cfg, thermo)
    K = 200
    u = np.random.default_rng(5).random((K, 16)).astype(np.float32)
    slots, slot_start, species_idx, tmpl, A_list, rep_slots = (
        jm.uvt_fused_tables(params, cfg))
    rc = jpairs.derived_cutoff(state.box, cfg)
    alpha = jpairs.derived_alpha(rc, cfg)
    d_self, d_excl, c1, cx, lnfv, kv, kcoef = jm._uvt_chunk_consts(
        state.pos, state.box, params, thermo, cfg, A_list, rep_slots)
    thr = cfg.cavity_autoreject_absolute
    new_pos, slot_alive, sums, _, _, _, _ = mc_kernel.run_steps_uvt(
        state.pos, params.eps, params.sig, params.charge, params.mass,
        state.atom_alive(params), slot_start, species_idx,
        state.mol_alive[slots], tmpl, state.box, rc, alpha,
        1.0 / thermo.temperature, thermo.move_factor, thermo.rot_factor,
        thr * thr, thermo.insert_probability, lnfv, d_self, d_excl, c1, cx,
        jnp.asarray(u), cfg, K, state.pos.shape[0], A_list=A_list,
        interpret=True, kvecs=kv, kcoef=kcoef, sk_re=state.sk_re,
        sk_im=state.sk_im)
    P, S, C, T = convert.from_jax(params, state, cfg, thermo)
    S2, stats = tm.run_chunk(S, P, C, T, K, uniforms=torch.as_tensor(u))
    s = np.asarray(sums)
    np.testing.assert_array_equal(stats.accepts.numpy()[:3], s[6:9])
    np.testing.assert_array_equal(stats.attempts[:3], s[9:12])
    assert s[6:9].sum() > 10          # the chain really moved
    np.testing.assert_array_equal(S2.mol_alive.numpy()[np.asarray(slots)],
                                  np.asarray(slot_alive))
    np.testing.assert_allclose(S2.pos.numpy(), np.asarray(new_pos),
                               atol=1e-4)


def test_gcmc_ideal_gas_occupancy():
    """Non-interacting GCMC: <N> = f V / kT (Poisson mean), to +-2.
    Every step is an insert or a delete (insert_probability 1): over
    8,000 sampled steps the standard error of <N> is ~0.7 (measured over
    five seeds), so +-2 is ~3 sigma."""
    L, T = 20.0, 300.0
    target_n = 20.0
    f_atm = target_n * T / L ** 3 / ATM2K_A3
    sp = Species(name="X", atom_names=("X",), pos=np.zeros((1, 3)),
                 mass=np.array([4.0]), charge=np.zeros(1),
                 polar=np.zeros(1), eps=np.zeros(1), sig=np.zeros(1))
    params, state = build_system(L * np.eye(3), species=(sp,),
                                 capacity=(80,), initial_counts=(0,),
                                 dtype=jnp.float64)
    cfg = RunConfig(ensemble="uvt", rd_potential="none", coulomb="none",
                    rd_lrc=False, dtype="float64", insert_species=(0,))
    thermo = Thermo.make(temperature=T, fugacity=(f_atm,),
                         insert_probability=1.0, move_factor=1.0,
                         rot_factor=0.1, n_species=1, dtype=jnp.float64)
    P, S, C, Th = convert.from_jax(params, state, cfg, thermo)
    S = tm.initialize(S, P, C, Th)
    g = torch.Generator().manual_seed(0)
    S, _ = tm.run_chunk(S, P, C, Th, 1000, generator=g)
    samples, att, acc = [], np.zeros(5), np.zeros(5)
    for _ in range(400):
        S, st = tm.run_chunk(S, P, C, Th, 20, generator=g)
        samples.append(float(S.n_molecules(P)))
        att += st.attempts
        acc += st.accepts.numpy()
    assert np.mean(samples) == pytest.approx(target_n, abs=2.0)
    assert att[tm.INSERT] > 500 and att[tm.DELETE] > 500
    assert acc[tm.INSERT] > 100 and acc[tm.DELETE] > 100


def test_nvt_displace_only_bookkeeping():
    """NVT (displace-only move table) on the LJ fluid keeps its carried
    energy equal to a fresh recompute."""
    p, s, c, t = systems.lj_fluid(n=32, dtype="float64", seed=3)
    c = dataclasses.replace(c, corrtime=100)
    P, S, C, T = convert.from_jax(p, s, c, t)
    S = tm.initialize(S, P, C, T)
    S2, stats = tm.run_chunk(S, P, C, T, 200,
                             generator=torch.Generator().manual_seed(1))
    assert stats.attempts[tm.DISPLACE] == 200
    assert 0 < int(stats.accepts[tm.DISPLACE]) < 200
    fresh = tm.initialize(S2, P, C, T)
    assert float(S2.energy.total) == pytest.approx(
        float(fresh.energy.total), rel=1e-9, abs=1e-6)
