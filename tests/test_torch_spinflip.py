"""The spinflip move in the port's fused kernels' plain versions — B3
(run_steps, lane 8), B1 (run_steps_uvt, lane 11) and B6
(run_steps_uvt_pda, lane 11) — against the JAX package's Pallas kernels in
interpret mode on injected uniform tables: the same decisions, spinflip
counts and spins step for step.  Then the ports of the reference's fused
spinflip tests (tests/test_fused_mc.py:795-865, :887, :918, :938, :1367,
:2193-2263): the gates, pure-flip chunks, the ortho/para equilibrium, the
µVT bookkeeping, C chains against one, the polar delayed acceptance's
spinflips; and the scan step against the fused one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.models import systems  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.state import stack_chains  # noqa: E402

import torch_pda  # noqa: E402

torch.set_num_threads(1)
# f32 sums of the plain versions against the Pallas kernels (the
# tolerances of tests/test_torch_fused_uvt.py: A&S erfc and f32 sums there)
F32_SUM_ATOL = 5e-2
F32_SUM_RTOL = 1e-4


def _tables(M, rng, C=None):
    """A random rotor table (float32, +-100 K) and spins."""
    lead = () if C is None else (C,)
    return (rng.uniform(-100.0, 100.0, lead + (M, 2)).astype(np.float32),
            rng.integers(0, 2, lead + (M,)).astype(np.int32))


def _jax_qrot(kind, p_spin=0.3, seed=1, n_h2=8):
    """(params, state, cfg, thermo) of the JAX package: the MOF + H2 system
    (n_side 3) with quantum_rotation and random rotor tables and spins,
    under nvt or uvt, initialized."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=n_h2,
                                      capacity=n_h2 if kind == "nvt"
                                      else 2 * n_h2)
    c = dataclasses.replace(c, fused_mc=True, quantum_rotation=True,
                            **({"ensemble": "nvt"} if kind == "nvt" else {}))
    t = t.replace(spinflip_probability=jnp.asarray(p_spin, jnp.float32))
    s = jm.initialize(s, p, c, t)
    rot, spin = _tables(int(p.n_mols_max), np.random.default_rng(seed))
    return p, s.replace(rot_f=jnp.asarray(rot), spin=jnp.asarray(spin)), c, t


def _u(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_plain_b3_spinflip_matches_pallas():
    """B3 with spinflip (p_spin 0.3) on a [120, 16] table: the same
    displacement and spinflip counts, spins, positions within 1e-4 A and
    sums within the f32 rule."""
    p, s, c, t = _jax_qrot("nvt")
    mov, mova, a_max, mv_slots = jmk.movable_mols(p, np.asarray(s.mol_alive))
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    kv, kcoef = jm._fused_ktable(s.box, c, alpha)
    thr = c.cavity_autoreject_absolute
    K = 120
    u = _u((K, 16), 3)
    out = jmk.run_steps(
        s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov, mova,
        s.box, rc, alpha, 1.0 / t.temperature, t.move_factor, t.rot_factor,
        thr * thr, jnp.asarray(u), c, K, s.pos.shape[0], a_max=a_max,
        interpret=True, kvecs=kv, kcoef=kcoef, sk_re=s.sk_re, sk_im=s.sk_im,
        rot_f=s.rot_f[mv_slots], spin=s.spin[mv_slots], p_spin=0.3)
    P, S, C, T = convert.from_jax(p, s, c, t)
    args, kw = tm.fused_nvt_launch_args(
        stack_chains([S]), P, C, T, torch.as_tensor(u[None]),
        tm.nvt_fused_tables(P, S.mol_alive))
    pos, sums, _, _, spin = tmk.run_steps(*args, **kw)
    g = sums[0].numpy()
    want = [float(x) for x in out[1:5]] + [float(out[8]), float(out[9])]
    assert g[5] > 20 and 0 < g[4] < g[5]
    np.testing.assert_array_equal(g[3:6], want[3:6])
    np.testing.assert_array_equal(spin[0].numpy(),
                                  (np.asarray(out[7]) > 0.5).astype(int))
    np.testing.assert_allclose(g[:3], want[:3], rtol=F32_SUM_RTOL,
                               atol=F32_SUM_ATOL)
    np.testing.assert_allclose(pos[0].numpy(), np.asarray(out[0]), atol=1e-4)


def test_plain_b3_spinflip_multi_chain_matches_pallas():
    """C = 2 chains at 77 and 150 K, each with its own rotor table and
    spins, through run_steps_multi(interpret=True) and the plain B3: the
    same counts and spins per chain."""
    p, s, c, t = _jax_qrot("nvt")
    mov, mova, a_max, mv_slots = jmk.movable_mols(p, np.asarray(s.mol_alive))
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    kv, kcoef = jm._fused_ktable(s.box, c, alpha)
    thr = c.cavity_autoreject_absolute
    Cn, K = 2, 100
    u = _u((Cn, K, 16), 4)
    rot, spin = _tables(int(p.n_mols_max), np.random.default_rng(7), Cn)
    temps = np.asarray([77.0, 150.0], np.float32)
    betas = np.float32(1.0) / temps
    bc = lambda x: jnp.broadcast_to(x, (Cn,) + x.shape)  # noqa: E731
    new_pos, sums, _, _, spin_out = jmk.run_steps_multi(
        bc(s.pos), p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
        mova, s.box, rc, alpha, jnp.asarray(betas), t.move_factor,
        t.rot_factor, thr * thr, jnp.asarray(u.reshape(Cn * K, 16)), c, K,
        s.pos.shape[0], a_max=a_max, interpret=True, kvecs=kv, kcoef=kcoef,
        sk_re=bc(s.sk_re), sk_im=bc(s.sk_im),
        rot_f=jnp.asarray(rot[:, mv_slots]),
        spin=jnp.asarray(spin[:, mv_slots]), p_spin=0.3)
    P, S, C, T = convert.from_jax(p, s, c, t)
    SS = stack_chains([S] * Cn).replace(rot_f=torch.as_tensor(rot),
                                        spin=torch.as_tensor(spin))
    T2 = T.replace(temperature=torch.as_tensor(temps))
    args, kw = tm.fused_nvt_launch_args(SS, P, C, T2, torch.as_tensor(u),
                                        tm.nvt_fused_tables(P, S.mol_alive))
    pos, got, _, _, spin_p = tmk.run_steps(*args, **kw)
    want = np.asarray(sums)
    np.testing.assert_array_equal(got[:, 3:6].numpy(), want[:, 3:6])
    assert (got[:, 5].numpy() > 15).all()
    np.testing.assert_array_equal(spin_p.numpy(),
                                  (np.asarray(spin_out) > 0.5).astype(int))
    np.testing.assert_allclose(pos.numpy(), np.asarray(new_pos), atol=1e-4)


def _jax_uvt(p, s, c, t, u, rot=None, spin=None, betas=None):
    """The reference B1 (interpret mode): one chain (u [K, 16]) or C
    chains (u [C, K, 16], per-chain rot [C, M, 2], spin [C, M])."""
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, c)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, c, A_list, rep)
    thr = c.cavity_autoreject_absolute
    if u.ndim == 2:
        return jmk.run_steps_uvt(
            s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start,
            spidx, s.mol_alive[slots], tmpl, s.box, rc, alpha,
            1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
            t.insert_probability, k[4], k[0], k[1], k[2], k[3],
            jnp.asarray(u), c, u.shape[0], s.pos.shape[0], A_list=A_list,
            interpret=True, kvecs=k[5], kcoef=k[6], sk_re=s.sk_re,
            sk_im=s.sk_im, rot_f=s.rot_f[slots], spin=s.spin[slots],
            p_spin=t.spinflip_probability)
    Cn, K = u.shape[:2]
    bc = lambda x: jnp.broadcast_to(x, (Cn,) + x.shape)  # noqa: E731
    return jmk.run_steps_uvt_multi(
        bc(s.pos), p.eps, p.sig, p.charge, p.mass, bc(s.atom_alive(p)),
        start, spidx, bc(s.mol_alive[slots]), tmpl, s.box, rc, alpha,
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u.reshape(Cn * K, 16)), c, K, s.pos.shape[0],
        A_list=A_list, interpret=True, kvecs=k[5], kcoef=k[6],
        sk_re=bc(s.sk_re), sk_im=bc(s.sk_im),
        rot_f=jnp.asarray(rot[:, np.asarray(slots)]),
        spin=jnp.asarray(spin[:, np.asarray(slots)]),
        p_spin=t.spinflip_probability,
        betas=None if betas is None else jnp.asarray(betas))


@pytest.mark.parametrize("chains", [1, 2])
def test_plain_b1_spinflip_matches_pallas(chains):
    """B1 with spinflip (lane 11 < 0.3) on [C, 150, 16] tables, C = 1 and
    2 (C = 2 at 77 and 150 K with their own tables): the same 8 move
    counts (spinflip's too), slot aliveness and spins; positions within
    1e-4 A, sums within the f32 rule."""
    p, s, c, t = _jax_qrot("uvt", seed=2)
    P, S, C, T = convert.from_jax(p, s, c, t)
    K = 150
    if chains == 1:
        u = _u((K, 16), 5)
        out = _jax_uvt(p, s, c, t, u)
        SS, T2, uu = stack_chains([S]), T, u[None]
        want_sums = np.asarray(out[2])[None]
        want_sa, want_sp = np.asarray(out[1])[None], np.asarray(out[5])[None]
    else:
        u = _u((chains, K, 16), 6)
        rot, spin = _tables(int(p.n_mols_max), np.random.default_rng(8),
                            chains)
        temps = np.asarray([77.0, 150.0], np.float32)
        out = _jax_uvt(p, s, c, t, u, rot, spin, np.float32(1.0) / temps)
        SS = stack_chains([S] * chains).replace(
            rot_f=torch.as_tensor(rot), spin=torch.as_tensor(spin))
        T2 = T.replace(temperature=torch.as_tensor(temps))
        uu = u
        want_sums = np.asarray(out[2])
        want_sa, want_sp = np.asarray(out[1]), np.asarray(out[5])
    args, kw = tm.fused_uvt_launch_args(SS, P, C, T2, torch.as_tensor(uu),
                                        tm.uvt_fused_tables(P, C))
    pos, sa, sums, _, _, spin_p = tmk.run_steps_uvt(*args, **kw)
    got = sums.numpy()
    np.testing.assert_array_equal(got[:, 6:14], want_sums[:, 6:14])
    assert (got[:, 13] > 25).all() and (got[:, 12] > 0).all()
    assert got[:, 6:9].sum() > 5
    np.testing.assert_array_equal(sa.numpy(), want_sa)
    np.testing.assert_array_equal(spin_p.numpy(),
                                  (want_sp > 0.5).astype(int))
    np.testing.assert_allclose(got[:, :6], want_sums[:, :6],
                               rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
    np.testing.assert_allclose(pos.numpy().reshape(np.asarray(
        out[0]).shape), np.asarray(out[0]), atol=1e-4)


def test_plain_b6_spinflip_matches_pallas():
    """B6 with spinflip (p_spin 0.3) on the polar MOF + H2 system: a
    forced spinflip survivor at step 0 and natural tables — the same
    n_done, hit, move type, slot, species and attempts (spinflip's too)
    as the Pallas kernel; the other move types' records by
    torch_pda.assert_records_match."""
    p, s, c, t = torch_pda.jax_system("direct")
    c = dataclasses.replace(c, quantum_rotation=True)
    t = t.replace(spinflip_probability=jnp.asarray(0.3, jnp.float32))
    rot, spin = _tables(int(p.n_mols_max), np.random.default_rng(4))
    s = s.replace(rot_f=jnp.asarray(rot), spin=jnp.asarray(spin))
    P, S, C, T = convert.from_jax(p, s, c, t)
    rng = np.random.default_rng(12)
    tables = []
    u = rng.random((torch_pda.SEG, 16)).astype(np.float32)
    u[0, 4], u[0, 11] = 1e-30, 1e-30
    tables.append(u)
    tables += [rng.random((torch_pda.SEG, 16)).astype(np.float32)
               for _ in range(3)]
    kinds = set()
    slots = np.asarray(jm.uvt_fused_tables(p, c)[0])
    for u in tables:
        cfg = jmk.pda_effective_cfg(c, p)
        sl, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, cfg)
        want = _jax_pda_rec(p, s, c, t, u, cfg, sl, start, spidx, tmpl,
                            A_list, rep)
        got = torch_pda.port_rec(P, S, C, T, u)
        np.testing.assert_array_equal(got[0, [0, 1, 2, 3, 4, 6, 7, 8, 11]],
                                      want[0, [0, 1, 2, 3, 4, 6, 7, 8, 11]])
        if got[0, 1] > 0.5 and got[0, 2] == 3:
            kinds.add(3)
            assert (got[1, :6] == 0).all() and (got[0, 9:11] == 0).all()
            assert int(S.spin[slots[int(got[0, 3])]]) in (0, 1)
        elif got[0, 1] > 0.5:
            kinds.add(int(got[0, 2]))
            torch_pda.assert_records_match(got, want)
    assert 3 in kinds and len(kinds) >= 2


def _jax_pda_rec(p, s, c, t, u, cfg, slots, start, spidx, tmpl, A_list,
                 rep):
    """torch_pda.jax_rec with the rotor table and spins in slot order."""
    from mpmc_tpu.ops import thole as jthole
    rc = jpairs.derived_cutoff(s.box, cfg)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, cfg, A_list, rep)
    paf, pkrc = jthole._field_variant_consts(s.box, cfg, cfg.jdtype)
    thr = cfg.cavity_autoreject_absolute
    return np.asarray(jmk.run_steps_uvt_pda(
        s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start, spidx,
        s.mol_alive[slots], tmpl, s.box, rc, jpairs.derived_alpha(rc, cfg),
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u, jnp.float32), cfg, u.shape[0], s.pos.shape[0],
        A_list=A_list, e0=s.e0, polar=p.polar, polar_damp=cfg.polar_damp,
        interpret=True, kvecs=k[5], kcoef=k[6], sk_re=s.sk_re,
        sk_im=s.sk_im, polar_field_alpha=0.0 if paf is None else paf,
        polar_field_krc=0.0 if pkrc is None else pkrc,
        rot_f=s.rot_f[slots], spin=s.spin[slots],
        p_spin=t.spinflip_probability), np.float64)


# ---------------------------------------------------------------------------
# ports of the reference's fused spinflip tests
# ---------------------------------------------------------------------------

def _port_qrot(kind, dF=100.0, p_spin=0.5, n_h2=8, coulomb="wolf"):
    """The port's MOF + H2 system (n_side 3, float32) under nvt or uvt
    with quantum_rotation and a hand-set table (F_para 0, F_ortho dF),
    every spin para — the reference's _h2_qrot_nvt / _h2_qrot_uvt."""
    p, s, c, t = systems.mof_h2_gcmc(
        n_side=3, n_h2=n_h2, capacity=n_h2 if kind == "nvt" else 2 * n_h2,
        ewald_kmax=3, device="cpu")
    c = dataclasses.replace(c, coulomb=coulomb, fused_mc=True,
                            quantum_rotation=True,
                            **({"ensemble": "nvt"} if kind == "nvt"
                               else {}))
    t = t.replace(spinflip_probability=torch.tensor(p_spin))
    s = tm.initialize(s, p, c, t)
    M = p.n_mols_max
    rot = torch.zeros((M, 2))
    rot[:, 1] = dF
    return p, s.replace(rot_f=rot, spin=torch.zeros(M, dtype=torch.int32)), \
        c, t


def test_spinflip_gates():
    """(:795) B3 takes spinflip where every movable molecule is a rotor,
    B1 where every insert species is; monatomic movables are refused by
    both, NPT (the hybrid path) and NVE always."""
    p, s, c, t = _port_qrot("nvt")
    assert tmk.supported(c, p) and tmk.supported_multi(c, p)
    assert tmk.supported_uvt(dataclasses.replace(
        c, ensemble="uvt", insert_species=(0,)), p)
    assert not tmk.supported_npt(dataclasses.replace(c, ensemble="npt"), p)
    assert not tmk.supported(dataclasses.replace(c, ensemble="nve"), p)
    p1, _, c1, _ = systems.lj_fluid(n=16, device="cpu")
    assert not tmk.supported(dataclasses.replace(c1, quantum_rotation=True),
                             p1)
    assert not tmk.supported_uvt(dataclasses.replace(
        c1, ensemble="uvt", insert_species=(0,), quantum_rotation=True), p1)
    assert not tmk.supported_uvt_polar_da(dataclasses.replace(
        c1, ensemble="uvt", insert_species=(0,), quantum_rotation=True,
        polarization=True, polar_delayed=True), p1)


@pytest.mark.parametrize("kind", ["nvt", "uvt"])
def test_pure_flip_chunk(kind):
    """(:818, :887) p_spin = 1: every step a spinflip — positions,
    aliveness, S(k) and every energy term bit-identical; 200 spinflip
    attempts, some accepted, nothing else attempted."""
    p, s, c, t = _port_qrot(kind, dF=50.0, p_spin=1.0, coulomb="ewald")
    run = tm.run_chunk_fused if kind == "nvt" else tm.run_chunk_fused_uvt
    g = torch.Generator().manual_seed(3)
    st, stats = run(s, p, c, t, 200, generator=g)
    assert torch.equal(st.pos, s.pos) and torch.equal(st.mol_alive,
                                                      s.mol_alive)
    assert torch.equal(st.sk_re, s.sk_re)
    assert float(st.energy.total) == float(s.energy.total)
    att, acc = stats.attempts, stats.host().accepts
    assert att[tm.SPINFLIP] == 200 and att[:tm.VOLUME].sum() == 0
    assert 0 < acc[tm.SPINFLIP] < 200
    assert int(st.spin.sum()) > 0


def test_ortho_para_equilibrium():
    """(:838) displace + spinflip (p_spin 0.5): the ortho fraction tends
    to the two-level weight e^{-dF/T} / (1 + e^{-dF/T}) (the table does
    not depend on positions here), and the energy bookkeeping holds."""
    dF = 100.0
    p, s, c, t = _port_qrot("nvt", dF=dF, p_spin=0.5)
    tables = tm.nvt_fused_tables(p, s.mol_alive)
    mv = tables[3]
    g = torch.Generator().manual_seed(4)
    st, fracs, n_disp = s, [], 0
    for i in range(20):
        st, stats = tm.run_chunk_fused(st, p, c, t, 100, generator=g,
                                       tables=tables)
        n_disp += int(stats.host().accepts[tm.DISPLACE])
        if i >= 4:
            fracs.append(float(st.spin[mv].double().mean()))
    w = np.exp(-dF / float(t.temperature))
    assert np.mean(fracs) == pytest.approx(w / (1 + w), abs=0.08)
    assert n_disp > 0
    fresh = tm.initialize(st, p, c, t)
    assert float(st.energy.rd) == pytest.approx(float(fresh.energy.rd),
                                                rel=2e-4, abs=5e-2)


def test_uvt_mixed_bookkeeping():
    """(:918) insert / delete / displace / spinflip: the carried terms
    equal a recompute, the attempts partition the chunk, exchanges ran."""
    p, s, c, t = _port_qrot("uvt", dF=80.0, p_spin=0.25)
    g = torch.Generator().manual_seed(6)
    st, stats = tm.run_chunk_fused_uvt(s, p, c, t, 400, generator=g)
    att, acc = stats.attempts, stats.host().accepts
    assert att.sum() == 400 and att[tm.SPINFLIP] > 0
    assert acc[tm.INSERT] + acc[tm.DELETE] > 0
    fresh = tm.initialize(st, p, c, t)
    for term in ("rd", "es_real", "lrc"):
        assert float(getattr(st.energy, term)) == pytest.approx(
            float(getattr(fresh.energy, term)), rel=2e-4, abs=5e-2), term


@pytest.mark.parametrize("kind", ["nvt", "uvt"])
def test_multi_chain_equals_single_chain(kind):
    """(:938, :1367) each chain of a C = 3 launch with its own table and
    spins equals the single-chain launch on its own rows, bit for bit."""
    p, s, c, t = _port_qrot(kind, dF=60.0, p_spin=0.3, n_h2=4)
    Cn, K = 3, 120
    rng = np.random.default_rng(9)
    rot = torch.zeros((Cn, p.n_mols_max, 2))
    rot[..., 1] = torch.as_tensor(30.0 + 70.0 * rng.random(
        (Cn, p.n_mols_max)), dtype=torch.float32)
    spin = torch.as_tensor(rng.random((Cn, p.n_mols_max)) < 0.5,
                           dtype=torch.int32)
    states = stack_chains([s] * Cn).replace(rot_f=rot, spin=spin)
    u = torch.as_tensor(_u((Cn, K, 16), 10))
    multi = (tm.run_chunk_fused_multi if kind == "nvt"
             else tm.run_chunk_fused_uvt_multi)
    one = tm.run_chunk_fused if kind == "nvt" else tm.run_chunk_fused_uvt
    out, stats = multi(states, p, c, t, K, uniforms=u)
    assert stats.attempts[:, tm.SPINFLIP].sum() > 0
    assert stats.attempts.sum() == Cn * K
    for k in range(Cn):
        sk, st_k = one(s.replace(rot_f=rot[k], spin=spin[k]), p, c, t, K,
                       uniforms=u[k])
        assert torch.equal(sk.pos, out.pos[k])
        assert torch.equal(sk.spin, out.spin[k])
        np.testing.assert_array_equal(st_k.attempts, stats.attempts[k])


def _port_qrot_pda(dF=50.0, p_spin=1.0, spin0=0):
    """The polar MOF + H2 system (n_side 3, 6 H2 in 12 slots, float32)
    with quantum_rotation and polar_delayed under fused_mc, a hand-set
    table (F_para 0, F_ortho dF) and every spin spin0 — the reference's
    _h2_qrot_polar_pda."""
    p, s, c, t = systems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=12,
                                     ewald_kmax=3, polarization=True,
                                     device="cpu")
    c = dataclasses.replace(c, fused_mc=True, quantum_rotation=True,
                            polar_delayed=True)
    t = t.replace(spinflip_probability=torch.tensor(p_spin))
    s = tm.initialize(s, p, c, t)
    M = p.n_mols_max
    rot = torch.zeros((M, 2))
    rot[:, 1] = dF
    return p, s.replace(rot_f=rot, spin=torch.full((M,), spin0,
                                                   dtype=torch.int32)), \
        c, t


def test_pda_pure_flip_chunk():
    """(:2213) p_spin = 1 through B6: positions, aliveness, S(k), dipoles
    and every energy term bit-identical, only spins and the spinflip
    counts move, and no SCF runs."""
    p, s, c, t = _port_qrot_pda()
    assert tmk.supported_uvt_polar_da(c, p)
    g = torch.Generator().manual_seed(2)
    st, stats = tm.run_chunk_fused_uvt_polar_da(s, p, c, t, 200,
                                                generator=g)
    for f in ("pos", "mol_alive", "sk_re", "mu"):
        assert torch.equal(getattr(st, f), getattr(s, f)), f
    assert float(st.energy.total) == float(s.energy.total)
    att, acc = stats.attempts, stats.host().accepts
    assert att[tm.SPINFLIP] >= 200 and att[:tm.VOLUME].sum() == 0
    assert 0 < acc[tm.SPINFLIP] <= att[tm.SPINFLIP]
    assert stats.polar_iters == 0
    assert int(st.spin.sum()) != int(s.spin.sum())


def test_pda_one_way_at_large_dF():
    """(:2237) dF = 800 K >> 77 K from all ortho: every alive rotor ends
    para, one accepted flip each, back-flips rejected."""
    p, s, c, t = _port_qrot_pda(dF=800.0, spin0=1)
    g = torch.Generator().manual_seed(3)
    st, stats = tm.run_chunk_fused_uvt_polar_da(s, p, c, t, 300,
                                                generator=g)
    mov = (st.mol_alive & ~p.mol_frozen & (p.mol_species >= 0))
    assert (st.spin[mov] == 0).all()
    acc, att = stats.host().accepts, stats.attempts
    assert acc[tm.SPINFLIP] == int(mov.sum())
    assert att[tm.SPINFLIP] > acc[tm.SPINFLIP]


def test_pda_mixed_bookkeeping():
    """(:2263) displace / insert / delete / spinflip through B6 and the
    exact SCF: the carried energy (polar term too) equals a recompute."""
    p, s, c, t = _port_qrot_pda(dF=60.0, p_spin=0.3)
    g = torch.Generator().manual_seed(4)
    st, stats = tm.run_chunk_fused_uvt_polar_da(s, p, c, t, 150,
                                                generator=g)
    att = stats.attempts
    assert att[tm.SPINFLIP] > 0 and att[tm.DISPLACE] > 0
    fresh = tm.initialize(st, p, c, t)
    assert float(st.energy.total) == pytest.approx(
        float(fresh.energy.total), rel=1e-3, abs=0.5)


@pytest.mark.parametrize("kind", ["nvt", "uvt"])
def test_scan_step_is_the_plain_twin(kind):
    """The scan step and the fused plain kernel on the same
    [300, 16] table in float64: lane 8 (nvt) or lane 11 (uvt) carves the
    same spinflips, with the same decisions and spins, and the same
    carried energy to rel 1e-9."""
    p, s, c, t = systems.mof_h2_gcmc(n_side=3, n_h2=6,
                                     capacity=6 if kind == "nvt" else 10,
                                     dtype="float64", device="cpu")
    c = dataclasses.replace(c, quantum_rotation=True,
                            **({"ensemble": "nvt"} if kind == "nvt" else {}))
    t = t.replace(spinflip_probability=torch.tensor(0.3,
                                                    dtype=torch.float64))
    s = tm.initialize(s, p, c, t)
    rot, spin = _tables(p.n_mols_max, np.random.default_rng(3))
    s = s.replace(rot_f=torch.as_tensor(rot, dtype=torch.float64),
                  spin=torch.as_tensor(spin))
    u = torch.as_tensor(np.random.default_rng(11).random((300, 16)))
    scan, st_s = tm.run_chunk(s, p, c, t, 300, uniforms=u)
    fused = tm.run_chunk_fused if kind == "nvt" else tm.run_chunk_fused_uvt
    fu, st_f = fused(s, p, c, t, 300, uniforms=u)
    np.testing.assert_array_equal(st_s.attempts, st_f.attempts)
    np.testing.assert_array_equal(st_s.host().accepts, st_f.host().accepts)
    assert st_s.attempts[tm.SPINFLIP] > 50
    assert torch.equal(scan.spin, fu.spin)
    assert torch.equal(scan.mol_alive, fu.mol_alive)
    assert float(scan.energy.total) == pytest.approx(
        float(fu.energy.total), rel=1e-9)
