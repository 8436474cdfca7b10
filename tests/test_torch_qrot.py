"""The port's rotor tables (mpmc_tpu_torch/ops/qrot.py) against the JAX
package's (mpmc_tpu/ops/qrot.py) in float64 — the grid potentials, the
levels and their l labels, the [M, 2] table, the batched drivers' initial
spins and tables, the on-device rebuild from level arrays — and the ports
of the reference's tests/test_qrot.py:34, :42, :57, :76, :229, :303 and
:326 (free and hindered rotors, the free energies and a spinflip, the nve
exclusion, the swap-time rebuild identity)."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import qrot as jq  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.config import RunConfig, Thermo  # noqa: E402
from mpmc_tpu_torch.constants import HBAR2_KB_AMU_A2  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.models import systems  # noqa: E402
from mpmc_tpu_torch.ops import qrot  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as pk  # noqa: E402
from mpmc_tpu_torch.state import build_system  # noqa: E402

torch.set_num_threads(1)


def _jittered_jax(seed):
    """The JAX package's MOF + H2 system (n_side 3, 6 H2) in float64 with
    the sorbates jittered by 0.3 A, initialized."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                      dtype="float64")
    rng = np.random.default_rng(seed)
    mov = ~np.asarray(p.mol_frozen)[np.asarray(p.mol_id)]
    pos = np.asarray(s.pos) + np.where(
        mov[:, None], rng.uniform(-0.3, 0.3, np.asarray(s.pos).shape), 0.0)
    s = s.replace(pos=jnp.asarray(pos))
    return p, jm.initialize(s, p, c, t), c, t


def test_tables_match_reference_f64():
    """V(Omega) of every rotor at rel 1e-10, its levels at rel 1e-9 with
    equal l labels, and the [M, 2] table at rel 1e-9, on a jittered
    geometry."""
    p, s, c, t = _jittered_jax(1)
    sp = [jsystems.h2_bss3()]
    P, S, C, T = convert.from_jax(p, s, c, t)
    th, ph, _ = jq.quadrature_grid()
    axes = jq.orientation_axes(th, ph)
    mols, _ = qrot.rotor_slots(S.mol_alive, P, sp)
    assert len(mols) == 6
    v = qrot.potentials_on_grid(S.pos, S.box, S.atom_alive(P), P, C,
                                T.temperature, mols, axes).numpy()
    for i, m in enumerate(mols):
        want = jq.potential_on_grid(s.pos, s.box, s.atom_alive(p), p, c,
                                    t.temperature, m, axes)
        np.testing.assert_allclose(v[i], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    e_ref = jq.eigen_tables(s.pos, s.box, s.atom_alive(p), s.mol_alive, p,
                            c, t, sp)
    e = qrot.eigen_tables(S.pos, S.box, S.atom_alive(P), S.mol_alive, P, C,
                          T, sp)
    assert sorted(e) == sorted(e_ref) == mols
    for m in mols:
        np.testing.assert_allclose(e[m][0], e_ref[m][0], rtol=1e-9,
                                   atol=1e-9 * np.abs(e_ref[m][0]).max())
        np.testing.assert_array_equal(e[m][1], e_ref[m][1])
    want = jq.free_energy_table(s.pos, s.box, s.atom_alive(p), s.mol_alive,
                                p, c, t, sp)
    got = qrot.free_energy_table(S.pos, S.box, S.atom_alive(P), S.mol_alive,
                                 P, C, T, sp)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert np.abs(want[mols, 1] - want[mols, 0]).min() > 1.0


def test_spherical_harmonics_match_scipy():
    """The numpy Y_lm of the basis against scipy's sph_harm_y (the
    reference's) on the 16 x 32 grid, l <= 4: within 1e-13."""
    from scipy.special import sph_harm_y
    th, ph, _ = qrot.quadrature_grid()
    y, ll = qrot.spherical_harmonics(4, th, ph)
    k = 0
    for l in range(5):
        for m in range(-l, l + 1):
            np.testing.assert_allclose(y[k], sph_harm_y(l, m, th, ph),
                                       rtol=0, atol=1e-13)
            assert ll[k] == l * (l + 1)
            k += 1


def test_batched_init_matches_reference():
    """The batched drivers' initial spins (default_rng(seed + 977), 3:1
    ortho) equal the reference's _qrot_init_batched's, and so do the
    per-chain tables at each chain's temperature (rel 1e-9)."""
    from mpmc_tpu.mc import run as jrun
    from mpmc_tpu.parallel import multichain as jmulti
    from mpmc_tpu_torch.mc import run as trun
    from mpmc_tpu_torch.parallel import multichain
    p, s, c, t = _jittered_jax(3)
    C, temps = 3, [77.0, 100.0, 130.0]
    jsu = jrun.Setup(params=p, state=s, cfg=c, thermo=t,
                     species=(jsystems.h2_bss3(),), species_names=["H2"],
                     frozen_mass=0.0)
    jstates, _ = jrun._qrot_init_batched(
        jsu, jmulti.stack_states(s, C, seed=c.seed), temps, 4)
    P, S, CF, T = convert.from_jax(p, s, c, t)
    tsu = trun.Setup(P, S, CF, T, (systems.h2_bss3(),), ["H2"], 0.0)
    tstates, eigs = trun._qrot_init_batched(
        tsu, multichain.stack_states(S, C), temps)
    np.testing.assert_array_equal(tstates.spin.numpy(),
                                  np.asarray(jstates.spin))
    np.testing.assert_allclose(tstates.rot_f.numpy(),
                               np.asarray(jstates.rot_f), rtol=1e-9,
                               atol=1e-9)
    assert len(eigs) == C and tstates.spin.dtype == torch.int32
    assert 0.5 < float(tstates.spin.double().mean()) < 0.95


def test_free_energies_from_levels_matches_host():
    """(:326) the rebuild from level arrays (the on-device per-swap path)
    equals table_from_eigs at rel 1e-12 at several temperatures, one
    replica or a stack with a temperature each; rows without a rotor map
    to zeros."""
    p, s, c, t = _jittered_jax(4)
    P, S, C, T = convert.from_jax(p, s, c, t)
    eigs = qrot.eigen_tables(S.pos, S.box, S.atom_alive(P), S.mol_alive, P,
                             C, T, [systems.h2_bss3()])
    lv, pr, va = (torch.as_tensor(x) for x in qrot.level_arrays(
        eigs, P.n_mols_max, 4))
    temps = (40.0, 77.0, 150.0)
    for temp in temps:
        host = qrot.table_from_eigs(eigs, P.n_mols_max, temp)
        dev = qrot.free_energies_from_levels(lv, pr, va, temp).numpy()
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)
    stack = qrot.free_energies_from_levels(
        lv.expand(3, -1, -1), pr.expand(3, -1, -1), va.expand(3, -1, -1),
        torch.tensor(temps, dtype=torch.float64)).numpy()
    for r, temp in enumerate(temps):
        np.testing.assert_allclose(stack[r], qrot.table_from_eigs(
            eigs, P.n_mols_max, temp), rtol=1e-12, atol=1e-12)
    lv0, par0, val0 = (torch.as_tensor(x)
                       for x in qrot.level_arrays({}, 3, 2))
    assert torch.equal(qrot.free_energies_from_levels(lv0, par0, val0, 50.0),
                       torch.zeros((3, 2), dtype=torch.float64))


def test_grid_pass_matches_per_chain_plain():
    """B4's plain version at position stride 0 (one batched [C, A, N]
    block) equals the per-chain plain B4 of each orientation within 1e-12
    (float64)."""
    p, s, c, t = systems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                     dtype="float64", device="cpu")
    s = tm.initialize(s, p, c, t)
    from mpmc_tpu_torch.ops import pairs
    mols = torch.as_tensor(qrot.rotor_slots(s.mol_alive, p,
                                            [systems.h2_bss3()])[0][:2])
    axes = torch.as_tensor(qrot._basis(4, 16, 32)[3][::37])
    rows = qrot.grid_rows(s.pos, p, mols, axes)
    G = axes.shape[0]
    rows = rows.reshape(-1, rows.shape[2], 3).contiguous()
    mol = mols.repeat_interleave(G)
    scal = pairs.pair_scalars(s.box, c)
    alive = s.atom_alive(p)
    got = pk.mol_pair_chains(s.pos, p.charge, p.eps, p.sig, p.mol_id32,
                             alive, p.mol_atoms, p.mol_natoms, mol, rows,
                             scal, c)
    for k in range(mol.shape[0]):
        want = pk.mol_pair_plain(s.pos, p.charge, p.eps, p.sig, p.mol_id32,
                                 alive, p.mol_atoms, p.mol_natoms, mol[k],
                                 rows[k], scal, c)
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# ports of tests/test_qrot.py
# ---------------------------------------------------------------------------

def _h2_system(box_len=30.0, with_frozen=False):
    """One H2 (BSS 3-site) in a cubic box, optionally beside one charged
    LJ site — the reference's h2_system, float64 on the CPU."""
    sp = systems.h2_bss3()
    fpos = fp = None
    coulomb = "none"
    if with_frozen:
        fpos = np.array([[5.0, 5.0, 5.0]])
        fp = {"charge": np.array([0.8]), "mass": np.array([40.0]),
              "eps": np.array([60.0]), "sig": np.array([3.2]),
              "polar": np.array([0.0])}
        coulomb = "cutoff"
    cfg = RunConfig(ensemble="nvt", rd_potential="lj", coulomb=coulomb,
                    rd_lrc=False, dtype="float64")
    params, state = build_system(
        np.eye(3) * box_len, frozen_pos=fpos, frozen_params=fp,
        species=(sp,), capacity=(1,), initial_counts=(1,),
        initial_pos={0: (sp.pos + np.full(3, box_len / 2))[None]},
        dtype=cfg.tdtype, device="cpu")
    return sp, params, state, cfg


def test_rotational_constant_h2():
    """(:34) B of H2 from its geometry."""
    b = qrot.rotational_constant(systems.h2_bss3())
    inertia = 2 * 1.008 * 0.371 ** 2
    assert b == pytest.approx(HBAR2_KB_AMU_A2 / (2 * inertia), rel=1e-12)
    assert 80.0 < b < 95.0


def test_free_rotor_spectrum():
    """(:42) an isolated H2: levels B l(l+1), 2l+1 of each l."""
    sp, params, state, cfg = _h2_system()
    evals, l_of = qrot.rotational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        torch.tensor(300.0, dtype=torch.float64), 0, sp, lmax=3)
    b = qrot.rotational_constant(sp)
    want = np.concatenate([[b * l * (l + 1)] * (2 * l + 1)
                           for l in range(4)])
    np.testing.assert_allclose(np.sort(evals), np.sort(want), rtol=1e-8,
                               atol=1e-8)
    for l in range(4):
        assert np.sum(l_of == l) == 2 * l + 1


def test_hindered_rotor_splits_levels():
    """(:57) H2 beside a charged LJ site: the l = 1 manifold splits and
    the levels leave the free ladder."""
    sp, params, state, cfg = _h2_system(with_frozen=True)
    pos = state.pos.clone()
    pos[1:4] += torch.tensor([6.6, 5.0, 5.0],
                             dtype=torch.float64) - state.pos[1]
    state = state.replace(pos=pos)
    evals, _ = qrot.rotational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        torch.tensor(300.0, dtype=torch.float64), 1, sp, lmax=3)
    b = qrot.rotational_constant(sp)
    e = np.sort(evals) - np.sort(evals)[0]
    assert e[1:4].max() - e[1:4].min() > 1e-2
    free = np.sort(np.concatenate([[b * l * (l + 1)] * (2 * l + 1)
                                   for l in range(4)]))
    assert np.max(np.abs(e - free)) > 1.0


def test_symmetry_free_energies_and_spinflip():
    """(:76) at 40 K F_para ~ 0 and F_ortho ~ 2B - T ln 3; a rotor started
    ortho flips to para through the scan path's spinflip move (the
    reference drives its host spinflip_sweep, which has no caller in the
    engine and is not ported) and stays there: at the ends of 40 chunks
    of 5 flips it is ortho at most 8 times (the two-level weight
    e^{-dF/T} / (1 + e^{-dF/T}) ~ 0.04 expects 1.6)."""
    sp, params, state, cfg = _h2_system()
    temp = 40.0
    evals, l_of = qrot.rotational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        torch.tensor(temp, dtype=torch.float64), 0, sp, lmax=3)
    f_para, f_ortho = qrot.symmetry_free_energies(evals, l_of, temp)
    b = qrot.rotational_constant(sp)
    assert f_para == pytest.approx(0.0, abs=1e-2)
    assert f_ortho == pytest.approx(2 * b - temp * np.log(3.0), rel=1e-3)
    cfg = dataclasses.replace(cfg, quantum_rotation=True)
    thermo = Thermo.make(temperature=temp, n_species=1,
                         spinflip_probability=1.0, dtype=torch.float64,
                         device="cpu")
    st = tm.initialize(state, params, cfg, thermo)
    st = st.replace(spin=torch.ones(1, dtype=torch.int32),
                    rot_f=torch.tensor([[f_para, f_ortho]],
                                       dtype=torch.float64))
    g = torch.Generator().manual_seed(0)
    ortho = flips = 0
    for _ in range(40):
        st, stats = tm.run_chunk(st, params, cfg, thermo, 5, generator=g)
        assert stats.attempts[tm.SPINFLIP] == 5
        flips += int(stats.accepts[tm.SPINFLIP])
        ortho += int(st.spin[0])
    assert flips >= 1 and ortho <= 8
    assert torch.equal(st.pos, state.pos)


def test_spinflip_excluded_under_nve():
    """(:229) under nve the move is off, with the reference's warning;
    every other ensemble carries it as the last branch."""
    cfg = RunConfig(ensemble="nve", quantum_rotation=True)
    assert not tm.spinflip_active(cfg)
    with pytest.warns(UserWarning, match="nve"):
        _, ids = tm.make_branch_picker(cfg)
    assert ids == [tm.DISPLACE]
    for ens in ("nvt", "uvt", "npt"):
        cfg = RunConfig(ensemble=ens, quantum_rotation=True,
                        insert_species=(0,) if ens == "uvt" else ())
        assert tm.spinflip_active(cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            pick, ids = tm.make_branch_picker(cfg)
        assert ids[-1] == tm.SPINFLIP
        thermo = Thermo.make(spinflip_probability=0.3, n_species=1,
                             insert_probability=0.5, device="cpu")
        lanes = np.array([0.1, 0.5, 0.9])
        # nvt carves on lane 8, uvt and npt on lane 11
        b = pick(lanes, lanes[::-1], thermo)
        spin = b == len(ids) - 1
        assert (spin == ((lanes if ens == "nvt" else lanes[::-1]) < 0.3)
                ).all()


def test_table_from_eigs_swap_rebuild_identity():
    """(:303) the table rebuilt at a new temperature from cached
    eigensolves equals a fresh table there (no Feynman-Hibbs: the
    potential does not depend on T), and differs from the old one."""
    sp, params, state, cfg = _h2_system(with_frozen=True)
    t1 = Thermo.make(temperature=77.0, n_species=1, dtype=torch.float64,
                     device="cpu")
    t2 = t1.replace(temperature=torch.tensor(150.0, dtype=torch.float64))
    eigs = qrot.eigen_tables(state.pos, state.box, state.atom_alive(params),
                             state.mol_alive, params, cfg, t1, [sp], lmax=3)
    rebuilt = qrot.table_from_eigs(eigs, params.n_mols_max, 150.0)
    fresh = qrot.free_energy_table(state.pos, state.box,
                                   state.atom_alive(params), state.mol_alive,
                                   params, cfg, t2, [sp], lmax=3)
    np.testing.assert_allclose(rebuilt, fresh, rtol=1e-12, atol=1e-12)
    assert np.max(np.abs(qrot.table_from_eigs(eigs, params.n_mols_max, 77.0)
                         - rebuilt)) > 1e-3
