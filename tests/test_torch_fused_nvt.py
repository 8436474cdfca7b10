"""The port's fused NVT/NVE path (kernel B3's plain version and the chunk
functions over it) against the JAX package: injected-uniform trajectories
against the fused NVT Pallas kernel (interpret mode) for one chain, for
three chains at their own temperatures and under NVE; the port's fused
path against its own scan path; bookkeeping against a full recompute; the
gates; and the CLI's NVT, chains and NVE decks.

Every system is jittered off its lattice first (a seeded numpy shift per
movable molecule): the fresh lattices put pairs exactly at r = rc, where
two correct evaluations may count a tie differently."""
import dataclasses
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.models import systems  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu.parallel import replica  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script, pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.state import stack_chains  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
# clusters of G CTAs an H100 SXM holds at once, as chip_smoke.py's B1 and
# B3 phases log them from cudaOccupancyMaxActiveClusters
H100_RESIDENT = {16: 7, 8: 15, 4: 30, 2: 66}
# f32 energy sums, plain B3 against the Pallas kernel: the Pallas kernel
# uses the A&S erfc (|error| <= 1.5e-7, ~1e-3 K per Ewald pair of the H2
# quadrupole at 1 A) and accumulates in f32; the plain version uses the
# exact erfc and accumulates in f64 (the tolerances of the fused µVT tests)
F32_SUM_ATOL = 5e-2
F32_SUM_RTOL = 1e-4
POS_ATOL = 1e-4       # A, f32 positions after the chunk
SK_RTOL = 1e-4        # S(k), relative to its largest entry


def _jitter(p, s, seed):
    """Shift every alive movable molecule by a seeded uniform vector in
    [-0.3, 0.3) A (rigidly)."""
    mol_id = np.asarray(p.mol_id)
    mov = (~np.asarray(p.mol_frozen)) & (np.asarray(p.mol_species) >= 0)
    shift = np.random.default_rng(seed).uniform(-0.3, 0.3, (len(mov), 3))
    shift[~mov] = 0.0
    pos = np.asarray(s.pos) + shift[mol_id]
    return s.replace(pos=jnp.asarray(pos, s.pos.dtype))


def _lj(n=48, dtype="float32", ensemble="nvt", seed=1, reservoir=180.0):
    """The LJ fluid, jittered; under nve with ``reservoir`` K per atom
    above its energy (180 K: the reservoir of tests/test_fused_mc.py)."""
    p, s, c, t = systems.lj_fluid(n=n, dtype=dtype)
    c = dataclasses.replace(c, ensemble=ensemble, fused_mc=True)
    s = jm.initialize(_jitter(p, s, seed), p, c, t)
    if ensemble == "nve":
        e = float(s.energy.total) + reservoir * n
        t = t.replace(nve_energy=jnp.asarray(e, c.jdtype))
    return p, s, c, t


def _mof(dtype="float32", seed=2):
    p, s, c, t = systems.mof_h2_gcmc(n_side=4, n_h2=12, capacity=24,
                                     dtype=dtype)
    c = dataclasses.replace(c, ensemble="nvt", fused_mc=True)
    return p, jm.initialize(_jitter(p, s, seed), p, c, t), c, t


def _jax_run(p, s, c, t, u, betas=None, nve=None):
    """The Pallas kernel (interpret mode) on the [C, K, 8] table ``u``, set
    up as metropolis._fused_chunk_nvt(_multi) does: (pos [C,N,3], sums
    [C,4] = d_rd d_es d_recip n_acc, sk_re [C,Nk] or None)."""
    mov, mova, a_max, _ = jmk.movable_mols(p, np.asarray(s.mol_alive))
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    kv, kcoef = jm._fused_ktable(s.box, c, alpha)
    thr = c.cavity_autoreject_absolute
    Cn, K = u.shape[0], u.shape[1]
    N = s.pos.shape[0]
    ew = c.coulomb == "ewald"
    if betas is None:
        out = jmk.run_steps(
            s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
            mova, s.box, rc, alpha, 1.0 / t.temperature, t.move_factor,
            t.rot_factor, thr * thr, jnp.asarray(u[0]), c, K, N,
            a_max=a_max, interpret=True, kvecs=kv, kcoef=kcoef,
            sk_re=s.sk_re, sk_im=s.sk_im,
            **({} if nve is None else dict(nve_k0=nve[0], nve_g=nve[1])))
        pos = np.asarray(out[0])[None]
        sums = np.asarray([[float(x) for x in out[1:5]]])
        sk = np.asarray(out[5])[None] if ew else None
        return pos, sums, sk
    bc = lambda x: jnp.broadcast_to(x, (Cn,) + x.shape)  # noqa: E731
    new_pos, sums, skr, _, _ = jmk.run_steps_multi(
        bc(s.pos), p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
        mova, s.box, rc, alpha, betas, t.move_factor, t.rot_factor,
        thr * thr, jnp.asarray(u.reshape(Cn * K, 8)), c, K, N, a_max=a_max,
        interpret=True, kvecs=kv, kcoef=kcoef,
        sk_re=bc(s.sk_re) if ew else None, sk_im=bc(s.sk_im) if ew else None)
    return (np.asarray(new_pos), np.asarray(sums)[:, :4],
            np.asarray(skr) if ew else None)


def _port_run(P, S, C, T, u):
    """The port's B3 (plain on CPU tensors) on S stacked C-fold and the
    injected table u [C,K,16]: (pos, sums [C,4], sk_re, sk_im)."""
    args, kw = tm.fused_nvt_launch_args(
        stack_chains([S] * u.shape[0]), P, C, T, torch.as_tensor(u),
        tm.nvt_fused_tables(P, S.mol_alive))
    return tmk.run_steps(*args, **kw)


def _assert_close(port, want):
    pos, sums, skr, _ = port
    w_pos, w_sums, w_sk = want
    s = sums.numpy()
    np.testing.assert_array_equal(s[:, 3], w_sums[:, 3])
    np.testing.assert_allclose(s[:, :3], w_sums[:, :3], rtol=F32_SUM_RTOL,
                               atol=F32_SUM_ATOL)
    np.testing.assert_allclose(pos.numpy(), w_pos, rtol=0, atol=POS_ATOL)
    if w_sk is not None:
        scale = float(np.abs(w_sk).max())
        np.testing.assert_allclose(skr.numpy(), w_sk, rtol=0,
                                   atol=SK_RTOL * scale)


@pytest.mark.parametrize("system", ["lj48", "mof_h2_ewald"])
def test_plain_b3_matches_pallas_kernel_one_chain(system):
    """One numpy-made table through run_steps(interpret=True) and the
    port's plain B3 (C = 1): equal acceptance counts, positions within
    1e-4 A, sums within abs 5e-2 K + rel 1e-4, S(k) within 1e-4."""
    p, s, c, t = _lj() if system == "lj48" else _mof()
    K = 200 if system == "lj48" else 150
    u = np.random.default_rng(5).random((1, K, 16)).astype(np.float32)
    want = _jax_run(p, s, c, t, u[..., :8])
    got = _port_run(*convert.from_jax(p, s, c, t), u)
    assert 10 < want[1][0, 3] < K - 10          # a real mix of decisions
    _assert_close(got, want)


def test_plain_b3_matches_pallas_multi_chain_ladder():
    """C = 3 at the temperatures of a geometric 80-400 K ladder through
    run_steps_multi(interpret=True) and the port's plain B3 (a per-chain
    temperature [C] in Thermo): per chain the checks of the single-chain
    test, and hotter chains accept more."""
    p, s, c, t = _mof()
    Cn, K = 3, 100
    temps = replica.geometric_ladder(80.0, 400.0, Cn).astype(np.float32)
    u = np.random.default_rng(9).random((Cn, K, 16)).astype(np.float32)
    want = _jax_run(p, s, c, t, u[..., :8],
                    betas=1.0 / jnp.asarray(temps, jnp.float32))
    P, S, C, T = convert.from_jax(p, s, c, t)
    got = _port_run(P, S, C, T.replace(temperature=torch.as_tensor(temps)),
                    u)
    _assert_close(got, want)
    acc = got[1][:, 3].numpy()
    assert acc[0] < acc[2], acc


@pytest.mark.parametrize("reservoir", [180.0, 600.0],
                         ids=["180K-per-atom", "600K-per-atom"])
def test_plain_b3_matches_pallas_kernel_nve(reservoir):
    """NVE (Ray's rule) on lj_fluid(n=32) over 150 steps: the port's
    reservoir nve_energy - (U + U_frozen) and exponent f_dof/2 - 1 against
    run_steps(interpret=True, nve_k0=, nve_g=) with the same values.  At
    180 K per atom (the reference test's) the effective temperature, 2/3
    of it, is the fluid's 120 K; at 600 K per atom it is 400 K, and the
    decisions must differ from NVT's on the same table."""
    p, s, c, t = _lj(n=32, ensemble="nve", reservoir=reservoir)
    u = np.random.default_rng(11).random((1, 150, 16)).astype(np.float32)
    P, S, C, T = convert.from_jax(p, s, c, t)
    args, kw = tm.fused_nvt_launch_args(
        stack_chains([S]), P, C, T, torch.as_tensor(u),
        tm.nvt_fused_tables(P, S.mol_alive))
    assert kw["nve_g"] == 1.5 * 32 - 1.0
    k0 = float(t.nve_energy) - float(s.energy.total)
    assert float(kw["nve_k0"][0]) == pytest.approx(k0, rel=1e-6)
    want = _jax_run(p, s, c, t, u[..., :8], nve=(k0, kw["nve_g"]))
    assert 10 < want[1][0, 3] < 140
    got = tmk.run_steps(*args, **kw)
    _assert_close(got, want)
    if reservoir == 600.0:
        nvt = _port_run(P, S, dataclasses.replace(C, ensemble="nvt"), T, u)
        assert int(nvt[1][0, 3]) != int(got[1][0, 3])


@pytest.mark.parametrize("ensemble", ["nvt", "nve"])
def test_fused_matches_scan_path_f64(ensemble):
    """One [K,16] table through the port's scan path (run_chunk) and its
    fused path (run_chunk_fused, plain B3) in f64: the same accept counts,
    positions equal to 1e-10 A (the scan path rotates by a quaternion,
    B3 by the equivalent matrix), and the same carried energy to 1e-9."""
    if ensemble == "nvt":
        P, S, C, T = convert.from_jax(*_mof("float64"))
    else:
        P, S, C, T = convert.from_jax(*_lj(n=32, dtype="float64",
                                           ensemble="nve"))
    K = 150
    u = torch.as_tensor(np.random.default_rng(21).random((K, 16)))
    a, sa = tm.run_chunk(S, P, C, T, K, uniforms=u)
    b, sb = tm.run_chunk_fused(S, P, C, T, K, uniforms=u)
    assert 10 < int(sa.accepts[tm.DISPLACE]) < K - 10
    np.testing.assert_array_equal(sa.attempts, sb.attempts)
    np.testing.assert_array_equal(sa.accepts.numpy(), sb.accepts.numpy())
    np.testing.assert_allclose(b.pos.numpy(), a.pos.numpy(), rtol=0,
                               atol=1e-10)
    assert float(b.energy.total) == pytest.approx(float(a.energy.total),
                                                  rel=1e-9, abs=1e-9)
    assert b.step == a.step == S.step + K


@pytest.mark.parametrize("ensemble", ["nvt", "nve"])
def test_fused_bookkeeping_matches_full_recompute_f64(ensemble):
    """run_chunk_fused in f64 on the CPU: after 300 steps every carried
    energy term equals a fresh initialize to 1e-9 (NVT: the MOF + H2
    system under Ewald, S(k) too; NVE: the LJ fluid, whose reservoir stays
    positive), and the caller's state is untouched."""
    if ensemble == "nvt":
        P, S, C, T = convert.from_jax(*_mof("float64"))
    else:
        P, S, C, T = convert.from_jax(*_lj(n=32, dtype="float64",
                                           ensemble="nve"))
    pos0 = S.pos.clone()
    st, stats = tm.run_chunk_fused(
        S, P, C, T, 300, generator=torch.Generator().manual_seed(4))
    assert stats.attempts[tm.DISPLACE] == 300
    assert 20 < int(stats.accepts[tm.DISPLACE]) < 280
    fresh = tm.initialize(st, P, C, T)
    for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl"):
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    if C.coulomb == "ewald":
        np.testing.assert_allclose(st.sk_re.numpy(), fresh.sk_re.numpy(),
                                   rtol=1e-9, atol=1e-9)
    if ensemble == "nve":
        u = st.energy.total + st.e_frozen.total
        assert float(T.nve_energy - u) > 0
    assert torch.equal(S.pos, pos0)


def test_gates_agree_with_the_reference():
    """supported / supported_multi against mc_kernel.supported /
    supported_multi on the port's surface (Feynman-Hibbs and spinflip
    included: refused on the monatomic fluid and under nve, taken on the
    MOF + H2 rotors; the RD forms, sg here, taken as the reference
    takes them)."""
    cases = []
    p, s, c, t = _lj()
    pm, sm, cm, tmo = _mof()
    for params, cfg in ((p, c), (pm, cm)):
        for kw in ({}, {"ensemble": "nve"}, {"coulomb": "wolf"},
                   {"coulomb": "cutoff"}, {"coulomb": "none"},
                   {"mixing_rule": "waldman_hagler"}, {"ensemble": "uvt"},
                   {"ensemble": "npt"}, {"dtype": "float64"},
                   {"polarization": True}, {"feynman_hibbs": True},
                   {"quantum_rotation": True},
                   {"quantum_rotation": True, "ensemble": "nve"},
                   {"rd_potential": "sg"}):
            cases.append((params, dataclasses.replace(cfg, **kw), True))
    P, PM = convert.from_jax(p, s, c, t)[0], convert.from_jax(
        pm, sm, cm, tmo)[0]
    n_true = 0
    for params, cfg, _ in cases:
        tp = P if params is p else PM
        tc = convert.config_from(cfg)
        for jgate, tgate in ((jmk.supported, tmk.supported),
                             (jmk.supported_multi, tmk.supported_multi)):
            got = tgate(tc, tp)
            assert got == jgate(cfg, params), (cfg, tgate)
            n_true += got
    assert n_true >= 8


def _lj_deck(tmp_path, *extra, n=32, numsteps=400, corrtime=200):
    """The port's LJ fluid written with io/pqr.write_state and a deck of
    its own (argon at 120 K, move_factor 0.5, coulomb off)."""
    params, state, cfg, _ = tsystems.lj_fluid(n=n, device="cpu")
    tpqr.write_state(str(tmp_path / "fluid.pqr"), params, state, ["AR"])
    L = float(state.box[0, 0])
    deck = tmp_path / "fluid.inp"
    deck.write_text("\n".join([
        f"numsteps {numsteps}", f"corrtime {corrtime}", "seed 3",
        "temperature 120", f"basis1 {L} 0 0", f"basis2 0 {L} 0",
        f"basis3 0 0 {L}", "move_factor 0.5", "rot_factor 0",
        "coulomb off", "pqr_input fluid.pqr", "pqr_restart restart.pqr",
        *extra]) + "\n")
    return deck


def _run_deck(deck, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        buf = io.StringIO()
        su, avgs = trun.run(input_script.parse_file(str(deck)), log=buf,
                            device="cpu")
    finally:
        os.chdir(old)
    return su, avgs, buf.getvalue()


def test_cli_fused_nvt_decks_run(tmp_path):
    """``python -m mpmc_tpu_torch --cpu`` on an NVT deck with fused_mc:
    the single-chain B3 path, one log line per corrtime, a restart; then
    the same deck with chains 3 through run.run."""
    deck = _lj_deck(tmp_path, "ensemble nvt", "fused_mc on")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "mpmc_tpu_torch", "--cpu",
                        str(deck)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "fused_mc: single-chain fused NVT kernel" in r.stdout
    assert "WARNING" not in r.stdout and "=== averages ===" in r.stdout
    assert r.stdout.count("\nstep ") == 2
    assert (tmp_path / "restart.pqr").stat().st_size > 0
    deck3 = _lj_deck(tmp_path, "ensemble nvt", "fused_mc on", "chains 3")
    su, avgs, out = _run_deck(deck3, tmp_path)
    assert "chain-interleaved multi-chain kernel (C=3)" in out
    assert "aggregate (3 chains" in out and "WARNING" not in out
    assert su.states.pos.shape[0] == 3 and avgs.count() == 2
    assert not torch.equal(su.states.pos[0], su.states.pos[1])


def test_cli_fused_nve_deck_runs(tmp_path):
    """An NVE deck with fused_mc and total_energy = U0 + 180 K per atom (U0
    from ``ensemble te`` on the same deck): the B3 path, a reservoir that
    stays positive, and a mean energy below the total."""
    te = _lj_deck(tmp_path, "ensemble te")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        e0 = float(trun.run(input_script.parse_file(str(te)),
                            log=io.StringIO(), device="cpu").total)
    finally:
        os.chdir(old)
    total = e0 + 180.0 * 32
    deck = _lj_deck(tmp_path, "ensemble nve", "fused_mc on",
                    f"total_energy {total}")
    su, avgs, out = _run_deck(deck, tmp_path)
    assert "fused_mc: single-chain fused NVT kernel" in out
    assert "WARNING" not in out
    u = su.state.reported_energy().total
    assert 0 < total - float(u) and avgs.mean("energy_total") < total


@pytest.mark.parametrize("lines,item", [
    # npt runs now (item None), with fused_mc on the hybrid path: B3
    # segments between scan-path volume attempts
    (("ensemble npt", "fused_mc on", "pressure 200",
      "volume_probability 0.05", "volume_change_factor 0.05"), None),
    # nve chains run as batched scan chains, with polarization too (item
    # None: the deck runs, under nve with no delayed acceptance)
    (("ensemble nve", "fused_mc on", "chains 3", "total_energy 0",
      "polarization on"), None),
], ids=["npt", "nve-chains"])
def test_nvt_slice_refusals(tmp_path, lines, item):
    """Both once refused, now run: npt under fused_mc takes the hybrid
    fused NPT path (B3's plain version here), the box moves and the
    carried energy of the f32 fluid stays within rel 1e-4 of a fresh
    recompute; polar nve chains under fused_mc run as batched polar
    chains (the fused gates refuse polarization: a WARNING), a few steps
    on the CPU."""
    if "ensemble npt" in lines:
        deck = _lj_deck(tmp_path, *lines)
        su, avgs, out = _run_deck(deck, tmp_path)
        assert "fused_mc: hybrid fused NPT (B3 segments + scan-path " \
               "volume moves)" in out
        assert "WARNING" not in out and su.state.step == 400
        assert 0 < avgs.mean("acc_volume") < 1
        fresh = tm.initialize(su.state, su.params, su.cfg, su.thermo)
        assert float(su.state.energy.total) == pytest.approx(
            float(fresh.energy.total), rel=1e-4)
        return
    deck = _lj_deck(tmp_path, *lines, numsteps=6, corrtime=3)
    su, _, out = _run_deck(deck, tmp_path)
    assert "batched scan chains (C=3)" in out
    assert "WARNING: fused_mc requested but unsupported" in out
    assert su.states.mu is not None and su.states.pos.shape[0] == 3


def test_f64_fused_nvt_deck_takes_the_scan_path(tmp_path):
    """The reference's gate refuses fusion in float64: a logged WARNING
    and the scan path, as in mpmc_tpu's run_mc."""
    deck = _lj_deck(tmp_path, "ensemble nvt", "fused_mc on",
                    "precision float64")
    _, _, out = _run_deck(deck, tmp_path)
    assert "WARNING: fused_mc requested but unsupported" in out
    assert "fused_mc: single-chain" not in out


def test_entry_points_need_a_device_or_cuda():
    """build_system and Thermo.make run on the CUDA device unless the
    caller names another: here, with none, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mpmc_tpu_torch.config import Thermo
    from mpmc_tpu_torch.state import build_system
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(np.eye(3) * 10.0, species=(tsystems.lj_atom(),),
                     capacity=(2,), initial_counts=(1,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Thermo.make(temperature=120.0)
    p, _ = build_system(np.eye(3) * 10.0, species=(tsystems.lj_atom(),),
                        capacity=(2,), initial_counts=(1,), device="cpu")
    assert p.device.type == "cpu"
    assert Thermo.make(device="cpu").temperature.device.type == "cpu"


@pytest.mark.parametrize("chains,want", [(1, 16), (16, 4), (32, 2)])
@pytest.mark.parametrize("n,nk", [(10029, 709), (10000, 0)],
                         ids=["mof_h2", "lj10k"])
def test_cluster_size_of_the_nvt_systems(chains, want, n, nk):
    """B3's cluster size at the 10.0k MOF + H2 system (709 k-vectors) and
    the 10k LJ fluid in float32 on an H100 (H100_RESIDENT): 16 for one
    chain, 4 for c16, 2 for c32; the slice within shared memory."""
    G = tmk.cluster_size(chains, n, torch.float32, H100_RESIDENT, nk)
    assert G == want
    assert (tmk.slice_bytes(n, torch.float32, G, nk)
            <= tmk.SMEM_BYTES - tmk.SMEM_STATIC)


def _b3_cpu_launch(n=48):
    """The launch arguments of a two-chain [2, 40, 16] table on the LJ
    fluid of n atoms, on the CPU."""
    P, S, C, T = convert.from_jax(*_lj(n=n))
    u = np.random.default_rng(4).random((2, 40, 16)).astype(np.float32)
    return tm.fused_nvt_launch_args(stack_chains([S, S]), P, C, T,
                                    torch.as_tensor(u),
                                    tm.nvt_fused_tables(P, S.mol_alive))


@pytest.mark.parametrize("bad", [0, 1, 6, 64])
def test_run_steps_rejects_cluster_sizes(bad):
    args, kw = _b3_cpu_launch()
    with pytest.raises(ValueError, match="cluster="):
        tmk.run_steps(*args, **kw, cluster=bad)


def test_run_steps_rejects_a_slice_beyond_shared_memory():
    """cluster=2 in float32 at 40k columns needs ~550 KB per CTA."""
    args, kw = _b3_cpu_launch()
    n = 40000
    big = list(args)
    big[0] = torch.zeros((2, n, 3))
    big[1] = torch.zeros(n, dtype=torch.bool)
    for i in (2, 3, 4, 5):
        big[i] = torch.zeros(n)
    with pytest.raises(ValueError, match="cluster=2 needs"):
        tmk.run_steps(*big, **kw, cluster=2)


def test_plain_b3_ignores_cluster():
    """The plain version's results do not depend on cluster=."""
    args, kw = _b3_cpu_launch()
    want = tmk.run_steps(*args, **kw)
    assert float(want[1][:, 3].sum()) > 0
    for G in tmk.CLUSTER_SIZES:
        for fn in (tmk.run_steps, tmk.run_steps_plain):
            got = fn(*args, **kw, cluster=G)
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(got, want))
