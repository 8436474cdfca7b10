"""The port's fused µVT path (kernel B1's plain version and the chunk functions over it)
against the JAX package: the per-chunk constants and tables, injected-
uniform trajectories against the fused µVT Pallas kernel (interpret mode)
for one chain and for two, bookkeeping against a full recompute, the
deep-core insert trap, and the CLI's fused and chains decks."""
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
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.state import slice_chain, stack_chains  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
# f32 energy sums, plain B1 against the Pallas kernel: the Pallas kernel
# uses the A&S erfc (|error| <= 1.5e-7, ~1.5e-7 qq KE/r per pair: up to
# ~1e-3 K per Ewald pair of the H2 quadrupole at 1 A) and accumulates in
# f32 (self terms of +-3e5 K: ulp 0.03 K); the plain version uses the
# exact erfc and accumulates in f64
F32_SUM_ATOL = 5e-2
F32_SUM_RTOL = 1e-4


def _jax_system(dtype="float32", **kw):
    p, s, c, t = systems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                     dtype=dtype, **kw)
    return p, jm.initialize(s, p, c, t), c, t


def _jax_kernel_inputs(p, s, c, t):
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, c)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    consts = jm._uvt_chunk_consts(s.pos, s.box, p, t, c, A_list, rep)
    return slots, start, spidx, tmpl, A_list, rc, alpha, consts


def _port_plain(P, S, C, T, u):
    """The port's B1 (plain on CPU tensors) on stacked states S and the
    injected table u [C,K,16]: (pos, slot_alive, sums, sk_re, sk_im)."""
    args, kw = tm.fused_uvt_launch_args(S, P, C, T, torch.as_tensor(u),
                                        tm.uvt_fused_tables(P, C))
    return tmk.run_steps_uvt(*args, **kw)


def test_chunk_consts_and_tables_match_jax_f64():
    p, s, c, t = _jax_system("float64")
    slots, start, spidx, tmpl, A_list, rc, alpha, consts = (
        _jax_kernel_inputs(p, s, c, t))
    P, S, C, T = convert.from_jax(p, s, c, t)
    got = tm.uvt_fused_tables(P, C)
    for a, b in zip(got[:3], (slots, start, spidx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the reference keeps its template table in float32
    np.testing.assert_allclose(got[3].numpy(), np.asarray(tmpl), atol=1e-7)
    assert got[5] == A_list
    np.testing.assert_array_equal(got[4].numpy(), A_list)
    assert got[6] == jm.uvt_fused_tables(p, c)[5]
    mine = tm._uvt_chunk_consts(S.pos, S.box, P, T, C, got[5], got[6])
    names = ("d_self", "d_excl", "c1", "cx", "lnfv", "kvecs", "kcoef")
    for name, a, b in zip(names, mine, consts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    assert float(np.abs(np.asarray(consts[2])).max()) > 0   # LRC is on


def _assert_sums_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got[6:12], want[6:12])
    np.testing.assert_allclose(got[:6], want[:6], rtol=F32_SUM_RTOL,
                               atol=F32_SUM_ATOL)


def test_plain_b1_matches_pallas_kernel_one_chain():
    """One numpy-made [200,16] table through run_steps_uvt(interpret=True)
    and the port's plain B1 (C = 1): equal move counts and slot aliveness,
    positions within 1e-4 A, energy sums within the f32 tolerance."""
    p, s, c, t = _jax_system()
    slots, start, spidx, tmpl, A_list, rc, alpha, k = _jax_kernel_inputs(
        p, s, c, t)
    K = 200
    u = np.random.default_rng(5).random((K, 16)).astype(np.float32)
    thr = c.cavity_autoreject_absolute
    new_pos, slot_alive, sums, _, _, _, _ = jmk.run_steps_uvt(
        s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start,
        spidx, s.mol_alive[slots], tmpl, s.box, rc, alpha,
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3], jnp.asarray(u),
        c, K, s.pos.shape[0], A_list=A_list, interpret=True, kvecs=k[5],
        kcoef=k[6], sk_re=s.sk_re, sk_im=s.sk_im)
    P, S, C, T = convert.from_jax(p, s, c, t)
    pos, sa, got, _, _ = _port_plain(P, stack_chains([S]), C, T, u[None])
    assert float(np.asarray(sums)[6:9].sum()) > 10     # the chain moved
    _assert_sums_close(got[0].numpy(), sums)
    np.testing.assert_array_equal(sa[0].numpy(), np.asarray(slot_alive))
    np.testing.assert_allclose(pos[0].numpy(), np.asarray(new_pos),
                               atol=1e-4)


def test_plain_b1_matches_pallas_multi_chain():
    """C = 2 through run_steps_uvt_multi(interpret=True) and the port's
    plain B1: per chain the same counts, aliveness and positions; and
    chain c of the C = 2 launch equals a C = 1 launch on its own block."""
    p, s, c, t = _jax_system()
    slots, start, spidx, tmpl, A_list, rc, alpha, k = _jax_kernel_inputs(
        p, s, c, t)
    Cn, K = 2, 120
    u = np.random.default_rng(9).random((Cn, K, 16)).astype(np.float32)
    thr = c.cavity_autoreject_absolute
    alive = jnp.broadcast_to(s.atom_alive(p), (Cn,) + s.pos.shape[:1])
    new_pos, slot_alive, sums, _, _, _, _ = jmk.run_steps_uvt_multi(
        jnp.broadcast_to(s.pos, (Cn,) + s.pos.shape), p.eps, p.sig,
        p.charge, p.mass, alive, start, spidx,
        jnp.broadcast_to(s.mol_alive[slots], (Cn, len(slots))), tmpl,
        s.box, rc, alpha, 1.0 / t.temperature, t.move_factor, t.rot_factor,
        thr * thr, t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u.reshape(Cn * K, 16)), c, K, s.pos.shape[0],
        A_list=A_list, interpret=True, kvecs=k[5], kcoef=k[6],
        sk_re=jnp.broadcast_to(s.sk_re, (Cn,) + s.sk_re.shape),
        sk_im=jnp.broadcast_to(s.sk_im, (Cn,) + s.sk_im.shape))
    P, S, C, T = convert.from_jax(p, s, c, t)
    pos, sa, got, skr, ski = _port_plain(P, stack_chains([S] * Cn), C, T, u)
    exch = 0
    for ch in range(Cn):
        _assert_sums_close(got[ch].numpy(), np.asarray(sums)[ch])
        np.testing.assert_array_equal(sa[ch].numpy(),
                                      np.asarray(slot_alive)[ch])
        np.testing.assert_allclose(pos[ch].numpy(),
                                   np.asarray(new_pos)[ch], atol=1e-4)
        one = _port_plain(P, stack_chains([S]), C, T, u[ch:ch + 1])
        for a, b in zip(one, (pos, sa, got, skr, ski)):
            assert torch.equal(a[0], b[ch])
        exch += int(got[ch, 7] + got[ch, 8])
    assert exch > 0          # the comparison covered exchanges


def test_fused_bookkeeping_matches_full_recompute_f64():
    """run_chunk_fused_uvt in f64 on the CPU: after 500 steps every
    carried energy term equals a fresh initialize to 1e-9, and S(k)
    equals a fresh structure factor."""
    P, S, C, T = convert.from_jax(*_jax_system("float64"))
    S0 = tm.initialize(S, P, C, T)
    n0 = int(S0.n_molecules(P))
    st, stats = tm.run_chunk_fused_uvt(
        S0, P, C, T, 500, generator=torch.Generator().manual_seed(4))
    att, acc = stats.attempts, stats.host().accepts
    assert att.sum() == 500 and att[tm.INSERT] > 50 and att[tm.DELETE] > 50
    assert acc[tm.INSERT] + acc[tm.DELETE] > 0
    assert int(st.n_molecules(P)) - n0 == acc[tm.INSERT] - acc[tm.DELETE]
    assert st.step == S0.step + 500
    fresh = tm.initialize(st, P, C, T)
    for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl"):
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    np.testing.assert_allclose(st.sk_re.numpy(), fresh.sk_re.numpy(),
                               rtol=1e-9, atol=1e-9)
    # the caller's state is untouched
    assert torch.equal(S0.pos, tm.initialize(S, P, C, T).pos)


def test_overlap_insert_keeps_accumulators_finite():
    """A crafted insert 1e-4 A from an atom overflows the f32 LJ sum to
    inf: the step rejects and the returned sums stay finite (an
    accept-multiply would give 0 * inf = NaN)."""
    from mpmc_tpu_torch.config import RunConfig as TRunConfig
    from mpmc_tpu_torch.models import systems as tsystems
    from mpmc_tpu_torch.state import build_system as tbuild
    sp = tsystems.lj_atom()
    cfg = TRunConfig(ensemble="uvt", rd_potential="lj", coulomb="none",
                     rd_lrc=False, dtype="float32", insert_species=(0,),
                     fused_mc=True)
    params, state = tbuild(np.eye(3) * 10.0, species=(sp,), capacity=(2,),
                           initial_counts=(1,),
                           initial_pos={0: np.array([[[5.0, 5.0, 5.0]]])},
                           device="cpu")
    u = np.zeros((1, 1, 16), np.float32)
    u[0, 0, 1:4] = [0.5 + 1e-5, 0.5, 0.5]   # insert, COM 1e-4 A away
    u[0, 0, 4] = 0.5
    slots, start, spidx, A_list = tmk.movable_slots(params, (0,))
    f = torch.float32
    one = torch.ones(1, dtype=f)
    _, sa, sums, _, _ = tmk.run_steps_uvt(
        state.pos[None], state.atom_alive(params)[None], params.eps,
        params.sig, params.charge, params.mass, torch.as_tensor(start),
        torch.as_tensor(spidx),
        state.mol_alive[torch.as_tensor(slots, dtype=torch.int64)][None],
        torch.zeros((1, 1, 3), dtype=f), torch.tensor([1], dtype=torch.int32),
        state.box, 4.9, 0.0, torch.tensor([1.0 / 120.0]), 0.5, 0.0, 0.0, 1.0,
        torch.tensor([[5.0]]), one * 0, one * 0, one * 0,
        torch.zeros((1, 1), dtype=f), torch.as_tensor(u), cfg)
    s = sums[0].numpy()
    assert np.isfinite(s).all(), s
    assert s[7] == 0.0 and s[10] == 1.0    # attempted, rejected
    assert sa.numpy().tolist() == [[True, False]]


def _deck(tmp_path, *extra):
    text = (REPO / "examples" / "h2_sorption.inp").read_text()
    text = text.replace("numsteps         20000", "numsteps 400").replace(
        "corrtime         1000", "corrtime 200").replace(
        "examples/framework_h2.pqr",
        str(REPO / "examples" / "framework_h2.pqr"))
    deck = tmp_path / "deck.inp"
    deck.write_text(text + "\n".join(extra) + "\n")
    return deck


@pytest.mark.parametrize("extra", [
    ("fused_mc on",), ("fused_mc on", "chains 3"),
    ("fused_mc on", "chains 3", "parallel_restarts on")],
    ids=["fused", "fused-chains3", "fused-chains3-parallel-restarts"])
def test_cli_fused_decks_run(tmp_path, extra):
    deck = _deck(tmp_path, *extra)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "mpmc_tpu_torch", "--cpu",
                        str(deck)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "fused_mc:" in r.stdout and "=== averages ===" in r.stdout
    assert "WARNING" not in r.stdout
    assert r.stdout.count("\nstep ") == 2
    assert (tmp_path / "restart.pqr").stat().st_size > 0
    if "chains 3" in extra:
        assert "aggregate (3 chains" in r.stdout
    # one restart per chain, and a trajectory per chain beyond chain 0
    per_chain = ["restart.pqr-r0", "restart.pqr-r1", "restart.pqr-r2",
                 "traj.pqr-r1", "traj.pqr-r2"]
    made = [f for f in per_chain if (tmp_path / f).exists()]
    assert made == (per_chain if "parallel_restarts on" in extra else [])


@pytest.mark.parametrize("lines,item", [
    # chains without fused_mc, and under nve, run as batched scan chains,
    # polar chains too, and npt chains (item None: the deck runs; npt on
    # the deck's H2 without its frozen framework)
    (("chains 3", "polarization on"), None),
    (("fused_mc on", "ensemble npt", "chains 3", "volume_probability 0.2",
      "pressure 2000"), None),
], ids=["chains-without-fused", "fused-nve-chains"])
def test_fused_refusals(tmp_path, monkeypatch, lines, item):
    """Both once refused, now run: polar chains without fused_mc on the
    batched polar route, a few steps on the CPU; npt chains under
    fused_mc on the batched scan chains (the fused gates take no chains
    under NPT: a WARNING), each chain in its own box, the carried energy
    of each equal to a fresh recompute within rel 1e-4 (f32)."""
    import io
    if "ensemble npt" not in lines:
        job = input_script.parse_file(str(_deck(
            tmp_path, *lines, "numsteps 6", "corrtime 3")))
        buf = io.StringIO()
        su, _ = trun.run(job, log=buf, device="cpu")
        assert "batched scan chains (C=3)" in buf.getvalue()
        assert "WARNING" not in buf.getvalue()
        assert su.states.mu is not None and su.states.e0 is not None
        return
    monkeypatch.chdir(tmp_path)
    pqr = tmp_path / "h2_gas.pqr"
    pqr.write_text("".join(
        ln for ln in (REPO / "examples" / "framework_h2.pqr").open()
        if " F " not in ln))
    deck = _deck(tmp_path, *lines, "pop_histogram off")
    deck.write_text(deck.read_text().replace(
        str(REPO / "examples" / "framework_h2.pqr"), str(pqr)))
    buf = io.StringIO()
    su, avgs = trun.run(input_script.parse_file(str(deck)), log=buf,
                        device="cpu")
    out = buf.getvalue()
    assert "batched scan chains (C=3)" in out
    assert "WARNING: fused_mc requested but unsupported" in out
    assert 0 < avgs.mean("acc_volume") < 1
    assert len({float(b[0, 0]) for b in su.states.box}) == 3
    from mpmc_tpu_torch.mc import metropolis as tm
    from mpmc_tpu_torch.state import slice_chain
    for c in range(3):
        sc = slice_chain(su.states, c)
        fresh = tm.initialize(sc, su.params, su.cfg, su.thermo)
        assert float(sc.energy.total) == pytest.approx(
            float(fresh.energy.total), rel=1e-4, abs=1e-3)


def test_f64_fused_deck_takes_the_scan_path(tmp_path, monkeypatch):
    """The reference's gate refuses fusion in float64: a logged WARNING
    and the scan path, as in mpmc_tpu's run_mc."""
    import io
    monkeypatch.chdir(tmp_path)
    job = input_script.parse_file(str(_deck(tmp_path, "fused_mc on",
                                            "precision float64")))
    buf = io.StringIO()
    trun.run(job, log=buf, device="cpu")
    assert "WARNING: fused_mc requested but unsupported" in buf.getvalue()


def test_stack_and_slice_chains_round_trip():
    P, S, C, T = convert.from_jax(*_jax_system())
    st = stack_chains([S, S])
    assert st.pos.shape == (2,) + S.pos.shape
    assert st.energy.rd.shape == (2,)
    back = slice_chain(st, 1)
    assert torch.equal(back.pos, S.pos) and back.step == S.step
    assert torch.equal(back.sk_re, S.sk_re)


# clusters of G CTAs an H100 SXM holds at once, one CTA per SM (a cluster
# lies within one GPC), as chip_smoke.py's B1 and B3 phases log them from
# cudaOccupancyMaxActiveClusters
H100_RESIDENT = {16: 7, 8: 15, 4: 30, 2: 66}


@pytest.mark.parametrize("chains,want", [(1, 16), (2, 16), (16, 4),
                                         (32, 2), (64, 2), (100, 2)])
def test_cluster_size_of_the_bench_system(chains, want):
    """B1's cluster size at the 10.8k bench system (N = 10,797, 709
    k-vectors, 512 slots) in float32 on an H100: 16 CTAs for one chain,
    4 each for c16 and 2 each for c32, since the card holds fewer than 16
    clusters of 8 and fewer than 32 of 4; beyond 66 chains the smallest
    G, in waves."""
    assert tmk.cluster_size(chains, 10797, torch.float32, H100_RESIDENT,
                            709, 512) == want
    assert tmk.cluster_size(chains, 10797, torch.float32,
                            H100_RESIDENT) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_size_never_exceeds_shared_memory(dtype):
    """Every G that cluster_size picks has a slice within one block's
    227 KB of shared memory (less the kernels' static tables), and is the
    largest G that fits of which the card holds all C clusters at once,
    whenever some G that fits does; the float64 bench system first fits
    at G = 4."""
    for n in (1, 300, 5000, 10797, 20000, 40000):
        for chains in (1, 2, 3, 7, 8, 16, 32, 33, 66, 67, 200):
            G = tmk.cluster_size(chains, n, dtype, H100_RESIDENT, 709, 512)
            assert G in tmk.CLUSTER_SIZES
            assert (tmk.slice_bytes(n, dtype, G, 709, 512)
                    <= tmk.SMEM_BYTES - tmk.SMEM_STATIC)
            fits = tmk.fitting_cluster_sizes(n, dtype, 709, 512)
            assert chains <= H100_RESIDENT[G] or G == min(fits)
            assert all(chains > H100_RESIDENT[g] for g in fits if g > G)
    assert min(tmk.fitting_cluster_sizes(10797, dtype, 709, 512)) == (
        4 if dtype == torch.float64 else 2)
    with pytest.raises(ValueError, match="do not fit"):
        tmk.cluster_size(1, 200000, dtype, H100_RESIDENT)


def _b1_cpu_launch():
    """The launch arguments of a two-chain [2, 40, 16] table on the small
    MOF + H2 system, on the CPU."""
    p, s, c, t = _jax_system()
    P, S, C, T = convert.from_jax(p, s, c, t)
    u = np.random.default_rng(2).random((2, 40, 16)).astype(np.float32)
    return tm.fused_uvt_launch_args(stack_chains([S, S]), P, C, T,
                                    torch.as_tensor(u),
                                    tm.uvt_fused_tables(P, C))


@pytest.mark.parametrize("bad", [0, 1, 3, 32, 2.5])
def test_run_steps_uvt_rejects_cluster_sizes(bad):
    args, kw = _b1_cpu_launch()
    with pytest.raises(ValueError, match="cluster="):
        tmk.run_steps_uvt(*args, **kw, cluster=bad)


def test_run_steps_uvt_rejects_a_slice_beyond_shared_memory():
    """cluster=2 in float32 at 40k columns needs ~550 KB per CTA."""
    args, kw = _b1_cpu_launch()
    n = 40000
    big = list(args)
    big[0] = torch.zeros((2, n, 3))
    big[1] = torch.zeros((2, n), dtype=torch.bool)
    for i in (2, 3, 4, 5):
        big[i] = torch.zeros(n)
    with pytest.raises(ValueError, match="cluster=2 needs"):
        tmk.run_steps_uvt(*big, **kw, cluster=2)


def test_plain_b1_ignores_cluster():
    """The plain version's results do not depend on cluster=."""
    args, kw = _b1_cpu_launch()
    want = tmk.run_steps_uvt(*args, **kw)
    assert float(want[2][:, 6:9].sum()) > 0
    for G in tmk.CLUSTER_SIZES:
        got = tmk.run_steps_uvt(*args, **kw, cluster=G)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = tmk.run_steps_uvt_plain(*args, **kw, cluster=G)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("chains,want", [(1, 16), (7, 16), (8, 8), (16, 4),
                                         (30, 4), (32, 2), (66, 2),
                                         (100, 2)])
def test_cluster_size_follows_the_resident_clusters(chains, want):
    """The largest G of which the card holds all C clusters at once;
    beyond that the smallest G that fits."""
    assert tmk.cluster_size(chains, 10797, torch.float32, H100_RESIDENT,
                            709, 512) == want
    # float64 first fits at G = 4
    assert tmk.cluster_size(chains, 10797, torch.float64, H100_RESIDENT,
                            709, 512) == max(want, 4)
