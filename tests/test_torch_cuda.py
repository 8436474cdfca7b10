"""The CUDA kernels (the pair kernels B2/B4, the fused µVT kernel B1, the
fused NVT/NVE kernel B3 — both at every cluster size —, the Thole field
kernel B5 and the polar delayed-acceptance stage-1 kernel B6) against
their plain versions on the card.

These need a CUDA device and ``nvcc``; they skip elsewhere.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest`` because tests/conftest.py configures JAX).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.mc import metropolis  # noqa: E402
from mpmc_tpu_torch.models import systems  # noqa: E402
from mpmc_tpu_torch.ops import pairs, thole  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as mk  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as pk  # noqa: E402
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _system(dtype, device):
    return systems.mof_h2_gcmc(n_side=6, n_h2=20, capacity=40, dtype=dtype,
                               device=device)


def _close(k, p, dtype):
    k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
    rel, floor = (1e-12, 1e-9) if dtype == "float64" else (2e-5, 1e-3)
    np.testing.assert_allclose(k, p, rtol=rel, atol=floor)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_terms_kernel_matches_plain(device, dtype):
    params, state, cfg, _ = _system(dtype, device)
    args = (state.pos, params.charge, params.eps, params.sig,
            params.mol_id32, state.atom_alive(params),
            params.mol_frozen[params.mol_id],
            pairs.pair_scalars(state.box, cfg), cfg)
    for rs in (0, metropolis.frozen_refresh_rows(params, cfg)):
        before = pk.pair_terms.launches
        k = pk.pair_terms(*args, row_start=rs)
        torch.cuda.synchronize(device)
        assert pk.pair_terms.launches == before + 1
        _close(k, pk.pair_terms_plain(*args, row_start=rs), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_kernel_matches_plain(device, dtype):
    params, state, cfg, _ = _system(dtype, device)
    mol = torch.tensor(int(np.flatnonzero(
        state.mol_alive.cpu().numpy()
        & (params.mol_species >= 0).cpu().numpy())[0]), device=device)
    trial = (state.pos[0] + params.species_pos[0]
             + torch.tensor([2.2, 0.31, 0.17], dtype=state.pos.dtype,
                            device=device))
    for rows in (None, trial):
        args = (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, state.atom_alive(params), params.mol_atoms,
                params.mol_natoms, mol, rows,
                pairs.pair_scalars(state.box, cfg), cfg)
        k = pk.mol_pair(*args)
        torch.cuda.synchronize(device)
        _close(k, pk.mol_pair_plain(*args), dtype)


@pytest.mark.parametrize("chains,capacity", [(1, 40), (3, 40), (1, 700)],
                         ids=["c1", "c3", "c1-slots700"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uvt_kernel_matches_plain(device, dtype, chains, capacity):
    """B1 against its plain version on one numpy-made [C, 200, 16] table:
    the same move counts and slot aliveness; positions within 1e-9 A
    (f64) / 1e-4 A (f32); sums rel 1e-10 (f64) / 2e-5 (f32).  700 slots
    take the kernel's slot scan over two 512-slot tiles."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=capacity, dtype=dtype, device=device)
    state = metropolis.initialize(state, params, cfg, thermo)
    states = multichain.stack_states(state, chains)
    u = torch.as_tensor(np.random.default_rng(3).random((chains, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        states, params, cfg, thermo, u,
        metropolis.uvt_fused_tables(params, cfg))
    before = mk.run_steps_uvt.launches
    k = mk.run_steps_uvt(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps_uvt.launches == before + 1
    p = mk.run_steps_uvt_plain(*args, **kw)
    k_sums, p_sums = k[2].cpu().numpy(), p[2].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 6:12], p_sums[:, 6:12])
    assert p_sums[:, 6:9].sum() > 10 * chains     # the chains moved
    assert torch.equal(k[1], p[1])
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    np.testing.assert_allclose(k_sums[:, :6], p_sums[:, :6],
                               rtol=1e-10 if f64 else 2e-5,
                               atol=1e-8 if f64 else 1e-3)
    for a, b in zip(k[3:], p[3:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-10 if f64 else 1e-4,
                                   atol=1e-9 if f64 else 1e-4)


# NVE reservoir per molecule: an effective temperature 2 R / dof (400 K for
# argon, ~240 K for rigid H2) far from the decks' 120 K and 77 K, so that
# Ray's rule and Metropolis at the thermo's temperature decide apart
NVE_RESERVOIR = 600.0
NVT_CASES = [(sys_, c, ens) for sys_ in ("lj", "mof")
             for c, ens in ((1, "nvt"), (3, "nvt"), (1, "nve"))]


@pytest.mark.parametrize("system,chains,ensemble", NVT_CASES,
                         ids=[f"{a}-c{b}-{c}" for a, b, c in NVT_CASES])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nvt_kernel_matches_plain(device, dtype, system, chains, ensemble):
    """B3 against its plain version on one numpy-made [C, 200, 16] table:
    the LJ fluid (a_max 1, no Coulomb) and the MOF + H2 system (a_max 3,
    Ewald), C = 1 and 3, NVE for one chain (reservoir NVE_RESERVOIR per
    molecule): the same accept counts; positions within 1e-9 A (f64) /
    1e-4 A (f32); sums rel 1e-10 (f64) / 2e-5 + 2e-3 K sqrt(accepted + 1)
    (f32); S(k) as for B1.  Under NVE the kernel's accept count must also
    differ from an NVT launch on the same table: a kernel that ignored
    Ray's rule would fail there."""
    if system == "lj":
        params, state, cfg, thermo = systems.lj_fluid(n=300, dtype=dtype,
                                                      device=device)
    else:
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=6, n_h2=20, capacity=20, dtype=dtype, device=device)
    cfg = dataclasses.replace(cfg, ensemble=ensemble, fused_mc=True)
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    if ensemble == "nve":
        thermo = thermo.replace(nve_energy=state.reported_energy().total
                                + NVE_RESERVOIR * len(tables[0]))
    u = torch.as_tensor(np.random.default_rng(3).random((chains, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, chains), params, cfg, thermo, u,
        tables)
    before = mk.run_steps.launches
    k = mk.run_steps(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps.launches == before + 1
    p = mk.run_steps_plain(*args, **kw)
    k_sums, p_sums = k[1].cpu().numpy(), p[1].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 3], p_sums[:, 3])
    assert (p_sums[:, 3] > 10).all()              # the chains moved
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :3]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :3])
           + 2e-3 * np.sqrt(p_sums[:, 3:4] + 1.0))
    assert (np.abs(k_sums[:, :3] - p_sums[:, :3]) <= tol).all()
    if cfg.coulomb == "ewald":
        for a, b in zip(k[2:], p[2:]):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-10 if f64 else 1e-4,
                                       atol=1e-9 if f64 else 1e-4)
    if ensemble == "nve":
        a_nvt, kw_nvt = metropolis.fused_nvt_launch_args(
            multichain.stack_states(state, 1), params,
            dataclasses.replace(cfg, ensemble="nvt"), thermo, u, tables)
        nvt = mk.run_steps(*a_nvt, **kw_nvt)[1].cpu().numpy()
        assert nvt[0, 3] != k_sums[0, 3], (nvt[0, 3], k_sums[0, 3])


def _same_chains(launch, args, kw, C, G, slice_c):
    """Each chain of the C-chain launch equals, bit for bit, a C = 1
    launch on its own block at the same cluster size G."""
    k = launch(*args, **kw, cluster=G)
    for c in range(C):
        a1, kw1 = slice_c(c)
        one = launch(*a1, **kw1, cluster=G)
        assert all(x is None or torch.equal(x[0], y[c])
                   for x, y in zip(one, k)), c
    return k


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uvt_kernel_cluster_sizes(device, dtype, cluster):
    """B1 at each cluster size G on a [2, 200, 16] table: the plain
    version's move counts and slot aliveness, positions and sums within
    test_uvt_kernel_matches_plain's tolerances, and each chain equal to
    its C = 1 launch at the same G.  The 336 columns split into slices of
    ceil(336 / G), so molecules straddle ranks."""
    params, state, cfg, thermo = _system(dtype, device)
    state = metropolis.initialize(state, params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    u = torch.as_tensor(np.random.default_rng(5).random((2, 200, 16)),
                        dtype=cfg.tdtype, device=device)

    def launch_args(states, uu):
        return metropolis.fused_uvt_launch_args(states, params, cfg, thermo,
                                                uu, tables)

    args, kw = launch_args(multichain.stack_states(state, 2), u)
    k = _same_chains(mk.run_steps_uvt, args, kw, 2, cluster,
                     lambda c: launch_args(multichain.stack_states(state, 1),
                                           u[c:c + 1]))
    assert mk.run_steps_uvt.last_cluster == cluster
    p = mk.run_steps_uvt_plain(*args, **kw)
    k_sums, p_sums = k[2].cpu().numpy(), p[2].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 6:12], p_sums[:, 6:12])
    assert p_sums[:, 6:9].sum() > 20
    assert torch.equal(k[1], p[1])
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    np.testing.assert_allclose(k_sums[:, :6], p_sums[:, :6],
                               rtol=1e-10 if f64 else 2e-5,
                               atol=1e-8 if f64 else 1e-3)


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nvt_kernel_cluster_sizes(device, dtype, cluster):
    """B3 at each cluster size G on the MOF + H2 system (Ewald, 3-site
    molecules across slice boundaries) with a [2, 200, 16] table: the
    plain version's accept counts, test_nvt_kernel_matches_plain's
    tolerances, and each chain equal to its C = 1 launch at the same G."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=20, dtype=dtype, device=device)
    cfg = dataclasses.replace(cfg, ensemble="nvt", fused_mc=True)
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    u = torch.as_tensor(np.random.default_rng(6).random((2, 200, 16)),
                        dtype=cfg.tdtype, device=device)

    def launch_args(states, uu):
        return metropolis.fused_nvt_launch_args(states, params, cfg, thermo,
                                                uu, tables)

    args, kw = launch_args(multichain.stack_states(state, 2), u)
    k = _same_chains(mk.run_steps, args, kw, 2, cluster,
                     lambda c: launch_args(multichain.stack_states(state, 1),
                                           u[c:c + 1]))
    assert mk.run_steps.last_cluster == cluster
    p = mk.run_steps_plain(*args, **kw)
    k_sums, p_sums = k[1].cpu().numpy(), p[1].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 3], p_sums[:, 3])
    assert (p_sums[:, 3] > 10).all()
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :3]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :3])
           + 2e-3 * np.sqrt(p_sums[:, 3:4] + 1.0))
    assert (np.abs(k_sums[:, :3] - p_sums[:, :3]) <= tol).all()


@pytest.mark.parametrize("mode", ["charge", "dipole"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thole_kernel_matches_plain(device, dtype, mode):
    """B5 against its plain version on the polar MOF + H2 system (1,120
    sites, dipoles from initialize): dense at the derived rc in the
    orthorhombic cell and in a skewed one; cell-sorted at rc 6 A with the
    tile-visit table, where the culled launch equals the dense launch bit
    for bit.  |kernel - plain| <= 1e-12 (float64) or 1e-5 (float32, the
    plain version's float32 sums against the kernel's double sums) x the
    largest |E_i|."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=10, n_h2=20, capacity=40, polarization=True, dtype=dtype,
        device=device)
    state = metropolis.initialize(systems.jittered(params, state, 5),
                                  params, cfg, thermo)
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    kern, plain = ((tk.charge_field, tk.charge_field_plain)
                   if mode == "charge"
                   else (tk.dipole_field, tk.dipole_field_plain))
    ok, src = ((alive, params.charge) if mode == "charge"
               else (pol_ok, torch.where(pol_ok[:, None], state.mu, 0.0)))
    lam, kind = cfg.polar_damp, cfg.polar_damp_type
    skew = state.box.clone()
    skew[1, 0], skew[2, 1] = 0.2 * skew[0, 0], -0.1 * skew[0, 0]
    rel = 1e-12 if dtype == "float64" else 1e-5

    def check(args, ortho, visit=None):
        before = kern.launches
        k = kern(*args, ortho=ortho, visit=visit)
        torch.cuda.synchronize(device)
        assert kern.launches == before + 1
        p = plain(*args, visit=visit)
        scale = float(p.abs().max())
        assert scale > 0
        assert float((k.double() - p.double()).abs().max()) <= rel * scale
        return k

    for box, ortho in ((state.box, True), (skew, False)):
        check((state.pos, box, ok, src, params.mol_id32,
               pairs.derived_cutoff(box, cfg), lam, kind), ortho)
    rc = torch.tensor(6.0, dtype=state.pos.dtype, device=device)
    perm, _ = thole.cull_perm(state.pos, state.box, ok, rc)
    args = (state.pos[perm].contiguous(), state.box, ok[perm],
            src[perm].contiguous(), params.mol_id32[perm], rc, lam, kind)
    visit = thole.cull_visit(args[0], args[2], state.box, rc)
    assert 0 < float(visit.float().mean()) < 1
    culled = check(args, True, visit)
    assert torch.equal(culled, kern(*args, ortho=True))


PDA_FIELDS = {"direct": {}, "wolf": {"polar_wolf": True},
              "ewald": {"polar_ewald": True}}


def pda_survivor_free(launch, u, rng):
    """``u`` [K,16] with every stage-1 coin 1 - 1e-7 and each row that
    still survives (a move with ln(acceptance) > ln u) drawn anew until
    the kernel runs all K rows: B6 never changes the state, so each row
    decides alone.  ``launch(u)`` returns B6's record."""
    u = u.clone()
    u[:, 4] = 1.0 - 1e-7
    for _ in range(400):
        rec = launch(u)
        if rec[0, 1] < 0.5:
            return u
        k = int(rec[0, 0]) - 1
        u[k] = torch.as_tensor(rng.random(16), dtype=u.dtype)
        u[k, 4] = 1.0 - 1e-7
    raise AssertionError("no survivor-free table found")


@pytest.mark.parametrize("field", list(PDA_FIELDS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_matches_plain(device, dtype, field):
    """B6 against its plain version on the polar MOF + H2 system (1,120
    sites, jittered, initialized under the field variant): a table per
    move type whose step 0 survives (stage-1 coin 1e-30), a table of
    natural coins and a survivor-free table (all 16 steps run).  Equal:
    n_done, hit, mtype, slot, species and attempts; rows within 1e-9 A
    (f64) / 1e-4 A (f32); the deltas, d* and lnb within rel 1e-10 + 1e-8 K
    (f64) / 2e-5 + 1e-3 K + 8 float32 epsilons x the root sum of squares
    of the summed terms (f32: the plain trace's rss, the scale of the two
    versions' per-term rounding)."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=40, polarization=True, dtype=dtype,
        device=device)
    cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True,
                              **PDA_FIELDS[field])
    state = metropolis.initialize(systems.jittered(params, state, 5),
                                  params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    rng = np.random.default_rng(3)
    f64 = dtype == "float64"

    def table(u):
        return torch.as_tensor(u, dtype=cfg.tdtype, device=device)

    def launch(u):
        args, kw = metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                              tables)
        return mk.run_steps_uvt_pda(*args, **kw).cpu().numpy(), args, kw

    us = []
    for lane8 in (0.9, 0.1, 0.4):
        u = rng.random((mk.PDA_SEG, 16))
        u[0, 4], u[0, 8] = 1e-30, lane8
        us.append(table(u))
    us.append(table(rng.random((mk.PDA_SEG, 16))))
    us.append(pda_survivor_free(lambda u: launch(u)[0],
                                table(rng.random((mk.PDA_SEG, 16))), rng))
    hits = 0
    for u in us:
        before = mk.run_steps_uvt_pda.launches
        k, args, kw = launch(u)
        torch.cuda.synchronize(device)
        assert mk.run_steps_uvt_pda.launches == before + 1
        trace = []
        p = mk.run_steps_uvt_pda_plain(*args, **kw,
                                       trace=trace).cpu().numpy()
        np.testing.assert_array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                      p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
        np.testing.assert_allclose(k[2:5], p[2:5], rtol=0,
                                   atol=1e-9 if f64 else 1e-4)
        vals = np.concatenate([k[1, :6], k[0, 9:11]])
        want = np.concatenate([p[1, :6], p[0, 9:11]])
        rss = np.zeros(8)
        if trace and trace[-1].get("rss"):
            rss[[0, 1, 2, 6]] = trace[-1]["rss"]
        tol = (1e-10 * np.abs(want) + 1e-8 if f64
               else 2e-5 * np.abs(want) + 1e-3
               + 8 * np.finfo(np.float32).eps * rss)
        assert (np.abs(vals - want) <= tol).all(), (vals, want)
        hits += int(k[0, 1])
    assert hits >= 3
    assert k[0, 0] == mk.PDA_SEG and k[0, 1] == 0     # survivor-free
