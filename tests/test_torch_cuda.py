"""The CUDA kernels (the pair kernels B2/B4 — B4 over chains with a shared
or a per-chain header, and at position stride 0; each RD form's instance
of both, and a short run of each form and of coulomb gwp —, the fused µVT kernel
B1, the fused NVT/NVE kernel B3 — both at every cluster size, B3 after an
NPT volume move too —, the Thole field kernel B5 and the polar
delayed-acceptance stage-1 kernel B6, B2 over a batch of geometries
(every RD instance; the surf drivers' energies) and the culled cell-list
pass and molecule-pair cache on the card; B1, B3 and B6 with the
Feynman-Hibbs/Kleinert corrections too, B1 and B6 with cavity bias and
TMMC, their XT instances, all three with spinflip, and all three's
instance of each RD form and of coulomb gwp) against
their plain versions on the card; B2 and B4 never launched under those
corrections; the native trajectory reader on a 10.8k-atom trajectory,
checkpoints of card states with a CUDA generator, and the float64 frame,
insertion and geometry analyzers of analyze.py on the card against the
same functions on the CPU.

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
    """B4 (one launch: a chain's cluster meets in distributed shared
    memory, no partial leaves the kernel) against its plain version,
    current rows and a trial; one launch counted per call; a repeat gives
    the same bits."""
    params, state, cfg, _ = _system(dtype, device)
    mol = torch.tensor(int(np.flatnonzero(
        state.mol_alive.cpu().numpy()
        & (params.mol_species >= 0).cpu().numpy())[0]), device=device)
    trial = (state.pos[0] + params.species_pos[0]
             + torch.tensor([2.2, 0.31, 0.17], dtype=state.pos.dtype,
                            device=device))
    for rows in (None, trial, None):
        args = (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, state.atom_alive(params), params.mol_atoms,
                params.mol_natoms, mol, rows,
                pairs.pair_scalars(state.box, cfg), cfg)
        before = pk.mol_pair.launches
        k = pk.mol_pair(*args)
        torch.cuda.synchronize(device)
        assert pk.mol_pair.launches == before + 1
        _close(k, pk.mol_pair_plain(*args), dtype)
        # the same bits on a repeat: the reduction order is fixed
        assert torch.equal(k, pk.mol_pair(*args))


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
    for bit, with and without a plan, takes one partial slot per visited
    tile, and refuses a plan of another table.  |kernel - plain| <= 1e-12
    (float64) or 1e-5 (float32, the plain version's float32 sums against
    the kernel's double sums) x the largest |E_i|."""
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
    fplan = tk.plan(state.box, rc, lam, args[0].shape[0], visit)
    tk._scratch.pop(device, None)
    for _ in range(2):
        assert torch.equal(culled, kern(*args, ortho=True, visit=visit,
                                        plan=fplan))
    # a culled plan's slots are its visited tiles
    assert tk._scratch[device][0].numel() == (
        fplan.slots * tk.TI * 3)
    assert fplan.slots == int((visit != 0).sum())
    # a plan of another table (equal shape and values) is refused
    other = tk.plan(state.box, rc, lam, args[0].shape[0], visit.clone())
    before = kern.launches
    with pytest.raises(ValueError, match="another call"):
        kern(*args, ortho=True, visit=visit, plan=other)
    assert kern.launches == before


def _b5_cloud(n, dtype, device, seed=0, L=20.0, skewed=False):
    """Random sites in 3-site molecules (about 15 % not ok), charges and
    dipoles (zero where not ok), molecule ids and a cell of edge L."""
    rng = np.random.default_rng(seed)
    box = np.eye(3) * L
    if skewed:
        box[1, 0], box[2, 0], box[2, 1] = 0.21 * L, -0.13 * L, 0.17 * L
    frac = rng.uniform(0.0, 1.0, (n, 3))
    ok = rng.uniform(size=n) > 0.15
    mu = np.where(ok[:, None], rng.normal(size=(n, 3)) * 0.01, 0.0)

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    return (t(frac @ box), t(box), t(ok, torch.bool),
            t(rng.normal(size=n) * 0.3), t(mu),
            t(np.arange(n) // 3, torch.int32))


B5_RAGGED = [(n, m, d, sk) for n in (0, 37, 300)
             for m in ("charge", "dipole")
             for d in ("exponential", "linear", "none")
             for sk in (False, True)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,mode,damp,skewed", B5_RAGGED,
                         ids=[f"n{n}-{m}-{d}-{'tri' if s else 'ortho'}"
                              for n, m, d, s in B5_RAGGED])
def test_thole_kernel_ragged(device, dtype, n, mode, damp, skewed):
    """B5 against its plain version at ragged site counts (none, under one
    tile, not a multiple of the tile), both modes, the three damping
    types, orthorhombic and triclinic cells: dense, and with visit tables
    that hold empty rows and empty columns (the plain version skips the
    same tiles).  float64: |kernel - plain| <= 1e-12 x max |E|.  float32
    (random sites come close, so one pair's term can far exceed the
    field): phase 4c's bound, the plain version in float64 on the same
    inputs as the reference and at most max(4 x the plain float32
    version's distance from it, 2e-6 x max |E|)."""
    pos, box, ok, q, mu, mol = _b5_cloud(n, getattr(torch, dtype), device,
                                         seed=n, skewed=skewed)
    kern, plain, src = ((tk.charge_field, tk.charge_field_plain, q)
                        if mode == "charge"
                        else (tk.dipole_field, tk.dipole_field_plain, mu))
    rc = torch.tensor(9.0, dtype=pos.dtype, device=device)
    args = (pos, box, ok, src, mol, rc, 2.1304, damp)
    a64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x for x in args)
    _, ni, nj = tk.grid_shape(n, tk.TI, tk.TJ)
    rng = np.random.default_rng(n + 1)
    tables = [None, rng.integers(0, 2, (ni, nj)),
              np.zeros((ni, nj), int), np.ones((ni, nj), int)]
    tables[1][0, :] = 0                      # an empty row tile
    tables[1][:, -1] = 0                     # an empty column tile
    for vis in tables:
        if vis is not None:
            vis = torch.as_tensor(vis, dtype=torch.int32, device=device)
        before = kern.launches
        k = kern(*args, ortho=not skewed, visit=vis)
        torch.cuda.synchronize(device)
        assert k.shape == (n, 3)
        assert kern.launches == before + (n > 0)
        if n == 0:
            continue
        p64 = plain(*a64, visit=vis)
        scale = max(float(p64.abs().max()), 1e-30)
        if dtype == "float64":
            tol = 1e-12 * scale
        else:
            tol = max(4.0 * float((plain(*args, visit=vis).double()
                                   - p64).abs().max()), 2e-6 * scale)
        assert float((k.double() - p64).abs().max()) <= tol
        if vis is not None and int(vis.sum()) == 0:
            assert not k.any()


def test_thole_kernel_scratch_across_sizes(device):
    """The kept scratch (partial slots and row-tile tickets) serves calls
    of different site counts: a large call grows it once, smaller and
    equal calls reuse it, and each call still holds to its plain version
    (test_thole_kernel_ragged's float32 bound) and repeats bit for bit
    (the tickets return to zero)."""
    kept = None
    for n in (3000, 500, 3000, 129):
        pos, box, ok, q, mu, mol = _b5_cloud(n, torch.float32, device,
                                             seed=7, L=40.0)
        args = (pos, box, ok, mu, mol,
                torch.tensor(12.0, device=device), 2.1304, "exponential")
        k = tk.dipole_field(*args, ortho=True)
        a64 = tuple(x.double() if torch.is_tensor(x)
                    and x.is_floating_point() else x for x in args)
        p64 = tk.dipole_field_plain(*a64)
        tol = max(4.0 * float((tk.dipole_field_plain(*args).double()
                               - p64).abs().max()),
                  2e-6 * float(p64.abs().max()))
        assert float((k.double() - p64).abs().max()) <= tol
        assert torch.equal(k, tk.dipole_field(*args, ortho=True))
        ptrs = [t.data_ptr() for t in tk._scratch[device]]
        if n < 3000:
            assert ptrs == kept
        kept = ptrs


@pytest.mark.parametrize("layout", ["dense", "culled", "tri"])
@pytest.mark.parametrize("mode", ["charge", "dipole"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thole_chains_kernel_is_each_chains_launch(device, dtype, mode,
                                                   layout):
    """B5 over a chain axis, one launch for C = 5 chains of 300 random
    sites (dense in an orthorhombic and a triclinic cell; culled at rc 9
    A, each chain in its own cell order with its own visit table): each
    chain bit for bit the single-chain launch on its own tensors; C = 1
    the single-chain launch; an active subset (chains 1 and 3) those
    chains' own launches and zeros elsewhere, in one launch; a repeat the
    same bits; each chain within test_thole_kernel_ragged's bound of the
    plain version."""
    dt = getattr(torch, dtype)
    clouds = [_b5_cloud(300, dt, device, seed=s, skewed=layout == "tri")
              for s in range(5)]
    box = clouds[0][1]
    pos, ok, q, mu, mol = (torch.stack([c[i] for c in clouds])
                           for i in (0, 2, 3, 4, 5))
    src = q if mode == "charge" else mu
    rc = torch.tensor(9.0, dtype=dt, device=device)
    visit = None
    if layout == "culled":
        perm, _ = thole.cull_perm(pos, box, ok, rc)
        pos, ok, src, mol = (thole._gather_sites(x, perm).contiguous()
                             for x in (pos, ok, src, mol))
        visit = thole.cull_visit(pos, ok, box, rc)
    chains_fn, one_fn, plain = (
        (tk.charge_field_chains, tk.charge_field, tk.charge_field_plain)
        if mode == "charge" else
        (tk.dipole_field_chains, tk.dipole_field, tk.dipole_field_plain))
    args = (pos, box, ok, src, mol, rc, 2.1304, "exponential")
    ortho = layout != "tri"
    before = chains_fn.launches
    k = chains_fn(*args, ortho=ortho, visit=visit)
    sub = chains_fn(*args, ortho=ortho, visit=visit, active=(1, 3))
    torch.cuda.synchronize(device)
    assert chains_fn.launches == before + 2
    assert torch.equal(k, chains_fn(*args, ortho=ortho, visit=visit))
    for c in range(5):
        one = one_fn(pos[c], box, ok[c], src[c], mol[c], rc, 2.1304,
                     "exponential", ortho=ortho,
                     visit=None if visit is None else visit[c])
        assert torch.equal(k[c], one), c
        assert (torch.equal(sub[c], one) if c in (1, 3)
                else not sub[c].any()), c
        a = (pos[c], box, ok[c], src[c], mol[c], rc, 2.1304, "exponential")
        a64 = tuple(x.double() if torch.is_tensor(x)
                    and x.is_floating_point() else x for x in a)
        vc = None if visit is None else visit[c]
        p64 = plain(*a64, visit=vc)
        scale = float(p64.abs().max())
        tol = (1e-12 * scale if dtype == "float64" else
               max(4.0 * float((plain(*a, visit=vc).double()
                                - p64).abs().max()), 2e-6 * scale))
        assert float((k[c].double() - p64).abs().max()) <= tol
    one_c = chains_fn(*(x[:1] if torch.is_tensor(x) and x.ndim >= 2
                        and x is not box else x for x in args),
                      ortho=ortho, visit=None if visit is None
                      else visit[:1])
    assert torch.equal(one_c[0], k[0])


def test_solve_scf_chains_on_the_card(device):
    """solve_scf_chains on the card (float64, 4 chains of the polar MOF +
    H2 system after a batched polar chunk, each trial a displaced
    molecule): each chain's iteration count equals single-chain
    solve_scf's on the card and its dipoles agree to 1e-9 of max |mu|;
    B5 over chains launched once per CG round."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=40, polarization=True, dtype="float64",
        device=device)
    state = metropolis.initialize(systems.jittered(params, state, 3),
                                  params, cfg, thermo)
    g = torch.Generator(device=device).manual_seed(4)
    states, _ = multichain.run_chunk_batched(
        multichain.stack_states(state, 4), params, cfg, thermo, 20,
        generator=g)
    alive = states.mol_alive[:, params.mol_id] & params.atom_ok
    from mpmc_tpu_torch.mc import moves
    from mpmc_tpu_torch.state import chain_rows
    u = torch.rand((4, 16), generator=g, device=device, dtype=torch.float64)
    mol, _ = moves.pick_by_rank(metropolis._movable_mask(
        params, states.mol_alive), u[:, 0])
    rows = moves.displace_rows(states.pos, params, mol, u, 1.0, 1.0)
    e0n, r0 = thole.move_deltas(states.pos, states.box[0], alive, params,
                                cfg, mol, states.e0, states.mu,
                                states.r_pol, new_rows=rows)
    pos_c = states.pos.clone()
    for c in range(4):
        pos_c[c, params.mol_atoms[mol[c]]] = rows[c]
    before = tk.dipole_field_chains.launches
    mu, it, _ = thole.solve_scf_chains(pos_c, states.box[0], alive, params,
                                       cfg, e0n, mu0=states.mu, r0=r0)
    torch.cuda.synchronize(device)
    assert tk.dipole_field_chains.launches - before == int(it.max())
    for c in range(4):
        mu1, it1, _ = thole.solve_scf(pos_c[c], states.box[0], alive[c],
                                      params, cfg, e0n[c], mu0=states.mu[c],
                                      r0=r0[c])
        assert it[c] == it1
        scale = float(mu1.abs().max())
        assert float((mu[c] - mu1).abs().max()) <= 1e-9 * scale


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


def _pda_agree(k, p, trace, f64, drec=None):
    """B6's record k against the plain record p: equal n_done, hit, mtype,
    slot, species and attempts; rows within 1e-9 A (f64) / 1e-4 A (f32);
    the deltas, d* and lnb within rel 1e-10 + 1e-8 K (f64) / 2e-5 + 1e-3 K
    + 8 float32 epsilons x the root sum of squares of the summed terms
    (f32: the plain trace's rss, the scale of the two versions' per-term
    rounding).  ``drec`` = (value, floor): d_rec is held to that value
    instead of p's, within the larger of the rule's tolerance and floor."""
    k, p = (x.cpu().numpy() if torch.is_tensor(x) else x for x in (k, p))
    np.testing.assert_array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                  p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
    np.testing.assert_allclose(k[2:5], p[2:5], rtol=0,
                               atol=1e-9 if f64 else 1e-4)
    vals = np.concatenate([k[1, :6], k[0, 9:11]])
    want = np.concatenate([p[1, :6], p[0, 9:11]])
    rss = np.zeros(8)
    if trace and trace[-1].get("rss"):
        rss[[0, 1, 2, 6]] = trace[-1]["rss"]
    if drec is not None:
        want[2] = drec[0]
    tol = (1e-10 * np.abs(want) + 1e-8 if f64
           else 2e-5 * np.abs(want) + 1e-3
           + 8 * np.finfo(np.float32).eps * rss)
    if drec is not None:
        tol[2] = max(tol[2], drec[1])
    assert (np.abs(vals - want) <= tol).all(), (vals, want, tol)


def _drec_on_rows(args, kw, rec, dt):
    """d_rec of the move in B6's record ``rec`` recomputed from the
    record's own trial rows (rows 2-4) with the plain version's reciprocal
    term (mc_kernel.pda_rec_terms) in ``dt``, summed in float64."""
    rec = rec.cpu().numpy() if torch.is_tensor(rec) else rec
    mt, slot, spf = (int(rec[0, i]) for i in (2, 3, 4))
    start, na = int(args[8][slot]), int(args[12][spf])
    pos, charge = args[0], args[4]
    new = torch.as_tensor(rec[2:5, :na].T, device=pos.device)
    return float(mk.pda_rec_terms(
        pos[start:start + na].to(dt), new.to(dt),
        charge[start:start + na].to(dt), mt != 1, mt != 2,
        *(kw[x].to(dt) for x in ("kvecs", "kcoef", "sk_re", "sk_im")))
        .double().sum())


@pytest.mark.parametrize("field", list(PDA_FIELDS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_matches_plain(device, dtype, field):
    """B6 against its plain version on the polar MOF + H2 system (1,120
    sites, jittered, initialized under the field variant): a table per
    move type whose step 0 survives (stage-1 coin 1e-30), a table of
    natural coins and a survivor-free table (all 16 steps run), held to
    _pda_agree's rules."""
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
        _pda_agree(k, mk.run_steps_uvt_pda_plain(*args, **kw, trace=trace),
                   trace, f64)
        hits += int(k[0, 1])
    assert hits >= 3
    assert k[0, 0] == mk.PDA_SEG and k[0, 1] == 0     # survivor-free


def _pda_setup(device, dtype, field, small):
    """(launch(u, cluster) -> record, plain(u) -> record, K) of B6 on the
    polar MOF + H2 system: small = 56 sites (n_side 3, 8 slots; at G = 16
    the last two ranks hold no column), else 344 (at G = 16 a ragged last
    slice); the 709 k-vectors split raggedly at every G;
    ``field`` one of PDA_FIELDS or "nvt" (all-displace, insert
    probability 0), initialized under its field."""
    shape = (dict(n_side=3, n_h2=6, capacity=8) if small
             else dict(n_side=6, n_h2=20, capacity=40))
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        **shape, polarization=True, dtype=dtype, device=device)
    cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True,
                              **({"ensemble": "nvt"} if field == "nvt"
                                 else PDA_FIELDS[field]))
    state = metropolis.initialize(systems.jittered(params, state, 5),
                                  params, cfg, thermo)
    if field == "nvt":
        thermo = thermo.replace(insert_probability=torch.zeros_like(
            thermo.insert_probability))
    cfg_eff = mk.pda_effective_cfg(cfg, params)
    tables = metropolis.uvt_fused_tables(params, cfg_eff)

    def args_of(u):
        return metropolis.pda_launch_args(state, params, cfg_eff, thermo, u,
                                          tables)

    def launch(u, cluster=None):
        a, kw = args_of(u)
        return mk.run_steps_uvt_pda(*a, **kw, cluster=cluster)

    def plain(u, trace=None):
        a, kw = args_of(u)
        return mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)

    return launch, plain, args_of, int(state.pos.shape[0]), cfg.tdtype


def _pda_tables(plain, K, tdtype, device, field, rng):
    """Named [K, 16] tables: step 0 survives (per move type; nvt: three
    displacements), natural coins, survivor-free (all K steps run), and the
    freeze at step K - 1 (survivor-free before it)."""
    def table(x):
        return torch.as_tensor(x, dtype=tdtype, device=device)

    us = {}
    for lane8 in (0.9, 0.1, 0.4):
        x = rng.random((K, 16))
        x[0, 4], x[0, 8] = 1e-30, lane8
        us[f"step 0 ({lane8})"] = table(x)
    us["natural"] = table(rng.random((K, 16)))
    free = pda_survivor_free(plain, table(rng.random((K, 16))), rng)
    us["survivor-free"] = free
    last = free.clone()
    for _ in range(200):
        x = rng.random(16)
        x[4], x[8] = 1e-30, 0.9
        last[K - 1] = table(x)
        rec = plain(last)
        if rec[0, 0] == K and rec[0, 1] > 0.5:
            us[f"freeze at step {K - 1}"] = last
            break
    else:
        raise AssertionError("no survivor at the last step found")
    return us


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("field", ["direct", "wolf", "ewald", "nvt"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_cluster_sizes(device, dtype, field, cluster):
    """B6 as one cluster of G CTAs, forced with cluster=, against its plain
    version on the 56-site system (G = 16: ranks with no column) and the
    344-site one (G = 16: a ragged last slice), for the three fields and
    nvt: step-0 survivors, natural coins, a survivor-free table (all 16
    steps) and the freeze at step 15 (test_pda_kernel_matches_plain's
    tolerances); each launch counted once, run at the G asked for, and a
    second launch gives the same bits.  On the 56-site cell (12 A wide)
    float32's d_rec errs by up to ~1e-2 K in the plain version too, past
    the float32 rule: there d_rec is held to d_rec recomputed in float64
    from the kernel's own trial rows, within the rule or 4x the plain
    version's largest distance from its own float64 recomputation on
    these tables, whichever is larger."""
    f64 = dtype == "float64"
    rng = np.random.default_rng(11 + cluster)
    for small in (True, False):
        launch, plain, args_of, n, tdtype = _pda_setup(device, dtype, field,
                                                       small)
        if small and cluster == 16:
            nloc = -(-n // 16)
            assert 15 * nloc >= n      # the last rank holds no column
        us = _pda_tables(plain, mk.PDA_SEG, tdtype, device, field, rng)
        a, kw = args_of(us["natural"])
        floor = None
        if small and not f64:
            floor = 4.0 * max(
                abs(float(p[1, 2]) - _drec_on_rows(a, kw, p, torch.float64))
                for p in map(plain, us.values()) if p[0, 1] > 0.5)
        hits = 0
        for name, u in us.items():
            before = mk.run_steps_uvt_pda.launches
            k = launch(u, cluster)
            torch.cuda.synchronize(device)
            assert mk.run_steps_uvt_pda.launches == before + 1
            assert mk.run_steps_uvt_pda.last_cluster == cluster
            trace = []
            p = plain(u, trace)
            drec = None
            if floor is not None and k[0, 1] > 0.5:
                drec = (_drec_on_rows(a, kw, k, torch.float64), floor)
            _pda_agree(k, p, trace, f64, drec)
            assert torch.equal(k, launch(u, cluster)), name
            hits += int(k[0, 1])
        assert hits >= 2
        assert us["survivor-free"] is not None
        k = launch(us[f"freeze at step {mk.PDA_SEG - 1}"], cluster)
        assert k[0, 0] == mk.PDA_SEG and k[0, 1] == 1


def _b2_inputs(n, dtype, device, seed=0, skewed=False):
    """pair_terms' arguments on n random sites in a 24 A cell (a cube, or
    with skewed a triclinic cell: off-diagonal cell vector terms):
    molecules of three consecutive sites, the first 40 % frozen, about one
    site in five dead (rows and columns), LJ + Ewald with the tail term."""
    params, state, cfg, _ = _system(dtype, device)
    cfg = dataclasses.replace(cfg, ortho_box=not skewed)
    rng = np.random.default_rng(seed)
    dt = cfg.tdtype
    cell = np.eye(3) * 24.0
    if skewed:
        cell[1, 0], cell[2, 0], cell[2, 1] = 5.0, -3.1, 4.1
    box = torch.as_tensor(cell, dtype=dt, device=device)
    pos = torch.as_tensor(rng.random((n, 3)) @ cell, dtype=dt,
                          device=device)
    charge = torch.as_tensor(rng.uniform(-0.5, 0.5, n), dtype=dt,
                             device=device)
    eps = torch.as_tensor(rng.uniform(10.0, 120.0, n), dtype=dt,
                          device=device)
    sig = torch.as_tensor(rng.uniform(2.5, 3.5, n), dtype=dt, device=device)
    mol = torch.as_tensor(np.arange(n) // 3, dtype=torch.int32,
                          device=device)
    alive = torch.as_tensor(rng.random(n) > 0.2, device=device)
    frozen = torch.as_tensor(np.arange(n) < 0.4 * n, device=device)
    return (pos, charge, eps, sig, mol, alive, frozen,
            pairs.pair_scalars(box, cfg), cfg)


def _b2_agree(device, args64, args32, rs):
    """B2 in float64 (rel 1e-12, abs 1e-9) and float32 (chip_smoke's
    rule: rel 2e-5, 4x the plain float32 result's distance from float64,
    abs 1e-3) against the plain version in float64; returns the float32
    result."""
    p64 = pk.pair_terms_plain(*args64, row_start=rs).cpu().numpy()
    k64 = pk.pair_terms(*args64, row_start=rs).cpu().numpy()
    np.testing.assert_allclose(k64, p64, rtol=1e-12, atol=1e-9)
    p32 = pk.pair_terms_plain(*args32, row_start=rs).double().cpu().numpy()
    k = pk.pair_terms(*args32, row_start=rs)
    k32 = k.double().cpu().numpy()
    fin = np.isfinite(p64)
    tol = np.maximum.reduce([2e-5 * np.abs(p64), 4.0 * np.abs(p32 - p64),
                             np.full_like(p64, 1e-3)])
    assert np.array_equal(np.isfinite(k32), fin)
    assert (np.abs(k32 - p64)[fin] <= tol[fin]).all(), (k32, p64)
    return k


@pytest.mark.parametrize("skewed", [False, True],
                         ids=["ortho", "triclinic"])
@pytest.mark.parametrize("n", [0, 1, 129, 300, 10797])
def test_pair_terms_kernel_work_list(device, n, skewed):
    """B2 (one launch over the tile work list) against its plain version
    on n random sites with dead rows and columns, in a cube and in a
    triclinic cell, float64 and float32, at row_start 0, 77 (not a
    multiple of the tile) and the frozen prefix; one launch counted per
    call with a pair (none when no row is at or past row_start); a repeat
    gives the same bits (the ticket is back at 0)."""
    a64 = _b2_inputs(n, "float64", device, skewed=skewed)
    a32 = tuple(x.float() if torch.is_tensor(x) and x.is_floating_point()
                else x for x in a64[:-2]) + _b2_inputs(
                    n, "float32", device, skewed=skewed)[-2:]
    for rs in sorted({0, min(77, n), int(0.4 * n)}):
        before = pk.pair_terms.launches
        k = _b2_agree(device, a64, a32, rs)
        torch.cuda.synchronize(device)
        listed = pk.work_list(n, rs, device).numel()
        assert pk.pair_terms.launches == before + 2 * (listed > 0)
        assert torch.equal(k, pk.pair_terms(*a32, row_start=rs))


def test_pair_terms_kernel_scratch_resizes(device):
    """B2 at 10,797 sites, then at 300 (the kept scratch serves), then at
    10,797 again: the same bits as the first call, and the scratch grown
    only for a longer list."""
    big = _b2_inputs(10797, "float32", device, seed=1)
    small = _b2_inputs(300, "float32", device, seed=2)
    first = pk.pair_terms(*big)
    kept = [t.data_ptr() for t in pk.pair_terms_scratch(
        device, torch.float32, 1)]
    pk.pair_terms(*small, row_start=5)
    assert [t.data_ptr() for t in pk.pair_terms_scratch(
        device, torch.float32, 1)] == kept
    assert torch.equal(pk.pair_terms(*big), first)
    have = pk.pair_terms_scratch(device, torch.float32, 1)[1].numel()
    assert have >= pk.work_list(10797, 0, device).numel()
    grown = pk.pair_terms_scratch(device, torch.float32, have + 1)
    assert grown[1].numel() == have + 1
    assert torch.equal(pk.pair_terms(*big), first)


def _chains(device, dtype, C, steps=30, seed=3):
    """C chains of the small system after ``steps`` batched scan steps
    (each chain its own positions and loading), with a [C] molecule pick
    of which the last chain's found nothing (count 0), and trial rows."""
    params, state, cfg, thermo = _system(dtype, device)
    state = metropolis.initialize(state, params, cfg, thermo)
    g = torch.Generator(device=device).manual_seed(seed)
    states, _ = multichain.run_chunk_batched(
        multichain.stack_states(state, C), params, cfg, thermo, steps,
        generator=g)
    mask = metropolis._movable_mask(params, states.mol_alive)
    mask[-1] = False
    u = torch.rand((C, 16), generator=g, device=device,
                   dtype=states.pos.dtype)
    from mpmc_tpu_torch.mc import moves
    mol, cnt = moves.pick_by_rank(mask, u[:, 0])
    assert int(cnt[-1]) == 0
    rows = moves.displace_rows(states.pos, params, mol, u, 0.8, 1.0)
    alive = states.mol_alive[:, params.mol_id] & params.atom_ok
    return params, states, cfg, mol, rows, alive


@pytest.mark.parametrize("C", [1, 2, 7, 128])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_chains_kernel(device, dtype, C):
    """B4 over a chain axis: one launch per call; C = 1 gives the
    single-chain launch's bits; every C against the plain version (B4's
    tolerance), current and trial rows, a chain with an empty pick
    included; a repeat gives the same bits (each chain's ticket back at
    0)."""
    params, states, cfg, mol, rows, alive = _chains(device, dtype, C)
    scal = pairs.pair_scalars(states.box[0], cfg)
    for r in (None, rows):
        args = (states.pos, params.charge, params.eps, params.sig,
                params.mol_id32, alive, params.mol_atoms, params.mol_natoms,
                mol, r, scal, cfg)
        before = pk.mol_pair_chains.launches
        k = pk.mol_pair_chains(*args)
        torch.cuda.synchronize(device)
        assert pk.mol_pair_chains.launches == before + 1
        assert k.shape == (C, 4)
        _close(k, pk.mol_pair_chains_plain(*args), dtype)
        assert torch.equal(k, pk.mol_pair_chains(*args))
        if C == 1:
            one = pk.mol_pair(states.pos[0], params.charge, params.eps,
                              params.sig, params.mol_id32, alive[0],
                              params.mol_atoms, params.mol_natoms, mol[0],
                              None if r is None else r[0], scal, cfg)
            assert torch.equal(k[0], one)


@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_chains_header_per_chain(device, dtype, C):
    """B4 over chains with a [C, 20] header (the NPT chains: chain c's
    positions and box scaled by its own exp(d ln V / 3)) against the plain
    version, each chain with its own header row (B4's tolerance); a
    shared [20] header gives the bits of the same header repeated per
    chain, and at C = 1 the single-chain launch's bits."""
    from mpmc_tpu_torch.mc import moves
    from mpmc_tpu_torch.state import slice_chain
    params, states, cfg, mol, rows, alive = _chains(device, dtype, C)
    # off the lattice first: a scaled lattice keeps its pairs at r = rc,
    # where two correct evaluations may count a tie differently
    jit = torch.stack([systems.jittered(params, slice_chain(states, c),
                                        40 + c).pos for c in range(C)])
    d_lnv = torch.linspace(-0.06, 0.06, C, dtype=states.pos.dtype,
                           device=device)
    pos, box = moves.scale_volume(jit, states.box, params, d_lnv)
    scal = pairs.pair_scalars(box, cfg)
    assert scal.shape == (C, 20)
    shared = pairs.pair_scalars(states.box[0], cfg)
    for r in (None, rows):
        args = (pos, params.charge, params.eps, params.sig, params.mol_id32,
                alive, params.mol_atoms, params.mol_natoms, mol, r)
        before = pk.mol_pair_chains.launches
        k = pk.mol_pair_chains(*args, scal, cfg)
        torch.cuda.synchronize(device)
        assert pk.mol_pair_chains.launches == before + 1
        _close(k, pk.mol_pair_chains_plain(*args, scal, cfg), dtype)
        k0 = pk.mol_pair_chains(*args, shared, cfg)
        rep = pk.mol_pair_chains(*args, shared.expand(C, 20).contiguous(),
                                 cfg)
        assert torch.equal(k0, rep)
        if C > 1:
            assert not torch.equal(k0, k)
        else:
            one = pk.mol_pair(pos[0], params.charge, params.eps, params.sig,
                              params.mol_id32, alive[0], params.mol_atoms,
                              params.mol_natoms, mol[0],
                              None if r is None else r[0], shared, cfg)
            assert torch.equal(k0[0], one)


def test_nvt_kernel_after_a_volume_move(device):
    """A frameless H2 fluid under Ewald (f32): after a volume move the
    next B3 launch takes the new box's rc, alpha and k-table
    (fused_nvt_launch_args), and it matches its plain version on a
    numpy-made [1, 200, 16] table (test_nvt_kernel_matches_plain's f32
    tolerances); then a 300-step hybrid NPT chunk launches B3 once per
    segment and keeps its carried energy within rel 1e-4 of a fresh
    recompute."""
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.mc import moves
    from mpmc_tpu_torch.ops import ewald
    from mpmc_tpu_torch.state import build_system
    params, state = build_system(
        24.0 * np.eye(3), species=(systems.h2_bss3(),), capacity=(60,),
        initial_counts=(60,), dtype=torch.float32, seed=5, device=device)
    cfg = RunConfig(ensemble="npt", coulomb="ewald", ewald_kmax=5,
                    ortho_box=True, fused_mc=True)
    thermo = Thermo.make(temperature=77.0, pressure=100.0,
                         volume_probability=0.02, volume_change_factor=0.05,
                         move_factor=1.0, rot_factor=1.0, n_species=1,
                         dtype=torch.float32, device=device)
    assert mk.supported_npt(cfg, params)
    state = metropolis.initialize(state, params, cfg, thermo)
    pos, box = moves.scale_volume(state.pos, state.box, params, 0.05)
    moved = metropolis.initialize(state.replace(pos=pos, box=box), params,
                                  cfg, thermo)
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    u = torch.as_tensor(np.random.default_rng(4).random((1, 200, 16)),
                        dtype=torch.float32, device=device)
    nvt = dataclasses.replace(cfg, ensemble="nvt")
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(moved, 1), params, nvt, thermo, u, tables)
    torch.testing.assert_close(kw["kvecs"], ewald.kvectors(box, 5))
    assert not torch.allclose(kw["kvecs"], ewald.kvectors(state.box, 5))
    k = mk.run_steps(*args, **kw)
    p = mk.run_steps_plain(*args, **kw)
    k_sums, p_sums = k[1].cpu().numpy(), p[1].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 3], p_sums[:, 3])
    assert p_sums[0, 3] > 10
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-4)
    tol = 2e-5 * np.abs(p_sums[:, :3]) + 2e-3 * np.sqrt(p_sums[:, 3:4] + 1)
    assert (np.abs(k_sums[:, :3] - p_sums[:, :3]) <= tol).all()
    for a, b in zip(k[2:], p[2:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    before = mk.run_steps.launches
    g = torch.Generator(device=device).manual_seed(2)
    st, stats = metropolis.run_chunk_fused_npt(moved, params, cfg, thermo,
                                               300, generator=g,
                                               tables=tables)
    torch.cuda.synchronize(device)
    assert stats.attempts[metropolis.VOLUME] == 6
    assert mk.run_steps.launches - before == 6
    fresh = metropolis.initialize(st, params, cfg, thermo)
    assert float(st.energy.total) == pytest.approx(
        float(fresh.energy.total), rel=1e-4)


def test_batched_deck_bookkeeping(device):
    """A short batched scan run on the card (4 chains, 200 steps): B4 over
    the chains launched once or twice a step, every chain's carried
    energy terms against a fresh recompute.  Float32: each term within
    rel 2e-5 (200 deltas of float32 rounding each) or 1e-2 K — per term,
    since es_self and es_excl here are ~5e5 K of opposite sign."""
    params, state, cfg, thermo = _system("float32", device)
    state = metropolis.initialize(state, params, cfg, thermo)
    g = torch.Generator(device=device).manual_seed(8)
    before = pk.mol_pair_chains.launches
    states, stats = multichain.run_chunk_batched(
        multichain.stack_states(state, 4), params, cfg, thermo, 200,
        generator=g)
    torch.cuda.synchronize(device)
    n = pk.mol_pair_chains.launches - before
    assert 200 <= n <= 400
    assert int(stats.accepts.sum()) > 0
    from mpmc_tpu_torch.state import slice_chain
    for c in range(4):
        st = slice_chain(states, c)
        fresh = metropolis.initialize(st, params, cfg, thermo)
        for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl"):
            carried = float(getattr(st.energy, k))
            full = float(getattr(fresh.energy, k))
            assert abs(carried - full) <= max(2e-5 * abs(full), 1e-2), (c, k)


@pytest.mark.parametrize("kernel", ["b3", "b1"])
def test_pt_round_on_the_card(device, kernel):
    """One PT round on the card: 8 replicas on a 77-250 K ladder, one
    fused launch (B3 on the LJ fluid under nvt, B1 on the GCMC system),
    the on-device swap, its decisions recomputed on the host from the
    round's energies, counts and uniforms."""
    from mpmc_tpu_torch.parallel import replica
    from torch_pt import recompute_round
    if kernel == "b3":
        params, state, cfg, thermo = systems.lj_fluid(n=256, device=device)
        cfg = dataclasses.replace(cfg, ensemble="nvt")
        tables = metropolis.nvt_fused_tables(params, state.mol_alive)
        chunk = metropolis.run_chunk_fused_multi
    else:
        params, state, cfg, thermo = _system("float32", device)
        tables = metropolis.uvt_fused_tables(params, cfg)
        chunk = metropolis.run_chunk_fused_uvt_multi
    state = metropolis.initialize(state, params, cfg, thermo)
    temps = replica.geometric_ladder(77.0, 250.0, 8)
    thermos = replica.stack_thermo(thermo, temps)
    g = torch.Generator(device=device).manual_seed(9)
    states, _ = chunk(multichain.stack_states(state, 8), params, cfg,
                      thermos, 200, generator=g, tables=tables)
    n = (replica.movable_counts(states.mol_alive, params.mol_frozen,
                                params.mol_species)
         if kernel == "b1" else None)
    for parity in (0, 1):
        u = replica.swap_uniforms(8, g, thermos.temperature.dtype)
        new_t, acc = replica.ladder_swap_batched(
            thermos.temperature, states.energy, u, parity, n_mols=n)
        rnd = {"temps": thermos.temperature, "energies": states.energy.total,
               "n_mols": n, "u": u, "parity": parity}
        want, want_acc, margin = recompute_round(rnd)
        if margin > 1e-5:
            np.testing.assert_array_equal(new_t.double().cpu().numpy(),
                                          want)
            assert int(acc) == want_acc
        np.testing.assert_allclose(np.sort(new_t.double().cpu().numpy()),
                                   temps, rtol=1e-6)
        thermos = thermos.replace(temperature=new_t)


def test_native_reader_on_a_bench_trajectory(device, tmp_path):
    """The native reader on a 10.8k-atom trajectory of three frames
    written from card tensors by the native writer: every frame's arrays
    equal io/pqr.py::read_frames field by field, and ``ensemble replay``
    over it launches B2 once per frame."""
    import io

    from mpmc_tpu_torch.io import input_script, native, pqr
    from mpmc_tpu_torch.mc import run
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=21, n_h2=256, capacity=512, device=device)
    path = str(tmp_path / "traj.pqr")
    alive = state.mol_alive.clone()
    for k in range(3):
        alive[1 + 7 * k] = False          # N changes between frames
        st = state.replace(mol_alive=alive.clone(),
                           pos=state.pos + 0.01 * k)
        pqr.write_state(path, params, st, ["H2"], mode="w" if k == 0
                        else "a", remark=f"frame {k}")
    ref = pqr.read_frames(path)
    got = list(native.stream_frames_arrays(path))
    assert len(got) == len(ref) == 3
    for arr, fr in zip(got, ref):
        assert arr["num"].shape[0] == len(fr.atoms) > 10000
        np.testing.assert_array_equal(arr["box"], fr.box)
        np.testing.assert_array_equal(
            arr["num"], [list(a.xyz) + [a.mass, a.charge, a.polar, a.eps,
                                        a.sig, a.omega, a.c6, a.c8, a.c10,
                                        a.gwp_alpha] for a in fr.atoms])
        np.testing.assert_array_equal(
            arr["ids"], [[a.serial, a.mol_id] for a in fr.atoms])
        assert arr["flags"].decode() == "".join(a.flag for a in fr.atoms)
        assert [native.decode_name(arr["mol_names"], k)
                for k in range(len(fr.atoms))] == [a.mol_name
                                                   for a in fr.atoms]
    L = float(state.box[0, 0])
    job = input_script.parse(
        f"ensemble replay\ntemperature 77\nbasis1 {L} 0 0\n"
        f"basis2 0 {L} 0\nbasis3 0 0 {L}\nallow_charged_cell on\n"
        f"pqr_input {path}\n")
    pk.reset_counts()
    avgs = run.run(job, log=io.StringIO(), device=device)
    torch.cuda.synchronize(device)
    assert pk.pair_terms.launches == 3
    assert avgs.samples["N"] == [255.0, 254.0, 253.0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_checkpoint_round_trip_of_card_tensors(device, dtype, tmp_path):
    """A checkpoint of a card state and a CUDA generator loads back on the
    card bit for bit, and the restored generator draws what the saved one
    draws next; a resumed chunk equals the uninterrupted one."""
    from mpmc_tpu_torch.io import checkpoint
    params, state, cfg, thermo = _system(dtype, device)
    state = metropolis.initialize(state, params, cfg, thermo)
    g = torch.Generator(device=device).manual_seed(5)
    st1, _ = metropolis.run_chunk(state, params, cfg, thermo, 50,
                                  generator=g)
    path = str(tmp_path / "ck.pt")
    checkpoint.save(path, st1, generator=g)
    st2, _ = metropolis.run_chunk(st1, params, cfg, thermo, 50, generator=g)
    g2 = torch.Generator(device=device).manual_seed(99)
    back, _, _ = checkpoint.load(path, state, generator=g2)
    assert back.pos.device == device and back.step == st1.step
    assert torch.equal(back.pos, st1.pos)
    assert torch.equal(back.sk_re, st1.sk_re)
    for k, v in st1.energy.as_dict().items():
        assert torch.equal(getattr(back.energy, k), v), k
    st2b, _ = metropolis.run_chunk(back, params, cfg, thermo, 50,
                                   generator=g2)
    assert torch.equal(st2b.pos, st2.pos)
    assert torch.equal(st2b.mol_alive, st2.mol_alive)
    assert float(st2b.energy.total) == float(st2.energy.total)
    assert torch.equal(torch.rand(8, generator=g, device=device),
                       torch.rand(8, generator=g2, device=device))


# the Feynman-Hibbs (order 2, 4) and Feynman-Kleinert corrections, as cfg
# fields; two chains of one launch at two temperatures
QUANTUM = {"fh2": {"feynman_hibbs": True},
           "fh4": {"feynman_hibbs": True, "feynman_hibbs_order": 4},
           "fk": {"feynman_kleinert": True}}
QUANTUM_TEMPS = (77.0, 120.0)


def _quantum_system(dtype, device, q, ensemble="uvt", capacity=40, **kw):
    """The MOF + H2 system (n_side 6) at 77 K under the correction ``q``,
    jittered and initialized, with a thermo of two chains at
    QUANTUM_TEMPS."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=capacity, dtype=dtype, device=device,
        **kw)
    cfg = dataclasses.replace(cfg, ensemble=ensemble, fused_mc=True,
                              **QUANTUM[q])
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    two = thermo.replace(temperature=torch.tensor(
        QUANTUM_TEMPS, dtype=cfg.tdtype, device=device))
    return params, state, cfg, thermo, two


@pytest.mark.parametrize("q", list(QUANTUM))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uvt_kernel_quantum_matches_plain(device, dtype, q):
    """B1 with FH2, FH4 or FK, two chains at 77 and 120 K (the terms at each
    chain's beta), against its plain version on one [2, 200, 16] table:
    test_uvt_kernel_matches_plain's checks; the molecule-mass plane is
    passed and the launch counted."""
    params, state, cfg, _, two = _quantum_system(dtype, device, q)
    u = torch.as_tensor(np.random.default_rng(5).random((2, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, 2), params, cfg, two, u,
        metropolis.uvt_fused_tables(params, cfg))
    assert kw["mol_mass"] is params.mol_mass_atom
    before = mk.run_steps_uvt.launches
    k = mk.run_steps_uvt(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps_uvt.launches == before + 1
    p = mk.run_steps_uvt_plain(*args, **kw)
    k_sums, p_sums = k[2].cpu().numpy(), p[2].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 6:12], p_sums[:, 6:12])
    assert p_sums[:, 6:9].sum() > 20
    assert torch.equal(k[1], p[1])
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :6]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :6])
           + 2e-3 * np.sqrt(p_sums[:, 6:9].sum(1, keepdims=True) + 1.0))
    assert (np.abs(k_sums[:, :6] - p_sums[:, :6]) <= tol).all()


@pytest.mark.parametrize("q", list(QUANTUM))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nvt_kernel_quantum_matches_plain(device, dtype, q):
    """B3 with FH2, FH4 or FK, two chains at 77 and 120 K, against its
    plain version on one [2, 200, 16] table: test_nvt_kernel_matches_
    plain's checks."""
    params, state, cfg, _, two = _quantum_system(dtype, device, q, "nvt",
                                                 capacity=20)
    u = torch.as_tensor(np.random.default_rng(3).random((2, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, 2), params, cfg, two, u,
        metropolis.nvt_fused_tables(params, state.mol_alive))
    k = mk.run_steps(*args, **kw)
    torch.cuda.synchronize(device)
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


@pytest.mark.parametrize("q", list(QUANTUM))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_quantum_matches_plain(device, dtype, q):
    """B6 with FH2, FH4 or FK on the polar MOF + H2 system: a forced
    survivor of each move type, a natural table and a survivor-free one,
    held to _pda_agree's rules."""
    params, state, cfg, thermo, _ = _quantum_system(
        dtype, device, q, polarization=True)
    cfg = dataclasses.replace(cfg, polar_delayed=True)
    state = metropolis.initialize(state, params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    rng = np.random.default_rng(13)

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
        k, args, kw = launch(u)
        torch.cuda.synchronize(device)
        trace = []
        _pda_agree(k, mk.run_steps_uvt_pda_plain(*args, **kw, trace=trace),
                   trace, dtype == "float64")
        hits += int(k[0, 1])
    assert hits >= 3


@pytest.mark.parametrize("q", [None, "fh2", "fk"])
def test_pair_kernels_not_launched_under_quantum(device, q):
    """The refresh and the scan path's per-move deltas launch B2 and B4
    without a quantum correction and never under FH or FK (their gate
    refuses; the plain tile pass runs on the card), and the energies stay
    on the card."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=40, device=device)
    if q:
        cfg = dataclasses.replace(cfg, **QUANTUM[q])
    pk.reset_counts()
    st = metropolis.initialize(state, params, cfg, thermo)
    st, _ = metropolis.run_chunk(
        st, params, cfg, thermo, 50,
        generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize(device)
    launched = pk.pair_terms.launches + pk.mol_pair.launches
    assert st.energy.rd.device.type == "cuda"
    assert (launched > 0) if q is None else launched == 0


# cavity bias, TMMC and its flat-histogram bias (the XT instances of B1
# and B6): 5^3 cells of 4.8 A over the 24 A box, radius 2 A (the cells at
# the framework closed, the pores open)
XT = dict(cavity_bias=True, cavity_grid=5, cavity_radius=2.0, tmmc=True,
          tmmc_bias=True)


def _xt_system(dtype, device, q=None, **kw):
    """The MOF + H2 system (n_side 6) at 77 K and 20 atm under XT (and the
    correction ``q``), jittered and initialized, with a seeded random eta;
    and a thermo of two chains at QUANTUM_TEMPS."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=40, dtype=dtype, device=device,
        pressure=20.0, **kw)
    cfg = dataclasses.replace(cfg, fused_mc=True, **XT,
                              **(QUANTUM[q] if q else {}))
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    assert 0 < int(state.cavity_open.sum()) < 5 ** 3
    eta = np.random.default_rng(3).uniform(-1, 1, params.n_mols_max + 1)
    thermo = thermo.replace(tmmc_eta=torch.as_tensor(
        eta, dtype=cfg.tdtype, device=device))
    two = thermo.replace(temperature=torch.tensor(
        QUANTUM_TEMPS, dtype=cfg.tdtype, device=device))
    return params, state, cfg, thermo, two


@pytest.mark.parametrize("q", [None, "fh2"])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uvt_kernel_xt_matches_plain(device, dtype, chains, q):
    """B1's XT instance (cavity bias, TMMC, tmmc_bias; with FH2 too)
    against its plain version on one [C, 200, 16] table: equal decisions,
    slot aliveness and TMMC attempt counts, the sums and positions as
    test_uvt_kernel_quantum_matches_plain, the Sigma a columns within
    C x 1e-9 (float64) or the attempts x (beta 2e-3 K + 1e-5) (float32,
    chip_smoke._sum_a_tol); launched once."""
    params, state, cfg, thermo, two = _xt_system(dtype, device, q)
    th = two if chains == 2 else thermo
    u = torch.as_tensor(np.random.default_rng(9).random((chains, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, chains), params, cfg, th, u,
        metropolis.uvt_fused_tables(params, cfg))
    tm_p = kw["tmmc_out"]
    p = mk.run_steps_uvt_plain(*args, **kw)
    kw_k = dict(kw, tmmc_out=torch.zeros_like(tm_p))
    before = mk.run_steps_uvt.launches
    k = mk.run_steps_uvt(*args, **kw_k)
    torch.cuda.synchronize(device)
    assert mk.run_steps_uvt.launches == before + 1
    k_sums, p_sums = k[2].cpu().numpy(), p[2].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 6:12], p_sums[:, 6:12])
    assert p_sums[:, 10:12].sum() > 50 and p_sums[:, 7:9].sum() > 0
    assert torch.equal(k[1], p[1])
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :6]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :6])
           + 2e-3 * np.sqrt(p_sums[:, 6:9].sum(1, keepdims=True) + 1.0))
    assert (np.abs(k_sums[:, :6] - p_sums[:, :6]) <= tol).all()
    tk_, tp = kw_k["tmmc_out"].cpu().numpy(), tm_p.cpu().numpy()
    np.testing.assert_array_equal(tk_[..., [0, 2]], tp[..., [0, 2]])
    assert tk_[..., [0, 2]].sum() == k_sums[:, 10:12].sum()
    beta = 1.0 / float(thermo.temperature)
    a_tol = (1e-9 if f64 else
             tp[..., [0, 2]] * (beta * 2e-3 + 1e-5))
    assert (np.abs(tk_[..., [1, 3]] - tp[..., [1, 3]]) <= a_tol).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_xt_matches_plain(device, dtype):
    """B6's XT instance (cavity bias and the tmmc_bias tilt) on the polar
    MOF + H2 system: a forced survivor of each move type, a natural table
    and a survivor-free one, held to _pda_agree's rules."""
    params, state, cfg, thermo, _ = _xt_system(dtype, device,
                                               polarization=True)
    cfg = dataclasses.replace(cfg, polar_delayed=True)
    state = metropolis.initialize(state, params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    rng = np.random.default_rng(17)

    def table(u):
        return torch.as_tensor(u, dtype=cfg.tdtype, device=device)

    def launch(u):
        args, kw = metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                              tables)
        assert "cav_list" in kw and "d_eta_ins" in kw
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
        k, args, kw = launch(u)
        torch.cuda.synchronize(device)
        trace = []
        _pda_agree(k, mk.run_steps_uvt_pda_plain(*args, **kw, trace=trace),
                   trace, dtype == "float64")
        hits += int(k[0, 1])
    assert hits >= 3


def test_xt_decks_on_the_card(device, tmp_path):
    """A fused µVT chunk with cavity bias and TMMC on the card: the
    collection holds every insert and delete attempt and the carried
    energy equals a fresh recompute (rel 1e-4)."""
    params, state, cfg, thermo, _ = _xt_system("float32", device)
    g = torch.Generator(device=device).manual_seed(5)
    st, stats = metropolis.run_chunk_fused_uvt(state, params, cfg, thermo,
                                               2000, generator=g)
    att = stats.attempts
    assert float(st.tmmc_c[:, [0, 2]].sum()) == att[1] + att[2] > 100
    fresh = metropolis.initialize(st, params, cfg, thermo)
    assert float(st.energy.total) == pytest.approx(
        float(fresh.energy.total), rel=1e-4)


# spinflip (quantum_rotation): B4 at position stride 0 (the rotor grid of
# ops/qrot.py), and B1 (XT), B3 (SF) and B6 (XT) with the move, against
# their plain versions on random rotor tables and spins


def _with_spins(state, params, cfg, seed, chains=None):
    """``state`` with random spins and a random rotor table of +-150 K
    (float64 on the state's device), so flips are both accepted and
    rejected at 77 K."""
    rng = np.random.default_rng(seed)
    lead = () if chains is None else (chains,)
    M = params.n_mols_max
    dev = state.pos.device
    return state.replace(
        spin=torch.as_tensor(rng.integers(0, 2, lead + (M,)),
                             dtype=torch.int32, device=dev),
        rot_f=torch.as_tensor(rng.uniform(-150.0, 150.0, lead + (M, 2)),
                              dtype=cfg.tdtype, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_stride0_matches_plain(device, dtype):
    """B4 over the 512 grid orientations of three rotors with the
    positions shared (stride 0): within _close of the plain version, and
    bit for bit the launch over an expanded, copied pos and alive."""
    from mpmc_tpu_torch.ops import qrot
    params, state, cfg, thermo = _system(dtype, device)
    state = metropolis.initialize(state, params, cfg, thermo)
    mols = qrot.rotor_slots(state.mol_alive, params,
                            [systems.h2_bss3()])[0][:3]
    axes = torch.as_tensor(qrot._basis(4, 16, 32)[3], dtype=state.pos.dtype,
                           device=device)
    mt = torch.as_tensor(mols, device=device)
    rows = qrot.grid_rows(state.pos, params, mt, axes)
    G = axes.shape[0]
    rows = rows.reshape(len(mols) * G, -1, 3).contiguous()
    mol = mt.repeat_interleave(G)
    alive = state.atom_alive(params)
    C = mol.shape[0]
    scal = pairs.pair_scalars(state.box, cfg)
    common = (params.charge, params.eps, params.sig, params.mol_id32)
    tail = (params.mol_atoms, params.mol_natoms, mol, rows, scal, cfg)
    before = pk.mol_pair_chains.launches
    k = pk.mol_pair_chains(state.pos, *common, alive, *tail)
    torch.cuda.synchronize(device)
    assert pk.mol_pair_chains.launches == before + 1
    _close(k, pk.mol_pair_chains_plain(state.pos, *common, alive, *tail),
           dtype)
    wide = pk.mol_pair_chains(
        state.pos.expand(C, -1, -1).contiguous(), *common,
        alive.expand(C, -1).contiguous(), *tail)
    assert torch.equal(k, wide)


def _ragged_system(n, dtype, device, seed=3):
    """A system of exactly n B4 columns: 1-3 frozen charged LJ sites and
    (n - 2) // 3 H2 slots (about half alive), random in a cube, and the
    two pad rows build_system adds after the last molecule."""
    from mpmc_tpu_torch.config import RunConfig
    from mpmc_tpu_torch.state import build_system
    cap = (n - 3) // 3
    F = n - 2 - 3 * cap
    rng = np.random.default_rng(seed)
    L = max(24.0, 3.0 * n ** (1 / 3))
    h2 = systems.h2_bss3()
    alive = cap // 2 + 1
    com = rng.uniform(0, L, (alive, 3))
    params, state = build_system(
        np.eye(3) * L, frozen_pos=rng.uniform(0, L, (F, 3)),
        frozen_params={"charge": rng.uniform(-0.5, 0.5, F),
                       "mass": np.full(F, 12.0),
                       "eps": rng.uniform(20, 80, F),
                       "sig": rng.uniform(2.8, 3.6, F),
                       "polar": np.zeros(F)},
        species=(h2,), capacity=(cap,), initial_counts=(alive,),
        initial_pos={0: com[:, None, :] + h2.pos[None]},
        dtype=getattr(torch, dtype), pad_atoms_to=1, seed=seed,
        device=device)
    cfg = RunConfig(ensemble="uvt", rd_potential="lj", coulomb="ewald",
                    ewald_kmax=5, insert_species=(0,), dtype=dtype)
    assert state.pos.shape[0] == n
    return params, state, cfg


@pytest.mark.parametrize("n", [37, 300, 1000])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_ragged_columns(device, dtype, n):
    """B4 at column counts that end inside a chunk (37 and 300: one and
    two chunks, 1000: four): C = 1 (the single-chain launch's bits), 5
    chains each with its own positions and a trial, and 5 placements at
    stride 0 (the expanded launch's bits), each within _close of the plain
    version."""
    params, state, cfg = _ragged_system(n, dtype, device)
    mol = int(np.flatnonzero(state.mol_alive.cpu().numpy()
                             & (params.mol_species >= 0).cpu().numpy())[0])
    alive = state.atom_alive(params)
    scal = pairs.pair_scalars(state.box, cfg)
    common = (params.charge, params.eps, params.sig, params.mol_id32)
    C = 5
    g = np.random.default_rng(n)
    shift = torch.as_tensor(g.uniform(-2, 2, (C, 1, 3)),
                            dtype=state.pos.dtype, device=device)
    rows = (state.pos[params.mol_atoms[mol]][None] + shift).contiguous()
    mols = torch.full((C,), mol, dtype=torch.int64, device=device)
    pos_c = (state.pos[None] + 0.05 * shift).contiguous()
    alive_c = alive.expand(C, -1).contiguous()
    for r in (None, rows):
        args = (pos_c, *common, alive_c, params.mol_atoms, params.mol_natoms,
                mols, r, scal, cfg)
        k = pk.mol_pair_chains(*args)
        torch.cuda.synchronize(device)
        _close(k, pk.mol_pair_chains_plain(*args), dtype)
        one = pk.mol_pair(pos_c[0], *common, alive_c[0], params.mol_atoms,
                          params.mol_natoms, mols[0],
                          None if r is None else r[0], scal, cfg)
        assert torch.equal(k[0], one)
    tail = (params.mol_atoms, params.mol_natoms, mols, rows, scal, cfg)
    k = pk.mol_pair_chains(state.pos, *common, alive, *tail)
    _close(k, pk.mol_pair_chains_plain(state.pos, *common, alive, *tail),
           dtype)
    wide = pk.mol_pair_chains(state.pos.expand(C, -1, -1).contiguous(),
                              *common, alive_c, *tail)
    assert torch.equal(k, wide)
    assert torch.isfinite(k).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_no_columns(device, dtype):
    """B4 over 0 columns (an empty system; 3 chains, trial rows): nothing
    is read past the empty planes, and every chain's sums are 0 with a
    closest approach of +inf."""
    params, state, cfg, _ = _system(dtype, device)
    dt = state.pos.dtype
    C = 3
    empty = torch.zeros(0, dtype=dt, device=device)
    mol = int(np.flatnonzero(state.mol_alive.cpu().numpy()
                             & (params.mol_species >= 0).cpu().numpy())[0])
    rows = state.pos[params.mol_atoms[mol]][None].expand(C, -1, -1)
    k = pk.mol_pair_chains(
        torch.zeros((C, 0, 3), dtype=dt, device=device), empty, empty,
        empty, torch.zeros(0, dtype=torch.int32, device=device),
        torch.zeros((C, 0), dtype=torch.bool, device=device),
        params.mol_atoms, params.mol_natoms,
        torch.full((C,), mol, dtype=torch.int64, device=device),
        rows.contiguous(), pairs.pair_scalars(state.box, cfg), cfg)
    torch.cuda.synchronize(device)
    want = torch.tensor([0.0, 0.0, 0.0, float("inf")], dtype=dt,
                        device=device).expand(C, 4)
    assert torch.equal(k, want)


def _orientations(state, params, mol, C, device, seed=11):
    """Trial rows [C, A, 3] of molecule ``mol`` turned about its COM to C
    random axes (qrot.grid_rows), and mol [C]."""
    from mpmc_tpu_torch.ops import qrot
    g = np.random.default_rng(seed)
    ax = g.standard_normal((C, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    mt = torch.tensor([mol], device=device)
    rows = qrot.grid_rows(state.pos, params, mt,
                          torch.as_tensor(ax, dtype=state.pos.dtype,
                                          device=device))
    return (rows.reshape(C, -1, 3).contiguous(),
            torch.full((C,), mol, dtype=torch.int64, device=device))


@pytest.mark.parametrize("side", [-1, 1], ids=["below", "above"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_regime_switch(device, dtype, side):
    """B4 at position stride 0 with an odd chain count just below
    (regime 2: a cluster per chain) and just above (regime 1: a CTA of
    chains streaming the column chunks) the card's grid_min: within
    _close of the plain version, and bit for bit the launch over an
    expanded, copied pos and alive (regime 2)."""
    params, state, cfg, _ = _system(dtype, device)
    n = state.pos.shape[0]
    gmin = pk.mol_pair_plan(n, 1, True, state.pos.dtype, cfg)["grid_min"]
    C = gmin + side
    assert C % 2 == 1
    plan = pk.mol_pair_plan(n, C, True, state.pos.dtype, cfg)
    assert plan["regime"] == (1 if side > 0 else 2)
    mol = int(np.flatnonzero(state.mol_alive.cpu().numpy()
                             & (params.mol_species >= 0).cpu().numpy())[0])
    rows, mols = _orientations(state, params, mol, C, device)
    alive = state.atom_alive(params)
    common = (params.charge, params.eps, params.sig, params.mol_id32)
    tail = (params.mol_atoms, params.mol_natoms, mols, rows,
            pairs.pair_scalars(state.box, cfg), cfg)
    before = pk.mol_pair_chains.shared_launches
    k = pk.mol_pair_chains(state.pos, *common, alive, *tail)
    torch.cuda.synchronize(device)
    assert pk.mol_pair_chains.shared_launches == before + 1
    _close(k, pk.mol_pair_chains_plain(state.pos, *common, alive, *tail),
           dtype)
    wide = pk.mol_pair_chains(state.pos.expand(C, -1, -1).contiguous(),
                              *common, alive.expand(C, -1).contiguous(),
                              *tail)
    assert torch.equal(k, wide)
    assert torch.equal(k, pk.mol_pair_chains(state.pos, *common, alive,
                                             *tail))


def test_mol_pair_grid_all_rotors_bench(device):
    """The rotor grid of the 10.8k bench system (chip_smoke's: 256 H2
    rotors x 512 orientations, float32) in one B4 launch, C = 131,072 >
    65,535 (regime 1): bit for bit its four 64-rotor launches and the
    launches over expanded, copied positions (regime 2, 8,192 chains a
    launch); the first 2,048 chains within _close of the plain version;
    and qrot.potentials_on_grid over all 256 rotors is that one launch."""
    from mpmc_tpu_torch.ops import qrot
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=21, n_h2=256, capacity=512, dtype="float32", device=device)
    state = metropolis.initialize(state, params, cfg, thermo)
    mols = qrot.rotor_slots(state.mol_alive, params, [systems.h2_bss3()])[0]
    assert len(mols) == 256
    axes = torch.as_tensor(qrot._basis(4, 16, 32)[3], dtype=torch.float32,
                           device=device)
    G = axes.shape[0]
    alive = state.atom_alive(params)
    scal = pairs.pair_scalars(state.box, cfg)
    common = (params.charge, params.eps, params.sig, params.mol_id32)

    def tail(ms):
        mt = torch.as_tensor(ms, device=device)
        rows = qrot.grid_rows(state.pos, params, mt, axes)
        return (params.mol_atoms, params.mol_natoms, mt.repeat_interleave(G),
                rows.reshape(-1, rows.shape[2], 3).contiguous(), scal, cfg)

    full = tail(mols)
    C = full[2].shape[0]
    assert C == 131072
    assert pk.mol_pair_plan(state.pos.shape[0], C, True, torch.float32,
                            cfg)["regime"] == 1
    k = pk.mol_pair_chains(state.pos, *common, alive, *full)
    torch.cuda.synchronize(device)
    parts = torch.cat([pk.mol_pair_chains(state.pos, *common, alive,
                                          *tail(mols[r0:r0 + 64]))
                       for r0 in range(0, 256, 64)])
    assert torch.equal(k, parts)
    step = 8192
    for c0 in range(0, C, step):
        sl = slice(c0, c0 + step)
        wide = pk.mol_pair_chains(
            state.pos.expand(step, -1, -1).contiguous(), *common,
            alive.expand(step, -1).contiguous(), *full[:2], full[2][sl],
            full[3][sl], scal, cfg)
        assert torch.equal(k[sl], wide), c0
    sl = slice(0, 2048)
    _close(k[sl], pk.mol_pair_chains_plain(
        state.pos, *common, alive, *full[:2], full[2][sl], full[3][sl],
        scal, cfg), "float32")
    before = pk.mol_pair_chains.launches
    v = qrot.potentials_on_grid(state.pos, state.box, alive, params, cfg,
                                thermo.temperature, mols, axes)
    assert pk.mol_pair_chains.launches == before + 1
    torch.testing.assert_close(
        v, (k[:, 0] + pairs.KE * k[:, 1]).reshape(256, G), rtol=0, atol=0)


def test_qrot_refresh_one_launch(device):
    """A rotor-table refresh (qrot.eigen_tables over every rotor of the
    small system) makes one B4 launch, at position stride 0."""
    from mpmc_tpu_torch.ops import qrot
    params, state, cfg, thermo = _system("float32", device)
    state = metropolis.initialize(state, params, cfg, thermo)
    before = (pk.mol_pair_chains.launches,
              pk.mol_pair_chains.shared_launches)
    eigs = qrot.eigen_tables(state.pos, state.box, state.atom_alive(params),
                             state.mol_alive, params, cfg, thermo,
                             [systems.h2_bss3()])
    assert len(eigs) > 1
    assert (pk.mol_pair_chains.launches,
            pk.mol_pair_chains.shared_launches) == (before[0] + 1,
                                                    before[1] + 1)


@pytest.mark.parametrize("xt", [False, True], ids=["sf", "sf+cav+tmmc"])
@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uvt_kernel_spinflip_matches_plain(device, dtype, chains, xt):
    """B1's XT instance with spinflip (p_spin 0.3; with cavity bias, TMMC
    and tmmc_bias too) against its plain version on one [C, 300, 16]
    table: equal move counts (spinflip's too), slot aliveness and spins;
    positions and sums within test_uvt_kernel_matches_plain's rules."""
    if xt:
        params, state, cfg, thermo, _ = _xt_system(dtype, device)
    else:
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=6, n_h2=20, capacity=40, dtype=dtype, device=device)
        cfg = dataclasses.replace(cfg, fused_mc=True)
        state = metropolis.initialize(state, params, cfg, thermo)
    cfg = dataclasses.replace(cfg, quantum_rotation=True)
    thermo = thermo.replace(spinflip_probability=torch.tensor(
        0.3, dtype=cfg.tdtype, device=device))
    assert mk.supported_uvt(cfg, params) or dtype == "float64"
    states = _with_spins(multichain.stack_states(state, chains), params,
                         cfg, 11, chains)
    u = torch.as_tensor(np.random.default_rng(4).random((chains, 300, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        states, params, cfg, thermo, u,
        metropolis.uvt_fused_tables(params, cfg))
    p = mk.run_steps_uvt_plain(*args, **kw)
    if xt:
        kw = dict(kw, tmmc_out=torch.zeros_like(kw["tmmc_out"]))
    before = mk.run_steps_uvt.launches
    k = mk.run_steps_uvt(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps_uvt.launches == before + 1
    k_sums, p_sums = k[2].cpu().numpy(), p[2].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 6:14], p_sums[:, 6:14])
    assert (p_sums[:, 13] > 50).all()
    assert (0 < p_sums[:, 12]).all() and (p_sums[:, 12] < p_sums[:, 13]).all()
    assert torch.equal(k[5], p[5]) and torch.equal(k[1], p[1])
    assert not torch.equal(p[5], kw["spin"])          # spins flipped
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :6]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :6])
           + 2e-3 * np.sqrt(p_sums[:, 6:9].sum(1, keepdims=True) + 1.0))
    assert (np.abs(k_sums[:, :6] - p_sums[:, :6]) <= tol).all()


@pytest.mark.parametrize("q", [None, "fh4"])
@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nvt_kernel_spinflip_matches_plain(device, dtype, chains, q):
    """B3's SF instance (with FH4 too) against its plain version on the
    MOF + H2 system with one [C, 300, 16] table, p_spin 0.3: equal accept
    counts (spinflip's too) and spins; positions and sums within
    test_nvt_kernel_matches_plain's rules."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=20, dtype=dtype, device=device)
    cfg = dataclasses.replace(cfg, ensemble="nvt", fused_mc=True,
                              quantum_rotation=True,
                              **(QUANTUM[q] if q else {}))
    thermo = thermo.replace(spinflip_probability=torch.tensor(
        0.3, dtype=cfg.tdtype, device=device))
    assert (mk.supported(cfg, params) and mk.supported_multi(cfg, params)
            or dtype == "float64")
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    states = _with_spins(multichain.stack_states(state, chains), params,
                         cfg, 12, chains)
    u = torch.as_tensor(np.random.default_rng(6).random((chains, 300, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_nvt_launch_args(states, params, cfg, thermo,
                                                u, tables)
    before = mk.run_steps.launches
    k = mk.run_steps(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps.launches == before + 1
    p = mk.run_steps_plain(*args, **kw)
    k_sums, p_sums = k[1].cpu().numpy(), p[1].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 3:6], p_sums[:, 3:6])
    assert (p_sums[:, 5] > 50).all() and (p_sums[:, 3] > 10).all()
    assert (0 < p_sums[:, 4]).all() and (p_sums[:, 4] < p_sums[:, 5]).all()
    assert torch.equal(k[4], p[4])
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :3]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :3])
           + 2e-3 * np.sqrt(p_sums[:, 3:4] + 1.0))
    assert (np.abs(k_sums[:, :3] - p_sums[:, :3]) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_spinflip_matches_plain(device, dtype):
    """B6's XT instance with spinflip (p_spin 0.3) on the polar MOF + H2
    system: a forced spinflip survivor at step 0, a forced one of each
    other move type, natural tables and a survivor-free one, held to
    _pda_agree's rules, with equal spinflip attempts."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=40, polarization=True, dtype=dtype,
        device=device)
    cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True,
                              quantum_rotation=True)
    thermo = thermo.replace(spinflip_probability=torch.tensor(
        0.3, dtype=cfg.tdtype, device=device))
    assert mk.supported_uvt_polar_da(cfg, params) or dtype == "float64"
    state = _with_spins(metropolis.initialize(
        systems.jittered(params, state, 5), params, cfg, thermo), params,
        cfg, 13)
    tables = metropolis.uvt_fused_tables(params, cfg)
    rng = np.random.default_rng(21)

    def table(u):
        return torch.as_tensor(u, dtype=cfg.tdtype, device=device)

    def launch(u):
        args, kw = metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                              tables)
        assert "rot_f" in kw
        return mk.run_steps_uvt_pda(*args, **kw).cpu().numpy(), args, kw

    us = []
    for lane11, lane8 in ((1e-30, 0.9), (0.9, 0.9), (0.9, 0.1), (0.9, 0.4)):
        u = rng.random((mk.PDA_SEG, 16))
        u[0, 4], u[0, 8], u[0, 11] = 1e-30, lane8, lane11
        us.append(table(u))
    us += [table(rng.random((mk.PDA_SEG, 16))) for _ in range(4)]
    us.append(pda_survivor_free(lambda u: launch(u)[0],
                                table(rng.random((mk.PDA_SEG, 16))), rng))
    spins = 0
    for u in us:
        k, args, kw = launch(u)
        torch.cuda.synchronize(device)
        trace = []
        p = mk.run_steps_uvt_pda_plain(*args, **kw, trace=trace).cpu().numpy()
        _pda_agree(k, p, trace, dtype == "float64")
        assert k[0, 11] == p[0, 11]
        spins += int(k[0, 2] == 3 and k[0, 1] > 0.5)
    assert spins >= 1


RD_FORMS = ("sg", "dreiding", "b14_7", "disp_expansion")


def _rd_system(dtype, device, form, **kw):
    """The small MOF + H2 system with its LJ wells mapped to ``form``
    (systems.rd_form_columns; disp_expansion damped, with its tail)."""
    params, state, cfg, thermo = _system(dtype, device)
    params, cfg = systems.with_rd_form(params, cfg, form, rd_lrc=True,
                                       damp_dispersion=True, **kw)
    return params, state, cfg, thermo


@pytest.mark.parametrize("form", RD_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_terms_kernel_rd_forms_match_plain(device, dtype, form):
    """B2's instance of each RD form (its own library) at row_start 0 and
    F against its plain version, one launch a call, the same bits on a
    repeat; disp_expansion's tail negative."""
    params, state, cfg, _ = _rd_system(dtype, device, form)
    disp, _ = pairs.site_columns(params, cfg)
    args = (state.pos, params.charge, params.eps, params.sig,
            params.mol_id32, state.atom_alive(params),
            params.mol_frozen[params.mol_id],
            pairs.pair_scalars(state.box, cfg), cfg)
    for rs in (0, metropolis.frozen_refresh_rows(params, cfg)):
        before = pk.pair_terms.launches
        k = pk.pair_terms(*args, row_start=rs, disp=disp)
        torch.cuda.synchronize(device)
        assert pk.pair_terms.launches == before + 1
        _close(k, pk.pair_terms_plain(*args, row_start=rs, disp=disp), dtype)
        assert torch.equal(k, pk.pair_terms(*args, row_start=rs, disp=disp))
        assert float(k[0]) != 0.0
        assert (float(k[3]) < 0) == (form == "disp_expansion")


@pytest.mark.parametrize("form", RD_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_kernel_rd_forms_match_plain(device, dtype, form):
    """B4's instance of each RD form against its plain version: one
    molecule's current and trial rows, over 3 chains (a [3, 20] header
    per chain), and at position stride 0 (the same trial in 4 placements
    against one system, bit for bit the launch over an expanded pos)."""
    params, state, cfg, _ = _rd_system(dtype, device, form)
    disp, _ = pairs.site_columns(params, cfg)
    alive = state.atom_alive(params)
    mol = int(np.flatnonzero(state.mol_alive.cpu().numpy()
                             & (params.mol_species >= 0).cpu().numpy())[0])
    trial = (state.pos[0] + params.species_pos[0]
             + torch.tensor([2.2, 0.31, 0.17], dtype=state.pos.dtype,
                            device=device))
    scal = pairs.pair_scalars(state.box, cfg)
    common = (params.charge, params.eps, params.sig, params.mol_id32)
    for rows in (None, trial):
        args = (state.pos, *common, alive, params.mol_atoms,
                params.mol_natoms, torch.tensor(mol, device=device), rows,
                scal, cfg)
        before = pk.mol_pair.launches
        k = pk.mol_pair(*args, disp=disp)
        torch.cuda.synchronize(device)
        assert pk.mol_pair.launches == before + 1
        _close(k, pk.mol_pair_plain(*args, disp=disp), dtype)
        assert float(k[0]) != 0.0
    C = 4
    shift = torch.tensor([[0.0, 0.0, 0.0], [0.3, -0.2, 0.1],
                          [-0.8, 0.5, 0.4], [1.1, 0.9, -0.6]],
                         dtype=state.pos.dtype, device=device)
    rows = (trial[None] + shift[:, None, :]).contiguous()
    mols = torch.full((C,), mol, dtype=torch.int64, device=device)
    box3 = state.box[None] * torch.tensor(
        [1.0, 1.01, 0.99, 1.02], dtype=state.pos.dtype,
        device=device)[:, None, None]
    pos_c = state.pos.expand(C, -1, -1).contiguous()
    alive_c = alive.expand(C, -1).contiguous()
    for pos, al, sc in ((pos_c, alive_c, pairs.pair_scalars(box3, cfg)),
                        (state.pos, alive, scal)):
        args = (pos, *common, al, params.mol_atoms, params.mol_natoms, mols,
                rows, sc, cfg)
        k = pk.mol_pair_chains(*args, disp=disp)
        _close(k, pk.mol_pair_chains_plain(*args, disp=disp), dtype)
    assert torch.equal(k, pk.mol_pair_chains(pos_c, *args[1:5], alive_c,
                                             *args[6:], disp=disp))


@pytest.mark.parametrize("form", RD_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_rd_forms_both_regimes(device, dtype, form):
    """B4's instance of each RD form at position stride 0 with grid_min +
    1 placements (regime 1) against its plain version and bit for bit
    the expanded launch (regime 2), and over 5 chains with their own
    positions within _close of the plain version."""
    params, state, cfg, _ = _rd_system(dtype, device, form)
    disp, _ = pairs.site_columns(params, cfg)
    n = state.pos.shape[0]
    C = pk.mol_pair_plan(n, 1, True, state.pos.dtype, cfg)["grid_min"] + 1
    assert pk.mol_pair_plan(n, C, True, state.pos.dtype, cfg)["regime"] == 1
    mol = int(np.flatnonzero(state.mol_alive.cpu().numpy()
                             & (params.mol_species >= 0).cpu().numpy())[0])
    rows, mols = _orientations(state, params, mol, C, device)
    alive = state.atom_alive(params)
    scal = pairs.pair_scalars(state.box, cfg)
    common = (params.charge, params.eps, params.sig, params.mol_id32)
    tail = (params.mol_atoms, params.mol_natoms, mols, rows, scal, cfg)
    k = pk.mol_pair_chains(state.pos, *common, alive, *tail, disp=disp)
    torch.cuda.synchronize(device)
    _close(k, pk.mol_pair_chains_plain(state.pos, *common, alive, *tail,
                                       disp=disp), dtype)
    wide = pk.mol_pair_chains(state.pos.expand(C, -1, -1).contiguous(),
                              *common, alive.expand(C, -1).contiguous(),
                              *tail, disp=disp)
    assert torch.equal(k, wide)
    c5 = 5
    pos_c = (state.pos[None] + 0.03 * torch.arange(
        c5, dtype=state.pos.dtype, device=device)[:, None, None]).contiguous()
    args = (pos_c, *common, alive.expand(c5, -1).contiguous(),
            params.mol_atoms, params.mol_natoms, mols[:c5], rows[:c5], scal,
            cfg)
    _close(pk.mol_pair_chains(*args, disp=disp),
           pk.mol_pair_chains_plain(*args, disp=disp), dtype)


def test_pair_kernels_rd_form_decks(device):
    """Each RD form (and coulomb gwp) through run_chunk on the card in
    float64: the forms launch B2 and B4, gwp neither (the plain pass); the
    carried energy equals a fresh recompute to rel 1e-9 (the small
    system's total nets terms of ~1e5 K: float64 keeps the check
    tight)."""
    for form in RD_FORMS + ("gwp",):
        if form == "gwp":
            params, state, cfg, thermo = _system("float64", device)
            params = params.replace(gwp_alpha=torch.where(
                params.charge != 0, 0.3, 0.0).to(params.eps.dtype))
            cfg = dataclasses.replace(cfg, coulomb="gwp")
        else:
            params, state, cfg, thermo = _rd_system("float64", device, form)
        pk.reset_counts()
        state = metropolis.initialize(state, params, cfg, thermo)
        g = torch.Generator(device=device).manual_seed(5)
        st, _ = metropolis.run_chunk(state, params, cfg, thermo, 60,
                                     generator=g)
        launched = pk.pair_terms.launches + pk.mol_pair.launches
        assert (launched > 0) == (form != "gwp"), form
        fresh = metropolis.initialize(st, params, cfg, thermo)
        np.testing.assert_allclose(float(st.energy.total),
                                   float(fresh.energy.total), rtol=1e-9,
                                   atol=1e-6)


# the fused kernels' forms: each RD form (disp_expansion damped, with its
# tail), coulomb gwp with LJ, and disp_expansion with gwp (ten column
# planes); B1, B3 and B6 run each in its form library
# gwp with lj under FH2 / FK: the quantum instance of gwp's library
FUSED_FORMS = RD_FORMS + ("gwp", "disp_expansion+gwp", "gwp+fh2", "gwp+fk")


def _fused_form_system(dtype, device, form, ensemble="uvt", capacity=40,
                       **kw):
    """The small MOF + H2 system under ``form`` (systems.rd_form_columns;
    gwp: widths 0.2-0.6 A, numpy seed 17, on every charged site; a
    QUANTUM key after the "+": that correction too) for the fused path of
    ``ensemble``, jittered and initialized."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=capacity, dtype=dtype, device=device,
        **kw)
    parts = form.split("+")
    if parts[0] in RD_FORMS:
        params, cfg = systems.with_rd_form(params, cfg, parts[0], rd_lrc=True,
                                           damp_dispersion=True)
    for q in parts[1:]:
        if q in QUANTUM:
            cfg = dataclasses.replace(cfg, **QUANTUM[q])
    if "gwp" in parts:
        q = params.charge.cpu().numpy()
        w = np.random.default_rng(17).uniform(0.2, 0.6, q.shape)
        params = params.replace(gwp_alpha=torch.as_tensor(
            np.where(q != 0, w, 0.0), dtype=params.eps.dtype, device=device))
        cfg = dataclasses.replace(cfg, coulomb="gwp")
    cfg = dataclasses.replace(cfg, ensemble=ensemble, fused_mc=True)
    state = metropolis.initialize(systems.jittered(params, state, 7),
                                  params, cfg, thermo)
    return params, state, cfg, thermo


def _rss_tol(trace, n_sums):
    """[C, n_sums]: 8 float32 epsilons x the root sum of squares of the rd
    and es terms of the accepted steps (the plain trace's rss) in the
    first two columns — the scale at which the two versions' per-term
    roundings drift apart (chip_smoke._rss_tol)."""
    sq = sum(torch.where(t["accept"][:, None], t["rss"] ** 2,
                         torch.zeros_like(t["rss"])) for t in trace)
    tol = np.zeros((sq.shape[0], n_sums))
    tol[:, :2] = 8 * np.finfo(np.float32).eps * np.sqrt(sq.cpu().numpy())
    return tol


@pytest.mark.parametrize("form", FUSED_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uvt_kernel_rd_forms_match_plain(device, dtype, form):
    """B1's form instance (uvt_<form>_kernel) on two chains against its
    plain version on one [2, 200, 16] table: equal decisions and slot
    aliveness, positions within 1e-9 / 1e-4 A, the sums within rel 1e-10
    (f64) or the classical float32 rule plus _rss_tol; the C columns and
    the widths passed, the launch counted."""
    params, state, cfg, thermo = _fused_form_system(dtype, device, form)
    u = torch.as_tensor(np.random.default_rng(5).random((2, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, 2), params, cfg, thermo, u,
        metropolis.uvt_fused_tables(params, cfg))
    assert (kw["disp"] is not None) == form.startswith("disp")
    assert (kw["gwp"] is not None) == ("gwp" in form.split("+"))
    assert (kw["mol_mass"] is not None) == (form.split("+")[-1] in QUANTUM)
    before = mk.run_steps_uvt.launches
    k = mk.run_steps_uvt(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps_uvt.launches == before + 1
    trace = []
    p = mk.run_steps_uvt_plain(*args, **kw, trace=trace)
    k_sums, p_sums = k[2].cpu().numpy(), p[2].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 6:12], p_sums[:, 6:12])
    assert p_sums[:, 6:9].sum() > 20 and p_sums[:, 7:9].sum() > 0
    assert torch.equal(k[1], p[1])
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :6]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :6])
           + 2e-3 * np.sqrt(p_sums[:, 6:9].sum(1, keepdims=True) + 1.0)
           + _rss_tol(trace, 6))
    assert (np.abs(k_sums[:, :6] - p_sums[:, :6]) <= tol).all()


@pytest.mark.parametrize("form", FUSED_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nvt_kernel_rd_forms_match_plain(device, dtype, form):
    """B3's form instance (nvt_<form>_kernel) on two chains against its
    plain version on one [2, 200, 16] table: test_nvt_kernel_quantum_
    matches_plain's checks, plus _rss_tol in float32."""
    params, state, cfg, thermo = _fused_form_system(dtype, device, form,
                                                    "nvt", capacity=20)
    u = torch.as_tensor(np.random.default_rng(3).random((2, 200, 16)),
                        dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, 2), params, cfg, thermo, u,
        metropolis.nvt_fused_tables(params, state.mol_alive))
    before = mk.run_steps.launches
    k = mk.run_steps(*args, **kw)
    torch.cuda.synchronize(device)
    assert mk.run_steps.launches == before + 1
    trace = []
    p = mk.run_steps_plain(*args, **kw, trace=trace)
    k_sums, p_sums = k[1].cpu().numpy(), p[1].cpu().numpy()
    np.testing.assert_array_equal(k_sums[:, 3:], p_sums[:, 3:])
    assert (p_sums[:, 3] > 10).all()
    f64 = dtype == "float64"
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               rtol=0, atol=1e-9 if f64 else 1e-4)
    tol = (np.maximum(1e-10 * np.abs(p_sums[:, :3]), 1e-8) if f64 else
           2e-5 * np.abs(p_sums[:, :3])
           + 2e-3 * np.sqrt(p_sums[:, 3:4] + 1.0) + _rss_tol(trace, 3))
    assert (np.abs(k_sums[:, :3] - p_sums[:, :3]) <= tol).all()


@pytest.mark.parametrize("form", FUSED_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pda_kernel_rd_forms_match_plain(device, dtype, form):
    """B6's form instance (pda_<form>_kernel) on the polar MOF + H2
    system: a forced survivor of each move type, a natural table and a
    survivor-free one, held to _pda_agree's rules."""
    params, state, cfg, thermo = _fused_form_system(dtype, device, form,
                                                    polarization=True)
    cfg = dataclasses.replace(cfg, polar_delayed=True)
    state = metropolis.initialize(state, params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    rng = np.random.default_rng(13)

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
        k, args, kw = launch(u)
        torch.cuda.synchronize(device)
        trace = []
        _pda_agree(k, mk.run_steps_uvt_pda_plain(*args, **kw, trace=trace),
                   trace, dtype == "float64")
        hits += int(k[0, 1])
    assert hits >= 3


B5_HEADER = [(C, layout) for C in (1, 3, 8) for layout in ("dense",
                                                          "culled")]


@pytest.mark.parametrize("C,layout", B5_HEADER,
                         ids=[f"c{C}-{lay}" for C, lay in B5_HEADER])
@pytest.mark.parametrize("mode", ["charge", "dipole"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thole_chains_header_per_chain(device, dtype, mode, C, layout):
    """B5 over C chains of 300 sites, each in its own cell (edges scaled
    -5 % .. +5 %, rc = L/2 - 1 per chain): a [C, 20] header, one launch;
    a shared header equals the same header repeated per chain bit for
    bit; chain c equals chain c launched alone in its own cell bit for
    bit; the culled launch (each chain's own cell order and visit table)
    equals the dense one bit for bit; each chain within
    test_thole_kernel_ragged's bound of the plain version with a box per
    chain."""
    dt = getattr(torch, dtype)
    scale = np.linspace(0.95, 1.05, C) if C > 1 else np.array([1.05])
    clouds = [_b5_cloud(300, dt, device, seed=s, L=20.0 * float(f))
              for s, f in enumerate(scale)]
    box = torch.stack([c[1] for c in clouds])
    pos, ok, q, mu, mol = (torch.stack([c[i] for c in clouds])
                           for i in (0, 2, 3, 4, 5))
    src = q if mode == "charge" else mu
    rc = 0.5 * torch.diagonal(box, dim1=-2, dim2=-1)[:, 0] - 1.0
    chains_fn, one_fn, plain = (
        (tk.charge_field_chains, tk.charge_field,
         tk.charge_field_chains_plain)
        if mode == "charge" else
        (tk.dipole_field_chains, tk.dipole_field,
         tk.dipole_field_chains_plain))
    visit = None
    if layout == "culled":
        perm, _ = thole.cull_perm(pos, box, ok, rc)
        pos, ok, src, mol = (thole._gather_sites(x, perm).contiguous()
                             for x in (pos, ok, src, mol))
        visit = thole.cull_visit(pos, ok, box, rc)
    args = (pos, box, ok, src, mol, rc, 2.1304, "exponential")
    before = chains_fn.launches
    k = chains_fn(*args, ortho=True, visit=visit)
    torch.cuda.synchronize(device)
    assert chains_fn.launches == before + 1
    if visit is not None:
        assert torch.equal(k, chains_fn(*args, ortho=True))
    shared = chains_fn(pos, box[0], ok, src, mol, rc[0], 2.1304,
                       "exponential", ortho=True)
    repeated = chains_fn(pos, box[0].expand(C, 3, 3).contiguous(), ok, src,
                         mol, rc[0].expand(C).contiguous(), 2.1304,
                         "exponential", ortho=True)
    assert torch.equal(shared, repeated)
    p64 = plain(*(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in args), visit=visit)
    p_dt = plain(*args, visit=visit)
    for c in range(C):
        one = one_fn(pos[c], box[c], ok[c], src[c], mol[c], rc[c], 2.1304,
                     "exponential", ortho=True,
                     visit=None if visit is None else visit[c])
        assert torch.equal(k[c], one), c
        scale_c = float(p64[c].abs().max())
        tol = (1e-12 * scale_c if dtype == "float64" else
               max(4.0 * float((p_dt[c].double() - p64[c]).abs().max()),
                   2e-6 * scale_c))
        assert float((k[c].double() - p64[c]).abs().max()) <= tol, c


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_qvib_grid_is_one_stride0_launch(device, dtype):
    """The stretch grid of every H2 (qvib.external_potentials_on_grid:
    224 bond lengths and b0 each) in one B4 launch at position stride 0,
    within _close of the plain version on the same rows."""
    from mpmc_tpu_torch.ops import qvib
    params, state, cfg, thermo = _system(dtype, device)
    state = metropolis.initialize(state, params, cfg, thermo)
    sp = dataclasses.replace(systems.h2_bss3(), vib_omega=4161.0)
    mols = np.flatnonzero(state.mol_alive.cpu().numpy()
                          & (params.mol_species >= 0).cpu().numpy())[:6]
    s, b0, mu = qvib.stretch_geometry(sp)
    grid = np.concatenate([qvib.stretch_grid(b0, mu, 4161.0 * qvib.CM1_K),
                           [b0]])
    before = (pk.mol_pair_chains.launches, pk.mol_pair_chains.shared_launches)
    k = qvib.external_potentials_on_grid(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        thermo.temperature, mols, [s] * len(mols), [b0] * len(mols),
        [grid] * len(mols))
    torch.cuda.synchronize(device)
    assert (pk.mol_pair_chains.launches,
            pk.mol_pair_chains.shared_launches) == (before[0] + 1,
                                                    before[1] + 1)
    rows = qvib.stretch_rows(state.pos, params, mols, [s] * len(mols),
                             [b0] * len(mols), [grid] * len(mols))
    G = grid.shape[0]
    mt = torch.as_tensor(mols, device=device).repeat_interleave(G)
    p = pk.mol_pair_chains_plain(
        state.pos, params.charge, params.eps, params.sig, params.mol_id32,
        state.atom_alive(params), params.mol_atoms, params.mol_natoms, mt,
        rows.reshape(-1, rows.shape[2], 3).contiguous(),
        pairs.pair_scalars(state.box, cfg), cfg)
    _close(k.reshape(-1), (p[:, 0] + pairs.KE * p[:, 1]), dtype)


# ---------------------------------------------------------------- B2 x C
B2C_FORMS = ("lj",) + RD_FORMS


def _dimer_batch(dtype, device, form, C=512, seed=12):
    """C geometries of a charged three-site H2 dimer in a 30 A cube (the
    surf drivers' system: one B2 tile, nearly all padding), each with its
    own separation (2.5-8 A) and orientations of both molecules, under the
    RD ``form`` (systems.with_rd_form, disp_expansion damped with its
    tail) and Ewald: (pair_terms' shared arguments, pos [C, N, 3],
    disp)."""
    from mpmc_tpu_torch.config import RunConfig
    from mpmc_tpu_torch.mc import surface
    from mpmc_tpu_torch.state import build_system
    dt = torch.float64 if dtype == "float64" else torch.float32
    params, state = build_system(np.eye(3) * 30.0,
                                 species=(systems.h2_bss3(),),
                                 capacity=(2,), initial_counts=(2,),
                                 dtype=dt, device=device)
    cfg = RunConfig(ensemble="nvt", dtype=dtype, rd_lrc=True)
    if form != "lj":
        params, cfg = systems.with_rd_form(params, cfg, form, rd_lrc=True,
                                           damp_dispersion=True)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, C, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = surface.dimer_positions(
        params, state.pos, 0, 1,
        torch.as_tensor(rng.uniform(2.5, 8.0, C), dtype=dt, device=device),
        torch.as_tensor(q[1], dtype=dt, device=device),
        torch.as_tensor(q[0], dtype=dt, device=device)).contiguous()
    disp, _ = pairs.site_columns(params, cfg)
    shared = (params.charge, params.eps, params.sig, params.mol_id32,
              state.atom_alive(params), params.mol_frozen[params.mol_id],
              pairs.pair_scalars(state.box, cfg), cfg)
    return shared, pos, disp


@pytest.mark.parametrize("form", B2C_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_terms_chains_kernel_identities(device, dtype, form):
    """B2 over a batch of dimer geometries at C = 1, 3, 64 and 512, every
    RD instance: one launch a call; each entry (every entry at C <= 64,
    every 37th at 512) equal to the lone B2 launch on its positions bit
    for bit; C = 1 equal to pair_terms; every entry within _close of
    pair_terms_chains_plain."""
    shared, pos, disp = _dimer_batch(dtype, device, form)
    for C in (1, 3, 64, 512):
        before = pk.pair_terms_chains.launches
        k = pk.pair_terms_chains(pos[:C].contiguous(), *shared, disp=disp)
        torch.cuda.synchronize(device)
        assert pk.pair_terms_chains.launches == before + 1
        assert k.shape == (C, 9)
        for c in range(0, C, 1 if C <= 64 else 37):
            lone = pk.pair_terms(pos[c].contiguous(), *shared, disp=disp)
            assert torch.equal(k[c], lone), (C, c)
        p = pk.pair_terms_chains_plain(pos[:C], *shared, disp=disp)
        _close(k, p, dtype)
    assert float(k[:, 0].abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_terms_chains_on_the_bench_system(device, dtype):
    """B2 over two geometries of the 10.8k bench system (its own and a
    jittered copy) at row_start 0 and F: each entry the lone launch bit
    for bit, within _close of the plain version."""
    params, state, cfg, _ = systems.mof_h2_gcmc(
        n_side=21, n_h2=256, capacity=512, dtype=dtype, device=device)
    moved = systems.jittered(params, state, seed=4)
    pos = torch.stack([state.pos, moved.pos]).contiguous()
    shared = (params.charge, params.eps, params.sig, params.mol_id32,
              state.atom_alive(params), params.mol_frozen[params.mol_id],
              pairs.pair_scalars(state.box, cfg), cfg)
    for rs in (0, metropolis.frozen_refresh_rows(params, cfg)):
        k = pk.pair_terms_chains(pos, *shared, row_start=rs)
        for c in range(2):
            assert torch.equal(k[c], pk.pair_terms(pos[c].contiguous(),
                                                   *shared, row_start=rs))
            _close(k[c], pk.pair_terms_plain(pos[c], *shared, row_start=rs),
                   dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_total_energy_launches_b2_over_the_batch(device, dtype):
    """energy.total_energy_chains of 64 dimer geometries on the card: one
    B2 launch over the batch in either precision (its gate is
    pair_kernel.supported, as pairs.pair_pass's for a lone geometry), and
    each entry's terms those of a lone total_energy on its positions."""
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.mc import surface
    from mpmc_tpu_torch.ops import energy
    from mpmc_tpu_torch.state import build_system
    dt = torch.float64 if dtype == "float64" else torch.float32
    params, state = build_system(np.eye(3) * 30.0,
                                 species=(systems.h2_bss3(),),
                                 capacity=(2,), initial_counts=(2,),
                                 dtype=dt, device=device)
    cfg = RunConfig(ensemble="nvt", dtype=dtype, rd_lrc=True)
    thermo = Thermo.make(temperature=77.0, dtype=dt, device=device)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = surface.dimer_positions(
        params, state.pos, 0, 1,
        torch.as_tensor(rng.uniform(2.5, 8.0, 64), dtype=dt, device=device),
        torch.as_tensor(q[1], dtype=dt, device=device),
        torch.as_tensor(q[0], dtype=dt, device=device))
    before = (pk.pair_terms_chains.launches, pk.pair_terms.launches)
    e = energy.total_energy_chains(pos, state.box, state.mol_alive, params,
                                   cfg, thermo)
    assert (pk.pair_terms_chains.launches, pk.pair_terms.launches) == (
        before[0] + 1, before[1])
    for c in range(0, 64, 9):
        lone, _ = energy.total_energy(pos[c], state.box, state.mol_alive,
                                      params, cfg, thermo)
        for k in ("rd", "es_real", "es_excl", "lrc"):
            assert torch.equal(getattr(e, k)[c], getattr(lone, k)), (c, k)
        _close(e.total[c], lone.total, dtype)


def _culled_system(device):
    """The small MOF + H2 system in float64 with rc 6 and the cell index
    forced (min_reduction None), on ``device``."""
    from mpmc_tpu_torch.ops import celllist
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=6, n_h2=12, capacity=24, dtype="float64", device=device)
    cfg = dataclasses.replace(cfg, cutoff=6.0, cell_list=True)
    params = celllist.attach(params, state.pos, state.box, cfg,
                             min_reduction=None)
    assert params.cell_index is not None
    return params, state, cfg, thermo


def test_culled_pass_and_partials_on_the_card(device):
    """The culled pass (one chain, and over chains at stride 0) and the
    molecule-pair partials and pair_matrix on the card against the same
    calls on the CPU (rel 1e-12); the scan path under cell_list and under
    mol_cache launches no B4."""
    P, S, C, T = _culled_system(device)
    Pc, Sc, _, Tc = _culled_system("cpu")
    mols = torch.tensor([1, 2, 3, 4])
    rows = S.pos[P.mol_atoms[mols.to(device)]] + 0.7
    k = pairs.mol_pair_pass(S.pos, S.box, S.atom_alive(P), P, C,
                            T.temperature, mols.to(device), row_pos=rows,
                            shared=True)
    p = pairs.mol_pair_pass(Sc.pos, Sc.box, Sc.atom_alive(Pc), Pc, C,
                            Tc.temperature, mols, row_pos=rows.cpu(),
                            shared=True)
    for f in ("rd", "es_real", "lrc_coeff", "min_r2"):
        np.testing.assert_allclose(getattr(k, f).cpu().numpy(),
                                   getattr(p, f).numpy(), rtol=1e-12,
                                   atol=1e-9)
    Cm = dataclasses.replace(C, cell_list=False, mol_cache=True)
    km = pairs.pair_matrix(S.pos, S.box, S.atom_alive(P), P, Cm,
                           T.temperature)
    pm = pairs.pair_matrix(Sc.pos, Sc.box, Sc.atom_alive(Pc), Pc, Cm,
                           Tc.temperature)
    for a, b in zip(km, pm):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-9 * float(b.abs().max()))
    for cfg in (C, Cm):
        pk.reset_counts()
        st = metropolis.initialize(S, P, cfg, T)
        g = torch.Generator(device=device).manual_seed(3)
        st, _ = metropolis.run_chunk(st, P, cfg, T, 100, generator=g)
        torch.cuda.synchronize(device)
        assert pk.mol_pair.launches == 0 and pk.pair_terms.launches == 1
        fresh = metropolis.initialize(st, P, cfg, T)
        np.testing.assert_allclose(float(st.energy.total),
                                   float(fresh.energy.total), rtol=1e-9,
                                   atol=1e-6)


ANALYZERS = ("rdf", "density", "loading", "cluster", "msd", "orient", "sq",
             "widom", "widom_mol", "pore", "asa")


def _analyzer_runs(name, path, tpl):
    """(integer outputs, float outputs) of one analyzer on a device."""
    from mpmc_tpu_torch import analyze as an
    u = an.sphere_points(96, seed=3)
    calls = {
        "rdf": lambda d: an.rdf_counts(path, "H2G", "H2G", rmax=6.0,
                                       nbins=60, device=d)[:2],
        "density": lambda d: an.density_grid(path, "H2", "M", (12, 11, 10),
                                             device=d),
        "loading": lambda d: (an.loading(path, "H2", "M", device=d),),
        "cluster": lambda d: an.cluster(path, "H2", "M", rc=4.5,
                                        max_size=8, device=d),
        "msd": lambda d: an.msd(path, "H2", "M", device=d),
        "orient": lambda d: an.orientation(path, "H2", "M", "H2E",
                                           device=d),
        "sq": lambda d: an.sq_hist(path, "*", "*", dr_bin=0.01,
                                   device=d)[:3],
        "widom": lambda d: an.widom_means(
            path, 34.2, 2.96, 77.0,
            np.random.default_rng(1).uniform(0, 1, (300, 3)), rc=6.0,
            device=d),
        "widom_mol": lambda d: an.widom_mol(path, tpl, 77.0, n_try=100,
                                            seed=2, rc=6.0, device=d),
        "pore": lambda d: an.pore_samples(
            path, "*", "F", frac_pts=np.random.default_rng(4).uniform(
                0, 1, (1500, 3)),
            frac_ctr=np.random.default_rng(5).uniform(0, 1, (200, 3)),
            device=d),
        "asa": lambda d: an.asa_counts(path, "*", "*", probe_sigma=1.0,
                                       unit_pts=u, device=d),
    }
    return calls[name]


@pytest.mark.parametrize("name", ANALYZERS)
def test_analyzer_on_the_card_equals_the_cpu(device, name, tmp_path):
    """Each frame analyzer in float64 on the card against the same
    function on the CPU (a GCMC trajectory, N changing, triclinic cell):
    integer outputs equal, float outputs within rel 1e-9."""
    from torch_analyze import gcmc_traj, h2_template
    path, _, _ = gcmc_traj(tmp_path)
    tpl = h2_template(tmp_path)
    call = _analyzer_runs(name, path, tpl)
    card, cpu = call(device), call("cpu")
    if isinstance(cpu, dict):
        card = [card[k] for k in sorted(cpu)]
        cpu = [cpu[k] for k in sorted(cpu)]
    for a, b in zip(card, cpu):
        a, b = np.asarray(a), np.asarray(b)
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# A13: the strip forms of B2, B4 and B5, and two ranks on the one card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_terms_strips_match_plain(device, dtype, D):
    """B2 over each strip's row tiles (I mod D == d) against its plain
    version over the same rows; the strips' sums add up to the whole
    pass, the closest approach their minimum."""
    params, state, cfg, _ = _system(dtype, device)
    args = (state.pos, params.charge, params.eps, params.sig,
            params.mol_id32, state.atom_alive(params),
            params.mol_frozen[params.mol_id],
            pairs.pair_scalars(state.box, cfg), cfg)
    parts = []
    for d in range(D):
        before = pk.pair_terms.strip_launches
        k = pk.pair_terms(*args, strip=(d, D))
        torch.cuda.synchronize(device)
        assert pk.pair_terms.strip_launches == before + 1
        _close(k, pk.pair_terms_plain(*args, strip=(d, D)), dtype)
        parts.append(k.double())
    full = pk.pair_terms(*args).double()
    summed = torch.stack(parts).sum(0)
    _close(summed[:8], full[:8], dtype)
    assert float(torch.stack(parts)[:, 8].min()) == float(full[8])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mol_pair_column_ranges_match_plain(device, dtype):
    """B4 over a rank's column range at d = 0 and 1 of 2 against its
    plain version, the two ranges adding up to the whole pass; the full
    range [0, N) bit for bit the launch without a range."""
    params, state, cfg, _ = _system(dtype, device)
    mol = torch.tensor(int(np.flatnonzero(
        state.mol_alive.cpu().numpy()
        & (params.mol_species >= 0).cpu().numpy())[0]), device=device)
    args = (state.pos, params.charge, params.eps, params.sig,
            params.mol_id32, state.atom_alive(params), params.mol_atoms,
            params.mol_natoms, mol, None,
            pairs.pair_scalars(state.box, cfg), cfg)
    n = state.pos.shape[0]
    parts = []
    for d in range(2):
        cols = pk.strip_cols(n, (d, 2))
        k = pk.mol_pair(*args, cols=cols)
        _close(k, pk.mol_pair_plain(*args, cols=cols), dtype)
        parts.append(k.double())
    whole = pk.mol_pair(*args)
    _close(parts[0][:3] + parts[1][:3], whole[:3].double(), dtype)
    assert torch.equal(pk.mol_pair(*args, cols=(0, n)), whole)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["dipole", "charge"])
def test_field_strip_matches_plain(device, mode, dtype):
    """B5 with a strip's visit table (its row tiles) against the plain
    version with the same table, in dipole mode (every sharded matvec)
    and charge mode (the sharded static field); rows outside the strip
    exact zeros."""
    params, state, cfg, _ = systems.mof_h2_gcmc(
        n_side=6, n_h2=20, capacity=40, polarization=True, dtype=dtype,
        device=device)
    alive = state.atom_alive(params)
    if mode == "dipole":
        kern, plain = tk.dipole_field, tk.dipole_field_plain
        ok = alive & (params.polar > 0)
        g = np.random.default_rng(5)
        src = torch.where(ok[:, None], torch.as_tensor(
            g.normal(size=(len(alive), 3)) * 0.05, dtype=state.pos.dtype,
            device=device), 0.0)
    else:
        kern, plain = tk.charge_field, tk.charge_field_plain
        ok, src = alive, params.charge
    _, ni, nj = tk.grid_shape(len(alive))
    for d in range(2):
        visit = ((torch.arange(ni, device=device) % 2) == d)[:, None] \
            .expand(ni, nj).to(torch.int32).contiguous()
        args = (state.pos, state.box, ok, src, params.mol_id32,
                pairs.derived_cutoff(state.box, cfg), cfg.polar_damp,
                cfg.polar_damp_type)
        k = kern(*args, ortho=True, visit=visit)
        rows = (torch.arange(len(alive), device=device) // tk.TI % 2) == d
        assert not bool((k[~rows] != 0).any())
        _close(k, plain(*args, ortho=True, visit=visit), dtype)

def test_spatial_te_on_two_ranks_of_one_card(device, tmp_path):
    """A spatial ``ensemble te`` on two gloo ranks sharing the card
    (--distributed --dist-backend gloo, one process a rank) against the
    single-rank te, term by term."""
    import os
    import pathlib
    import subprocess
    import sys

    from mpmc_tpu_torch.io import pqr
    from mpmc_tpu_torch.parallel import multihost
    repo = pathlib.Path(__file__).resolve().parents[1]
    params, state, _, _ = _system("float64", "cpu")
    pqr.write_state(str(tmp_path / "s.pqr"), params, state, ["H2"])
    L = float(state.box[0, 0])
    base = (f"ensemble te\ntemperature 77\nbasis1 {L} 0 0\nbasis2 0 {L} 0\n"
            f"basis3 0 0 {L}\nprecision float64\nallow_charged_cell on\n"
            f"pqr_input {tmp_path / 's.pqr'}\n")
    (tmp_path / "one.inp").write_text(base)
    (tmp_path / "two.inp").write_text(base + "spatial_devices 2\n")
    env = dict(os.environ, PYTHONPATH=str(repo))
    port = multihost.free_port()

    def cli(*a):
        return subprocess.Popen([sys.executable, "-m", "mpmc_tpu_torch", *a],
                                cwd=tmp_path, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)

    procs = [cli("--distributed", "--dist-backend", "gloo", "--coordinator",
                 f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(r), "two.inp") for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    one = cli("one.inp").communicate(timeout=300)[0]

    def terms(text):
        return {ln.split("=")[0].strip(): float(ln.split("=")[1])
                for ln in text.splitlines() if ln.count("=") == 1
                and ln.split("=")[0].strip() in ("rd", "es_real", "es_recip",
                                                 "total")}
    got, want = terms(outs[0][0]), terms(one)
    assert "spatial sharding: 2 devices" in outs[0][0]
    assert set(got) == set(want) == {"rd", "es_real", "es_recip", "total"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-10, abs=1e-6), k
