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
    """B4 (one launch: its last block reduces the partials) against its
    plain version, current rows and a trial; one launch counted per call,
    and the scratch kept across calls (no allocation per move)."""
    params, state, cfg, _ = _system(dtype, device)
    mol = torch.tensor(int(np.flatnonzero(
        state.mol_alive.cpu().numpy()
        & (params.mol_species >= 0).cpu().numpy())[0]), device=device)
    trial = (state.pos[0] + params.species_pos[0]
             + torch.tensor([2.2, 0.31, 0.17], dtype=state.pos.dtype,
                            device=device))
    kept = None
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
        # the same bits on a repeat: the ticket is back at 0 and the
        # reduction order fixed
        assert torch.equal(k, pk.mol_pair(*args))
        ptrs = [t.data_ptr() for t in pk.mol_pair_scratch(
            device, state.pos.dtype, 1)]
        assert kept is None or ptrs == kept
        kept = ptrs


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
