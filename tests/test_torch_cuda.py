"""The CUDA kernels (the pair kernels B2/B4 and the fused µVT kernel B1)
against their plain versions on the card.

These need a CUDA device and ``nvcc``; they skip elsewhere.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest`` because tests/conftest.py configures JAX).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.mc import metropolis  # noqa: E402
from mpmc_tpu_torch.models import systems  # noqa: E402
from mpmc_tpu_torch.ops import pairs  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as mk  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as pk  # noqa: E402
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
