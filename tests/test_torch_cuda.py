"""The CUDA pair kernels against their plain versions on the card.

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
from mpmc_tpu_torch.ops.cuda import pair_kernel as pk  # noqa: E402

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
