"""Shared set-up of the port's Feynman-Hibbs/Kleinert tests
(tests/test_torch_fh.py, test_torch_fused_fh.py, test_torch_fused_nvt_fh.py):
the corrections, the MOF + H2 system at 77 K built and initialized by the
JAX package under one of them, the f32 tolerances of the plain kernels
against the Pallas ones, and the fused chunk's float64 bookkeeping."""
import dataclasses

import numpy as np
import pytest
import torch

from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.models import systems
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.mc import metropolis as tm

# the corrections: FH order 2, FH order 4, FK (which takes precedence)
QUANTUM = {"fh2": {"feynman_hibbs": True},
           "fh4": {"feynman_hibbs": True, "feynman_hibbs_order": 4},
           "fk": {"feynman_kleinert": True}}
CLASSICAL = {"feynman_hibbs": False, "feynman_kleinert": False}
# f32 sums, plain against Pallas: the A&S erfc and f32 accumulation of the
# Pallas kernels (tests/test_torch_fused_uvt.py's tolerances)
F32_SUM_ATOL = 5e-2
F32_SUM_RTOL = 1e-4
POS_ATOL = 1e-4
TEMPS = (77.0, 120.0)         # two chains' temperatures


def jax_system(kind, q, dtype="float32", n_side=4):
    """The JAX MOF + H2 system at 77 K (a frozen framework partner of huge
    molecular mass included) with the correction ``q``, as the fused µVT
    (kind "uvt") or NVT ("nvt") path runs it, initialized."""
    p, s, c, t = systems.mof_h2_gcmc(n_side=n_side, n_h2=8, capacity=16,
                                     temperature=77.0, dtype=dtype)
    c = dataclasses.replace(c, fused_mc=True, **QUANTUM[q])
    if kind == "nvt":
        c = dataclasses.replace(c, ensemble="nvt")
    return p, jm.initialize(s, p, c, t), c, t


def assert_sums(got, want, counts):
    """Kernel sums: the ``counts`` columns equal, the energy columns within
    the f32 tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got[..., counts], want[..., counts])
    e = [i for i in range(got.shape[-1]) if i not in counts]
    np.testing.assert_allclose(got[..., e], want[..., e], rtol=F32_SUM_RTOL,
                               atol=F32_SUM_ATOL)


def check_fused_bookkeeping_f64(kind, q):
    """The fused chunk on the plain B1 (kind "uvt") or B3 ("nvt") in
    float64 under the correction ``q``: after 200 steps every carried
    term equals a fresh initialize to 1e-9; the correction moves the
    starting state's rd by more than 1 K against its classical energy."""
    P, S, C, T = convert.from_jax(*jax_system(kind, q, "float64"))
    classical = tm.initialize(S, P, dataclasses.replace(C, **CLASSICAL), T)
    assert abs(float(classical.energy.rd) - float(S.energy.rd)) > 1.0
    g = torch.Generator().manual_seed(4)
    chunk = tm.run_chunk_fused_uvt if kind == "uvt" else tm.run_chunk_fused
    st, stats = chunk(S, P, C, T, 200, generator=g)
    assert int(stats.host().accepts.sum()) > 10
    fresh = tm.initialize(st, P, C, T)
    for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl"):
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
