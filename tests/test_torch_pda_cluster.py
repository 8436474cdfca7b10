"""B6 as one thread-block cluster (csrc/pda_kernel.cu), pure Python: the
shared memory of a CTA's slice with the polar planes, the cluster size the
wrapper picks from the card's resident cluster counts, the refusal of a
size that fits no G, the length of the partial vector each CTA exchanges
per step, and the CPU route's handling of ``cluster=``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.models import systems  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402

torch.set_num_threads(1)

# clusters of G CTAs an H100 SXM holds at once, one CTA per SM (a cluster
# lies within one GPC), as chip_smoke.py's B1 and B3 phases log them
H100_RESIDENT = {16: 7, 8: 15, 4: 30, 2: 66}
# the 10.8k polar bench system: 10,797 columns, 709 k-vectors, 512 slots
N, NK, MS = 10797, 709, 512


def _seg(b):
    return (b + 15) // 16 * 16


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4),
                                        (torch.float64, 8)])
@pytest.mark.parametrize("G", [2, 4, 8, 16])
def test_polar_slice_bytes_of_the_bench_system(dtype, size, G):
    """B1's slice (six column planes, eight k-vector planes, the slot
    species, the column and slot alive flags) plus four column planes
    (polar, e0 x/y/z), each segment rounded to 16 bytes; at G = 16 about
    31 KB in float32 and 60 KB in float64."""
    nloc, kloc = -(-N // G), -(-NK // G)
    b1 = (_seg(6 * nloc * size) + _seg(8 * kloc * size) + _seg(4 * MS)
          + _seg(nloc) + _seg(MS))
    assert tmk.slice_bytes(N, dtype, G, NK, MS) == b1
    assert tmk.slice_bytes(N, dtype, G, NK, MS, polar=True) == (
        b1 + _seg(4 * nloc * size))
    if G == 16:
        assert tmk.slice_bytes(N, dtype, G, NK, MS, polar=True) == (
            31696 if size == 4 else 60128)


@pytest.mark.parametrize("dtype,fits", [(torch.float32, [4, 8, 16]),
                                        (torch.float64, [8, 16])])
def test_pda_cluster_size_of_the_bench_system(dtype, fits):
    """The G whose polar slice fits beside B6's static tables: float32
    from 4 CTAs, float64 from 8 (B1's float64 slice fits at 4); one chain
    runs at the largest G the card holds a cluster of, else the next."""
    assert tmk.fitting_cluster_sizes(N, dtype, NK, MS, polar=True) == fits
    assert tmk.cluster_size(1, N, dtype, H100_RESIDENT, NK, MS,
                            polar=True) == 16
    held = {**H100_RESIDENT, 16: 0}
    assert tmk.cluster_size(1, N, dtype, held, NK, MS, polar=True) == 8
    none = {G: 0 for G in H100_RESIDENT}
    assert tmk.cluster_size(1, N, dtype, none, NK, MS,
                            polar=True) == min(fits)
    for G in tmk.CLUSTER_SIZES:
        big = tmk.slice_bytes(N, dtype, G, NK, MS, polar=True)
        assert (G in fits) == (
            big <= tmk.SMEM_BYTES - tmk.SMEM_STATIC_PDA)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pda_cluster_size_refuses_a_size_that_fits_no_g(dtype):
    with pytest.raises(ValueError, match="do not fit"):
        tmk.cluster_size(1, 100000, dtype, H100_RESIDENT, NK, MS,
                         polar=True)
    with pytest.raises(ValueError, match="cluster=8 needs"):
        tmk._check_cluster(8, 100000, dtype, NK, MS, "run_steps_uvt_pda",
                           polar=True)


@pytest.mark.parametrize("na,field,want", [
    (1, 0, 8), (3, 0, 14), (3, 1, 14), (3, 2, 23), (4, 2, 29), (5, 0, 20),
    (8, 1, 29), (8, 2, 53)])
def test_pda_partial_len(na, field, want):
    """d_rd, d_es, z_others, d_rec, en[3 na], eo[3 na] under polar_ewald
    (field 2), min r^2: at most 53 doubles (8 sites, polar_ewald), the
    kernel's exchange row."""
    assert tmk.pda_partial_len(na, field) == want


def _cpu_launch(field="direct"):
    """B6's launch arguments on the 57-site polar system on the CPU, with
    a [16, 16] table whose step 0 survives."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=10, polarization=True, dtype="float32",
        device="cpu")
    cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True,
                              polar_wolf=field == "wolf")
    state = tm.initialize(systems.jittered(params, state, 5), params, cfg,
                          thermo)
    u = np.random.default_rng(4).random((tmk.PDA_SEG, 16))
    u[0, 4], u[0, 8] = 1e-30, 0.9
    return tm.pda_launch_args(state, params, cfg, thermo,
                              torch.as_tensor(u, dtype=torch.float32),
                              tm.uvt_fused_tables(params, cfg))


@pytest.mark.parametrize("field", ["direct", "wolf"])
def test_plain_b6_ignores_cluster(field):
    """On CPU tensors the wrapper checks cluster=, then runs the plain
    version, whose record does not depend on it."""
    args, kw = _cpu_launch(field)
    want = tmk.run_steps_uvt_pda(*args, **kw)
    assert float(want[0, 1]) == 1.0
    for G in tmk.CLUSTER_SIZES:
        assert torch.equal(tmk.run_steps_uvt_pda(*args, **kw, cluster=G),
                           want)
        assert torch.equal(
            tmk.run_steps_uvt_pda_plain(*args, **kw, cluster=G), want)


@pytest.mark.parametrize("bad", [0, 1, 3, 32, 2.5])
def test_run_steps_uvt_pda_rejects_cluster_sizes(bad):
    args, kw = _cpu_launch()
    with pytest.raises(ValueError, match="cluster="):
        tmk.run_steps_uvt_pda(*args, **kw, cluster=bad)


def test_run_steps_uvt_pda_rejects_a_slice_beyond_shared_memory():
    """cluster=2 at 40k float32 columns needs ~510 KB per CTA."""
    args, kw = _cpu_launch()
    n = 40000
    big = list(args)
    big[0] = torch.zeros((n, 3))
    big[1] = torch.zeros(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="cluster=2 needs"):
        tmk.run_steps_uvt_pda(*big, **kw, cluster=2)
