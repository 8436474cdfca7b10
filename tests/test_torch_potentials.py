"""The port's RD forms (mpmc_tpu_torch/ops/potentials.py) against the JAX
package's mpmc_tpu/ops/potentials.py in float64, rel 1e-12 (of the
largest |value| of the set where a form changes sign): sg below its 0.3
bohr floor, across the damping onset and beyond, dreiding and b14_7 from
the core to past the well, the Tang-Toennies factors at n = 6, 8, 10, the
damped and undamped dispersion expansion, its tail coefficient, and each
form's mixing rules through rd_pair_energy_generic.  Inputs from numpy
seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig  # noqa: E402
from mpmc_tpu.ops import potentials as jp  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.constants import BOHR_A, HARTREE_K  # noqa: E402
from mpmc_tpu_torch.ops import potentials as tp  # noqa: E402

torch.set_num_threads(1)
REL = 1e-12


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * float(np.abs(want).max()))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def test_constants_match_jax():
    """The port's copies of the conversion constants and SG's."""
    from mpmc_tpu import constants as jc
    assert BOHR_A == jc.BOHR_A and HARTREE_K == jc.HARTREE_K
    for k in ("ALPHA", "BETA", "GAMMA", "C6", "C8", "C9", "C10", "RC"):
        assert getattr(tp, "_SG_" + k) == getattr(jp, "_SG_" + k)


# r in A: below the floor (0.3 bohr = 0.159 A), through the damping onset
# (8.32 bohr = 4.40 A), out to 20 A
R_SG = np.concatenate([[1e-4, 0.05, 0.1587, 0.1588, 0.3],
                       np.random.default_rng(0).uniform(0.2, 20.0, 400),
                       [8.32 * BOHR_A - 1e-9, 8.32 * BOHR_A,
                        8.32 * BOHR_A + 1e-9]])


def test_sg_energy_matches_jax():
    """sg_energy on 408 distances, the floor's plateau included: below
    0.3 bohr every r gives the floor's value."""
    got = tp.sg_energy(_t(R_SG)).numpy()
    _close(got, jp.sg_energy(jnp.asarray(R_SG)))
    assert got[0] == got[1] == got[2] > 1e6


@pytest.mark.parametrize("form", ["dreiding", "b14_7"])
def test_exp6_and_buffered_energies_match_jax(form):
    """dreiding_energy (D0, r0) and b14_7_energy (eps, r0) on random
    distances 0.3-16 A with random well depths and positions."""
    rng = np.random.default_rng(1 if form == "dreiding" else 2)
    r = rng.uniform(0.3, 16.0, 500)
    e = rng.uniform(5.0, 300.0, 500)
    r0 = rng.uniform(2.5, 4.5, 500)
    fj = getattr(jp, form + "_energy")
    ft = getattr(tp, form + "_energy")
    _close(ft(_t(r), _t(e), _t(r0)).numpy(),
           fj(jnp.asarray(r), jnp.asarray(e), jnp.asarray(r0)))


@pytest.mark.parametrize("n", [6, 8, 10])
def test_tt_damping_matches_jax(n):
    """tt_damping(x, n) for x from 1e-3 to 40."""
    x = np.concatenate([np.geomspace(1e-3, 40.0, 300), [0.0]])
    _close(tp.tt_damping(_t(x), n).numpy(), jp.tt_damping(jnp.asarray(x), n))


@pytest.mark.parametrize("damp", [True, False], ids=["damped", "bare"])
def test_disp_expansion_energy_matches_jax(damp):
    """disp_expansion_energy with PHAHST-like A, B, C6, C8, C10 on 1.5-16
    A."""
    rng = np.random.default_rng(3)
    n = 400
    r = rng.uniform(1.5, 16.0, n)
    a = rng.uniform(1e4, 1e6, n)
    b = rng.uniform(2.5, 4.5, n)
    c6, c8, c10 = (rng.uniform(1e4, 1e5, n), rng.uniform(1e5, 1e6, n),
                   rng.uniform(1e6, 1e7, n))
    args = (r, a, b, c6, c8, c10)
    _close(tp.disp_expansion_energy(*map(_t, args), damp=damp).numpy(),
           jp.disp_expansion_energy(*map(jnp.asarray, args), damp=damp))


def test_disp_tail_coefficient_matches_jax():
    """disp_tail_coefficient at cutoffs 6-40 A."""
    rng = np.random.default_rng(4)
    args = (rng.uniform(0.0, 1e5, 100), rng.uniform(0.0, 1e6, 100),
            rng.uniform(0.0, 1e7, 100), rng.uniform(6.0, 40.0, 100))
    _close(tp.disp_tail_coefficient(*map(_t, args)).numpy(),
           jp.disp_tail_coefficient(*map(jnp.asarray, args)))


@pytest.mark.parametrize("form", ["sg", "dreiding", "b14_7",
                                  "disp_expansion"])
def test_generic_pair_energy_mixing_matches_jax(form):
    """rd_pair_energy_generic over a [12, 40] grid of row and column sites
    (zero-sigma, zero-eps and zero-C sites among them, as an H2 centre
    site has) at random distances: each form's mixing rules and its 1e-6 /
    1e-12 guards."""
    rng = np.random.default_rng(5)
    big = form == "disp_expansion"

    def col(n, zero):
        e = rng.uniform(1e4, 1e6, n) if big else rng.uniform(5, 200, n)
        s = rng.uniform(2.5, 4.5, n) if big else rng.uniform(2.0, 4.0, n)
        cs = [rng.uniform(1e3, 1e5, n), rng.uniform(1e4, 1e6, n),
              rng.uniform(1e5, 1e7, n)]
        for v in [e, s] + cs:
            v[zero] = 0.0
        return [e, s] + cs

    rows, cols = col(12, [0, 5]), col(40, [3, 17, 30])
    r = rng.uniform(2.0, 14.0, (12, 40))
    cfg = RunConfig(rd_potential=form, damp_dispersion=True)
    tcfg = convert.config_from(cfg)

    def gen(mod, conv, c):
        ri = [conv(v)[:, None] for v in rows]
        cj = [conv(v)[None, :] for v in cols]
        return mod.rd_pair_energy_generic(
            conv(r), ri[0], cj[0], ri[1], cj[1], ri[2], cj[2], ri[3], cj[3],
            ri[4], cj[4], c)

    want = np.asarray(gen(jp, jnp.asarray, cfg))
    got = gen(tp, _t, tcfg).numpy()
    _close(got, want)
    if form == "disp_expansion":
        bare = dataclasses.replace(cfg, damp_dispersion=False)
        _close(gen(tp, _t, convert.config_from(bare)).numpy(),
               np.asarray(gen(jp, jnp.asarray, bare)))
