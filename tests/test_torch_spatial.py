"""The port's sharded passes (mpmc_tpu_torch/parallel/spatial.py) on D = 2
and 3 gloo ranks on the CPU (uneven strips) against the reference's
mpmc_tpu.parallel.spatial on the 8-device CPU mesh of tests/conftest.py,
and against mpmc_tpu's unsharded total_energy, in float64: the pair pass,
the reciprocal sum and the total energy, on a small MOF (n_side 6, three
row tiles) and the golden configurations of the port's slice without
polarization (tests/test_torch_spatial_scf.py holds the polar ones), and
a polarizable Drude fluid under cdvdw.  The ranks run once per D for
every case, the two groups together (tests/torch_dist.py)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import pairs as jpairs  # noqa: E402
from mpmc_tpu.parallel import spatial as jspatial  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402

import torch_dist  # noqa: E402

TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
GOLDEN = ("lj_fluid", "mof_h2_ewald", "mof_h2_wolf_wh", "h2_dispexp_gwp")
# cdvdw: the many-body vdW pass is whole on every rank, the pair pass and
# the SCF's matvec sharded (the reference's te_supported falls back to
# the whole energy; the port's sum is the same)
CASES = ("mof6",) + GOLDEN + ("cdvdw_fluid",)
DS = (2, 3)
# float64, summed in other orders than the reference's: rel 1e-12 of each
# term, with an absolute floor of 1e-12 of the largest term for the sums
# that cancel (a pass of n pairs carries n ulps of its largest terms)
REL = 1e-12


def _build(name):
    if name == "mof6":
        return jsystems.mof_h2_gcmc(n_side=6, n_h2=24, capacity=32,
                                    dtype="float64")
    if name == "cdvdw_fluid":
        from test_torch_vdw import _fluid
        return _fluid()[0]
    from test_torch_energy import _build as golden
    return golden(name)


def _mesh(D):
    return Mesh(np.array(jax.devices()[:D]), (jspatial.AXIS,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX systems, {D: [rank results]}, the reference's values): the
    reference's sharded passes on the mof6 system (the one with several
    row tiles) over a 2-device mesh, and its unsharded total energy of
    every case."""
    systems = {n: _build(n) for n in CASES}
    cases = [(n, *convert.from_jax(*systems[n])) for n in CASES]
    wait = torch_dist.start_groups(torch_dist.spatial_passes, DS,
                                   tmp_path_factory.mktemp("spatial"), cases)
    ref = {}
    for n, (p, s, c, t) in systems.items():
        alive = s.atom_alive(p)
        ref[n] = {"te": jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c,
                                             t)[0]}
        if n == "mof6":
            ref[n]["pair"] = jspatial.pair_pass_sharded(
                s.pos, s.box, alive, p, c, t.temperature, _mesh(2))
            rc = jpairs.derived_cutoff(s.box, c)
            ref[n]["recip"] = jspatial.recip_energy_sharded(
                s.pos, p.charge, alive, s.box, jpairs.derived_alpha(rc, c),
                c.ewald_kmax, _mesh(2))
    return systems, wait(), ref


def _close(got, want, scale=None):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    floor = REL * (np.max(np.abs(want)) if scale is None else scale)
    assert np.all(np.abs(got - want) <= REL * np.abs(want) + floor), (
        got, want)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", CASES)
def test_ranks_agree_bit_for_bit(runs, name, D):
    """Every rank holds the same bits of every sharded result."""
    _, ranks, _ = runs
    r0 = ranks[D][0][name]
    for r in ranks[D][1:]:
        assert r[name] == r0


@pytest.mark.parametrize("D", DS)
def test_pair_pass_sharded_matches_reference(runs, D):
    """mof6 (three row tiles: uneven strips at D = 3) against the
    reference's pair_pass_sharded."""
    _, ranks, ref = runs
    want = ref["mof6"]["pair"]
    got = ranks[D][0]["mof6"]["pair"]
    scale = max(abs(float(want.rd)), abs(float(want.es_real)),
                abs(float(want.es_excl)))
    for k, g in zip(("rd", "es_real", "es_excl", "lrc_coeff"), got):
        _close(g, float(getattr(want, k)), scale)
    assert got[4] == pytest.approx(float(want.min_r2), rel=1e-14)


@pytest.mark.parametrize("D", DS)
def test_recip_energy_sharded_matches_reference(runs, D):
    """mof6's k-table split over D ranks (padded to a multiple of D)
    against the reference's recip_energy_sharded."""
    _, ranks, ref = runs
    _close(ranks[D][0]["mof6"]["recip"], float(ref["mof6"]["recip"]))


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", CASES)
def test_total_energy_sharded_matches_reference(runs, name, D):
    """Each term against mpmc_tpu's unsharded total_energy."""
    _, ranks, ref = runs
    want = ref[name]["te"]
    got = ranks[D][0][name]["te"]
    scale = max(abs(float(getattr(want, k))) for k in TERMS)
    for k in TERMS:
        _close(got[k], float(getattr(want, k)), scale)

