"""The port's sharded polar passes (mpmc_tpu_torch/parallel/spatial.py:
B5's row strips under spatial_axis) on D = 2 and 3 gloo ranks on the CPU
against the reference's mpmc_tpu.parallel.spatial on the 8-device CPU mesh
and its unsharded solve and total energy, in float64: the static field at
rel 1e-12, mu at rel 1e-10 with the same CG iteration count, the polar
term, on a small polar MOF (n_side 6, three row tiles, the CG solver) and
the golden polar configuration (mof_h2_polar_fh: the direct solver and
Feynman-Hibbs)."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy, thole as jthole  # noqa: E402
from mpmc_tpu.parallel import spatial as jspatial  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402

import torch_dist  # noqa: E402

TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
CASES = ("mof6_polar", "mof_h2_polar_fh")
DS = (2, 3)


def _build(name):
    if name == "mof6_polar":
        return jsystems.mof_h2_gcmc(n_side=6, n_h2=24, capacity=32,
                                    polarization=True, dtype="float64")
    from test_torch_energy import _build as golden
    return golden(name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX systems, {D: [rank results]}, the reference's values): on the
    polar MOF its sharded static field and solve over a 2-device mesh and
    its unsharded solve; on the golden system its total energy."""
    systems = {n: _build(n) for n in CASES}
    cases = [(n, *convert.from_jax(*systems[n])) for n in CASES]
    wait = torch_dist.start_groups(torch_dist.spatial_passes, DS,
                                   tmp_path_factory.mktemp("spatial_scf"),
                                   cases)
    p, s, c, t = systems["mof6_polar"]
    alive = s.atom_alive(p)
    mesh = Mesh(np.array(jax.devices()[:2]), (jspatial.AXIS,))
    e0 = jspatial.static_field_sharded(s.pos, s.box, alive, p, c, mesh)
    mu, it = jspatial.solve_scf_sharded(s.pos, s.box, alive, p, c, e0, mesh)
    e0_1 = jthole.static_field(s.pos, s.box, alive, p, c)
    mu_1, it_1, *_ = jthole.solve_scf(s.pos, s.box, alive, p, c, e0_1)
    ref = {"e0": np.asarray(e0), "mu": np.asarray(mu), "iters": int(it),
           "mu_1": np.asarray(mu_1), "iters_1": int(it_1),
           "polar_1": float(jthole.polar_energy(mu_1, e0_1))}
    p, s, c, t = systems["mof_h2_polar_fh"]
    ref["fh_te"] = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c,
                                        t)[0]
    return systems, wait(), ref


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", CASES)
def test_ranks_agree_bit_for_bit(runs, name, D):
    """Every rank holds the same bits of the field, mu and the energy."""
    _, ranks, _ = runs
    r0 = ranks[D][0][name]
    for r in ranks[D][1:]:
        for k, v in r[name].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(v, r0[k]), k
            else:
                assert v == r0[k], k


@pytest.mark.parametrize("D", DS)
def test_static_field_sharded_matches_reference(runs, D):
    _, ranks, ref = runs
    got = ranks[D][0]["mof6_polar"]["e0"]
    assert np.max(np.abs(got - ref["e0"])) <= \
        1e-12 * np.max(np.abs(ref["e0"]))


@pytest.mark.parametrize("D", DS)
def test_solve_scf_sharded_matches_reference(runs, D):
    """mu against the reference's solve_scf_sharded and its unsharded
    solve at rel 1e-10 of |mu|, with the same CG iteration count."""
    _, ranks, ref = runs
    got = ranks[D][0]["mof6_polar"]
    scale = np.max(np.abs(ref["mu"]))
    assert np.max(np.abs(got["mu"] - ref["mu"])) <= 1e-10 * scale
    assert np.max(np.abs(got["mu"] - ref["mu_1"])) <= 1e-10 * scale
    assert got["iters"] == ref["iters"] == ref["iters_1"] > 1


@pytest.mark.parametrize("D", DS)
def test_polar_term_matches_reference(runs, D):
    """The sharded total energy's polar term on the polar MOF against
    -ke/2 mu.E0 of the reference's unsharded solve."""
    _, ranks, ref = runs
    got = ranks[D][0]["mof6_polar"]["te"]["polar"]
    assert got == pytest.approx(ref["polar_1"], rel=1e-10)


@pytest.mark.parametrize("D", DS)
def test_golden_polar_total_energy_matches_reference(runs, D):
    """mof_h2_polar_fh (direct solver, Feynman-Hibbs) sharded, term by
    term against mpmc_tpu's unsharded total_energy at rel 1e-12 of each
    term (floor: 1e-12 of the largest)."""
    _, ranks, ref = runs
    want = ref["fh_te"]
    got = ranks[D][0]["mof_h2_polar_fh"]["te"]
    scale = max(abs(float(getattr(want, k))) for k in TERMS)
    for k in TERMS:
        w = float(getattr(want, k))
        assert abs(got[k] - w) <= 1e-12 * (abs(w) + scale), (k, got[k], w)
