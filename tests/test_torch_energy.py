"""The port's total_energy against mpmc_tpu.ops.energy.total_energy in
float64, term by term, on the golden configurations inside the port's
slice; the JAX->port converter; the port's own system builder."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.mc import metropolis as jmetro  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tmetro  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402

torch.set_num_threads(1)

TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
GOLDEN_IN_SLICE = ("lj_fluid", "mof_h2_ewald", "mof_h2_wolf_wh",
                   "mof_h2_polar_fh", "h2_dispexp_gwp")


def _build(name):
    if name == "h2_dispexp_gwp":
        from test_golden import _build as golden_build
        return golden_build(name)
    if name == "lj_fluid":
        return jsystems.lj_fluid(n=32, dtype="float64", seed=3)
    if name == "mof_h2_polar_fh":
        p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                          polarization=True, dtype="float64")
        return p, s, dataclasses.replace(c, feynman_hibbs=True,
                                         polar_solver="direct"), t
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      dtype="float64")
    if name == "mof_h2_wolf_wh":
        c = dataclasses.replace(c, coulomb="wolf",
                                mixing_rule="waldman_hagler")
    return p, s, c, t


def _close(got, want):
    for k in TERMS:
        g, w = float(getattr(got, k)), float(np.asarray(getattr(want, k)))
        assert g == pytest.approx(w, rel=1e-10, abs=1e-8), (k, g, w)


# the frozen-reuse refresh needs a frozen framework (not in lj_fluid or
# h2_dispexp_gwp: tests/test_torch_rd_runs.py runs it under
# disp_expansion and gwp on the MOF) and a temperature-independent frozen
# part (not under Feynman-Hibbs)
ENERGY_CASES = [(n, m) for n in GOLDEN_IN_SLICE
                for m in ("plain", "split_frozen", "frozen_cached")
                if not (n in ("lj_fluid", "mof_h2_polar_fh", "h2_dispexp_gwp")
                        and m == "frozen_cached")]


@pytest.mark.parametrize("name,mode", ENERGY_CASES)
def test_total_energy_matches_jax_f64(name, mode):
    p, s, c, t = _build(name)
    P, S, C, T = convert.from_jax(p, s, c, t)
    if mode == "plain":
        want, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t)
        got, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T)
        _close(got, want)
        return
    wa, wf, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t,
                                     split_frozen=True)
    ga, gf, aux = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T,
                                       split_frozen=True)
    if mode == "split_frozen":
        _close(ga, wa)
        _close(gf, wf)
        return
    # the per-corrtime fast refresh: rows >= F only, frozen part reused
    F = jmetro.frozen_refresh_rows(p, c)
    assert F > 0 and F == tmetro.frozen_refresh_rows(P, C)
    want, _, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t,
                                      split_frozen=True, frozen_cached=wf,
                                      active_row_start=F)
    got, same, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T,
                                        split_frozen=True, frozen_cached=gf,
                                        active_row_start=F)
    assert same is gf
    _close(got, want)


@pytest.mark.parametrize("name", GOLDEN_IN_SLICE)
def test_convert_round_trips_every_field(name):
    p, s, c, t = _build(name)
    s = jmetro.initialize(s, p, c, t)
    P, S, C, T = convert.from_jax(p, s, c, t)
    for f in dataclasses.fields(P):
        if f.name == "cell_index":     # an object, None without cell_list
            assert P.cell_index is None and p.cell_index is None
        elif f.init:
            np.testing.assert_array_equal(getattr(P, f.name).numpy(),
                                          np.asarray(getattr(p, f.name)),
                                          err_msg=f.name)
    np.testing.assert_array_equal(P.mol_id32.numpy(), np.asarray(p.mol_id))
    for f in ("pos", "box", "mol_alive", "sk_re", "sk_im"):
        w = getattr(s, f)
        if w is None:
            assert getattr(S, f) is None
        else:
            np.testing.assert_array_equal(getattr(S, f).numpy(),
                                          np.asarray(w), err_msg=f)
    assert S.step == int(np.asarray(s.step))
    for e_port, e_jax in ((S.energy, s.energy), (S.e_frozen, s.e_frozen)):
        for k in TERMS:
            assert float(getattr(e_port, k)) == float(getattr(e_jax, k))
    for f in dataclasses.fields(C):
        assert getattr(C, f.name) == getattr(c, f.name), f.name
    for f in dataclasses.fields(T):
        if getattr(t, f.name) is None:      # tmmc_eta before any bias
            assert getattr(T, f.name) is None, f.name
            continue
        np.testing.assert_array_equal(getattr(T, f.name).numpy(),
                                      np.asarray(getattr(t, f.name)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_port_builder_matches_jax_builder(dtype):
    """models/systems.mof_h2_gcmc builds the same padded layout, values
    and thermo as the JAX builder."""
    jp, js, jc, jt = jsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                          dtype=dtype)
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      dtype=dtype, device="cpu")
    ref = convert.from_jax(jp, js, jc, jt)
    for a, b in zip((P, S.pos, S.box, S.mol_alive), (ref[0], ref[1].pos,
                                                    ref[1].box,
                                                    ref[1].mol_alive)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            for f in dataclasses.fields(a):
                if f.name == "cell_index":    # None without cell_list
                    assert a.cell_index is None and b.cell_index is None
                    continue
                assert torch.equal(getattr(a, f.name),
                                   getattr(b, f.name)), f.name
    assert C == ref[2]
    for f in dataclasses.fields(T):
        if getattr(T, f.name) is None:      # tmmc_eta before any bias
            assert getattr(ref[3], f.name) is None, f.name
            continue
        assert torch.equal(getattr(T, f.name), getattr(ref[3], f.name))
