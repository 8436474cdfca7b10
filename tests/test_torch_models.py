"""The port's species library (models/__init__.py) and the builders
co2_3site, n2_3site, ch4_united_atom and mof_h2_ch4_gcmc
(models/systems.py) against the JAX package: every Species field, and
each builder's Params, SimState, RunConfig and Thermo in float64."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpmc_tpu.models as jmodels  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
import mpmc_tpu_torch.models as tmodels  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.state import Params  # noqa: E402

SPECIES_FIELDS = ("pos", "mass", "charge", "polar", "eps", "sig", "omega",
                  "c6", "c8", "c10", "gwp_alpha")


def _same_species(a, b):
    assert a.name == b.name and tuple(a.atom_names) == tuple(b.atom_names)
    assert a.vib_omega == b.vib_omega
    for f in SPECIES_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert a.natoms == b.natoms and a.total_mass == b.total_mass


@pytest.mark.parametrize("name", sorted(jmodels.BUILTINS))
def test_library_species_match_reference(name):
    _same_species(tmodels.get(name), jmodels.get(name))
    _same_species(tmodels.get(name.upper()), jmodels.get(name))


def test_library_names_and_unknown():
    assert sorted(tmodels.BUILTINS) == sorted(jmodels.BUILTINS)
    with pytest.raises(KeyError, match="unknown built-in model 'xe'"):
        tmodels.get("xe")
    _same_species(tmodels.h2_3site(polarizable=True),
                  jmodels.h2_3site(polarizable=True))


@pytest.mark.parametrize("fn", ["co2_3site", "n2_3site", "ch4_united_atom",
                                "h2_bss3", "lj_atom"])
def test_system_species_match_reference(fn):
    _same_species(getattr(tsystems, fn)(), getattr(jsystems, fn)())


def _same_system(t, j):
    P, S, C, T = t
    jp, js, jc, jt = convert.from_jax(*j)
    for f in dataclasses.fields(Params):
        if not f.init:
            continue
        a, b = getattr(P, f.name), getattr(jp, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f.name)
    for f in ("pos", "box", "mol_alive"):
        torch.testing.assert_close(getattr(S, f), getattr(js, f), rtol=0,
                                   atol=0, msg=f)
    assert C == jc
    for f in dataclasses.fields(T):
        a, b = getattr(T, f.name), getattr(jt, f.name)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f.name)


@pytest.mark.parametrize("kw", [{}, {"n_side": 4, "n_h2": 5, "n_ch4": 7,
                                     "capacity": 16, "seed": 3,
                                     "pressures": (2.0, 0.5)}])
def test_mof_h2_ch4_gcmc_matches_reference(kw):
    """The two-sorbate MOF GCMC builder in float64: every Params tensor,
    positions, box, aliveness, the cfg and the thermo equal the
    reference's, and the species are H2 (3 sites) and CH4 (1)."""
    t = tsystems.mof_h2_ch4_gcmc(dtype="float64", device="cpu", **kw)
    j = jsystems.mof_h2_ch4_gcmc(dtype="float64", **kw)
    _same_system(t, j)
    P = t[0]
    assert P.species_natoms.tolist() == [3, 1]
    assert t[2].insert_species == (0, 1)
    with pytest.raises(ValueError, match="exceeds interstitial"):
        tsystems.mof_h2_ch4_gcmc(n_side=2, n_h2=5, n_ch4=5, device="cpu")
