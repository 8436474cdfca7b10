"""GCMC of a charged atom species under Ewald with allow_charged_cell on
the port's scan path: the jellium (neutralising background) delta of an
insert or delete, quadratic in the cell charge, against the port's own
recompute and the JAX package's energies (tests/test_ewald.py's case)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import atom_species  # noqa: E402
from mpmc_tpu.config import RunConfig, Thermo  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.state import build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl")


def _charged_gcmc():
    """Six +0.5 e atoms of one species in a 12 A box, room for twelve,
    Ewald kmax 8 with the charged cell allowed (float64)."""
    L = 12.0
    coords = np.random.default_rng(5).uniform(1.0, L - 1.0, (6, 3))
    sp = atom_species(eps=10.0, sig=2.5, charge=0.5)
    params, state = build_system(
        L * np.eye(3), species=(sp,), capacity=(12,), initial_counts=(6,),
        initial_pos={0: coords[:, None, :]}, dtype=jnp.float64)
    cfg = RunConfig(ensemble="uvt", rd_potential="none", coulomb="ewald",
                    dtype="float64", rd_lrc=False, cutoff=0.5 * L,
                    ewald_kmax=8, insert_species=(0,),
                    allow_charged_cell=True)
    th = Thermo.make(temperature=300.0, fugacity=(2.0,),
                     insert_probability=0.6, move_factor=1.0,
                     rot_factor=0.1, n_species=1, dtype=jnp.float64)
    return params, state, cfg, th


def test_initial_energies_match_the_reference():
    """Every term of the charged cell's energy, port against JAX, at rel
    1e-12 (the background term rides in es_self)."""
    p, s, c, t = _charged_gcmc()
    want = jm.initialize(s, p, c, t).energy
    P, S, C, T = convert.from_jax(p, s, c, t)
    got = tm.initialize(S, P, C, T).energy
    for term in TERMS:
        assert float(getattr(got, term)) == pytest.approx(
            float(getattr(want, term)), rel=1e-12, abs=1e-12), term


def test_charged_gcmc_bookkeeping():
    """300 scan-path GCMC steps with inserts and deletes of the charged
    species: the carried energy equals a fresh recompute to 1e-9.  The
    cell fills towards its twelve slots; this stream's draws accept both
    inserts and deletes, so the delta is held in both directions."""
    P, S, C, T = convert.from_jax(*_charged_gcmc())
    S = tm.initialize(S, P, C, T)
    S2, stats = tm.run_chunk(S, P, C, T, 300,
                             generator=torch.Generator().manual_seed(2))
    acc = np.asarray(stats.accepts)
    assert acc[tm.INSERT] > 0 and acc[tm.DELETE] > 0
    fresh = tm.initialize(S2, P, C, T)
    for term in TERMS:
        assert float(getattr(S2.energy, term)) == pytest.approx(
            float(getattr(fresh.energy, term)), rel=1e-9, abs=1e-9), term
