"""The port's library PT drivers (parallel/replica.py
run_parallel_tempering_fused and run_parallel_tempering_fused_multi, over
the plain B3 and B1 here) against the JAX package: with the reference
key's round uniforms injected, every round's swap decisions equal
mpmc_tpu's _ladder_swap_core on the same temperatures, energies and
counts, and so do the final temperatures and the count; the
equal-temperature and real-ladder checks and the refusals of
tests/test_parallel.py:504-575 and :631-640."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.models import systems  # noqa: E402
from mpmc_tpu.parallel import replica as jreplica  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.parallel import replica  # noqa: E402

torch.set_num_threads(1)
DRIVERS = {"fused": replica.run_parallel_tempering_fused,
           "fused_multi": replica.run_parallel_tempering_fused_multi}


def _mof(ensemble, capacity=8):
    """tests/test_parallel.py's fused PT system: mof_h2_gcmc(n_side=3,
    n_h2=4), Wolf, f32, fused_mc (port objects)."""
    p, s, c, t = systems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=capacity,
                                     ewald_kmax=3, dtype="float32")
    c = dataclasses.replace(c, ensemble=ensemble, coulomb="wolf",
                            fused_mc=True)
    return convert.from_jax(p, s, c, t)


def _reference_uniforms(seed, n_rounds, R):
    """The reference's round uniforms: uniform(key_r, (R,)) of
    split(PRNGKey(seed + 7), n_rounds)."""
    keys = jax.random.split(jax.random.PRNGKey(seed + 7), n_rounds)
    return keys, np.stack([np.asarray(jax.random.uniform(k, (R,),
                                                         jnp.float32))
                           for k in keys])


@pytest.mark.parametrize("ensemble,driver", [
    ("uvt", "fused"), ("nvt", "fused"), ("uvt", "fused_multi"),
    ("nvt", "fused_multi")])
def test_swap_decisions_are_the_references(ensemble, driver):
    """A 4-replica 100-300 K ladder, 5 rounds of 30 steps, corrtime 60 (a
    refresh every other round): each round's new temperatures and
    accepted count equal mpmc_tpu's _ladder_swap_core of the round's
    temperatures, active energies and (µVT) molecule counts with the
    reference's round key; the final temperatures and count returned are
    the rounds'."""
    P, S, C, T = _mof(ensemble, capacity=4 if driver == "fused_multi"
                      else 8)
    C = dataclasses.replace(C, corrtime=60)
    temps = replica.geometric_ladder(100.0, 300.0, 4)
    keys, u = _reference_uniforms(3, 5, 4)
    trace = []
    states, final, n_acc = DRIVERS[driver](
        P, S, C, T, temps, n_rounds=5, steps_per_round=30, seed=3,
        round_uniforms=u, trace=trace)
    assert len(trace) == 5
    total = 0
    for r, rnd in enumerate(trace):
        assert rnd["parity"] == r % 2
        np.testing.assert_array_equal(rnd["u"].numpy(), u[r])
        n = rnd["n_mols"]
        assert (n is not None) == (ensemble == "uvt")
        want_t, want_acc = jreplica._ladder_swap_core(
            jnp.asarray(rnd["temps"].numpy()),
            jnp.asarray(rnd["energies"].numpy()).astype(jnp.float32),
            keys[r], r % 2,
            n_mols=None if n is None else jnp.asarray(n.numpy()))
        np.testing.assert_array_equal(rnd["new_temps"].numpy(),
                                      np.asarray(want_t))
        assert int(rnd["accepted"]) == int(want_acc)
        total += int(want_acc)
    assert n_acc == total and 0 < total < 2 + 1 + 2 + 1 + 2
    np.testing.assert_array_equal(final, trace[-1]["new_temps"].double())
    assert sorted(final) == pytest.approx(sorted(temps), rel=1e-6)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_equal_ladder_and_real_ladder(driver):
    """tests/test_parallel.py::test_fused_pt_single_chip and
    ::test_fused_pt_multi_chain: an equal-T ladder accepts every attempted
    swap (2 + 1 + 2 + 1 in four rounds of 4 replicas); a real ladder ends
    as a permutation of its rungs, with every replica advanced 120 steps
    and moved (µVT for the single-chain driver, NVT for the multi-chain
    one, as the reference tests)."""
    multi = driver == "fused_multi"
    P, S, C, T = _mof("nvt" if multi else "uvt", capacity=4 if multi else 8)
    run = DRIVERS[driver]
    _, _, n_acc = run(P, S, C, T, [150.0] * 4, n_rounds=4,
                      steps_per_round=30, seed=1)
    assert n_acc == 2 + 1 + 2 + 1
    temps = replica.geometric_ladder(100.0, 300.0, 4)
    states, final_t, _ = run(P, S, C, T, temps, n_rounds=3,
                             steps_per_round=40, seed=2)
    assert sorted(final_t) == pytest.approx(sorted(temps))
    chains = ([states.pos[c] for c in range(4)] if multi
              else [st.pos for st in states])
    steps = [states.step] * 4 if multi else [st.step for st in states]
    assert steps == [120] * 4
    for pos in chains:
        assert float((pos - S.pos).abs().max()) > 0.0


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_refusals(driver):
    """tests/test_parallel.py::test_fused_pt_rejects_t_dependent_energies
    and ::test_pt_and_chains_reject_spinflip_moves, plus NVE and a config
    outside the fused gates (float64): ValueError each."""
    P, S, C, T = _mof("nvt")
    run = DRIVERS[driver]
    for flag in ("feynman_hibbs", "feynman_kleinert"):
        with pytest.raises(ValueError, match="T-dependent|feynman"):
            run(P, S, dataclasses.replace(C, **{flag: True}), T,
                [150.0] * 2, n_rounds=1, steps_per_round=4)
    with pytest.raises(ValueError, match="spinflip|supported_multi"):
        run(P, S, dataclasses.replace(C, quantum_rotation=True), T,
            [150.0] * 2, n_rounds=1, steps_per_round=4)
    with pytest.raises(ValueError, match="nve|supported_multi"):
        run(P, S, dataclasses.replace(C, ensemble="nve"), T, [150.0] * 2,
            n_rounds=1, steps_per_round=4)
    with pytest.raises(ValueError, match="fused-gate|supported_multi"):
        run(P, S, dataclasses.replace(C, dtype="float64"), T, [150.0] * 2,
            n_rounds=1, steps_per_round=4)
