"""The cross-chain block line of ``chains N`` (mc/run.py::chains_mean)
when a chain has no alive polarizable site: each key is averaged over the
chains that report it, as the reference's run_mc_chains does
(mpmc_tpu/mc/run.py:1329-1335).  The state: two stacked chains of the
polar MOF + H2 system with the framework's polarizability set to 0 and
one chain's H2 deleted, the empty chain first or second; float64 on the
CPU against the JAX package's observables_batched and its mean."""
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import run as jrun  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.parallel import multichain as jmc  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script, pqr  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402

torch.set_num_threads(1)


def _reference_mean(per_chain):
    """The reference's cross-chain mean (mpmc_tpu/mc/run.py:1329-1337)."""
    keys = []
    for o in per_chain:
        keys.extend(k for k in o if k not in keys)
    obs = {k: float(np.mean([o[k] for o in per_chain if k in o]))
           for k in keys}
    obs["N_sem_chains"] = float(np.std([o["N"] for o in per_chain])
                                / np.sqrt(len(per_chain)))
    return obs


def _stacked(empty):
    """The reference's two stacked chains, chain ``empty`` without H2,
    refreshed (multichain.initialize_batched); returns (params, states,
    cfg, thermo)."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=2, capacity=4,
                                      polarization=True, dtype="float64")
    c = dataclasses.replace(c, use_pallas=False)
    frozen_atom = np.asarray(p.mol_frozen)[np.asarray(p.mol_id)]
    p = dataclasses.replace(p, polar=jnp.where(jnp.asarray(frozen_atom),
                                              0.0, p.polar))
    s = jm.initialize(s, p, c, t)
    states = jmc.stack_states(s, 2)
    alive = np.array(states.mol_alive)
    alive[empty, ~np.asarray(p.mol_frozen)] = False
    states = dataclasses.replace(states, mol_alive=jnp.asarray(alive))
    return p, jmc.initialize_batched(states, p, c, t), c, t


@pytest.mark.parametrize("empty", [0, 1], ids=["empty-first",
                                                "empty-second"])
def test_block_means_over_the_reporting_chains(empty):
    p, states, c, t = _stacked(empty)
    framework_mass = float(np.sum(np.asarray(p.mass)[
        np.asarray(p.mol_frozen)[np.asarray(p.mol_id)]]))
    jsu = jrun.Setup(p, states, c, t, (jsystems.h2_bss3(),), ["H2"],
                     framework_mass)
    ref_chains = jrun.observables_batched(jsu, states, 2)
    assert ["polar_rrms_debye" in o for o in ref_chains] == [
        k != empty for k in range(2)]
    want = _reference_mean(ref_chains)

    P, S, C, T = convert.from_jax(p, states, c, t)
    tsu = trun.Setup(P, S, C, T, (tsystems.h2_bss3(),), ["H2"],
                     framework_mass)
    got = trun.chains_mean(trun.observables_batched(tsu, S, 2))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-300), k
    assert got["polar_rrms_debye"] == ref_chains[1 - empty][
        "polar_rrms_debye"]


@pytest.mark.parametrize("empty", [0, 1], ids=["empty-first",
                                                "empty-second"])
def test_polar_chains_run_with_an_empty_chain(empty, tmp_path, monkeypatch):
    """run_mc_chains on the batched polar route with one chain emptied
    (an nvt deck, so it stays empty): no KeyError, and every block line
    carries the other chain's polar_rrms_debye."""
    params, state, _, _ = tsystems.mof_h2_gcmc(
        n_side=3, n_h2=2, capacity=4, polarization=True, device="cpu")
    frozen_atom = params.mol_frozen[params.mol_id]
    params = params.replace(polar=torch.where(frozen_atom, 0.0,
                                              params.polar))
    pqr.write_state(str(tmp_path / "p.pqr"), params, state, ["H2"])
    L = float(state.box[0, 0])
    job = input_script.parse(
        f"ensemble nvt\nnumsteps 6\ncorrtime 3\nseed 3\ntemperature 77\n"
        f"basis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
        "allow_charged_cell on\npolarization on\nprecision float64\n"
        f"chains 2\npqr_input {tmp_path / 'p.pqr'}\n")
    stack = multichain.stack_states

    def stack_with_an_empty_chain(st, n):
        states = stack(st, n)
        alive = states.mol_alive.clone()
        alive[empty, 1:] = False          # slot 0 is the framework
        return states.replace(mol_alive=alive)
    monkeypatch.setattr(multichain, "stack_states", stack_with_an_empty_chain)
    jsonl = tmp_path / "obs.jsonl"
    su, avgs = trun.run(job, log=io.StringIO(), jsonl_path=str(jsonl),
                        device="cpu")
    assert int(su.states.mol_alive[empty].sum()) == 1      # the framework
    blocks = [json.loads(x) for x in jsonl.read_text().splitlines()
              if '"step"' in x]
    assert len(blocks) == 2
    for b in blocks:
        assert b["polar_rrms_debye"] > 0
        assert b["N"] == 1.0          # the mean of 0 and 2 molecules
    assert len(avgs.samples["polar_rrms_debye"]) == 2
