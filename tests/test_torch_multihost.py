"""Multi-host parallel tempering (mpmc_tpu_torch/parallel/multihost.py and
replica.run_parallel_tempering, the port's analog of
tests/test_multihost.py): a PT ladder of 8 replicas over 4 gloo ranks on
the CPU — its swap decisions against the reference's rule
(mpmc_tpu/parallel/replica.py:283, _ladder_swap_core) at the reference
key's uniforms, injected; its history equal to one process's —;
``distribute`` keeps each rank's rows and does not double the stack; the
replica-count guard; and a two-process ``--distributed`` command line
equal to the single command that starts its ranks itself."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.parallel import replica as jreplica  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.parallel import multihost, replica  # noqa: E402

import torch_dist  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
R, ROUNDS, SPR, D = 8, 4, 5, 4


def _keys():
    master = jax.random.PRNGKey(11)
    return [jax.random.fold_in(master, r) for r in range(ROUNDS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    p, s, c, t = tsystems.mof_h2_gcmc(n_side=2, n_h2=3, capacity=6,
                                      pressure=20.0, dtype="float64",
                                      device="cpu")
    temps = replica.geometric_ladder(77.0, 160.0, R)
    U = np.stack([np.asarray(jax.random.uniform(k, (R,), jnp.float64))
                  for k in _keys()])
    wait = torch_dist.start_groups(torch_dist.mesh_pt, (D,),
                                   tmp_path_factory.mktemp("mesh_pt"),
                                   p, s, c, t, temps, ROUNDS, SPR, U)
    one = torch_dist.mesh_pt(torch.device("cpu"), p, s, c, t, temps, ROUNDS,
                             SPR, U)
    return one, wait()[D]


def test_swaps_follow_the_reference_rule(runs):
    """Each round's new ladder and accepted pairs against the reference's
    _ladder_swap_core on the round's energies, molecule counts (µVT) and
    key — the key whose uniforms the port was given."""
    _, ranks = runs
    trace = ranks[0]["trace"]
    assert len(trace) == ROUNDS
    n_acc = 0
    for rec, key in zip(trace, _keys()):
        want, acc = jreplica._ladder_swap_core(
            jnp.asarray(rec["temps"]), jnp.asarray(rec["energies"]), key,
            int(rec["parity"]), n_mols=jnp.asarray(rec["n_mols"]))
        assert np.array_equal(rec["new_temps"], np.asarray(want))
        assert int(rec["accepted"]) == int(acc)
        n_acc += int(acc)
    assert n_acc > 0


def test_history_equals_one_process(runs):
    """The 4-rank run's history, ladder and energies against the
    single-process drive of the same replicas, on every rank."""
    one, ranks = runs
    for r in ranks:
        assert r["history"] == one["history"]
        assert np.array_equal(r["ladder"], one["ladder"])
    mine = np.concatenate([r["energy"] for r in ranks])
    assert np.array_equal(mine, one["energy"])
    assert sorted(one["ladder"]) == pytest.approx(
        sorted(replica.geometric_ladder(77.0, 160.0, R)))


def test_distribute_keeps_this_ranks_rows(runs):
    """Each rank keeps rows [2d, 2d + 2) of the stack — not the whole
    stack, which would double the replica axis across the ranks (the
    reference's trap, mpmc_tpu/parallel/multihost.py:61-95); in one
    process the whole stack."""
    one, ranks = runs
    per = R // D
    for d, r in enumerate(ranks):
        assert r["mine_pos"].shape[0] == per
        assert np.array_equal(r["mine_pos"],
                              r["stack_pos"][d * per:(d + 1) * per])
    assert np.array_equal(one["mine_pos"], one["stack_pos"])


def test_replica_count_guard(runs):
    """Fewer replicas than ranks, or a count the ranks do not divide, is
    refused (one process takes any count)."""
    one, ranks = runs
    assert ranks[0]["guards"][0] == f"{D - 1} replicas < {D} ranks: every " \
        "rank needs at least one"
    assert ranks[0]["guards"][1] == f"{R + 1} replicas not divisible by " \
        f"{D} ranks"
    assert one["guards"] == [f"0 replicas < 1 ranks: every rank needs at "
                             "least one", None]


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "mpmc_tpu_torch",
                             "--cpu", *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _rows(path):
    return [{k: v for k, v in json.loads(line).items()
             if "sec" not in k and "time" not in k}
            for line in path.read_text().splitlines()]


def test_distributed_cli_equals_the_single_command(tmp_path):
    """``--distributed`` over two processes (the multi-host command line:
    --coordinator, --num-processes, --process-id) against ``python -m
    mpmc_tpu_torch`` of the same deck, which starts its two ranks itself:
    the same JSONL history and restart file; rank 1 writes nothing."""
    deck = torch_dist.gcmc_deck(
        tmp_path, "parallel_tempering on\nn_replicas 4\nptemp_freq 10\n"
        "chain_devices 2\n", numsteps=40)
    text = pathlib.Path(deck).read_text()
    for d in ("multi", "single"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "pt.inp").write_text(
            text + f"pqr_restart {tmp_path / d / 'restart.pqr'}\n")
    port = multihost.free_port()
    procs = [_cli(["--distributed", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(r), "pt.inp",
                   "--jsonl", "pt.jsonl"], tmp_path / "multi")
             for r in range(2)]
    procs.append(_cli(["pt.inp", "--jsonl", "pt.jsonl"], tmp_path / "single"))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    assert "backend gloo" in outs[0][0] and outs[1][0] == ""
    a, b = _rows(tmp_path / "multi" / "pt.jsonl"), \
        _rows(tmp_path / "single" / "pt.jsonl")
    assert a == b and len(a) >= 2
    assert (tmp_path / "multi" / "restart.pqr").read_text() == \
        (tmp_path / "single" / "restart.pqr").read_text()


def test_distributed_refuses_another_device_count(tmp_path):
    """A deck whose device count differs from the job's processes is
    refused on every rank, naming both numbers."""
    deck = torch_dist.gcmc_deck(tmp_path, "chains 4\n", numsteps=20)
    port = multihost.free_port()
    procs = [_cli(["--distributed", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(r), deck],
                  tmp_path) for r in range(2)]
    for p in procs:
        _, se = p.communicate(timeout=120)
        assert p.returncode != 0
        assert ("--distributed over 2 processes, but the deck asks for 1 "
                "devices") in se
