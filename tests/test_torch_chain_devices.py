"""``chain_devices`` (multichain.ChainBlock): each of D = 2 gloo ranks on
the CPU advances its block of the chains with the same launches' plain
twins, and the run equals the single-process run chain by chain — the
batched scan chains (``chains 4``), the fused µVT chains (plain B1 at 2
chains a rank), a batched PT ladder (host swaps) and a fused NVT ladder
(plain B3, on-device swaps: every rank takes the same decisions).  Also
the reference's refusals: C or R not divisible by D, more devices than
the job has."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch import cli  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.parallel import multihost  # noqa: E402

import torch_dist  # noqa: E402

DECKS = {
    "chains": ("chains 4\n", "float64"),
    "fused_chains": ("chains 4\nfused_mc on\n", "float32"),
    "pt": ("parallel_tempering on\nn_replicas 4\nptemp_freq 10\n",
           "float64"),
    "pt_fused": ("ensemble nvt\nparallel_tempering on\nn_replicas 4\n"
                 "ptemp_freq 10\nfused_mc on\n", "float32"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain_devices")
    sharded, single = [], []
    for name, (extra, prec) in DECKS.items():
        sharded.append((name, torch_dist.gcmc_deck(
            tmp, extra + "chain_devices 2\n", precision=prec,
            name=name + "_d2")))
        single.append((name, torch_dist.gcmc_deck(
            tmp, extra, precision=prec, name=name)))
    wait = torch_dist.start_groups(torch_dist.deck_runs, (2,), tmp, sharded)
    one = torch_dist.deck_runs(torch.device("cpu"), single)
    return one, wait()[2]


@pytest.mark.parametrize("name", list(DECKS))
def test_chain_devices_equals_the_single_process_run(runs, name):
    """Every chain's positions, aliveness and energy, and the ladder,
    equal the single-process run's bit for bit."""
    one, ranks = runs
    got, want = ranks[0][name], one[name]
    for k in ("pos", "mol_alive", "energy", "temps"):
        assert np.array_equal(got[k], want[k]), k
    assert got["N"] == want["N"]


@pytest.mark.parametrize("name", list(DECKS))
def test_ranks_hold_the_same_stack(runs, name):
    """The gathered stack and the ladder are the same on both ranks."""
    _, ranks = runs
    for k in ("pos", "mol_alive", "energy", "temps"):
        assert np.array_equal(ranks[0][name][k], ranks[1][name][k]), k


@pytest.mark.parametrize("name", list(DECKS))
def test_each_rank_logs_its_block(runs, name):
    """The log names the sharding (blocks of 2), and a fused deck its
    kernel route."""
    one, ranks = runs
    what = "replicas" if name.startswith("pt") else "chains"
    assert f"chain sharding: 2 devices x 2 {what}" in ranks[0][name]["log"]
    assert "chain sharding" not in one[name]["log"]
    if "fused" in name:
        assert "fused_mc: chain-interleaved" in ranks[0][name]["log"]


@pytest.mark.parametrize("extra,msg", [
    ("chains 3\n", "chains 3 not divisible by chain_devices 2"),
    ("parallel_tempering on\nn_replicas 3\n",
     "n_replicas 3 not divisible by chain_devices 2")])
def test_indivisible_counts_are_refused(tmp_path, extra, msg):
    """The reference's ValueError (mpmc_tpu/mc/run.py:842-844,
    :1248-1250), raised before any rank is needed."""
    job = input_script.parse_file(torch_dist.gcmc_deck(
        tmp_path, extra + "chain_devices 2\n"))
    with pytest.raises(ValueError, match=f"^{msg}$"):
        trun.run(job, log=io.StringIO(), device="cpu")


def test_more_devices_than_the_job_has_are_refused(tmp_path):
    """Without --cpu the command line starts one rank per GPU and refuses
    more ranks than GPUs, in the reference's words."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    deck = torch_dist.gcmc_deck(tmp_path, "chains 4\nchain_devices 2\n")
    with pytest.raises(ValueError, match="^chain_devices 2 but only 0 "
                       "devices visible$"):
        cli.main([deck])
    with pytest.raises(ValueError, match="^spatial_devices 3 but only 0 "
                       "devices available$"):
        multihost.check_devices(3, "spatial_devices", cpu=False)


def test_a_group_of_the_wrong_size_is_refused(tmp_path):
    """A driver run outside a group of D ranks names both numbers."""
    job = input_script.parse_file(torch_dist.gcmc_deck(
        tmp_path, "chains 4\nchain_devices 2\n"))
    with pytest.raises(ValueError, match="chain_devices 2 but the process "
                       "group has 1 ranks"):
        trun.run(job, log=io.StringIO(), device="cpu")
