"""The port's parallel tempering on one card (parallel/replica.py,
mc/run.py::run_mc_pt and run_mc_pt_fug) against the JAX package: every
swap rule on the same inputs (the on-device core fed the reference key's
uniforms, the µVT factor, the fugacity swap, the host swaps with the same
numpy seed), the ladder, the PT decks over the plain B3, B1 and batched
routes and pt_fugacity, and the nve refusal (the ideal-gas fugacity
ladder is tests/test_torch_replica_ideal_gas.py)."""
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.parallel import replica as jrep  # noqa: E402
from mpmc_tpu_torch.io import input_script, pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.parallel import replica  # noqa: E402
from torch_pt import recompute_round  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def test_geometric_ladder_equals_the_reference():
    for args in ((77.0, 250.0, 8), (100.0, 200.0, 4), (300.0, 300.0, 1)):
        np.testing.assert_array_equal(replica.geometric_ladder(*args),
                                      jrep.geometric_ladder(*args))


def _ladder(R, seed):
    rng = np.random.default_rng(seed)
    temps = jrep.geometric_ladder(77.0, 250.0, R)
    energies = rng.normal(-2000.0, 400.0, R)
    n = rng.integers(0, 30, R)
    return temps, energies, n


@pytest.mark.parametrize("R", [8, 5])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("uvt", [False, True], ids=["nvt", "uvt"])
def test_ladder_swap_core_equals_the_reference(R, parity, uvt):
    """_ladder_swap_core fed jax.random.uniform(key, (R,)) decides as the
    reference's with that key, for 10 keys; with ``n_mols`` (a µVT
    ladder) the (beta_j/beta_i)^dN factor included."""
    n_acc = 0
    for k in range(10):
        temps, energies, n = _ladder(R, k)
        key = jax.random.PRNGKey(100 + k)
        jn = jnp.asarray(n) if uvt else None
        want_t, want_acc = jrep._ladder_swap_core(
            jnp.asarray(temps), jnp.asarray(energies), key, parity,
            n_mols=jn)
        u = np.array(jax.random.uniform(key, (R,), jnp.float64))
        got_t, got_acc = replica._ladder_swap_core(
            torch.as_tensor(temps), torch.as_tensor(energies),
            torch.as_tensor(u), parity,
            n_mols=torch.as_tensor(n) if uvt else None)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        assert int(got_acc) == int(want_acc)
        n_acc += int(got_acc)
        # the ladder stays a permutation of its rungs
        np.testing.assert_array_equal(np.sort(got_t.numpy()), temps)
    assert 0 < n_acc < 10 * ((R - parity) // 2)


def test_uvt_factor_changes_decisions():
    """The µVT factor is live: with loadings far apart the same energies
    and uniforms decide differently with and without it."""
    temps = jrep.geometric_ladder(77.0, 250.0, 8)
    energies = np.zeros(8)
    n = np.array([40, 0, 40, 0, 40, 0, 40, 0])
    u = torch.full((8,), 0.5, dtype=torch.float64)
    t_plain, a_plain = replica._ladder_swap_core(
        torch.as_tensor(temps), torch.as_tensor(energies), u, 0)
    t_uvt, a_uvt = replica._ladder_swap_core(
        torch.as_tensor(temps), torch.as_tensor(energies), u, 0,
        n_mols=torch.as_tensor(n))
    assert int(a_plain) == 4 and int(a_uvt) == 0


@pytest.mark.parametrize("parity", [0, 1])
def test_fugacity_swap_equals_the_reference(parity):
    """ladder_swap_fugacity_batched (uniforms fed in) and
    movable_counts_per_species against the reference, 10 keys."""
    R, sp = 6, (0, 1)
    for k in range(10):
        rng = np.random.default_rng(k)
        rows = (np.geomspace(1.0, 10.0, R)[:, None]
                * np.array([[1.5, 0.5]]))[rng.permutation(R)]
        counts = rng.integers(0, 15, (R, 2))
        key = jax.random.PRNGKey(7 + k)
        want_f, want_acc = jrep.ladder_swap_fugacity_batched(
            jnp.asarray(rows), jnp.asarray(counts), key, parity, sp)
        u = np.array(jax.random.uniform(key, (R,), jnp.float64))
        got_f, got_acc = replica.ladder_swap_fugacity_batched(
            torch.as_tensor(rows), torch.as_tensor(counts),
            torch.as_tensor(u), parity, sp)
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        assert int(got_acc) == int(want_acc)
    rng = np.random.default_rng(3)
    alive = rng.random((4, 12)) < 0.6
    frozen = np.arange(12) < 2
    species = np.where(frozen, -1, rng.integers(0, 2, 12))
    want = jrep.movable_counts_per_species(
        jnp.asarray(alive), jnp.asarray(frozen), jnp.asarray(species), sp)
    got = replica.movable_counts_per_species(
        torch.as_tensor(alive), torch.as_tensor(frozen),
        torch.as_tensor(species), sp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        replica.movable_counts(torch.as_tensor(alive),
                               torch.as_tensor(frozen),
                               torch.as_tensor(species)).numpy(),
        np.asarray(jrep.movable_counts(jnp.asarray(alive),
                                       jnp.asarray(frozen),
                                       jnp.asarray(species))))


@pytest.mark.parametrize("uvt", [False, True], ids=["nvt", "uvt"])
def test_host_swaps_equal_the_reference_with_the_same_seed(uvt):
    """host_swap and host_swap_fugacity from default_rng(seed + 101) make
    the reference's decisions, round after round."""
    R = 7
    ra, rb = np.random.default_rng(108), np.random.default_rng(108)
    temps_a = temps_b = jrep.geometric_ladder(77.0, 250.0, R)
    rows_a = rows_b = np.geomspace(1.0, 8.0, R)[:, None] * [[2.0, 1.0]]
    for k in range(30):
        _, energies, n = _ladder(R, k)
        parity = k % 2
        temps_a, acc_a = replica.host_swap(temps_a, energies, parity, ra,
                                           n_mols=n if uvt else None)
        temps_b, acc_b = jrep.host_swap(temps_b, energies, parity, rb,
                                        n_mols=n if uvt else None)
        np.testing.assert_array_equal(temps_a, temps_b)
        assert acc_a == acc_b
        rows_a, fa = replica.host_swap_fugacity(rows_a, n, parity, ra)
        rows_b, fb = jrep.host_swap_fugacity(rows_b, n, parity, rb)
        np.testing.assert_array_equal(rows_a, rows_b)
        assert fa == fb


def test_pair_uniforms_are_the_host_swaps_draws():
    """The host route's round record reads the uniforms host_swap draws
    (a copy of the generator, one per pair at its low lane)."""
    rng = np.random.default_rng(5)
    u = trun._pt_pair_uniforms(rng, 7, 1)
    assert np.isnan(u[[0, 2, 4, 6]]).all()
    np.testing.assert_array_equal(u[[1, 3, 5]],
                                  np.random.default_rng(5).random(3))
    assert rng.random() == u[1]


def _h2_deck(tmp_path, *extra):
    text = (REPO / "examples" / "h2_sorption.inp").read_text()
    text = text.replace("numsteps         20000", "numsteps 200").replace(
        "corrtime         1000", "corrtime 100").replace(
        "examples/framework_h2.pqr",
        str(REPO / "examples" / "framework_h2.pqr"))
    deck = tmp_path / "deck.inp"
    deck.write_text(text + "\n".join(extra) + "\n")
    return deck


def _lj_deck(tmp_path, *extra, n=32):
    params, state, _, _ = tsystems.lj_fluid(n=n, device="cpu")
    tpqr.write_state(str(tmp_path / "fluid.pqr"), params, state, ["AR"])
    L = float(state.box[0, 0])
    deck = tmp_path / "fluid.inp"
    deck.write_text("\n".join([
        "numsteps 200", "corrtime 100", "seed 3", "temperature 120",
        f"basis1 {L} 0 0", f"basis2 0 {L} 0", f"basis3 0 0 {L}",
        "move_factor 0.5", "rot_factor 0", "coulomb off",
        "pqr_input fluid.pqr", "pqr_restart restart.pqr", *extra]) + "\n")
    return deck


def _run(tmp_path, deck):
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        buf = io.StringIO()
        su, avgs = trun.run(input_script.parse_file(str(deck)), log=buf,
                            device="cpu")
    finally:
        os.chdir(old)
    return su, avgs, buf.getvalue()


PT = ("parallel_tempering on", "n_replicas 6", "max_temperature 250",
      "ptemp_freq 25")


@pytest.mark.parametrize("kind,route", [
    ("lj", "fused"), ("h2", "fused"), ("h2", "scan")],
    ids=["b3-nvt", "b1-uvt", "batched-uvt"])
def test_pt_decks(tmp_path, kind, route):
    """A temperature-ladder PT deck over the plain B3 (nvt), the plain B1
    (uvt) and the batched scan route (uvt, host swaps): the logged route,
    the ladder a permutation of its rungs at the end, swaps accepted, and
    the last round's decisions recomputed on the host."""
    extra = PT + (("fused_mc on",) if route == "fused" else ())
    deck = (_lj_deck(tmp_path, "ensemble nvt", *extra) if kind == "lj"
            else _h2_deck(tmp_path, *extra))
    su, avgs, out = _run(tmp_path, deck)
    ladder = replica.geometric_ladder(
        120.0 if kind == "lj" else 77.0, 250.0, 6)
    assert "parallel tempering: 6 replicas" in out
    if route == "fused":
        assert "fused_mc: chain-interleaved PT kernel (C=6)" in out
        assert "on-device swaps" in out
    else:
        assert "batched scan chains (C=6)" in out
    got = su.thermo.temperature.double().numpy()
    np.testing.assert_allclose(np.sort(got), ladder, rtol=1e-6)
    assert 0.0 < avgs.mean("swap_acceptance") <= 1.0
    new, acc, _ = recompute_round(su.pt_round)
    np.testing.assert_array_equal(
        new, su.pt_round["new_temps"].double().numpy())
    assert acc == int(su.pt_round["accepted"])
    assert su.states.pos.shape[0] == 6 and "aggregate (6 replicas" in out


@pytest.mark.parametrize("fused", [True, False], ids=["b1", "batched"])
def test_pt_fugacity_decks(tmp_path, fused):
    """pt_fugacity over the plain B1 (per-chain ln(f V) rows, on-device
    swaps) and the batched route (host swaps): the fugacity rows a
    permutation of the ladder's, the last round recomputed on the
    host."""
    deck = _h2_deck(tmp_path, "pt_fugacity on", "n_replicas 4",
                    "ptemp_freq 25", "max_pressure 8",
                    *(("fused_mc on",) if fused else ()))
    su, avgs, out = _run(tmp_path, deck)
    assert "fugacity-ladder PT: 4 replicas" in out
    assert ("on-device swaps" in out) == fused
    rows = su.thermo.fugacity.double().numpy()
    base = rows.sum(1).min()
    np.testing.assert_allclose(np.sort(rows.sum(1)),
                               base * np.geomspace(1.0, 8.0, 4), rtol=1e-5)
    new, acc, _ = recompute_round(su.pt_round)
    np.testing.assert_array_equal(
        new, su.pt_round["new_fugacity"].double().numpy())
    assert acc == int(su.pt_round["accepted"])


def test_cli_pt_decks(tmp_path):
    """``python -m mpmc_tpu_torch --cpu`` runs a parallel_tempering deck
    and a pt_fugacity deck (batched route, host swaps)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for lines, head in ((PT, "parallel tempering: 6 replicas"),
                        (("pt_fugacity on", "ptemp_freq 50"),
                         "fugacity-ladder PT: 4 replicas")):
        deck = _h2_deck(tmp_path, *lines)
        r = subprocess.run([sys.executable, "-m", "mpmc_tpu_torch", "--cpu",
                            str(deck)], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert head in r.stdout and "swap acceptance:" in r.stdout
        assert r.stdout.count("\nstep ") == 2


def test_pt_refuses_nve(tmp_path):
    deck = _lj_deck(tmp_path, "ensemble nve", "total_energy -100",
                    "parallel_tempering on")
    with pytest.raises(ValueError, match="undefined for ensemble nve"):
        _run(tmp_path, deck)
