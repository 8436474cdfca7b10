"""Spinflip decks through the port's CLI entry (mc/run.py) on the CPU —
the ports of tests/test_qrot.py:103, :379, :394, :412, :439 and :463 (a
single H2 at 40 K relaxes toward para on the scan path, batched chains,
both PT routes and the fused µVT and PT kernels) — and the rest of the
slice's run surface: an exact resume with spins, the nve warning, the
library PT drivers' refusal and the campaign's (the reference's campaign
fails on such a deck)."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as run_mod  # noqa: E402

torch.set_num_threads(1)


def _h2_deck(tmp_path, extra="", numsteps=1500, temperature=40):
    """The reference's _h2_deck: one H2 (BSS) in a 20 A box at 40 K,
    quantum_rotation with lmax 3, spinflip_probability 0.3, float64."""
    d = 0.371
    pqr = tmp_path / "h2.pqr"
    pqr.write_text(
        "ATOM 1 H2G H2 1 M 10.0 10.0 10.0 0.0 -0.93634 0.0 34.2 2.96\n"
        f"ATOM 2 H2E H2 1 M 10.0 10.0 {10 + d} 1.008 0.46817 0.0 0.0 0.0\n"
        f"ATOM 3 H2E H2 1 M 10.0 10.0 {10 - d} 1.008 0.46817 0.0 0.0 0.0\n"
        "END\n")
    return input_script.parse(f"""
ensemble nvt
numsteps {numsteps}
corrtime 250
temperature {temperature}
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
coulomb off
rd_lrc off
precision float64
quantum_rotation on
quantum_rotation_level_max 3
spinflip_probability 0.3
pqr_input {pqr}
""" + extra)


def _run(job):
    log = io.StringIO()
    out = run_mod.run(job, log=log, device="cpu")
    return (out[1] if isinstance(out, tuple) else out), log.getvalue()


def test_cli_scan_path_relaxes_to_para(tmp_path):
    """(:103) the scan path: the observables are reported and the rotor
    relaxes toward para."""
    avgs, _ = _run(_h2_deck(tmp_path))
    assert "ortho_fraction" in avgs.samples
    assert "energy_qrot" in avgs.samples
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.4
    assert avgs.mean("acc_spinflip") >= 0.0


def test_cli_chains_relax_to_para(tmp_path):
    """(:379) chains 3 on the batched scan chains: each chain's spins and
    table, the cross-chain ortho fraction relaxes toward para."""
    avgs, log = _run(_h2_deck(tmp_path, "chains 3\n", numsteps=1000))
    assert "batched scan chains (C=3)" in log
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.4
    assert avgs.mean("acc_spinflip") >= 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_cli_pt_relaxes_to_para(tmp_path, fused):
    """(:394, :439) a 3-replica ladder with spinflip, host swaps on the
    batched chains or on-device swaps over B3's plain version (each swap
    rebuilding the replicas' tables from their level arrays): the base
    replica relaxes toward para, and swaps are accepted."""
    extra = ("parallel_tempering on\nn_replicas 3\nmax_temperature 120\n"
             "ptemp_freq 125\n")
    if fused:
        extra += "fused_mc on\nprecision float32\n"
    avgs, log = _run(_h2_deck(tmp_path, extra))
    assert ("fused_mc: on-device swaps" in log) == fused
    assert "swap_acceptance" in avgs.samples
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.45
    assert avgs.mean("swap_acceptance") > 0.0


def test_cli_fused_uvt_flips_and_exchanges(tmp_path):
    """(:412) GCMC with spinflip on B1's plain version (its XT
    instance's arithmetic): flips and insertions accepted, a weak para
    preference with O(1) molecules."""
    avgs, log = _run(_h2_deck(tmp_path, """ensemble uvt
pressure 0.5
insert_probability 0.3
max_molecules 6
fused_mc on
precision float32
"""))
    assert "fused_mc: single-chain fused µVT kernel" in log
    assert avgs.mean("acc_spinflip") > 0.0
    assert avgs.mean("acc_insert") > 0.0
    assert np.mean(avgs.samples["ortho_fraction"]) <= 0.75


def test_cli_pt_fused_uvt_relaxes_to_para(tmp_path):
    """(:463) a µVT ladder with spinflip on B1 over the replicas with
    on-device swaps: para wins, swaps accepted, molecules present."""
    avgs, log = _run(_h2_deck(tmp_path,
                              "ensemble uvt\npressure 0.5\n"
                              "insert_probability 0.3\nmax_molecules 6\n"
                              "parallel_tempering on\nn_replicas 3\n"
                              "max_temperature 120\nptemp_freq 125\n"
                              "fused_mc on\nprecision float32\n",
                              numsteps=1000))
    assert "chain-interleaved PT kernel" in log
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.45
    assert avgs.mean("swap_acceptance") > 0.0
    assert avgs.mean("N") > 0.0


def test_spinflip_checkpoint_resume_is_exact(tmp_path):
    """A two-block fused NVT run equals a one-block run resumed from its
    checkpoint (spins and table in it), bit for bit."""
    import dataclasses
    base = "fused_mc on\nprecision float32\n"
    two = _h2_deck(tmp_path, base, numsteps=500)
    st2 = run_mod.run_mc(two, log=io.StringIO(), device="cpu")[0].state
    ck = str(tmp_path / "run.ck")
    one = dataclasses.replace(_h2_deck(tmp_path, base, numsteps=250),
                              checkpoint_output=ck)
    run_mod.run_mc(one, log=io.StringIO(), device="cpu")
    again = dataclasses.replace(_h2_deck(tmp_path, base, numsteps=250),
                                checkpoint_input=ck)
    log = io.StringIO()
    st = run_mod.run_mc(again, log=log, device="cpu")[0].state
    assert "resumed exactly" in log.getvalue()
    assert torch.equal(st.spin, st2.spin)
    assert torch.equal(st.pos, st2.pos)
    assert torch.equal(st.rot_f, st2.rot_f)


def test_nve_runs_without_spinflip(tmp_path):
    """Under nve the move is off with the reference's warning; the run
    still reports the spins' observables, which then never change."""
    job = _h2_deck(tmp_path, "ensemble nve\ntotal_energy 50\n",
                   numsteps=500)
    with pytest.warns(UserWarning, match="nve"):
        avgs, _ = _run(job)
    assert avgs.mean("acc_spinflip") == 0.0
    assert len(set(avgs.samples["ortho_fraction"])) == 1


def test_library_pt_drivers_and_campaign_refuse(tmp_path):
    """The library PT drivers refuse spinflip as the reference's do, and
    the campaign refuses quantum_rotation (CAMPAIGN_SPIN_TRAP)."""
    from mpmc_tpu_torch import campaign
    from mpmc_tpu_torch.parallel import replica
    job = _h2_deck(tmp_path, "fused_mc on\nprecision float32\n")
    su = run_mod.setup(job, device="cpu")
    with pytest.raises(ValueError, match="quantum_rotation"):
        replica.run_parallel_tempering_fused(
            su.params, su.state, su.cfg, su.thermo, [40.0, 60.0], 2, 10)
    uvt = _h2_deck(tmp_path, "ensemble uvt\npressure 0.5\n"
                   "insert_probability 0.3\nmax_molecules 4\n")
    with pytest.raises(ValueError, match="campaign"):
        campaign.run_isotherm(uvt, [0.5], chains=2, min_steps=100,
                              max_steps=100, device="cpu")


def test_reference_campaign_fails_with_spinflip(tmp_path):
    """Why the port's campaign refuses: the reference's campaign stacks
    chains with no spins, and its spinflip step fails on them."""
    from mpmc_tpu import campaign as jcampaign
    from mpmc_tpu.io import input_script as jinput
    d = 0.371
    pqr = tmp_path / "h2.pqr"
    pqr.write_text(
        "ATOM 1 H2G H2 1 M 10.0 10.0 10.0 0.0 -0.93634 0.0 34.2 2.96\n"
        f"ATOM 2 H2E H2 1 M 10.0 10.0 {10 + d} 1.008 0.46817 0.0 0.0 0.0\n"
        f"ATOM 3 H2E H2 1 M 10.0 10.0 {10 - d} 1.008 0.46817 0.0 0.0 0.0\n"
        "END\n")
    job = jinput.parse(f"""
ensemble uvt
numsteps 100
corrtime 50
temperature 40
pressure 0.5
insert_probability 0.3
max_molecules 4
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
coulomb off
rd_lrc off
quantum_rotation on
spinflip_probability 0.3
pqr_input {pqr}
""")
    with pytest.raises(TypeError, match="NoneType"):
        jcampaign.run_isotherm(job, [0.5], chains=2, min_steps=50,
                               max_steps=50, equil_blocks=0)


@pytest.mark.parametrize("mode", ["plain", "delayed", "chains"])
def test_polar_scan_spinflip_bookkeeping(tmp_path, mode):
    """Spinflip on the polar scan path (the trial keeps the rows, the
    field and the residual; the SCF, or under polar_delayed the surrogate
    then the SCF, decides it) and on the batched polar chains, float64:
    flips attempted and accepted, and after a further chunk the carried
    energy, polar term included, equals a fresh recompute to rel 1e-6."""
    from torch_polar import polar_deck
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    extra = ("quantum_rotation on\nspinflip_probability 0.5\n"
             "corrtime 20\n" + {"plain": "", "delayed": "polar_delayed on\n",
                                "chains": "chains 2\n"}[mode])
    job = polar_deck(tmp_path, extra, numsteps=40)
    su, avgs = run_mod.run(job, log=io.StringIO(), device="cpu")
    assert avgs.mean("acc_spinflip") > 0.0
    g = torch.Generator().manual_seed(8)
    if mode == "chains":
        sts, stats = multichain.run_chunk_batched(su.states, su.params, su.cfg,
                                                  su.thermo, 20,
                                                  generator=g)
        st = sts
    else:
        st, stats = metropolis.run_chunk(su.state, su.params, su.cfg,
                                         su.thermo, 20, generator=g)
    assert np.asarray(stats.attempts)[..., metropolis.SPINFLIP].sum() > 0
    fresh = (multichain.initialize_batched if mode == "chains"
             else metropolis.initialize)(st, su.params, su.cfg, su.thermo)
    np.testing.assert_allclose(st.energy.total.numpy(),
                               fresh.energy.total.numpy(), rtol=1e-6)
    np.testing.assert_allclose(st.energy.polar.numpy(),
                               fresh.energy.polar.numpy(), rtol=1e-6)
