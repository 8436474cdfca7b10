"""The port's polar scan path (mpmc_tpu_torch/mc/metropolis.py with
polarization, plain Metropolis and delayed acceptance) against the JAX
package: a step replay of a polar GCMC chunk, the carried energy against a
fresh recompute, a polar deck through run_mc on the CPU, and the routing
of polar_delayed under fused_mc (the fused polar DA path over B6 where its
gate holds; where it refuses, the scan-path DA)."""
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.ops import thole as jt  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.state import mol_rows  # noqa: E402
from torch_polar import mof_polar, polar_deck as _polar_deck, to_np  # noqa: E402

torch.set_num_threads(1)

K_REPLAY = 80


def _jax_polar(p, c, box):
    """Jitted JAX pieces of a polar step on the system (p, c): the trial
    field and initial residual (move_deltas) for each move type, the SCF
    solve and the zodid surrogate."""
    def deltas(insert, delete):
        def f(pos, alive, e0, mu, r_pol, sk_re, sk_im, mol, rows):
            return jt.move_deltas(pos, box, alive, p, c, mol, e0, mu, r_pol,
                                  new_rows=rows, insert=insert,
                                  delete=delete, with_residual=True,
                                  sk=(sk_re, sk_im))
        return jax.jit(f)

    def solve(pos, alive, e0, mu0, r0):
        mu, it, _ = jt.solve_scf(pos, box, alive, p, c, e0, mu0, r0)
        return mu, it, jt.polar_energy(mu, e0)

    return ({None: deltas(False, False), True: deltas(True, False),
             False: deltas(False, True)}, jax.jit(solve),
            jax.jit(lambda e0, alive: jt.zodid_energy(e0, alive, p)))


@pytest.mark.parametrize("delayed", [False, True], ids=["metropolis", "da"])
def test_polar_step_replay_matches_jax(delayed):
    """K_REPLAY injected-uniform steps of a polar GCMC chunk on the MOF +
    H2 system (float64).  At each step JAX's move_deltas, solve_scf and
    polar_energy get the port's pre-move state and trial rows: the polar
    energy change agrees to rel 1e-9, the CG iteration counts are equal,
    and the accept decision is the same (stage 1 on lane 4 with the zodid
    surrogate, stage 2 on lane 12, under delayed acceptance)."""
    (p, s, c, t), (P, S, C, T) = mof_polar(polar_precision=1e-9,
                                           polar_delayed=delayed)
    S = tm.initialize(S, P, C, T)
    u = torch.as_tensor(np.random.default_rng(8).random((K_REPLAY, 16)))
    step, carry, consts, branch, stats = tm.chunk_setup(S, P, C, T, u)
    deltas, solve, zodid = _jax_polar(p, c, s.box)
    temp = float(T.temperature)
    n_acc = n_solved = 0
    for k in range(K_REPLAY):
        pre = {key: (v.clone() if torch.is_tensor(v) else v)
               for key, v in carry.items() if key != "u"}
        trace = []
        step(carry, u[k], int(branch[k]), T, consts, stats, trace=trace)
        rec = trace[0]
        mol = int(rec["mol"])
        move = {0: None, 1: True, 2: False}[int(branch[k])]
        own = to_np((P.mol_id == mol) & P.atom_ok)
        alive = to_np(pre["alive"])
        pos = to_np(pre["pos"])
        # a deletion has no trial rows: pass the current ones (unused)
        rows = to_np(rec["rows"] if rec["rows"] is not None
                     else mol_rows(pre["pos"], P, mol))
        e0_j, r0_j = deltas[move](
            pos, alive, to_np(pre["e0"]), to_np(pre["mu"]),
            to_np(pre["r_pol"]), to_np(pre["sk_re"]), to_np(pre["sk_im"]),
            mol, rows)
        pos_c, alive_c = pos.copy(), alive.copy()
        if move is False:
            alive_c &= ~own
        else:
            n = int(own.sum())
            pos_c[own] = rows[:n]
            alive_c |= own
        np.testing.assert_allclose(to_np(rec["e0"]), np.asarray(e0_j),
                                   rtol=0, atol=1e-12)
        reject = bool(rec["reject"])
        d_other = float(rec["d"].total)
        ln_bias = float(rec["ln_bias"])
        if delayed:
            d_surr = float(zodid(e0_j, alive_c) - zodid(pre["e0"].numpy(),
                                                          alive))
            assert float(rec["d_surr"]) == pytest.approx(d_surr, rel=1e-9,
                                                         abs=1e-9)
            acc1 = (not reject) and (
                np.log(max(float(u[k, 4]), 1e-38))
                < ln_bias - (d_other + d_surr) / temp)
            assert bool(rec["acc1"]) == acc1
        if not delayed or acc1:
            mu_j, it_j, pol_j = solve(pos_c, alive_c, e0_j, to_np(pre["mu"]),
                                      r0_j)
            d_polar = float(pol_j) - float(pre["energy"].polar)
            assert rec["iters"] == int(it_j) > 0
            assert float(rec["d_polar"]) == pytest.approx(
                d_polar, rel=1e-9, abs=1e-9 * abs(float(pol_j)))
            np.testing.assert_allclose(to_np(rec["mu"]), np.asarray(mu_j),
                                       rtol=0, atol=1e-10)
            n_solved += 1
        if delayed:
            want = acc1 and (np.log(max(float(u[k, 12]), 1e-38))
                             < -(d_polar - d_surr) / temp)
        else:
            want = (not reject) and (np.log(max(float(u[k, 4]), 1e-38))
                                     < ln_bias - (d_other + d_polar) / temp)
        assert bool(rec["accept"]) == want, k
        n_acc += want
    assert n_acc > 5 and n_solved > 5
    if delayed:
        assert n_solved < K_REPLAY      # stage 1 spared some solves


@pytest.mark.parametrize("delayed", [False, True], ids=["metropolis", "da"])
def test_polar_chunk_bookkeeping(delayed):
    """After a 150-step polar GCMC chunk the carried energy, polar term
    included, equals a fresh recompute (float64, rel 1e-9), and the carried
    static field and dipoles equal the fresh ones."""
    (p, s, c, t), (P, S, C, T) = mof_polar(polar_precision=1e-10,
                                           polar_delayed=delayed)
    S = tm.initialize(S, P, C, T)
    S2, stats = tm.run_chunk(S, P, C, T, 150,
                             generator=torch.Generator().manual_seed(4))
    acc = stats.accepts.numpy()
    assert acc[tm.DISPLACE] > 0 and acc[tm.INSERT] + acc[tm.DELETE] > 0
    assert stats.polar_iters > 0
    fresh = tm.initialize(S2, P, C, T)
    for k in ("total", "polar"):
        assert float(getattr(S2.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9), k
    np.testing.assert_allclose(to_np(S2.e0), to_np(fresh.e0), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(to_np(S2.mu), to_np(fresh.mu), rtol=0,
                               atol=1e-8)


def test_polar_deck_runs_through_run_mc(tmp_path):
    """A polar deck through run_mc on the CPU: the polar_rrms_debye and
    CG-iteration observables in the JSONL stream, and the dipole and
    field files written every block."""
    job = _polar_deck(tmp_path, f"dipole_output {tmp_path / 'dip.dat'}\n"
                      f"field_output {tmp_path / 'field.dat'}\n")
    buf = io.StringIO()
    su, avgs = trun.run_mc(job, log=buf, jsonl_path=str(tmp_path / "o.jl"),
                           device="cpu")
    assert "WARNING" not in buf.getvalue()
    blocks = [json.loads(x) for x in (tmp_path / "o.jl").read_text()
              .splitlines() if '"step"' in x]
    assert len(blocks) == 2
    for b in blocks:
        assert b["polar_rrms_debye"] >= 0 and b["energy_polar"] <= 0
        assert b["polar_iters_per_step"] > 0
    # the lattice's own field vanishes by symmetry: H2 polarizes it
    assert min(b["energy_polar"] for b in blocks) < 0
    dip = (tmp_path / "dip.dat").read_text().splitlines()
    n_pol = int(to_np((su.params.polar > 0)
                      & su.state.atom_alive(su.params)).sum())
    assert len([x for x in dip if not x.startswith("#")]) == n_pol > 0
    assert (tmp_path / "field.dat").stat().st_size > 0
    assert np.isfinite(avgs.mean("energy_polar"))


def test_fused_polar_delayed_is_refused_as_a10b(tmp_path):
    """polar_delayed with fused_mc, where the reference takes its fused
    polar DA kernel (B6: float32, the CG solver, a delta-able field), is
    no longer refused as ROADMAP A10b: run_mc takes the fused polar DA
    path with the reference's log line, and never a silent scan path."""
    job = _polar_deck(tmp_path, "polar_delayed on\nfused_mc on\n",
                      numsteps=100, precision="float32")
    buf = io.StringIO()
    su, avgs = trun.run_mc(job, log=buf, device="cpu")
    assert ("fused_mc: polar delayed-acceptance stage-1 kernel (exact SCF "
            "stage 2 per survivor)") in buf.getvalue()
    assert "WARNING" not in buf.getvalue()
    assert su.state.step >= 100 and np.isfinite(avgs.mean("energy_polar"))


def test_fused_polar_delayed_refused_by_gate_runs_scan_da(tmp_path):
    """Where the fused DA gate refuses (the Jacobi solver), polar_delayed
    with fused_mc runs the scan-path delayed acceptance with the
    reference's WARNING."""
    job = _polar_deck(tmp_path, "polar_delayed on\nfused_mc on\n"
                      "polar_zodid on\n", numsteps=100, precision="float32")
    assert job.cfg.polar_solver == "jacobi"
    job = dataclasses.replace(job, cfg=dataclasses.replace(
        job.cfg, polar_max_iter=8))
    buf = io.StringIO()
    su, avgs = trun.run_mc(job, log=buf, device="cpu")
    assert "WARNING: polar_delayed requested but the fused stage-1 kernel " \
        "refuses this combination" in buf.getvalue()
    assert su.cfg.polar_delayed and su.state.step == 100
    assert np.isfinite(avgs.mean("energy_polar"))


GATE_CASES = {"uvt": {}, "nvt": {"ensemble": "nvt"},
              "nve": {"ensemble": "nve"}, "float64": {"dtype": "float64"},
              "jacobi": {"polar_solver": "jacobi"},
              "no-delayed": {"polar_delayed": False},
              "polar-ewald": {"polar_ewald": True},
              "polar-ewald-wolf-es": {"polar_ewald": True, "coulomb": "wolf"},
              "polar-wolf": {"polar_wolf": True}}


@pytest.mark.parametrize("case", GATE_CASES)
def test_polar_da_gate_matches_jax(case):
    """The port routes on the reference's fused polar DA gate: its
    supported_uvt_polar_da agrees with JAX's on the MOF + H2 system."""
    from mpmc_tpu.models import systems as jsystems
    from mpmc_tpu.ops.pallas import mc_kernel as jmk
    from mpmc_tpu_torch import convert
    from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=12,
                                      polarization=True)
    c = dataclasses.replace(c, **{"polar_delayed": True, "fused_mc": True,
                                  **GATE_CASES[case]})
    P, _, C, _ = convert.from_jax(p, s, c, t)
    want = jmk.supported_uvt_polar_da(c, p)
    assert tmk.supported_uvt_polar_da(C, P) == want
    assert want == (case in ("uvt", "nvt", "polar-ewald", "polar-wolf"))
