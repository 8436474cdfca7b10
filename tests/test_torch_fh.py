"""The Feynman-Hibbs (FH2, FH4) and Feynman-Kleinert (FK) quantum
corrections in the port against the JAX package: ops/lj.py's functions
and the pair terms in float64 to rel 1e-12 (the golden mof_h2_polar_fh
configuration included), the scan path's and the batched chains'
bookkeeping under each correction, the static gates of the pair kernels
(B2, B4) and of the fused kernels (B1, B3, B6), the pair passes' plain
route, the example deck h2_quantum_fk.inp, and the temperature-ladder
trap that the port refuses.  The plain B1, B3 and B6 against the
reference's kernels under the corrections: tests/test_torch_fused_fh.py,
test_torch_fused_nvt_fh.py and test_torch_pda_fh.py."""
import dataclasses
import io
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import energy as jenergy  # noqa: E402
from mpmc_tpu.ops import lj as jlj  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu.ops.pallas import pair_kernel as jpk  # noqa: E402
from mpmc_tpu.parallel import replica as jreplica  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402
from mpmc_tpu_torch.ops import lj as tlj  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from test_golden import GOLDEN  # noqa: E402
from torch_fh import CLASSICAL, QUANTUM  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
# float64, the port against the JAX package: the two sides differ by the
# last bits of pow and the exp/log library calls
REL = 1e-12


def _close(got, want, scale=None):
    """rel 1e-12 of each value, or of the largest magnitude of the set
    (``scale``) where a value crosses zero."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 0.0 if scale is None else REL * scale
    np.testing.assert_allclose(got, want, rtol=REL, atol=atol)


# r on both sides of the FK series switch at x = 0.1: near the well x is
# O(1), at 20-40 A the curvature and so x are tiny
R = np.concatenate([np.linspace(1.6, 12.0, 300), np.linspace(12, 40, 60)])
RED = np.linspace(0.5, 60.0, R.size)


@pytest.mark.parametrize("fn", ["derivatives", "fh2", "fh4", "fk"])
@pytest.mark.parametrize("temp", [20.0, 77.0])
def test_lj_quantum_functions_match_jax_f64(fn, temp):
    """lj.derivatives, feynman_hibbs (2, 4) and feynman_kleinert against
    the JAX package's on 360 distances at 20 and 77 K, rel 1e-12 (of the
    largest |value| where a term changes sign)."""
    eps, sig = 34.2, 2.96
    r = jnp.asarray(R)
    rt = torch.tensor(R)
    e_t, s_t = (torch.tensor(v, dtype=torch.float64) for v in (eps, sig))
    if fn == "derivatives":
        for a, b in zip(tlj.derivatives(rt, e_t, s_t),
                        jlj.derivatives(r, eps, sig)):
            _close(a.numpy(), b, scale=float(np.abs(b).max()))
        return
    red, t_t = torch.tensor(RED), torch.tensor(temp, dtype=torch.float64)
    if fn == "fk":
        got = tlj.feynman_kleinert(rt, e_t, s_t, red, t_t).numpy()
        want = np.asarray(jlj.feynman_kleinert(r, eps, sig, jnp.asarray(RED),
                                               temp))
    else:
        order = 2 if fn == "fh2" else 4
        got = tlj.feynman_hibbs(rt, e_t, s_t, red, t_t, order).numpy()
        want = np.asarray(jlj.feynman_hibbs(r, eps, sig, jnp.asarray(RED),
                                            temp, order))
    _close(got, want, scale=float(np.abs(want).max()))


def test_fk_series_switches_match_jax_f64():
    """_ln_sinhc and _xcothx_m1 on both sides of x = 0.1 and to x = 60,
    rel 1e-12."""
    x = np.concatenate([np.linspace(0.0, 0.0999, 50),
                        np.linspace(0.1, 60.0, 200)])
    for a, b in ((tlj._ln_sinhc, jlj._ln_sinhc),
                 (tlj._xcothx_m1, jlj._xcothx_m1), (tlj._xcothx, jlj._xcothx)):
        want = np.asarray(b(jnp.asarray(x)))
        _close(a(torch.tensor(x)).numpy(), want, scale=1e-300)


def _polar_fh(q="fh2"):
    """The golden mof_h2_polar_fh configuration (tests/test_golden.py) under
    the correction ``q``."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                      polarization=True, dtype="float64")
    c = dataclasses.replace(c, polar_solver="direct", **QUANTUM[q])
    return p, s, c, t


@pytest.mark.parametrize("q", list(QUANTUM))
def test_total_energy_matches_jax_f64(q):
    """Every term of total_energy on mof_h2_polar_fh under FH2 (the golden
    numbers), FH4 and FK against the JAX package, rel 1e-12 — plain and
    split at the frozen framework."""
    p, s, c, t = _polar_fh(q)
    P, S, C, T = convert.from_jax(p, s, c, t)
    want, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t)
    got, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T)
    for k in TERMS:
        _close(float(getattr(got, k)), float(getattr(want, k)))
    if q == "fh2":
        for k, v in GOLDEN["mof_h2_polar_fh"].items():
            assert float(getattr(got, k)) == pytest.approx(v, rel=1e-9,
                                                           abs=1e-6), k
    wa, wf, _ = jenergy.total_energy(s.pos, s.box, s.mol_alive, p, c, t,
                                     split_frozen=True)
    ga, gf, _ = tenergy.total_energy(S.pos, S.box, S.mol_alive, P, C, T,
                                     split_frozen=True)
    for k in ("rd", "es_real", "lrc"):
        _close(float(getattr(ga, k)), float(getattr(wa, k)))
        _close(float(getattr(gf, k)), float(getattr(wf, k)))
    classical, _ = tenergy.total_energy(
        S.pos, S.box, S.mol_alive, P, dataclasses.replace(C, **CLASSICAL), T)
    assert abs(float(got.rd) - float(classical.rd)) > 1.0


def _mof_f64(q, n_h2=6):
    """The MOF + H2 system (n_side 3) at 77 K and 20 atm under the
    correction ``q``, float64, initialized and carried over."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=n_h2, capacity=10,
                                      temperature=77.0, pressure=20.0,
                                      dtype="float64")
    c = dataclasses.replace(c, **QUANTUM[q])
    return convert.from_jax(p, jm.initialize(s, p, c, t), c, t)


@pytest.mark.parametrize("q", list(QUANTUM))
def test_scan_path_bookkeeping_f64(q):
    """The scan path (displace, insert, delete through the plain tile
    pass) for 150 steps in float64: every carried term equals a fresh
    initialize to 1e-9, with exchanges among the accepted moves."""
    P, S, C, T = _mof_f64(q)
    st, stats = tm.run_chunk(S, P, C, T, 150,
                             generator=torch.Generator().manual_seed(8))
    acc = stats.host().accepts
    assert acc.sum() > 5 and acc[tm.INSERT] + acc[tm.DELETE] > 0, acc
    assert int(st.n_molecules(P)) > 0
    fresh = tm.initialize(st, P, C, T)
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k


def test_batched_chains_bookkeeping_f64():
    """FK on two batched scan chains (the plain tile pass over the chain
    axis, mol_pair_chains_plain with a temperature per chain at 77 and
    120 K): each chain's carried energy equals its fresh recompute at its
    own temperature to 1e-9."""
    P, S, C, T = _mof_f64("fk")
    states = multichain.stack_states(S, 2)
    T2 = T.replace(temperature=torch.tensor([77.0, 120.0],
                                            dtype=torch.float64))
    states = multichain.initialize_batched(states, P, C, T2)
    out, _ = multichain.run_chunk_batched(
        states, P, C, T2, 60, generator=torch.Generator().manual_seed(2))
    fresh = multichain.initialize_batched(out, P, C, T2)
    np.testing.assert_allclose(out.energy.total.numpy(),
                               fresh.energy.total.numpy(), rtol=1e-9,
                               atol=1e-9)
    assert float(fresh.energy.rd[0]) != float(fresh.energy.rd[1])


RD_FORMS = ("lj", "none", "sg", "dreiding", "b14_7", "disp_expansion")


def test_gate_matrix_matches_the_reference():
    """Over every combination of FH, FK, FH order and RD form (float32):
    pair_kernel.supported equals the reference's B2/B4 gate; the fused
    kernels' _supported_physics equals the reference's on the port's RD
    forms (lj, none) and refuses the others (ROADMAP A12a-2b)."""
    base = jsystems.mof_h2_gcmc(n_side=3, n_h2=2, capacity=4)[2]
    n_fused = 0
    for rd in RD_FORMS:
        for fh in (False, True):
            for fk in (False, True):
                for order in (2, 4):
                    c = dataclasses.replace(
                        base, rd_potential=rd, feynman_hibbs=fh,
                        feynman_kleinert=fk, feynman_hibbs_order=order)
                    tc = convert.config_from(c)
                    assert tpk.supported(tc) == jpk.supported(c), c
                    want = jmk._supported_physics(c)
                    got = tmk._supported_physics(tc)
                    if rd in ("lj", "none"):
                        assert got == want, (rd, fh, fk, order)
                        n_fused += got and (fh or fk)
                    else:
                        assert not got
    assert n_fused == 6          # lj with FH and/or FK, either order


@pytest.mark.parametrize("q", [None, "fh2", "fk"])
def test_pair_passes_route(q, monkeypatch):
    """Without a correction the refresh and the per-move deltas call the
    B2/B4 wrappers; under FH or FK they never do (the plain tile pass, as
    the reference's scan path): the wrappers are replaced by counters."""
    P, S, C, T = _mof_f64("fh2")
    C = dataclasses.replace(C, **(QUANTUM[q] if q else CLASSICAL))
    calls = {"pair_terms": 0, "mol_pair": 0}
    for name in calls:
        orig = getattr(tpk, name)

        def counted(*a, _n=name, _f=orig, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tpk, name, counted)
    st = tm.initialize(S, P, C, T)
    tm.run_chunk(st, P, C, T, 20, generator=torch.Generator().manual_seed(1))
    if q is None:
        assert calls["pair_terms"] > 0 and calls["mol_pair"] > 0
    else:
        assert calls == {"pair_terms": 0, "mol_pair": 0}


def test_temperature_ladder_trap_and_refusal():
    """The reference's swap rule under FH (mpmc_tpu/parallel/replica.py:
    109-131, caches refreshed at the new temperatures afterwards,
    mpmc_tpu/mc/run.py:963-973) prices each configuration at its own
    rung's temperature only.  With U_T the FH-corrected energy, the
    isothermal weight of a swap is ln P = b_i U_{T_i}(x_i) + b_j
    U_{T_j}(x_j) - b_i U_{T_i}(x_j) - b_j U_{T_j}(x_i).  Two replicas in
    one configuration must have ln P = 0; the reference's (b_i - b_j)(E_i
    - E_j) is 2.72 at 20 / 40 K.  Moved apart by up to 0.5 A per
    molecule, the reference's rule accepts e^9 times too often.  The port
    refuses FH/FK under parallel_tempering (ValueError FH_PT_TRAP); the
    fugacity ladder, at one temperature, runs."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                      dtype="float64")
    c = dataclasses.replace(c, feynman_hibbs=True)

    def u_at(pos, temp):
        th = t.replace(temperature=jnp.asarray(temp, jnp.float64))
        return float(jenergy.total_energy(pos, s.box, s.mol_alive, p, c,
                                          th)[0].total)

    mol_id = np.asarray(p.mol_id)
    mov = ~np.asarray(p.mol_frozen) & (np.asarray(p.mol_species) >= 0)
    shift = np.random.default_rng(1).uniform(-0.5, 0.5, (len(mov), 3))
    shift[~mov] = 0.0
    temps = np.array([20.0, 40.0])
    b = 1.0 / temps
    for x_j, gap_min in ((s.pos, 2.0), (jnp.asarray(np.asarray(s.pos)
                                                    + shift[mol_id]), 5.0)):
        e = np.array([u_at(s.pos, temps[0]), u_at(x_j, temps[1])])
        ln_ref = (b[0] - b[1]) * (e[0] - e[1])
        ln_iso = (b[0] * e[0] + b[1] * e[1] - b[0] * u_at(x_j, temps[0])
                  - b[1] * u_at(s.pos, temps[1]))
        assert ln_ref - ln_iso > gap_min, (ln_ref, ln_iso)
        if x_j is s.pos:
            assert abs(ln_iso) < 1e-9          # a swap of equals
            # the reference swaps on its own rule: always, here
            rng = np.random.default_rng(0)
            assert sum(jreplica.host_swap(temps, e, 0, rng)[1]
                       for _ in range(20)) == 20
    job = input_script.parse("feynman_hibbs on\nparallel_tempering on\n")
    with pytest.raises(ValueError, match="feynman_hibbs / feynman_kleinert "
                                         "under parallel_tempering"):
        trun.check_supported(job)
    trun.check_supported(input_script.parse(
        "feynman_kleinert on\npt_fugacity on\nparallel_tempering on\n"))


def _example_fk(tmp_path, *lines):
    """examples/h2_quantum_fk.inp cut in depth (numsteps 40, corrtime 20,
    the example framework by its path) plus ``lines``, parsed."""
    text = (REPO / "examples" / "h2_quantum_fk.inp").read_text()
    text = text.replace("numsteps         20000", "numsteps 40")
    text = text.replace("corrtime         1000", "corrtime 20")
    text = text.replace("examples/framework_h2.pqr",
                        str(REPO / "examples" / "framework_h2.pqr"))
    assert "numsteps 40" in text and "corrtime 20" in text
    deck = tmp_path / "fk.inp"
    deck.write_text(text + "".join(f"{x}\n" for x in lines))
    return input_script.parse_file(str(deck))


@pytest.mark.parametrize("extra", [(), ("pt_fugacity on", "n_replicas 2")],
                         ids=["fused-uvt", "pt_fugacity"])
def test_example_fk_deck_runs(extra, tmp_path):
    """examples/h2_quantum_fk.inp (FK, fused_mc, 20 K) runs on the CPU:
    on the fused µVT kernel's plain version with the pair passes' plain
    route named in the log; with pt_fugacity the ladder stays on the
    batched scan chains, as the reference's gate keeps it."""
    job = _example_fk(tmp_path, *extra)
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        buf = io.StringIO()
        su, avgs = trun.run(job, log=buf, device="cpu")
    finally:
        os.chdir(old)
    text = buf.getvalue()
    assert "pair passes: the plain tile pass on the device" in text
    assert np.isfinite(avgs.mean("energy_total"))
    if extra:
        assert ("keep this fugacity-ladder run on the batched scan chains"
                in text)
        assert "batched scan chains (C=2)" in text
    else:
        assert "fused_mc: single-chain fused µVT kernel" in text
        assert su.state.step == 40


@pytest.mark.parametrize("polar", [False, True], ids=["b1-b3", "b6"])
def test_molecule_mass_plane_fits_the_bench_system(polar):
    """The quantum decks' slice holds a seventh column plane (the molecular
    masses): slice_bytes grows by that plane alone, and the 10.8k bench
    system (10,797 columns, 709 k-vectors, 512 slots) still fits a
    cluster of G = 16 in float32 (and of every G that fits without the
    plane, B6's polar slice too)."""
    n, nk, ms = 10797, 709, 512
    for G in tmk.CLUSTER_SIZES:
        nloc = -(-n // G)
        extra = -(-(7 * nloc * 4) // 16) * 16 - -(-(6 * nloc * 4) // 16) * 16
        assert (tmk.slice_bytes(n, torch.float32, G, nk, ms, polar, True)
                - tmk.slice_bytes(n, torch.float32, G, nk, ms, polar)
                == extra)
    fits = tmk.fitting_cluster_sizes(n, torch.float32, nk, ms, polar, True)
    assert 16 in fits
    assert fits == tmk.fitting_cluster_sizes(n, torch.float32, nk, ms, polar)
