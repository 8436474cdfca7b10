"""The port's hybrid fused NPT path (metropolis.run_chunk_fused_npt: B3
displacement segments, run here through its plain version, between
scan-path volume attempts) against the JAX package: the gate, the exact
attempt mix, bookkeeping after volume moves (the segment after a volume
attempt reads the new box's k-table), determinism, pv = 0, the ideal-gas
volume, and the CLI deck (ports of tests/test_fused_mc.py:592-680)."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.config import Thermo  # noqa: E402
from mpmc_tpu.models import systems  # noqa: E402
from mpmc_tpu.ops.pallas import mc_kernel as jmk  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from torch_npt import (hcl_npt, ideal_npt, lj_npt, port, table,  # noqa: E402
                       with_cfg, write_deck)

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl")


def _npt_fluid(n=24, pv=0.1, dtype="float32"):
    """tests/test_fused_mc.py's _npt_fluid: the LJ fluid under NPT with
    fused_mc (reference objects)."""
    params, state, cfg, _ = systems.lj_fluid(n=n, dtype=dtype)
    cfg = dataclasses.replace(cfg, ensemble="npt", fused_mc=True)
    thermo = Thermo.make(temperature=120.0, pressure=200.0,
                         volume_probability=pv, volume_change_factor=0.1,
                         move_factor=0.5, rot_factor=0.0, n_species=1,
                         dtype=cfg.jdtype)
    return params, state, cfg, thermo


def test_supported_npt_matches_the_reference_gate():
    """supported_npt against mc_kernel.supported_npt on the port's
    surface: the fluid, other ensembles, polarization, f64, other
    Coulomb forms, spinflip, a charged rigid fluid, and a MOF (frozen
    framework: refused by both)."""
    p, s, c, t = _npt_fluid()
    ph, sh, ch, _ = hcl_npt(dtype="float32")
    pm, sm, cm, _ = systems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8)
    cases = [(p, c), (ph, ch), (pm, dataclasses.replace(cm, ensemble="npt"))]
    for kw in ({"ensemble": "nvt"}, {"ensemble": "uvt"},
               {"polarization": True}, {"dtype": "float64"},
               {"coulomb": "wolf"}, {"coulomb": "ewald"},
               {"quantum_rotation": True}, {"tmmc": True}):
        cases.append((p, dataclasses.replace(c, **kw)))
    n_true = 0
    for params, cfg in cases:
        tp = convert.from_jax(params, s if params is p else
                              (sh if params is ph else sm), cfg, t)[0]
        got = tmk.supported_npt(convert.config_from(cfg), tp)
        assert got == jmk.supported_npt(cfg, params), cfg
        n_true += got
    assert n_true == 4


def test_attempt_mix_step_and_bookkeeping():
    """tests/test_fused_mc.py::test_npt_attempt_mix_and_bookkeeping: K =
    200 at pv = 0.1 makes exactly 20 volume attempts and 180
    displacements, advances step by exactly K, rescales the box; here in
    f64 the carried energy equals a fresh recompute to 1e-9 (the
    reference holds f32 to 2e-4)."""
    _, P, S, C, T = port(_npt_fluid(dtype="float64"))
    st, stats = tm.run_chunk_fused_npt(
        S, P, C, T, 200, generator=torch.Generator().manual_seed(5))
    assert st.step == S.step + 200
    assert stats.attempts[tm.VOLUME] == 20
    assert stats.attempts[tm.DISPLACE] == 180
    assert int(stats.accepts[tm.VOLUME]) > 0
    assert int(stats.accepts[tm.DISPLACE]) > 0
    assert float((st.box - S.box).abs().max()) > 0.0
    fresh = tm.initialize(st, P, C, T)
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k


def test_segments_after_a_volume_move_read_the_new_k_table():
    """The charged rigid fluid under Ewald in f64 through the hybrid path
    (plain B3 over 2-site molecules, the S(k) delta): each segment's
    launch takes rc, alpha and the k-table from the box it starts in, so
    after 30 volume attempts the carried energy and S(k) still equal a
    fresh recompute to 1e-9; the injected table's rows equal a drawn
    table's."""
    _, P, S, C, T = port(hcl_npt(n_mol=8, pv=0.1))
    K = 300
    u = table(K, seed=3)
    st, stats = tm.run_chunk_fused_npt(S, P, C, T, K, uniforms=u)
    assert stats.attempts[tm.VOLUME] == 30
    assert 0 < int(stats.accepts[tm.VOLUME]) < 30
    assert int(stats.accepts[tm.DISPLACE]) > 20
    fresh = tm.initialize(st, P, C, T)
    for k in TERMS:
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    np.testing.assert_allclose(st.sk_re.numpy(), fresh.sk_re.numpy(),
                               rtol=1e-9, atol=1e-9)
    g = torch.Generator().manual_seed(8)
    drawn = tm.draw_uniforms(torch.Generator().manual_seed(8), K,
                             torch.float64)
    a, _ = tm.run_chunk_fused_npt(S, P, C, T, K, generator=g)
    b, _ = tm.run_chunk_fused_npt(S, P, C, T, K, uniforms=drawn)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.box, b.box)


def test_deterministic_and_pv_zero():
    """Two runs from one seed are equal bit for bit; pv = 0 is a pure
    displacement chunk (tests/test_fused_mc.py::
    test_npt_deterministic_and_pv_zero)."""
    _, P, S, C, T = port(_npt_fluid(n=16, pv=0.2))
    a, _ = tm.run_chunk_fused_npt(S, P, C, T, 60,
                                  generator=torch.Generator().manual_seed(1))
    b, _ = tm.run_chunk_fused_npt(S, P, C, T, 60,
                                  generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.pos, b.pos) and torch.equal(a.box, b.box)
    _, P, S, C, T = port(_npt_fluid(n=16, pv=0.0))
    st, stats = tm.run_chunk_fused_npt(
        S, P, C, T, 50, generator=torch.Generator().manual_seed(1))
    assert stats.attempts[tm.VOLUME] == 0
    assert stats.attempts[tm.DISPLACE] == 50
    assert torch.equal(st.box, S.box) and st.step == S.step + 50


def test_ideal_gas_volume_through_the_hybrid_path():
    """Ideal-gas NPT through the hybrid path: <V> = (N + 1) kT / P within
    15 % (tests/test_fused_mc.py::test_npt_ideal_gas_volume_fused: 400
    steps, then 120 samples 20 steps apart, f32)."""
    j, expect_v = ideal_npt(pv=0.5, dtype="float32")
    _, P, S, C, T = port(with_cfg(j, fused_mc=True))
    T = T.replace(rot_factor=torch.zeros_like(T.rot_factor))
    assert tmk.supported_npt(C, P)
    g = torch.Generator().manual_seed(21)
    S, _ = tm.run_chunk_fused_npt(S, P, C, T, 400, generator=g)
    vols = []
    for _ in range(120):
        S, _ = tm.run_chunk_fused_npt(S, P, C, T, 20, generator=g)
        vols.append(float(torch.abs(torch.linalg.det(S.box.double()))))
    assert np.mean(vols) == pytest.approx(expect_v, rel=0.15)


def test_cli_hybrid_npt_deck(tmp_path, monkeypatch):
    """An NPT LJ deck with fused_mc on (f32) takes the hybrid path (its
    log line, no WARNING), ends at step numsteps and accepts some volume
    moves; in f64 it takes the scan path with the reference's
    WARNING."""
    monkeypatch.chdir(tmp_path)
    j = lj_npt(pv=0.1, dtype="float32")
    deck = write_deck(tmp_path, j, "numsteps 200", "corrtime 100",
                      "coulomb off", "fused_mc on")
    buf = io.StringIO()
    su, avgs = trun.run(input_script.parse_file(str(deck)), log=buf,
                        device="cpu")
    out = buf.getvalue()
    assert "fused_mc: hybrid fused NPT (B3 segments + scan-path volume " \
           "moves)" in out
    assert "WARNING" not in out and su.state.step == 200
    assert 0 < avgs.mean("acc_volume") < 1
    deck.write_text(deck.read_text().replace("precision float32",
                                             "precision float64"))
    buf = io.StringIO()
    trun.run(input_script.parse_file(str(deck)), log=buf, device="cpu")
    assert "WARNING: fused_mc requested but unsupported" in buf.getvalue()
    assert "hybrid" not in buf.getvalue()
