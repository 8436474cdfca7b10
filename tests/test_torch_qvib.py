"""The port's quantum vibration (ops/qvib.py, wired in mc/run.py)
against the JAX package in float64 on the CPU: the stretch geometry and
grid, the finite-difference levels, V_ext on a bond-length grid (B4's
plain version at position stride 0 against the reference's vmapped
mol_pair_pass), each molecule's levels and the whole table (one pair
pass for every molecule), the free-molecule ladder, the run's
observables against the reference's table on the same state, and the
CLI deck."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.ops import qvib as jqvib  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.io import pqr as tpqr  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops import qvib as tqvib  # noqa: E402

torch.set_num_threads(1)
VIB = 4161.0          # H2's fundamental [cm^-1]


def _system():
    """The MOF + H2 system (n_side 3, 6 H2) in float64: reference objects
    and the port's, and the H2 species with vib_omega set (each
    package's)."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                      dtype="float64")
    c = dataclasses.replace(c, use_pallas=False)
    jsp = dataclasses.replace(jsystems.h2_bss3(), vib_omega=VIB)
    tsp = dataclasses.replace(tsystems.h2_bss3(), vib_omega=VIB)
    return (p, s, c, t), convert.from_jax(p, s, c, t), jsp, tsp


def test_geometry_grid_and_levels_match_reference():
    _, _, jsp, tsp = _system()
    s, b0, mu = tqvib.stretch_geometry(tsp)
    js, jb0, jmu = jqvib.stretch_geometry(jsp)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-15)
    assert (b0, mu) == pytest.approx((jb0, jmu), rel=1e-15)
    hw = VIB * tqvib.CM1_K
    np.testing.assert_array_equal(tqvib.stretch_grid(b0, mu, hw),
                                  jqvib.stretch_grid(jb0, jmu, hw))
    rng = np.random.default_rng(1)
    bg = tqvib.stretch_grid(b0, mu, hw)
    v = 0.5 * mu * hw * hw / 47.9 * (bg - b0) ** 2 + rng.normal(size=224)
    np.testing.assert_allclose(tqvib.stretch_levels(bg, v, mu, 5),
                               jqvib.stretch_levels(bg, v, mu, 5),
                               rtol=1e-10)
    for bad in (tsystems.ch4_united_atom(),):
        with pytest.raises(ValueError, match="not a linear molecule"):
            tqvib.stretch_geometry(bad)


def test_external_potential_on_grid_matches_reference():
    """V_ext(b) of each H2 on its 224-point grid: the port's stride-0
    plain B4 against the reference's vmapped mol_pair_pass, rel 1e-10
    (abs 1e-8 K)."""
    (jp, js, jc, jt), (P, S, C, T), jsp, tsp = _system()
    s, b0, mu = tqvib.stretch_geometry(tsp)
    bg = tqvib.stretch_grid(b0, mu, VIB * tqvib.CM1_K)
    ja = js.mol_alive[jp.mol_id] & jp.atom_ok
    for m in np.nonzero(np.asarray(js.mol_alive & ~jp.mol_frozen))[0][:3]:
        want = jqvib.external_potential_on_grid(
            js.pos, js.box, ja, jp, jc, jt.temperature, int(m), s, b0, bg)
        got = tqvib.external_potential_on_grid(
            S.pos, S.box, S.atom_alive(P), P, C, T.temperature, int(m), s,
            b0, bg)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-8)
        assert np.ptp(got) > 1e-2


def test_levels_and_table_match_reference(monkeypatch):
    """Each H2's levels and the whole [M, 4] table against the
    reference's (rel 1e-9); the table takes one pair pass for every
    molecule and grid point (B4 at stride 0, one launch on the card)."""
    (jp, js, jc, jt), (P, S, C, T), jsp, tsp = _system()
    ja = js.mol_alive[jp.mol_id] & jp.atom_ok
    m = int(np.nonzero(np.asarray(js.mol_alive & ~jp.mol_frozen))[0][0])
    lv, hw = tqvib.vibrational_levels(S.pos, S.box, S.atom_alive(P), P, C,
                                      T.temperature, m, tsp)
    jlv, jhw = jqvib.vibrational_levels(js.pos, js.box, ja, jp, jc,
                                        jt.temperature, m, jsp)
    np.testing.assert_allclose(lv, jlv, rtol=1e-9)
    assert hw == pytest.approx(jhw, rel=1e-15)
    calls = []
    real = tpairs.mol_pair_pass

    def counted(*a, **k):
        calls.append(k.get("shared"))
        return real(*a, **k)

    monkeypatch.setattr(tpairs, "mol_pair_pass", counted)
    table = tqvib.vibration_table(S.pos, S.box, S.atom_alive(P),
                                  S.mol_alive, P, C, T, [tsp])
    jtable = jqvib.vibration_table(js.pos, js.box, ja, js.mol_alive, jp, jc,
                                   jt, [jsp])
    assert calls == [True]
    np.testing.assert_array_equal(np.isnan(table), np.isnan(jtable))
    assert (~np.isnan(table[:, 0])).sum() == 6
    np.testing.assert_allclose(table, jtable, rtol=1e-9)


def test_free_molecule_gives_the_bare_ladder():
    """A lone H2 in a large empty box: E_n = (n + 1/2) hbar w_e within the
    grid's discretization (1e-3)."""
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.state import build_system
    sp = dataclasses.replace(tsystems.h2_bss3(), vib_omega=VIB)
    params, state = build_system(
        40.0 * np.eye(3), species=(sp,), capacity=(1,), initial_counts=(1,),
        initial_pos={0: np.array([[[20.0, 20.0, 20.0]]]) + sp.pos[None]},
        dtype=torch.float64, device="cpu")
    cfg = RunConfig(ensemble="nvt", coulomb="none", dtype="float64")
    thermo = Thermo.make(temperature=77.0, n_species=1, dtype=torch.float64,
                         device="cpu")
    lv, hw = tqvib.vibrational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        thermo.temperature, 0, sp)
    np.testing.assert_allclose(lv, (np.arange(4) + 0.5) * hw, rtol=1e-3)


def test_qvib_deck_reports_the_references_observables(tmp_path):
    """quantum_vibration + vib_omega through run.run: the block keys
    qvib_zpe and qvib_fundamental_shift, and on the final state they are
    the reference's table's means."""
    _, (P, S, C, T), jsp, _ = _system()
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=8,
                                      device="cpu", dtype="float64")
    tpqr.write_state(str(tmp_path / "h2.pqr"), P, S, ["H2"])
    L = float(S.box[0, 0])
    job = input_script.parse(f"""
ensemble nvt
numsteps 40
corrtime 20
temperature 77
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
precision float64
allow_charged_cell on
quantum_vibration on
vib_omega {VIB}
pqr_input {tmp_path / 'h2.pqr'}
""")
    trun.check_supported(job)
    log = io.StringIO()
    su, avgs = trun.run(job, log=log, device="cpu")
    assert su.species[0].vib_omega == VIB
    assert len(avgs.samples["qvib_zpe"]) == 2
    obs = trun.qvib_obs(su, su.state, su.thermo)
    assert obs["qvib_zpe"] == avgs.samples["qvib_zpe"][-1]
    import jax.numpy as jnp
    from mpmc_tpu.config import Thermo as JThermo
    st = su.state
    jt = JThermo.make(temperature=77.0, n_species=1, dtype=jnp.float64)
    jtable = jqvib.vibration_table(
        jnp.asarray(st.pos.numpy()), jnp.asarray(st.box.numpy()),
        jnp.asarray(st.atom_alive(su.params).numpy()),
        jnp.asarray(st.mol_alive.numpy()), _jparams(su), su.cfg, jt, [jsp])
    ok = ~np.isnan(jtable[:, 0])
    assert obs["qvib_zpe"] == pytest.approx(jtable[ok, 0].mean(), rel=1e-9)
    assert obs["qvib_fundamental_shift"] == pytest.approx(
        ((jtable[ok, 1] - jtable[ok, 0]) - VIB * jqvib.CM1_K).mean(),
        rel=1e-7, abs=1e-7)


def _jparams(su):
    """The reference's Params of the port's set-up (the same system)."""
    import jax.numpy as jnp
    from mpmc_tpu.state import Params as JParams
    p = su.params
    kw = {}
    for f in dataclasses.fields(JParams):
        v = getattr(p, f.name, None)
        if v is not None:
            kw[f.name] = jnp.asarray(v.numpy())
    return JParams(**kw)
