"""The port's fused polar delayed acceptance — kernel B6's plain version
(ops/cuda/mc_kernel.run_steps_uvt_pda on CPU tensors) and its chunk
function mc/metropolis.run_chunk_fused_uvt_polar_da — against the JAX
package and the port's own scan path, on the polar MOF + H2 system
(mof_h2_gcmc(n_side=3, n_h2=6, capacity=10, polarization=True)) built in
JAX and carried over by convert.from_jax:

- B6 against mpmc_tpu's run_steps_uvt_pda(interpret=True), float32, for
  the direct field under ensembles uvt and nvt (the polar_wolf and
  polar_ewald fields: tests/test_torch_pda_fields.py): tables whose
  stage-1 coin forces a survivor at step 0 for each move type, and tables
  of natural coins that must freeze at the same step;
- B6's surrogate delta d* in float64 against thole.field_delta +
  zodid_energy (direct and wolf; under polar_ewald the kernel omits the
  k-space field delta by design);
- the chunk function against the scan-path delayed acceptance fed the rows each
  segment consumed, in float64: the same decisions, positions, energies;
- the chunk function's bookkeeping against a fresh recompute, uvt and nvt;
- run_mc's routing, and the refusals of what B6 does not carry."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import thole  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from torch_pda import (LANE8, SEG, check_forced_survivor,  # noqa: E402
                       check_natural_freeze, jax_system, port_rec)
from torch_polar import polar_deck  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["direct", "nvt"])
def test_plain_b6_matches_pallas_forced_survivor(variant):
    check_forced_survivor(variant)


@pytest.mark.parametrize("variant", ["direct", "nvt"])
def test_plain_b6_natural_freeze_matches_pallas(variant):
    check_natural_freeze(variant)


def _survivors(P, S, C, T, seed=3):
    """The records of forced stage-1 survivors of each move type."""
    rng = np.random.default_rng(seed)
    out = []
    for lane8 in LANE8.values():
        for _ in range(12):
            u = rng.random((SEG, 16))
            u[0, 4], u[0, 8] = 1e-30, lane8
            rec = port_rec(P, S, C, T, u)
            if rec[0, 1] > 0.5:
                out.append(rec)
                break
    assert len(out) == 3
    return out


@pytest.mark.parametrize("variant", ["direct", "wolf"])
def test_plain_b6_d_surr_matches_port_helpers_f64(variant):
    """Float64: B6's d* for a survivor of each move type equals the zodid
    difference of the port's own helpers, thole.field_delta at the
    recorded rows and zodid_energy, to rel 1e-9."""
    P, S, C, T = convert.from_jax(*jax_system(variant, "float64"))
    slots = tm.uvt_fused_tables(P, C)[0].numpy()
    alive = S.atom_alive(P)
    for rec in _survivors(P, S, C, T):
        mt, mol = int(rec[0, 2]), int(slots[int(rec[0, 3])])
        n = int(P.mol_natoms[mol])
        rows = torch.as_tensor(np.repeat(rec[2:5, :1].T, P.max_atoms_per_mol,
                                         0))
        rows[:n] = torch.as_tensor(rec[2:5, :n].T)
        e0n = thole.field_delta(S.pos, S.box, alive, P, C, mol, S.e0,
                                new_rows=None if mt == 2 else rows,
                                insert=mt == 1, delete=mt == 2)
        mol_alive = S.mol_alive.clone()
        mol_alive[mol] = mt != 2
        alive_c = mol_alive[P.mol_id] & P.atom_ok
        want = float(thole.zodid_energy(e0n, alive_c, P)
                     - thole.zodid_energy(S.e0, alive, P))
        assert rec[0, 9] == pytest.approx(want, rel=1e-9, abs=1e-12), mt


def _record_segments(monkeypatch):
    """Wrap the chunk function's B6 so that each segment's n_done is
    recorded."""
    seen = []
    orig = tmk.run_steps_uvt_pda

    def rec(*a, **k):
        out = orig(*a, **k)
        seen.append(int(out[0, 0]))
        return out

    monkeypatch.setattr(tmk, "run_steps_uvt_pda", rec)
    return seen


@pytest.mark.parametrize("variant", ["direct", "wolf"])
def test_fused_pda_matches_scan_da_f64(variant, monkeypatch):
    """Float64: the chunk function on injected segment tables and the scan-path
    delayed acceptance (run_chunk with polar_delayed) fed the rows each
    segment consumed (rows 0..n_done-1 of each) make the same decisions:
    equal attempts, accepts, CG iterations and aliveness, positions within
    1e-10 A, the energy and its polar term within rel 1e-9."""
    P, S, C, T = convert.from_jax(*jax_system(variant, "float64"))
    n = 150
    u = torch.as_tensor(np.random.default_rng(7).random((40, SEG, 16)))
    seen = _record_segments(monkeypatch)
    st_f, stats_f = tm.run_chunk_fused_uvt_polar_da(S, P, C, T, n,
                                                    uniforms=u)
    rows = torch.cat([u[i, :k] for i, k in enumerate(seen)])
    assert n <= len(rows) == st_f.step - S.step < n + SEG
    st_s, stats_s = tm.run_chunk(S, P, C, T, len(rows), uniforms=rows)
    np.testing.assert_array_equal(stats_f.attempts, stats_s.attempts)
    np.testing.assert_array_equal(stats_f.host().accepts,
                                  stats_s.host().accepts)
    assert stats_f.polar_iters == stats_s.polar_iters > 0
    acc = stats_f.host().accepts
    assert acc[tm.DISPLACE] > 0 and acc[tm.INSERT] + acc[tm.DELETE] > 0
    assert torch.equal(st_f.mol_alive, st_s.mol_alive)
    np.testing.assert_allclose(st_f.pos.numpy(), st_s.pos.numpy(), rtol=0,
                               atol=1e-10)
    for k in ("total", "polar"):
        assert float(getattr(st_f.energy, k)) == pytest.approx(
            float(getattr(st_s.energy, k)), rel=1e-9), k


@pytest.mark.parametrize("ensemble", ["uvt", "nvt"])
def test_fused_pda_bookkeeping_f64(ensemble):
    """Float64: after a 200-step chunk the carried energy, polar term
    included, equals initialize's recompute to 1e-9; the attempts lie in
    [200, 200 + PDA_SEG) and equal the steps done; under nvt only
    displacements are attempted and the aliveness is unchanged."""
    variant = "nvt" if ensemble == "nvt" else "direct"
    P, S, C, T = convert.from_jax(*jax_system(variant, "float64"))
    st, stats = tm.run_chunk_fused_uvt_polar_da(
        S, P, C, T, 200, generator=torch.Generator().manual_seed(2))
    att, acc = stats.attempts, stats.host().accepts
    assert 200 <= att.sum() < 200 + SEG and st.step - S.step == att.sum()
    assert acc.sum() > 0 and stats.polar_iters > 0
    if ensemble == "nvt":
        assert att[tm.INSERT] == att[tm.DELETE] == 0
        assert torch.equal(st.mol_alive, S.mol_alive)
    else:
        assert acc[tm.INSERT] + acc[tm.DELETE] > 0
    fresh = tm.initialize(st, P, C, T)
    for k in ("total", "polar", "es_recip", "rd"):
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    np.testing.assert_allclose(st.e0.numpy(), fresh.e0.numpy(), rtol=0,
                               atol=1e-10)


def test_run_mc_routes_polar_delayed_to_b6(tmp_path, monkeypatch):
    """A float32 polar deck with polar_delayed and fused_mc (ensemble uvt
    and nvt) runs the fused PDA chunk through run_mc, with the
    reference's log line and no WARNING."""
    called = []
    orig = tm.run_chunk_fused_uvt_polar_da

    def chunk(*a, **k):
        called.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tm, "run_chunk_fused_uvt_polar_da", chunk)
    for extra in ("", "ensemble nvt\n"):
        job = polar_deck(tmp_path, "polar_delayed on\nfused_mc on\n"
                          + extra, numsteps=100, precision="float32")
        buf = io.StringIO()
        su, _ = trun.run_mc(job, log=buf, device="cpu")
        text = buf.getvalue()
        assert ("fused_mc: polar delayed-acceptance stage-1 kernel (exact "
                "SCF stage 2 per survivor)") in text
        assert "WARNING" not in text and su.state.step >= 100
    assert len(called) == 2


# (cfg fields, the ROADMAP item B6 refuses them with; None: B6 runs them,
# given the input they need)
REFUSED = {"cavity_bias": ({"cavity_bias": True}, None),
           "tmmc": ({"tmmc": True, "tmmc_bias": True}, None),
           "quantum_rotation": ({"quantum_rotation": True}, None),
           "feynman_hibbs": ({"feynman_hibbs": True}, None),
           "rd_sg": ({"rd_potential": "sg"}, "A12a-2b")}


@pytest.mark.parametrize("flag", list(REFUSED))
def test_b6_refuses_a11_features(flag):
    """What B6 does not carry raises NotImplementedError naming the
    ROADMAP item, in the plain version too: the RD forms beyond lj/none
    (A12a-2b).  Feynman-Hibbs, cavity bias, TMMC and spinflip, once
    refused, run (item None): with the molecule-mass plane, the open-cell
    list, the tmmc_bias tilts or the rotor table and spins B6's plain
    version gives a record; without the plane, the list or the table it
    raises (TMMC is collected by the chunk function, and its tilts default to
    0)."""
    P, S, C, T = convert.from_jax(*jax_system("direct"))
    cfg = tmk.pda_effective_cfg(C, P)
    u = torch.as_tensor(np.random.default_rng(0).random((SEG, 16)),
                        dtype=torch.float32)
    args, kw = tm.pda_launch_args(S, P, cfg, T, u,
                                  tm.uvt_fused_tables(P, cfg))
    extra, item = REFUSED[flag]
    args = args[:-1] + (dataclasses.replace(cfg, **extra),)
    if item is None:
        need = {"feynman_hibbs": ("need mol_mass",
                                  dict(mol_mass=P.mol_mass_atom)),
                "cavity_bias": ("needs cav_list", dict(zip(
                    ("cav_list", "cav_n"), tmk.pack_cavity(torch.ones(
                        C.cavity_grid ** 3, dtype=torch.bool))))),
                "tmmc": (None, dict(d_eta_ins=0.5, d_eta_del=-0.5)),
                "quantum_rotation": ("needs rot_f and spin", dict(
                    rot_f=torch.zeros((len(args[8]), 2)),
                    spin=torch.zeros(len(args[8]), dtype=torch.int32),
                    p_spin=0.5))}[flag]
        if need[0] is not None:
            with pytest.raises(ValueError, match=need[0]):
                tmk.run_steps_uvt_pda(*args, **kw)
        if flag == "cavity_bias":
            need[1]["cav_n"] = need[1]["cav_n"].reshape(1)
        rec = tmk.run_steps_uvt_pda(*args, **dict(kw, **need[1]))
        assert rec.shape == (8, 16) and 1 <= float(rec[0, 0]) <= SEG
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}$"):
        tmk.run_steps_uvt_pda(*args, **kw)
