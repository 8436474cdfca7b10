"""The spatial MC step (mpmc_tpu_torch/parallel/spatial.py: state
replicated, B4 on each rank's column strip, B2 and B5 on its row tiles) on
D = 2 gloo ranks on the CPU, in float64 with injected uniforms, against
the port's unsharded run_chunk on the same inputs: the same accepts,
positions within 1e-12, the ranks bit for bit alike, and the carried energy
against a sharded recompute at rel 1e-9 — on a GCMC MOF, its polar twin
(the direct field: the SCF's matvecs sharded) and an NPT LJ fluid (volume
attempts re-price the whole system through the sharded passes).  Also the
reference's gate (mc_supported) and its refusal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu.parallel import spatial as jspatial  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.mc import metropolis  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.parallel import spatial  # noqa: E402

import torch_dist  # noqa: E402

K = 60


def _cases():
    """(name, P, S, C, T, uniforms) on the CPU in float64."""
    rng = np.random.default_rng(2026)
    out = []
    p, s, c, t = tsystems.mof_h2_gcmc(n_side=4, n_h2=8, capacity=16,
                                      pressure=20.0, dtype="float64",
                                      device="cpu")
    out.append(("gcmc", p, s, c, t))
    p, s, c, t = tsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=12,
                                      pressure=20.0, polarization=True,
                                      dtype="float64", device="cpu")
    out.append(("polar", p, s, c, t))
    p, s, c, t = tsystems.lj_fluid(n=96, dtype="float64", device="cpu")
    c = dataclasses.replace(c, ensemble="npt")
    t = t.replace(pressure=torch.tensor(200.0, dtype=torch.float64),
                  volume_probability=torch.tensor(0.1, dtype=torch.float64),
                  volume_change_factor=torch.tensor(0.01,
                                                    dtype=torch.float64))
    out.append(("npt", p, s, c, t))
    return [(n, p, s, c, t, torch.as_tensor(rng.uniform(size=(K, 16))))
            for n, p, s, c, t in out]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    wait = torch_dist.start_groups(torch_dist.spatial_mc, (2,),
                                   tmp_path_factory.mktemp("spatial_mc"),
                                   cases)
    single = {}
    for name, p, s, c, t, u in cases:
        st = metropolis.initialize(s, p, c, t)
        st, stats = metropolis.run_chunk(st, p, c, t, K, uniforms=u)
        single[name] = (st, stats)
    return single, wait()[2]


NAMES = ("gcmc", "polar", "npt")


@pytest.mark.parametrize("name", NAMES)
def test_same_accepts_and_positions_as_one_rank(runs, name):
    single, ranks = runs
    st, stats = single[name]
    got = ranks[0][name]
    assert np.array_equal(got["attempts"], np.asarray(stats.attempts))
    assert np.array_equal(got["accepts"], stats.accepts.numpy())
    assert got["accepts"].sum() > 0
    assert np.array_equal(got["mol_alive"], st.mol_alive.numpy())
    assert np.max(np.abs(got["pos"] - st.pos.numpy())) <= 1e-12
    assert np.max(np.abs(got["box"] - st.box.numpy())) <= 1e-12
    assert got["energy"] == pytest.approx(float(st.energy.total),
                                          rel=1e-12, abs=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_ranks_stay_bit_identical(runs, name):
    _, ranks = runs
    for k, v in ranks[1][name].items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, ranks[0][name][k]), k
        else:
            assert v == ranks[0][name][k], k


@pytest.mark.parametrize("name", NAMES)
def test_carried_energy_equals_a_recompute(runs, name):
    """Bookkeeping: the chunk's carried energy against the sharded
    refresh of its final state at rel 1e-9; a collective per move (the
    displacement's old and new passes in one plane) plus the SCF's."""
    _, ranks = runs
    r = ranks[0][name]
    assert r["energy"] == pytest.approx(r["fresh"], rel=1e-9, abs=1e-9)
    moves = int(np.sum(r["attempts"]))
    assert r["collectives"]["collectives"] >= moves


def _jcfg(**kw):
    _, _, c, _ = jsystems.mof_h2_gcmc(n_side=2, n_h2=1, capacity=2)
    return dataclasses.replace(c, **kw)


GATE = [{}, {"ensemble": "nvt"}, {"ensemble": "npt"}, {"ensemble": "te"},
        {"polarization": True}, {"polarization": True, "polar_wolf": True},
        {"polarization": True, "polar_ewald": True}, {"cdvdw": True},
        {"cell_list": True}, {"rd_crystal": True}, {"mol_cache": True},
        {"spectre": True}]


@pytest.mark.parametrize("kw", GATE, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_mc_supported_is_the_reference_gate(kw):
    cj = _jcfg(**kw)
    assert spatial.mc_supported(convert.config_from(cj)) == \
        jspatial.mc_supported(cj)


def test_refusal_is_the_reference_error():
    """A refused configuration raises the reference's ValueError, word for
    word (mpmc_tpu/mc/run.py:1527-1534)."""
    import inspect

    from mpmc_tpu.mc import run as jrun
    src = inspect.getsource(jrun.run_mc)
    assert all(part in src for part in (
        '"spatial_devices with this configuration is "',
        '"unsupported in the MC loop (needs the scan-path jnp "',
        '"surface: no cdvdw/cell_list/rd_crystal/mol_cache/"'))
    p, s, c, t = tsystems.mof_h2_gcmc(n_side=2, n_h2=1, capacity=2,
                                      device="cpu")
    c = dataclasses.replace(c, cell_list=True)
    with pytest.raises(ValueError) as err:
        spatial.run_chunk_spatial(s, p, c, t, 1,
                                  uniforms=torch.zeros(1, 16))
    assert str(err.value) == spatial.MC_REFUSAL
    assert "surface: no cdvdw/cell_list/rd_crystal/mol_cache/spectre; " \
        "polarization only on the direct damped field, not " \
        "polar_ewald/polar_wolf)" in str(err.value)
