"""Cavity-biased insertion through the port's chunk functions: the
reference's cavity tests of tests/test_fused_mc.py (:680 bookkeeping, :707
inserts only into open cells, :734 the ideal gas at radius 0, :1557
chains against single chains, :2156 the polar delayed acceptance) on the
port's plain kernels, on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu_torch.config import RunConfig, Thermo  # noqa: E402
from mpmc_tpu_torch.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import (all_molecule_coms, build_system,  # noqa
                                  slice_chain)

torch.set_num_threads(1)


def _open_cell_of(st, params, mols, g):
    coms = all_molecule_coms(st.pos, params).numpy()
    binv = np.linalg.inv(st.box.numpy())
    frac = coms[mols] @ binv % 1.0
    ijk = np.minimum((frac * g).astype(int), g - 1)
    return (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]


def test_uvt_cavity_bias_bookkeeping():
    """tests/test_fused_mc.py:680 on the port, in float64 (the plain B1 on
    the CPU; in float32 the +-9e3 K self terms of the exchanges leave
    rounding of ~0.06 K in the carried es_self): fused cavity-biased GCMC
    with closed and open cells; every carried energy term matches a fresh
    recompute to 1e-9 after 600 steps, and inserts land."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=4, n_h2=12, capacity=24,
                                      dtype="float64", device="cpu")
    C = dataclasses.replace(C, fused_mc=True, cavity_bias=True,
                            cavity_grid=6, cavity_radius=2.0)
    assert tmk.supported_uvt(dataclasses.replace(C, dtype="float32"), P)
    S = tm.initialize(S, P, C, T)
    n_open = int(S.cavity_open.sum())
    assert 0 < n_open < 6 ** 3
    st, stats = tm.run_chunk_fused_uvt(
        S, P, C, T, 600, generator=torch.Generator().manual_seed(3))
    att, acc = stats.attempts, stats.host().accepts
    assert att[tm.INSERT] > 50
    assert acc[tm.INSERT] + acc[tm.DELETE] > 0
    fresh = tm.initialize(st, P, C, T)
    for term in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl"):
        assert float(getattr(st.energy, term)) == pytest.approx(
            float(getattr(fresh.energy, term)), rel=1e-9, abs=1e-9), term


@pytest.mark.parametrize("route", ["fused", "scan"])
def test_port_cavity_inserts_land_in_open_cells(route):
    """tests/test_fused_mc.py:707 on the port, fused and on the scan path:
    every accepted insert's COM lies in a cell open in the chunk's
    grid."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=4, n_h2=2, capacity=24,
                                      pressure=20.0, device="cpu")
    C = dataclasses.replace(C, fused_mc=True, cavity_bias=True,
                            cavity_grid=5, cavity_radius=2.5)
    S = tm.initialize(S, P, C, T)
    alive0 = S.mol_alive.clone()
    chunk = tm.run_chunk_fused_uvt if route == "fused" else tm.run_chunk
    st, stats = chunk(S, P, C, T, 400,
                      generator=torch.Generator().manual_seed(11))
    new = torch.nonzero(st.mol_alive & ~alive0)[:, 0].numpy()
    assert stats.host().accepts[tm.INSERT] > 0 and len(new) > 0
    cells = _open_cell_of(st, P, new, C.cavity_grid)
    assert S.cavity_open.numpy()[cells].all()


def test_uvt_cavity_bias_preserves_equilibrium_density():
    """tests/test_fused_mc.py:734 on the port: the ideal gas under fused
    GCMC with cavity bias at radius 0 (every cell open, the correction
    ln 1 = 0) keeps <N> = fV/kT = 20 within 2.  Every step is an insert or
    a delete (insert_probability 1; an ideal gas needs no displacement),
    so 50-step samples hold the reference's 100-step samples' exchanges."""
    L, T, target_n = 20.0, 300.0, 20.0
    f_atm = target_n * T / L ** 3 / ATM2K_A3
    sp = tsystems.lj_atom("HE", eps=0.0, sig=0.0, mass=4.0)
    params, state = build_system(L * np.eye(3), species=(sp,),
                                 capacity=(80,), initial_counts=(10,),
                                 dtype=torch.float32, seed=3, device="cpu")
    cfg = RunConfig(ensemble="uvt", rd_potential="none", coulomb="none",
                    rd_lrc=False, dtype="float32", insert_species=(0,),
                    fused_mc=True, cavity_bias=True, cavity_grid=4,
                    cavity_radius=0.0)
    thermo = Thermo.make(temperature=T, fugacity=(f_atm,),
                         insert_probability=1.0, move_factor=1.0,
                         rot_factor=0.1, n_species=1, dtype=torch.float32,
                         device="cpu")
    assert tmk.supported_uvt(cfg, params)
    state = tm.initialize(state, params, cfg, thermo)
    assert int(state.cavity_open.sum()) == 4 ** 3
    g = torch.Generator().manual_seed(5)
    state, _ = tm.run_chunk_fused_uvt(state, params, cfg, thermo, 1000,
                                      generator=g)
    samples = []
    for _ in range(60):
        state, _ = tm.run_chunk_fused_uvt(state, params, cfg, thermo, 50,
                                          generator=g)
        samples.append(int(state.mol_alive.sum()))
    assert np.mean(samples) == pytest.approx(target_n, abs=2.0)


def test_multi_chain_cavity_bias_equals_single_chain():
    """tests/test_fused_mc.py:1557 on the port: chains whose grids have
    diverged (a refresh after 60 steps) each reproduce the single-chain
    chunk on their own rows, bit for bit."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=16,
                                      device="cpu")
    C = dataclasses.replace(C, coulomb="wolf", fused_mc=True,
                            cavity_bias=True, cavity_grid=4,
                            cavity_radius=2.0)
    T = T.replace(fugacity=T.fugacity * 10.0)
    assert tmk.supported_uvt_multi(C, P)
    S = tm.initialize(S, P, C, T)
    Cn = 3
    states = multichain.stack_states(S, Cn)
    states, _ = tm.run_chunk_fused_uvt_multi(
        states, P, C, T, 60, generator=torch.Generator().manual_seed(9))
    states = multichain.initialize_batched(states, P, C, T)
    grids = states.cavity_open.numpy()
    assert grids.any(axis=1).all()
    assert not (grids[0] == grids[1]).all() or not (
        grids[0] == grids[2]).all()
    K = 120
    u = torch.rand((Cn, K, 16), generator=torch.Generator().manual_seed(2))
    out, stats = tm.run_chunk_fused_uvt_multi(states, P, C, T, K,
                                              uniforms=u)
    exch = 0
    for ch in range(Cn):
        ref, rstats = tm.run_chunk_fused_uvt(slice_chain(states, ch), P, C,
                                             T, K, uniforms=u[ch])
        assert torch.equal(out.pos[ch], ref.pos)
        assert torch.equal(out.mol_alive[ch], ref.mol_alive)
        assert torch.equal(stats.accepts[ch], rstats.accepts)
        exch += int(rstats.accepts[tm.INSERT] + rstats.accepts[tm.DELETE])
    assert exch > 0


def test_port_pda_cavity_bookkeeping_and_open_cells():
    """tests/test_fused_mc.py:2156 on the port: the fused polar delayed
    acceptance with cavity bias; the carried energy (polar term too)
    matches a recompute and every accepted insert lies in an open
    cell."""
    P, S, C, T = tsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=12,
                                      polarization=True, pressure=20.0,
                                      device="cpu")
    C = dataclasses.replace(C, polar_delayed=True, fused_mc=True,
                            cavity_bias=True, cavity_grid=5,
                            cavity_radius=2.0)
    assert tmk.supported_uvt_polar_da(C, P)
    S = tm.initialize(S, P, C, T)
    open_mask = S.cavity_open.numpy()
    assert 0 < open_mask.sum() < 5 ** 3
    alive0 = S.mol_alive.clone()
    st, stats = tm.run_chunk_fused_uvt_polar_da(
        S, P, C, T, 300, generator=torch.Generator().manual_seed(13))
    assert int(stats.host().accepts.sum()) > 0
    fresh = tm.initialize(st, P, C, T)
    for term in ("rd", "es_real", "es_recip", "polar"):
        assert float(getattr(st.energy, term)) == pytest.approx(
            float(getattr(fresh.energy, term)), rel=2e-4, abs=5e-2), term
    new = torch.nonzero(st.mol_alive & ~alive0)[:, 0].numpy()
    if len(new):
        assert open_mask[_open_cell_of(st, P, new, C.cavity_grid)].all()


@pytest.mark.parametrize("route", ["fused", "batched"])
def test_pt_with_cavity_bias(tmp_path, route):
    """Cavity bias under parallel tempering (a temperature ladder of 4
    replicas on examples/h2_sorption.inp's MOF, 200 steps): the plain B1
    with on-device swaps and the batched scan chains with host swaps; each
    replica refreshes its own grid at every corrtime (a grid per replica,
    open cells logged, all replicas' grids rebuilt from their own
    positions), and a TMMC deck under the ladder is refused at parse."""
    import io
    import os
    import pathlib
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run as trun
    repo = pathlib.Path(__file__).resolve().parents[1]
    text = (repo / "examples" / "h2_sorption.inp").read_text()
    text = text.replace("numsteps         20000", "numsteps 200").replace(
        "corrtime         1000", "corrtime 100").replace(
        "examples/framework_h2.pqr",
        str(repo / "examples" / "framework_h2.pqr"))
    extra = ["parallel_tempering on", "n_replicas 4", "ptemp_freq 25",
             "max_temperature 150", "cavity_bias on", "cavity_grid 6",
             "cavity_radius 2.0"] + (["fused_mc on"] if route == "fused"
                                     else [])
    deck = tmp_path / "deck.inp"
    deck.write_text(text + "\n".join(extra) + "\n")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        buf = io.StringIO()
        su, avgs = trun.run(input_script.parse_file(str(deck)), log=buf,
                            device="cpu")
    finally:
        os.chdir(old)
    out = buf.getvalue()
    assert ("on-device swaps" in out) == (route == "fused")
    grids = su.states.cavity_open
    assert grids.shape == (4, 6 ** 3)
    for c in range(4):
        st = slice_chain(su.states, c)
        want = tmoves_grid(st, su.params, su.cfg)
        assert torch.equal(grids[c], want)
    assert 0 < avgs.mean("cavity_open") < 6 ** 3
    with pytest.raises(ValueError, match="parallel tempering"):
        input_script.parse(text + "tmmc on\nparallel_tempering on\n")


def tmoves_grid(state, params, cfg):
    from mpmc_tpu_torch.mc import moves
    return moves.cavity_open_grid(state.pos, state.box,
                                  state.atom_alive(params), cfg.cavity_grid,
                                  cfg.cavity_radius)
