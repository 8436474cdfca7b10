"""The port's native PQR writer (csrc/pqr_io.cpp through io/native.py and
io/pqr.py::write_state): byte for byte the port's Python writer and the
JAX package's Python writer, for restart, trajectory-append and per-chain
files, on a charged and an extended-column system; a failed g++ build
raises."""
import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.config import RunConfig, Thermo  # noqa: E402
from mpmc_tpu.io import pqr as jpqr  # noqa: E402
from mpmc_tpu.models import systems  # noqa: E402
from mpmc_tpu.state import Species, build_system  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import native, pqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.ops.cuda import _build  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain  # noqa: E402

torch.set_num_threads(1)


def _charged():
    """The 10.8k bench system's layout at a small size: a charged MOF
    lattice with 3-site H2 slots (f32, the production type)."""
    return systems.mof_h2_gcmc(n_side=5, n_h2=12, capacity=24,
                               ewald_kmax=3, dtype="float32")


def _extended():
    """Every extended column set: omega, c6, c8, c10 on the framework and
    the sorbate (f64)."""
    sp = Species(name="XE", atom_names=("X1", "X2"),
                 pos=np.array([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0]]),
                 mass=np.array([2.0, 3.0]), charge=np.array([0.3, -0.3]),
                 polar=np.array([0.7, 0.2]), eps=np.array([10.0, 30.0]),
                 sig=np.array([2.9, 3.1]), omega=np.array([0.11, 0.22]),
                 c6=np.array([1.5, 2.5]), c8=np.array([30.25, 40.5]),
                 c10=np.array([700.125, 800.0]))
    rng = np.random.default_rng(3)
    fpos = rng.uniform(0.0, 14.0, (9, 3))
    fp = {"charge": rng.uniform(-0.5, 0.5, 9), "mass": np.full(9, 12.0),
          "polar": np.full(9, 1.2), "eps": np.full(9, 40.0),
          "sig": np.full(9, 3.3), "omega": np.full(9, 0.5),
          "c6": np.full(9, 11.5), "c8": np.full(9, 123.25),
          "c10": np.full(9, 4567.5), "gwp_alpha": np.full(9, 0.125)}
    params, state = build_system(14.0 * np.eye(3), frozen_pos=fpos,
                                 frozen_params=fp, species=(sp,),
                                 capacity=(8,), initial_counts=(5,),
                                 dtype=jnp.float64, seed=5)
    cfg = RunConfig(ensemble="uvt", coulomb="ewald", dtype="float64",
                    ewald_kmax=3, insert_species=(0,))
    thermo = Thermo.make(temperature=200.0, fugacity=(20.0,),
                         insert_probability=0.4, move_factor=0.6,
                         rot_factor=0.8, n_species=1, dtype=jnp.float64)
    return params, state, cfg, thermo


def _jax_like(jstate, state):
    """The reference's state with the port's positions and aliveness."""
    return jstate.replace(pos=jnp.asarray(state.pos.numpy()),
                          mol_alive=jnp.asarray(state.mol_alive.numpy()))


def _same(a, b):
    assert filecmp.cmp(a, b, shallow=False), (open(a).read()[:400],
                                              open(b).read()[:400])


def _three_ways(tmp_path, tag, params, state, jparams, jstate, names,
                remark, wrap=False):
    """One frame through the native writer, the port's Python writer and
    the reference's Python writer; all three byte-identical."""
    nat, py, ref = (str(tmp_path / f"{tag}.{k}.pqr")
                    for k in ("nat", "py", "ref"))
    pqr.write_state(nat, params, state, names, remark=remark, wrap=wrap)
    pos = pqr.wrapped_positions(params, state) if wrap else None
    pqr.write(py, pqr.snapshot_atoms(params, state, names, pos=pos),
              remark=remark, box=state.box.numpy())
    js = _jax_like(jstate, state)
    if wrap:
        js = js.replace(pos=jnp.asarray(jpqr.wrapped_positions(jparams,
                                                               js)))
    jpqr.write(ref, jpqr.snapshot_atoms(jparams, js, names), remark=remark,
               use_native=False, box=np.asarray(js.box))
    _same(nat, py)
    _same(nat, ref)
    return nat


@pytest.mark.parametrize("system", ["charged", "extended"])
@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrapall"])
def test_restart_matches_both_python_writers(tmp_path, system, wrap):
    """A restart file after a few MC steps (molecules moved, inserted and
    deleted): native == port Python == reference Python, byte for byte."""
    jp, js, jc, jt = _charged() if system == "charged" else _extended()
    names = ["H2"] if system == "charged" else ["XE"]
    P, S, C, T = convert.from_jax(jp, js, jc, jt)
    S = tm.initialize(S, P, C, T)
    S2, _ = tm.run_chunk(S, P, C, T, 60,
                         generator=torch.Generator().manual_seed(2))
    for tag, st in (("start", S), ("moved", S2)):
        _three_ways(tmp_path, tag, P, st, jp, js, names,
                    f"restart step {st.step}", wrap=wrap)


def test_trajectory_append_and_per_chain_files(tmp_path):
    """Trajectory frames appended through the RunWriter's modes and one
    restart per chain of stacked chains: native == port Python."""
    jp, js, jc, jt = _charged()
    P, S, C, T = convert.from_jax(jp, js, jc, jt)
    S = tm.initialize(S, P, C, T)
    states = multichain.stack_states(S, 3)
    g = torch.Generator().manual_seed(4)
    nat, py = str(tmp_path / "traj.nat"), str(tmp_path / "traj.py")
    for frame in range(3):
        states, _ = multichain.run_chunk_batched(states, P, C, T, 20,
                                                 generator=g)
        mode = "w" if frame == 0 else "a"
        st0 = slice_chain(states, 0)
        pqr.write_state(nat, P, st0, ["H2"], mode=mode,
                        remark=f"frame step {st0.step}")
        pqr.write(py, pqr.snapshot_atoms(P, st0, ["H2"]), mode=mode,
                  remark=f"frame step {st0.step}", box=st0.box.numpy())
        for k in range(3):
            st = slice_chain(states, k)
            _three_ways(tmp_path, f"r{k}", P, st, jp, js, ["H2"],
                        f"restart replica {k} step {st.step}")
    _same(nat, py)
    assert open(nat).read().count("END\n") == 3


def test_extended_mode_adds_the_gwp_column(tmp_path):
    """``extended``: the native line is the Python writer's extended line
    plus the gwp_alpha column (%8.5f), as the reference's native writer
    writes it."""
    P, S, _, _ = convert.from_jax(*_extended())
    nat, py = str(tmp_path / "x.nat"), str(tmp_path / "x.py")
    pqr.write_state(nat, P, S, ["XE"], extended=True)
    atoms = pqr.snapshot_atoms(P, S, ["XE"])
    pqr.write(py, atoms, extended=True, box=S.box.numpy())
    a, b = open(nat).read().splitlines(), open(py).read().splitlines()
    assert len(a) == len(b) == len(atoms) + 2
    gwp = P.gwp_alpha.numpy()[S.atom_alive(P).numpy()]
    assert a[:1] == b[:1] and a[-1] == b[-1] == "END"
    for la, lb, g in zip(a[1:-1], b[1:-1], gwp):
        assert la == lb + f" {g:8.5f}"


def test_write_frame_matches_arrays_route(tmp_path):
    """write_frame (a PqrAtom list) and write_state (packed arrays) write
    the same bytes."""
    jp, js, jc, jt = _charged()
    P, S, _, _ = convert.from_jax(jp, js, jc, jt)
    a, b = str(tmp_path / "a.pqr"), str(tmp_path / "b.pqr")
    pqr.write_state(a, P, S, ["H2"], remark="r")
    with open(b, "w") as fh:
        fh.write("REMARK r\n" + pqr.cryst_record(S.box.numpy()) + "\n")
    native.write_frame(b, pqr.snapshot_atoms(P, S, ["H2"]), mode="a")
    _same(a, b)


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_build._libs, "pqr_io", raising=False)


def test_failed_gxx_build_raises(tmp_path, monkeypatch):
    """g++ failing (here: ``false`` in its place) raises; nothing falls
    back to the Python writer."""
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on pqr_io.cpp"):
        native.write_frame_arrays(str(tmp_path / "x.pqr"),
                                  np.zeros((0, 13)), np.zeros((0, 2)),
                                  b"", b"", b"")
    assert not (tmp_path / "x.pqr").exists()


def test_missing_gxx_raises(tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.write_frame_arrays(str(tmp_path / "x.pqr"),
                                  np.zeros((0, 13)), np.zeros((0, 2)),
                                  b"", b"", b"")
