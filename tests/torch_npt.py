"""Shared by the NPT tests (test_torch_npt.py, test_torch_fused_npt.py,
test_torch_npt_chains.py): frameless NPT systems built with the JAX
package's build_system and carried over to the port, and a deck
writer."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from helpers import free_atoms
from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.state import Species, build_system
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.mc import metropolis as tm


def lj_npt(n=15, L=13.0, seed=13, pv=0.2, dtype="float64"):
    """The LJ fluid of tests/test_mc.py::test_npt_lj_bookkeeping: n atoms
    at uniform random positions in an L box, eps 100 K, sigma 3.2 A, 200
    K and 50 atm (reference objects)."""
    coords = np.random.default_rng(seed).uniform(0, L, (n, 3))
    params, state = free_atoms(L * np.eye(3), coords, eps=100.0, sig=3.2,
                               dtype=jnp.dtype(dtype))
    cfg = RunConfig(ensemble="npt", coulomb="none", dtype=dtype,
                    pair_chunk=32, ortho_box=True)
    thermo = Thermo.make(temperature=200.0, pressure=50.0,
                         volume_probability=pv, volume_change_factor=0.1,
                         move_factor=0.7, rot_factor=0.3, n_species=1,
                         dtype=jnp.dtype(dtype))
    return params, state, cfg, thermo


def hcl_npt(n_mol=6, pv=0.2, dtype="float64"):
    """A frameless charged rigid-molecule fluid under Ewald with a derived
    cutoff (rc = L/2, alpha = 3.5/rc and the k-vectors all move with the
    box): n_mol two-site HCl molecules (+-0.2 e) in a 12 A box, 250 K,
    300 atm (reference objects)."""
    sp = Species(name="hcl", atom_names=("H", "Cl"),
                 pos=np.array([[0, 0, 0], [1.3, 0, 0]]),
                 mass=np.array([1.0, 35.5]), charge=np.array([0.2, -0.2]),
                 polar=np.zeros(2), eps=np.array([20.0, 120.0]),
                 sig=np.array([2.5, 3.4]))
    params, state = build_system(12.0 * np.eye(3), species=(sp,),
                                 capacity=(n_mol,), initial_counts=(n_mol,),
                                 dtype=jnp.dtype(dtype), seed=7)
    cfg = RunConfig(ensemble="npt", coulomb="ewald", dtype=dtype,
                    ewald_kmax=5, pair_chunk=32, ortho_box=True)
    thermo = Thermo.make(temperature=250.0, pressure=300.0,
                         volume_probability=pv, volume_change_factor=0.08,
                         move_factor=0.6, rot_factor=0.8, n_species=1,
                         dtype=jnp.dtype(dtype))
    return params, state, cfg, thermo


def ideal_npt(n=15, T=300.0, p_atm=80.0, pv=0.5, seed=9, dtype="float64"):
    """The ideal gas of tests/test_mc.py::test_npt_ideal_gas_volume: n
    non-interacting atoms started at the expected volume (n + 1) kT / P;
    returns (reference objects, expected volume)."""
    from mpmc_tpu.constants import ATM2K_A3
    expect_v = (n + 1) * T / (p_atm * ATM2K_A3)
    L0 = expect_v ** (1 / 3)
    coords = np.random.default_rng(seed).uniform(0, L0, (n, 3))
    params, state = free_atoms(L0 * np.eye(3), coords, eps=0.0, sig=0.0,
                               dtype=jnp.dtype(dtype))
    cfg = RunConfig(ensemble="npt", rd_potential="none", coulomb="none",
                    rd_lrc=False, dtype=dtype, ortho_box=True)
    thermo = Thermo.make(temperature=T, pressure=p_atm,
                         volume_probability=pv, volume_change_factor=0.2,
                         move_factor=1.0, rot_factor=0.1, n_species=1,
                         dtype=jnp.dtype(dtype))
    return (params, state, cfg, thermo), expect_v


def port(j):
    """(reference objects initialized, port P, S, C, T initialized)."""
    params, state, cfg, thermo = j
    state = jm.initialize(state, params, cfg, thermo)
    P, S, C, T = convert.from_jax(params, state, cfg, thermo)
    return (params, state, cfg, thermo), P, tm.initialize(S, P, C, T), C, T


def table(K, seed=1, C=None):
    """A numpy-seeded uniform table: [K, 16], or [C, K, 16]."""
    shape = (K, 16) if C is None else (C, K, 16)
    return torch.as_tensor(np.random.default_rng(seed).random(shape))


def with_cfg(j, **kw):
    params, state, cfg, thermo = j
    return params, state, dataclasses.replace(cfg, **kw), thermo


def write_deck(tmp_path, j, *lines, name="npt"):
    """The port's state of reference system ``j`` written with
    io/pqr.write_state and an NPT deck of its thermo; returns the deck."""
    from mpmc_tpu_torch.io import pqr as tpqr
    params, state, cfg, thermo = j
    P, S, C, T = convert.from_jax(params, state, cfg, thermo)
    tpqr.write_state(str(tmp_path / f"{name}.pqr"), P, S, ["M"])
    L = float(S.box[0, 0])
    deck = tmp_path / f"{name}.inp"
    deck.write_text("\n".join([
        "ensemble npt", "seed 3", f"temperature {float(T.temperature)}",
        f"pressure {float(T.pressure)}",
        f"volume_probability {float(T.volume_probability)}",
        f"volume_change_factor {float(T.volume_change_factor)}",
        f"move_factor {float(T.move_factor)}",
        f"rot_factor {float(T.rot_factor)}",
        f"basis1 {L!r} 0 0", f"basis2 0 {L!r} 0", f"basis3 0 0 {L!r}",
        f"precision {cfg.dtype}", f"pqr_input {name}.pqr",
        "pqr_restart restart.pqr", *lines]) + "\n")
    return deck
