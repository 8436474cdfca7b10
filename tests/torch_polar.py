"""Shared set-up of the port's polarization tests (tests/test_torch_thole*.py,
tests/test_torch_polar_mc.py and tests/test_torch_pda.py): the polar MOF +
H2 system built and initialized by the JAX package and carried over to the
port, a small polar GCMC deck, a random site cloud, and a skewed cell."""
import dataclasses

import numpy as np
import torch

from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.models import systems as jsystems
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.io import input_script, pqr
from mpmc_tpu_torch.models import systems as tsystems


def to_np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def mof_polar(n_side=3, n_h2=6, capacity=12, **cfg_kw):
    """The polar MOF + H2 system in float64, initialized by JAX (e0, mu
    and r_pol set), and its conversion to the port."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=n_side, n_h2=n_h2,
                                      capacity=capacity, polarization=True,
                                      dtype="float64")
    c = dataclasses.replace(c, use_pallas=False, **cfg_kw)
    s = jm.initialize(s, p, c, t)
    return (p, s, c, t), convert.from_jax(p, s, c, t)


def polar_deck(tmp_path, extra="", numsteps=200, precision="float64"):
    """A small polar GCMC deck (the MOF + H2 system, n_side 3) written to
    tmp_path; returns the parsed Job."""
    params, state, _, _ = tsystems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True, device="cpu")
    pqr.write_state(str(tmp_path / "polar.pqr"), params, state, ["H2"])
    L = float(state.box[0, 0])
    text = (f"ensemble uvt\nnumsteps {numsteps}\ncorrtime 100\nseed 3\n"
            f"temperature 77\npressure 20.0\nbasis1 {L} 0 0\n"
            f"basis2 0 {L} 0\nbasis3 0 0 {L}\ninsert_probability 0.5\n"
            "cavity_autoreject_absolute 1.0\nmax_molecules 12\n"
            "allow_charged_cell on\npolarization on\n"
            f"precision {precision}\n"
            f"pqr_input {tmp_path / 'polar.pqr'}\n"
            f"pqr_restart {tmp_path / 'restart.pqr'}\n" + extra)
    (tmp_path / "deck.inp").write_text(text)
    return input_script.parse_file(str(tmp_path / "deck.inp"))


def cloud(n=300, L=20.0, seed=0):
    """Random sites in 3-site molecules: positions, ok mask, charges and
    dipoles (zero where not ok), molecule ids, and the box length."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, L, (n, 3))
    ok = rng.uniform(size=n) > 0.15
    q = rng.normal(size=n) * 0.3
    mu = np.where(ok[:, None], rng.normal(size=(n, 3)) * 0.01, 0.0)
    return pos, ok, q, mu, np.arange(n) // 3, L


def cell(L, skewed):
    """An orthorhombic cell of edge L, or a skewed one."""
    box = np.eye(3) * L
    if skewed:
        box[1, 0], box[2, 0], box[2, 1] = 0.21 * L, -0.13 * L, 0.17 * L
    return box
