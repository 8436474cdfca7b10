"""Carry a system built by the JAX package over to the port.

``from_jax`` reads every field of the reference's dataclasses through
``np.asarray`` — so this module never imports jax — and returns the
port's objects with the same values on ``device``.  The tests use it so
that both packages compute on one system.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.state import EnergyBreakdown, Params, SimState


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def config_from(cfg) -> RunConfig:
    """The port's RunConfig with the same field values."""
    return RunConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(RunConfig)})


def _energy(e, device):
    if e is None:
        return None
    return EnergyBreakdown(**{k: _tensor(getattr(e, k), device)
                              for k in ("rd", "lrc", "es_real", "es_recip",
                                        "es_self", "es_excl", "polar",
                                        "vdw")})


def from_jax(params, state, cfg, thermo, device="cpu"):
    """(Params, SimState, RunConfig, Thermo) of the port with the values
    of the reference's objects.  Fields the port's slice does not carry
    (PRNG key, caches of options outside the slice) are dropped.  A
    stacked state (the reference's multichain.stack_states) comes across
    with its leading chain axis on every tensor; its step is chain 0's
    (the chains advance in lockstep)."""
    p = Params(**{f.name: _tensor(getattr(params, f.name), device)
                  for f in dataclasses.fields(Params) if f.init})
    sk = (lambda x: None if x is None else _tensor(x, device))
    s = SimState(
        pos=_tensor(state.pos, device), box=_tensor(state.box, device),
        mol_alive=_tensor(state.mol_alive, device),
        energy=_energy(state.energy, device),
        step=int(np.asarray(state.step).reshape(-1)[0]),
        sk_re=sk(state.sk_re), sk_im=sk(state.sk_im),
        e_frozen=_energy(state.e_frozen, device), mu=sk(state.mu),
        e0=sk(state.e0), r_pol=sk(state.r_pol),
        cavity_open=sk(getattr(state, "cavity_open", None)),
        tmmc_c=sk(getattr(state, "tmmc_c", None)),
        spin=(None if getattr(state, "spin", None) is None
              else sk(state.spin).to(torch.int32)),
        rot_f=sk(getattr(state, "rot_f", None)))
    t = Thermo(**{f.name: (None if getattr(thermo, f.name, None) is None
                           else _tensor(getattr(thermo, f.name), device))
                  for f in dataclasses.fields(Thermo)})
    return p, s, config_from(cfg), t
