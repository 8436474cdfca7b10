"""Exact checkpoint/resume (port of mpmc_tpu/io/checkpoint.py): the whole
simulation state, the running averages and the random stream.

A PQR restart file keeps positions only, so a run resumed from it starts
its averages from zero and draws new random numbers.  A checkpoint keeps
every tensor of ``SimState`` — positions, box, alive mask, the carried
energies and the frozen part, the Ewald structure factor, the polar
dipoles, static field and residual — with the step counter, the
``Averages`` samples and the state of the ``torch.Generator`` the run
draws its uniform tables from.  The reference carries its PRNG key inside
the state; the port's MC loops draw from one generator, so resuming it is
part of resuming the state: a resumed run is bit-identical to an
uninterrupted one wherever the run itself is deterministic.

Format: one ``torch.save`` file — a dict of plain values and CPU tensors
(read back with ``weights_only=True``) — written to a temporary name and
renamed, so an interrupted save never leaves a partial file.  A stacked
state (``chains N``, the campaign) saves the same way with its leading
chain axis.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from mpmc_tpu_torch.state import EnergyBreakdown, SimState
from mpmc_tpu_torch.utils.averages import Averages

FORMAT_VERSION = 1
_SLOTS = tuple(f.name for f in dataclasses.fields(EnergyBreakdown))


def _leaves(state: SimState):
    """[(name, tensor or None)] of every tensor field of ``state``, the
    energy breakdowns slot by slot, in field order."""
    out = []
    for f in dataclasses.fields(SimState):
        v = getattr(state, f.name)
        if f.name == "step":
            continue
        if isinstance(v, EnergyBreakdown) or (
                v is None and f.name in ("energy", "e_frozen")):
            for k in _SLOTS:
                out.append((f"{f.name}.{k}",
                            None if v is None else getattr(v, k)))
        else:
            out.append((f.name, v))
    return out


def save(path: str, state: SimState, avgs: Optional[Averages] = None,
         extra: Optional[dict] = None,
         generator: Optional[torch.Generator] = None) -> None:
    """Write ``state`` (tensors moved to the CPU), ``avgs``' samples,
    ``extra`` (plain values) and ``generator``'s state to ``path``."""
    leaves = _leaves(state)
    payload = {
        "version": FORMAT_VERSION,
        "step": int(state.step),
        "tensors": {k: v.detach().cpu() for k, v in leaves
                    if v is not None},
        "none": [k for k, v in leaves if v is None],
        "averages": ({k: [float(x) for x in v]
                      for k, v in avgs.samples.items()}
                     if avgs is not None else None),
        "extra": extra or {},
        "generator": (generator.get_state() if generator is not None
                      else None),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str, like: SimState,
         generator: Optional[torch.Generator] = None
         ) -> Tuple[SimState, Averages, dict]:
    """(state, averages, extra) from ``path``, the tensors on ``like``'s
    device.  ``like`` is a state of the same system (built from the same
    inputs and initialized); a field present in one and absent in the
    other, or a shape or dtype that differs, raises ValueError.  With
    ``generator`` its state is set to the saved one (ValueError if the
    checkpoint holds none)."""
    z = torch.load(path, map_location="cpu", weights_only=True)
    if z.get("version") != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {z.get('version')} "
                         "unsupported")
    ref = _leaves(like)
    saved = z["tensors"]
    have = [k for k, v in ref if v is not None]
    if sorted(have) != sorted(saved):
        raise ValueError(
            f"checkpoint has {len(saved)} tensor fields; the current system "
            f"has {len(have)} ({sorted(set(saved) ^ set(have))} differ) — "
            "was it built from the same inputs?")
    vals = {}
    for k, v in ref:
        if v is None:
            vals[k] = None
            continue
        a = saved[k]
        if tuple(a.shape) != tuple(v.shape):
            raise ValueError(
                f"checkpoint field {k} shape {tuple(a.shape)} != system "
                f"{tuple(v.shape)} — capacities or species differ")
        if a.dtype != v.dtype:
            raise ValueError(f"checkpoint field {k} dtype {a.dtype} != "
                             f"system {v.dtype}")
        vals[k] = a.to(v.device)
    kw = {"step": int(z["step"])}
    for f in dataclasses.fields(SimState):
        if f.name == "step":
            continue
        if f.name in ("energy", "e_frozen"):
            slots = [vals[f"{f.name}.{k}"] for k in _SLOTS]
            kw[f.name] = (None if slots[0] is None
                          else EnergyBreakdown(*slots))
        else:
            kw[f.name] = vals[f.name]
    if generator is not None:
        if z["generator"] is None:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(z["generator"])
    avgs = Averages()
    for k, v in (z["averages"] or {}).items():
        avgs.samples[k] = list(v)
    return SimState(**kw), avgs, z["extra"]


def template_state(state: SimState, cfg, params, thermo) -> SimState:
    """A state with every cache the run carries computed (energies, the
    frozen part, S(k) under Ewald), so the saved fields do not depend on
    when the checkpoint is taken."""
    from mpmc_tpu_torch.mc import metropolis
    if state.e_frozen is None or (cfg.coulomb == "ewald"
                                  and state.sk_re is None):
        return metropolis.initialize(state, params, cfg, thermo)
    return state
