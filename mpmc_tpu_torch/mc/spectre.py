"""SPECTRE: the massive-polarizability free-charge treatment (port of
mpmc_tpu/mc/spectre.py).

- PQR atoms flagged ``S`` are spectre sites: mobile point charges (the
  infinite-polarizability limit of an induced dipole is a free charge),
  moved by the ordinary displacement moves like any movable molecule.
- At every corrtime boundary their charges are renormalized: each |q_i|
  clamped to ``spectre_max_charge``, then, when ``spectre_max_target`` >
  0, the set's sum_i |q_i| rescaled onto that target (and clamped again).

The full refresh that follows (metropolis.initialize, with the frozen
reuse off under spectre: frozen_refresh_rows) rebuilds every
charge-dependent cache — S(k), the self and exclusion terms, e_frozen —
and the kernels read the charge column anew at every launch, so the
renormalization keeps no bookkeeping of its own.  The run applies it
between a chunk and its refresh (mc/run.py), and nothing composes the
two, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch


def spectre_atom_indices(params, spectre_species) -> np.ndarray:
    """Atom-slot indices of every molecule of a spectre species."""
    if not spectre_species:
        return np.zeros(0, np.int64)
    mol_sp = params.mol_species.cpu().numpy()
    atom_sp = mol_sp[params.mol_id.cpu().numpy()]
    ok = np.isin(atom_sp, np.asarray(list(spectre_species)))
    ok &= params.atom_ok.cpu().numpy()
    return np.nonzero(ok)[0]


def renormalize_charges(q, idx, max_charge: float, max_target: float):
    """Clamp each spectre |q| to max_charge, then rescale the set onto
    sum|q| = max_target (if a positive target is set); a float64 copy."""
    q = np.array(q, np.float64, copy=True)
    if len(idx) == 0:
        return q
    qs = np.clip(q[idx], -max_charge, max_charge)
    if max_target > 0.0:
        total = np.sum(np.abs(qs))
        if total > 1e-30:
            qs = qs * (max_target / total)
            qs = np.clip(qs, -max_charge, max_charge)
    q[idx] = qs
    return q


def apply(params, spectre_idx: np.ndarray, cfg):
    """The per-corrtime renormalization: ``params`` with the updated
    charge column (its device and type)."""
    q = renormalize_charges(params.charge.cpu().numpy(), spectre_idx,
                            cfg.spectre_max_charge, cfg.spectre_max_target)
    return params.replace(charge=torch.as_tensor(
        q, dtype=params.charge.dtype, device=params.charge.device))


def observables(params, spectre_idx) -> dict:
    """The block observables of the spectre sites: sum |q| and max |q|
    (the reference's ``spectre_total_charge`` / ``spectre_max_abs_charge``);
    {} without sites."""
    if spectre_idx is None or not len(spectre_idx):
        return {}
    qs = np.abs(params.charge.cpu().numpy().astype(np.float64)[spectre_idx])
    return {"spectre_total_charge": float(np.sum(qs)),
            "spectre_max_abs_charge": float(np.max(qs))}
