"""Coupled-dipole many-body van der Waals, ``cdvdw`` (port of
mpmc_tpu/ops/vdw.py).

Every polarizable site with a Drude frequency is a quantum Drude
oscillator of polarizability alpha_i [A^3] and frequency omega_i [a.u.]
(the PQR omega column); the dipole-coupled normal modes give

    E_vdw = (hbar/2) [ sum_k omega_k  -  3 sum_i omega_i ],

omega_k^2 the eigenvalues of the 3P x 3P matrix

    M_(ia)(jb) = omega_i^2 delta_ij delta_ab
                 - omega_i omega_j sqrt(alpha_i alpha_j) T_(ia)(jb),

T the damped, cut-off dipole tensor of the polarization model
(thole.dipole_tensor).  The sites are fixed when the system is built
(``params.vdw_sites``: alpha > 0 and omega > 0), so the matrix keeps its
shape; a dead site decouples (its block is omega_i^2 and its modes cancel
its free term).  The eigensolve is torch.linalg.eigvalsh, as the
reference's is jnp.linalg.eigvalsh outside any kernel; over a leading
chain axis it is one batched eigensolve.
"""
from __future__ import annotations

import torch

from mpmc_tpu_torch.constants import HARTREE_K
from mpmc_tpu_torch.ops import thole


def vdw_energy(pos, box, atom_alive, params, cfg):
    """Many-body dispersion energy [K], 0 without eligible sites.  Over
    chains: ``pos`` [C, N, 3], ``atom_alive`` [C, N] and a shared or
    per-chain ``box`` give [C]."""
    sites = params.vdw_sites
    lead = pos.shape[:-2]
    if sites is None or sites.shape[0] == 0:
        return torch.zeros(lead, dtype=pos.dtype, device=pos.device)
    p = pos[..., sites, :]
    alpha = params.polar[sites]
    omega = params.omega[sites]
    ok = atom_alive[..., sites]
    P = sites.shape[0]
    t = thole.dipole_tensor(p, box, ok, cfg)               # [..., P,P,3,3]
    scale = (omega[:, None] * omega[None, :]
             * torch.sqrt(alpha[:, None] * alpha[None, :]))
    m = -scale[..., None, None] * t                        # coupling blocks
    m = m.transpose(-3, -2).reshape(lead + (3 * P, 3 * P))
    m = m + torch.diag(torch.repeat_interleave(omega * omega, 3))
    lam = torch.linalg.eigvalsh(m)
    coupled = torch.sum(torch.sqrt(torch.clamp(lam, min=0.0)), dim=-1)
    free = 3.0 * torch.sum(omega)       # dead sites cancel exactly
    return (0.5 * HARTREE_K * (coupled - free)).to(pos.dtype)
