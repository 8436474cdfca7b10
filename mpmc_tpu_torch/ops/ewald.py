"""Ewald summation: reciprocal-space, self, background and Wolf terms
(port of mpmc_tpu/ops/ewald.py).

    U_recip = ke * (2 pi / V) sum_{k != 0} w_k exp(-k^2/4a^2)/k^2 |S(k)|^2
    S(k)    = sum_i alive_i q_i exp(i k . r_i)
    U_self  = -ke * a/sqrt(pi) * sum_i alive_i q_i^2

k-vectors come from a static integer half-space table (|n| <= kmax,
weight 2).  The phase k.r is computed elementwise — three multiplies and
adds per (atom, k) — so no matmul (and no TF32) touches coordinates.
The cached S(k) makes the per-move update O(A * Nk).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mpmc_tpu_torch.constants import KE


@functools.lru_cache(maxsize=None)
def half_space_ints(kmax: int):
    """Static integer k-vector table: one of each +/-n pair, |n|<=kmax, n!=0."""
    rng = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    n2 = (n * n).sum(1)
    sphere = (n2 > 0) & (n2 <= kmax * kmax)
    half = ((n[:, 0] > 0)
            | ((n[:, 0] == 0) & (n[:, 1] > 0))
            | ((n[:, 0] == 0) & (n[:, 1] == 0) & (n[:, 2] > 0)))
    return np.ascontiguousarray(n[sphere & half], dtype=np.float64)


def kvectors(box, kmax: int):
    """[Nk,3] reciprocal vectors for the current box; [C, Nk, 3] for
    stacked boxes [C, 3, 3] (the integer k-set depends on kmax alone, so
    every chain has the same Nk and only the vectors differ).  The inverse
    skips linalg.inv's singularity check, a host sync on the card."""
    ints = torch.as_tensor(half_space_ints(kmax), dtype=box.dtype,
                           device=box.device)
    recip = 2.0 * math.pi * torch.linalg.inv_ex(box).inverse.transpose(-1,
                                                                       -2)
    return _phase(ints, recip.transpose(-1, -2))


def _phase(rows, kvecs):
    """[..., R, Nk] k . r, elementwise (rows [..., R, 3], kvecs [Nk,3] or
    one set per chain [C, Nk, 3] against rows [C, R, 3])."""
    return (rows[..., :, None, 0] * kvecs[..., None, :, 0]
            + rows[..., :, None, 1] * kvecs[..., None, :, 1]
            + rows[..., :, None, 2] * kvecs[..., None, :, 2])


def structure_factor(pos, charge, alive, kvecs, chunk=4096):
    """S(k) = sum_i alive_i q_i e^{i k.r_i} -> (re, im), each [Nk].
    Row-chunked so the [rows, Nk] phase block stays small at 10k atoms."""
    q = torch.where(alive, charge, torch.zeros_like(charge))
    re = torch.zeros(kvecs.shape[0], dtype=pos.dtype, device=pos.device)
    im = torch.zeros_like(re)
    for i0 in range(0, pos.shape[0], chunk):
        ph = _phase(pos[i0:i0 + chunk], kvecs)
        qc = q[i0:i0 + chunk, None]
        re = re + torch.sum(qc * torch.cos(ph), dim=0)
        im = im + torch.sum(qc * torch.sin(ph), dim=0)
    return re, im


def mol_structure_factor(pos_rows, charge_rows, row_ok, kvecs):
    """Partial S(k) from one molecule's atoms (for delta updates); with a
    leading chain dimension on every argument, ``kvecs`` shared [Nk, 3]
    or per chain [C, Nk, 3], one per chain ([C, Nk])."""
    q = torch.where(row_ok, charge_rows, torch.zeros_like(charge_rows))
    ph = _phase(pos_rows, kvecs)                 # [..., A, Nk]
    return (torch.sum(q[..., :, None] * torch.cos(ph), dim=-2),
            torch.sum(q[..., :, None] * torch.sin(ph), dim=-2))


def recip_weights(box, alpha, kvecs, pair_w=2.0):
    """(prefactor, [Nk] weights) of U_recip = prefactor * sum w |S|^2 —
    fixed for a fixed box, so the MC step computes them once per chunk
    (the determinant is a LAPACK call, not a per-move op) and after each
    NPT volume attempt.  Stacked boxes [C, 3, 3], ``alpha`` [C] and
    ``kvecs`` [C, Nk, 3] give ([C], [C, Nk])."""
    v = torch.abs(torch.linalg.det(box))
    k2 = torch.sum(kvecs * kvecs, dim=-1)
    k2s = torch.where(k2 > 1e-12, k2, torch.ones_like(k2))
    w = pair_w * torch.exp(-k2 / (4.0 * alpha * alpha)[..., None]) / k2s
    return KE * (2.0 * math.pi / v), w


def recip_energy_w(sk_re, sk_im, pref, w):
    """U_recip from a structure factor and recip_weights ([C] for
    structure factors [C, Nk])."""
    return pref * torch.sum(w * (sk_re * sk_re + sk_im * sk_im), dim=-1)


def recip_energy_from_sk(sk_re, sk_im, box, alpha, kvecs, pair_w=2.0):
    """U_recip from a cached structure factor (half-space table: each
    entry stands for +/-k, pair weight 2)."""
    return recip_energy_w(sk_re, sk_im,
                          *recip_weights(box, alpha, kvecs, pair_w))


def recip_energy(pos, charge, alive, box, alpha, kmax: int):
    """Full reciprocal-space energy + structure factor."""
    kv = kvectors(box, kmax)
    sk_re, sk_im = structure_factor(pos, charge, alive, kv)
    return recip_energy_from_sk(sk_re, sk_im, box, alpha, kv), (sk_re, sk_im)


def self_energy(charge, alive, alpha):
    q2 = torch.where(alive, charge * charge, torch.zeros_like(charge))
    return -KE * alpha / math.sqrt(math.pi) * torch.sum(q2)


def background_coefficient(alpha, volume):
    """c_bg such that the uniform-background (jellium) correction for a
    non-neutral cell is E_bg = c_bg * Q_tot^2; zero effect when neutral."""
    return -KE * math.pi / (2.0 * alpha * alpha * volume)


def background_correction(charge, alive, alpha, volume):
    """E_bg = -ke pi Q^2/(2 alpha^2 V), Q = net ALIVE charge."""
    q_tot = torch.sum(torch.where(alive, charge, torch.zeros_like(charge)))
    return background_coefficient(alpha, volume) * q_tot * q_tot


def wolf_self_energy(charge, alive, alpha, rc):
    """Wolf self/shift term:
    U_self = -ke (erfc(a rc)/(2 rc) + a/sqrt(pi)) sum q_i^2."""
    q2 = torch.where(alive, charge * charge, torch.zeros_like(charge))
    return -KE * (torch.special.erfc(alpha * rc) / (2.0 * rc)
                  + alpha / math.sqrt(math.pi)) * torch.sum(q2)
