"""Lennard-Jones repulsion-dispersion: mixing rules, pair energy and the
long-range tail (port of the parts of mpmc_tpu/ops/lj.py the GCMC slice
runs; Feynman-Hibbs/Kleinert are refused at setup).

All inputs/outputs in MPMC units (K, A).  Elementwise over tensors of any
shape — callers apply masks.
"""
from __future__ import annotations

import math

import torch


def mix(eps_i, eps_j, sig_i, sig_j, rule="lb"):
    """Combine per-atom LJ parameters into pair parameters."""
    if rule == "lb":
        return torch.sqrt(eps_i * eps_j), 0.5 * (sig_i + sig_j)
    if rule == "waldman_hagler":
        s6i, s6j = sig_i ** 6, sig_j ** 6
        denom = torch.clamp(s6i + s6j, min=1e-300)
        sig = (0.5 * denom) ** (1.0 / 6.0)
        eps = torch.sqrt(eps_i * eps_j) * (2.0 * sig_i ** 3 * sig_j ** 3
                                           / denom)
        return eps, sig
    raise ValueError(f"unknown mixing rule: {rule}")


def energy(r2, eps, sig):
    """U = 4 eps [ (sig/r)^12 - (sig/r)^6 ]  with r2 = r^2 (safe, pre-masked)."""
    s2 = sig * sig / r2
    s6 = s2 * s2 * s2
    return 4.0 * eps * s6 * (s6 - 1.0)


def tail_coefficient(eps, sig, rc):
    """Per-(ordered-)pair long-range tail coefficient T_ij, with
    U_lrc = (1/2) sum_ij T_ij / V:
      T_ij = (16 pi / 3) eps sig^3 [ (1/3)(sig/rc)^9 - (sig/rc)^3 ]."""
    src = sig / rc
    s3 = src * src * src
    s9 = s3 * s3 * s3
    return (16.0 * math.pi / 3.0) * eps * sig ** 3 * (s9 / 3.0 - s3)
