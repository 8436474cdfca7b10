"""Lennard-Jones repulsion-dispersion: mixing rules, pair energy, analytic
derivatives, the Feynman-Hibbs and Feynman-Kleinert quantum corrections,
and the long-range tail (port of mpmc_tpu/ops/lj.py).

  U_FH2 = (hbar^2 beta / 24 mu) (V'' + 2 V'/r),
  U_FH4 = (hbar^4 beta^2 / 1152 mu^2) (15 V'/r^3 + 4 V'''/r + V''''),

with mu the reduced mass of the two interacting *molecules*; FK is the
variational effective potential W - V of feynman_kleinert_from_derivs.

All inputs/outputs in MPMC units (K, A, amu).  Elementwise over tensors of
any shape — callers apply masks.
"""
from __future__ import annotations

import math

import torch

from mpmc_tpu_torch.constants import HBAR2_KB_AMU_A2


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


def derivatives(r, eps, sig):
    """Analytic dV/dr .. d4V/dr4 of 12-6 LJ (for Feynman-Hibbs/Kleinert)."""
    sr = sig / r
    s6 = sr ** 6
    s12 = s6 * s6
    inv = 1.0 / r
    v1 = 4.0 * eps * (-12.0 * s12 + 6.0 * s6) * inv
    v2 = 4.0 * eps * (156.0 * s12 - 42.0 * s6) * inv * inv
    v3 = 4.0 * eps * (-2184.0 * s12 + 336.0 * s6) * inv ** 3
    v4 = 4.0 * eps * (32760.0 * s12 - 3024.0 * s6) * inv ** 4
    return v1, v2, v3, v4


def feynman_hibbs(r, eps, sig, red_mass, temperature, order=2):
    """FH quantum correction to the LJ pair energy (order 2 or 4)."""
    v1, v2, v3, v4 = derivatives(r, eps, sig)
    m = torch.clamp(red_mass, min=1e-30)
    c2 = HBAR2_KB_AMU_A2 / (24.0 * temperature * m)
    u = c2 * (v2 + 2.0 * v1 / r)
    if order >= 4:
        c4 = (HBAR2_KB_AMU_A2 * HBAR2_KB_AMU_A2
              / (1152.0 * temperature * temperature * m * m))
        u = u + c4 * (15.0 * v1 / r ** 3 + 4.0 * v3 / r + v4)
    return u


def _ln_sinhc(x):
    """ln(sinh x / x) for x in [0, inf), in the exp/log-only form the
    fused kernels compute (sinh x = e^x (1 - e^-2x) / 2): the x >= 40
    limit x - ln 2x falls out (e^-80 underflows to 0); below x = 0.1 the
    two-term series, exact to x^6/2835, replaces 1 - e^-2x, whose float32
    rounding would swamp the signal."""
    small = x * x / 6.0 - x ** 4 / 180.0
    big = (x - torch.log(2.0 * torch.clamp(x, min=1e-30))
           + torch.log(torch.clamp(1.0 - torch.exp(-2.0 * x), min=1e-30)))
    return torch.where(x < 0.1, small, big)


def _xcothx_m1(x):
    """x coth x - 1 for x in [0, inf), exp-only and returned as the
    difference, so the x^2/3-scale signal is never rounded against 1.0:
    the series below x = 0.1 (error ~2 x^6/945), above it (x(1+e) -
    (1-e))/(1-e) with e = e^-2x."""
    e = torch.exp(-2.0 * torch.clamp(x, min=0.1))
    return torch.where(x < 0.1, x * x / 3.0 - x ** 4 / 45.0,
                       (x * (1.0 + e) - (1.0 - e)) / (1.0 - e))


def _xcothx(x):
    """x coth x (see _xcothx_m1)."""
    return 1.0 + _xcothx_m1(x)


def feynman_kleinert_from_derivs(r, v1, v2, v3, v4, red_mass, temperature,
                                 n_iter=8):
    """Feynman-Kleinert variational effective-potential correction W - V
    of a radial pair potential from its derivatives at r (Feynman and
    Kleinert, Phys. Rev. A 34, 5080 (1986)): the pair's relative
    coordinate (reduced mass mu) in an isotropic 3D harmonic trial,

        W(r) = 3 T ln[sinh x / x] + V_a2(r) - (3/2) mu W2 a2,
        x = hbar Omega / (2 kB T),
        a2(Omega) = (T / (mu W2)) [x coth x - 1]     (per component),
        W2 = Omega^2 = (1/3mu) lap V_a2(r)           (self-consistent),

    with the Gaussian-smeared potential to quartic order in the width,
    V_a2 = V + (a2/2) lap V + (a4/8) lap^2 V, lap V = V'' + 2 V'/r and
    lap^2 V = V'''' + 4 V'''/r, solved by ``n_iter`` fixed-point rounds.
    Where the smeared curvature is negative the trial frequency is
    clamped to ~0, which gives the Feynman-Hibbs width hbar^2/(12 mu kB
    T)."""
    m = torch.clamp(red_mass, min=1e-30)
    d2 = v2 + 2.0 * v1 / r                  # lap V      [K / A^2]
    d4 = v4 + 4.0 * v3 / r                  # lap^2 V    [K / A^4]
    t = temperature
    # x^2 = (hbar Omega / 2 kB T)^2 = HBAR2_KB_AMU_A2 y / (4 T^2), with
    # y = Omega^2 in K / (amu A^2)
    c_x2 = HBAR2_KB_AMU_A2 / (4.0 * t * t)
    y_min = 1e-12
    a2 = torch.zeros_like(r)
    y = torch.clamp(d2 / (3.0 * m), min=y_min)
    for _ in range(n_iter):
        x = torch.sqrt(c_x2 * y)
        # a2 = (T/(mu y)) [x coth x - 1]; the y -> 0 limit hbar^2/(12 mu T)
        a2 = torch.where(y > y_min, t / (m * y) * _xcothx_m1(x),
                         HBAR2_KB_AMU_A2 / (12.0 * m * t))
        y = torch.clamp((d2 + 0.5 * a2 * d4) / (3.0 * m), min=y_min)
    x = torch.sqrt(c_x2 * y)
    dva = 0.5 * a2 * d2 + 0.125 * a2 * a2 * d4       # V_a2 - V
    return 3.0 * t * _ln_sinhc(x) + dva - 1.5 * m * y * a2


def feynman_kleinert(r, eps, sig, red_mass, temperature):
    """FK effective-potential correction W - V of the 12-6 LJ pair."""
    v1, v2, v3, v4 = derivatives(r, eps, sig)
    return feynman_kleinert_from_derivs(r, v1, v2, v3, v4, red_mass,
                                        temperature)


def tail_coefficient(eps, sig, rc):
    """Per-(ordered-)pair long-range tail coefficient T_ij, with
    U_lrc = (1/2) sum_ij T_ij / V:
      T_ij = (16 pi / 3) eps sig^3 [ (1/3)(sig/rc)^9 - (sig/rc)^3 ]."""
    src = sig / rc
    s3 = src * src * src
    s9 = s3 * s3 * s3
    return (16.0 * math.pi / 3.0) * eps * sig ** 3 * (s9 / 3.0 - s3)
