"""Repulsion-dispersion forms beyond LJ (port of mpmc_tpu/ops/potentials.py
without london_c6 and the cdvdw repulsions): Silvera-Goldman ``sg``,
Dreiding exp-6 ``dreiding``, Halgren's buffered 14-7 ``b14_7`` and the
Born-Mayer + damped C6/C8/C10 dispersion expansion ``disp_expansion``
(the PHAHST family), with the expansion's long-range tail.

Parameter columns, as the reference documents them:

- ``sg``            : no parameters (H2-H2, Silvera & Goldman 1978,
                      Hartree/bohr converted to K/A);
- ``dreiding``      : eps = well depth D0 [K], sig = r0 [A]; zeta 13.772;
                      D0 geometric, r0 arithmetic mean;
- ``b14_7``         : eps [K], sig = r0 [A]; delta 0.07, gamma 0.12,
                      Halgren's mixing rules;
- ``disp_expansion``: eps = Born-Mayer prefactor A [K], sig = exponent B
                      [1/A], C6/C8/C10 in K A^2n; A geometric, B harmonic,
                      C2n geometric mean; Tang-Toennies damping f_2n(B r)
                      under ``damp_dispersion``.

Integer powers follow the reference's (jax's integer_pow: repeated
squaring, ``_ipow``); a real power is ``torch.pow``.  Every function takes
broadcastable tensors; the plain pair passes (ops/pairs.py) and, formula
for formula, the kernels (csrc/pair_kernel.cuh) compute these.
"""
from __future__ import annotations

import math

import torch

from mpmc_tpu_torch.constants import BOHR_A, HARTREE_K

# the RD forms of this module (pairs._tile_values' generic branch)
FORMS = ("sg", "dreiding", "b14_7", "disp_expansion")

# Silvera-Goldman constants (atomic units; Silvera & Goldman, JCP 69, 4209
# (1978)), the isotropic H2-H2 pair potential
_SG_ALPHA = 1.713
_SG_BETA = 1.5671
_SG_GAMMA = 0.00993
_SG_C6 = 12.14
_SG_C8 = 215.2
_SG_C9 = 143.1
_SG_C10 = 4813.9
_SG_RC = 8.32   # bohr, the damping's onset (1.28 r_min)
DREIDING_ZETA = 13.772


def _ipow(x, n):
    """x ** n for an integer n >= 1 by repeated squaring, in the order of
    jax's integer_pow (x^7 = (x x^2) x^4)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def sg_energy(r_ang):
    """Silvera-Goldman H2-H2 potential, r in A, in K.  r is floored at
    0.3 bohr (0.16 A): below it the dispersion sum overflows float32 while
    the damping underflows to 0, and 0 x inf = NaN would poison a sum; the
    floor makes that region a constant ~1.1e6 K plateau, the same in
    every path."""
    r = torch.clamp(r_ang, min=0.3 * BOHR_A) / BOHR_A
    rep = torch.exp(_SG_ALPHA - _SG_BETA * r - _SG_GAMMA * r * r)
    r2 = r * r
    r6 = r2 * r2 * r2
    disp = (_SG_C6 / r6 + _SG_C8 / (r6 * r2) + _SG_C10 / (r6 * r2 * r2)
            - _SG_C9 / (r6 * r2 * r))
    fc = torch.where(r < _SG_RC, torch.exp(-_ipow(_SG_RC / r - 1.0, 2)),
                     torch.ones_like(r))
    return (rep - fc * disp) * HARTREE_K


def dreiding_energy(r, d0, r0, zeta=DREIDING_ZETA):
    """Dreiding exponential-6: D0 [(6/(z-6)) e^{z(1-p)} - (z/(z-6)) p^-6],
    p = r / r0."""
    p = r / r0
    a = 6.0 / (zeta - 6.0)
    b = zeta / (zeta - 6.0)
    return d0 * (a * torch.exp(zeta * (1.0 - p)) - b * p ** (-6.0))


def b14_7_energy(r, eps, r0, delta=0.07, gamma=0.12):
    """Halgren buffered 14-7: eps ((1+d)/(p+d))^7 ((1+g)/(p^7+g) - 2)."""
    p = r / r0
    t = _ipow((1.0 + delta) / (p + delta), 7)
    return eps * t * ((1.0 + gamma) / (_ipow(p, 7) + gamma) - 2.0)


def tt_damping(x, n):
    """Tang-Toennies damping f_n(x) = 1 - e^-x sum_{k<=n} x^k / k!."""
    s = torch.ones_like(x)
    term = torch.ones_like(x)
    for k in range(1, n + 1):
        term = term * x / k
        s = s + term
    return 1.0 - torch.exp(-x) * s


def disp_expansion_energy(r, a_ij, b_ij, c6, c8, c10, damp=True):
    """Born-Mayer repulsion + (damped) C6/C8/C10 dispersion."""
    rep = a_ij * torch.exp(-b_ij * r)
    r2 = r * r
    r6 = r2 * r2 * r2
    x = b_ij * r
    f6 = tt_damping(x, 6) if damp else 1.0
    f8 = tt_damping(x, 8) if damp else 1.0
    f10 = tt_damping(x, 10) if damp else 1.0
    return (rep - f6 * c6 / r6 - f8 * c8 / (r6 * r2)
            - f10 * c10 / (r6 * r2 * r2))


def disp_tail_coefficient(c6, c8, c10, rc):
    """Ordered-pair long-range tail of the dispersion expansion (the
    Born-Mayer term decays exponentially, the damping is 1 beyond any sane
    cutoff): T_ij = -4 pi [C6/(3 rc^3) + C8/(5 rc^5) + C10/(7 rc^7)];
    U_lrc = (1/2V)[2 sum_{i<j} T_ij + sum_i T_ii], as lj.tail_coefficient."""
    rc3 = rc * rc * rc
    rc5 = rc3 * rc * rc
    rc7 = rc5 * rc * rc
    return -4.0 * math.pi * (c6 / (3.0 * rc3) + c8 / (5.0 * rc5)
                             + c10 / (7.0 * rc7))


def disp_mix(ci, cj):
    """The geometric mean of a dispersion coefficient, sqrt(max(ci cj, 0))."""
    return torch.sqrt(torch.clamp(ci * cj, min=0.0))


def rd_pair_energy_generic(r, ei, ej, si, sj, c6i, c6j, c8i, c8j, c10i,
                           c10j, cfg):
    """The RD pair energies of FORMS from broadcastable per-side columns,
    with each form's mixing rules (module docstring)."""
    if cfg.rd_potential == "sg":
        return sg_energy(r)
    if cfg.rd_potential == "dreiding":
        d0 = torch.sqrt(ei * ej)
        r0 = torch.clamp(0.5 * (si + sj), min=1e-6)
        return dreiding_energy(r, d0, r0)
    if cfg.rd_potential == "b14_7":
        r0 = ((_ipow(si, 3) + _ipow(sj, 3))
              / torch.clamp(_ipow(si, 2) + _ipow(sj, 2), min=1e-12))
        se = _ipow(torch.sqrt(ei) + torch.sqrt(ej), 2)
        eps = 4.0 * ei * ej / torch.clamp(se, min=1e-12)
        return b14_7_energy(r, eps, torch.clamp(r0, min=1e-6))
    if cfg.rd_potential == "disp_expansion":
        a_ij = torch.sqrt(torch.clamp(ei * ej, min=0.0))
        b_ij = 2.0 * si * sj / torch.clamp(si + sj, min=1e-12)
        return disp_expansion_energy(
            r, a_ij, b_ij, disp_mix(c6i, c6j), disp_mix(c8i, c8j),
            disp_mix(c10i, c10j), cfg.damp_dispersion)
    raise ValueError(cfg.rd_potential)
