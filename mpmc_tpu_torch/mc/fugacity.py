"""Fugacity equation-of-state module.

Rebuild of the reference's fugacity layer (SURVEY.md §2 "Fugacity EoS",
src/mc/fugacity.c [C]): converts ``pressure`` [atm] into per-sorbate
fugacities for the uVT acceptance rule.  The reference uses
species-specific empirical fits (Zhou/Shaw H2, Peng-Robinson/BACK CO2,
CH4, N2 [M]); since the exact fit polynomials were unverifiable
(SURVEY.md §0), this rebuild uses the Peng-Robinson equation of state with
literature critical constants for all four species — thermodynamically
standard, accurate to a few percent over sorption-relevant conditions, and
clearly documented here as the contract.  Explicit ``fugacities``/
``user_fugacities`` bypass the EoS entirely, exactly like the reference.

Accuracy upgrade (round 2, VERDICT item 6): raw PR misrepresents the
second virial coefficient of quantum gases — for H2 at 77 K it gives
B_PR = -23.8 cm^3/mol against the measured ~-11.7, a ~2% fugacity error
already at 10 atm.  ``fugacity`` therefore rescales PR's attraction
parameter so the EoS's own low-density limit reproduces the measured
second virial coefficient:

    a_eff(T) = (b - B_lit(T)) * R * T      =>   b - a_eff/(RT) = B_lit

with B_lit(T) interpolated from the compiled measurements below
(Dymond & Smith-style compilation values).  This is exact in the
truncated-virial regime (where measured B IS the fugacity), internally
consistent at every pressure, and keeps the PR repulsive structure at
high density (H2 77 K 100 atm: phi = 0.938 vs raw PR 0.80 and the
B+C virial estimate 0.90-0.93).  Documented error band: <=0.1% where
|B P/RT| < 0.02 (H2 77 K below ~10 atm, CO2 298 K below ~4 atm); a few
percent at 100 atm where the third virial / PR shape dominates.
Outside a species' tabulated T range: pure PR.

Host-side (numpy) — runs once per (T, P) change, never inside jit.
"""
from __future__ import annotations

import dataclasses
import math

R_L_ATM_MOL_K = 0.0820573660809596


@dataclasses.dataclass(frozen=True)
class CriticalConstants:
    tc: float     # K
    pc: float     # atm
    omega: float  # acentric factor


# literature critical constants (NIST/CRC)
SPECIES = {
    "h2": CriticalConstants(tc=33.19, pc=12.96, omega=-0.216),
    "co2": CriticalConstants(tc=304.13, pc=72.81, omega=0.224),
    "ch4": CriticalConstants(tc=190.56, pc=45.39, omega=0.011),
    "n2": CriticalConstants(tc=126.19, pc=33.51, omega=0.037),
    "he": CriticalConstants(tc=5.19, pc=2.24, omega=-0.385),
    "ar": CriticalConstants(tc=150.69, pc=47.87, omega=-0.002),
}


# Second virial coefficients B(T) [cm^3/mol] — compilation values
# (Dymond & Smith / NIST-style tables; normal-H2).  Linear interpolation
# in T; outside the range the correction is skipped (pure PR).
VIRIAL_B = {
    "h2": [(30.0, -82.0), (40.0, -52.7), (50.0, -35.5), (60.0, -24.0),
           (70.0, -16.0), (80.0, -9.8), (90.0, -5.1), (100.0, -1.9),
           (110.0, 0.7), (150.0, 7.1), (200.0, 11.3), (300.0, 14.8),
           (400.0, 15.8)],
    "n2": [(75.0, -277.8), (80.0, -242.9), (100.0, -160.0),
           (125.0, -104.0), (150.0, -71.5), (200.0, -35.2),
           (250.0, -16.2), (300.0, -4.2), (400.0, 9.0), (500.0, 16.9)],
    "co2": [(220.0, -244.0), (250.0, -181.0), (273.15, -149.7),
            (298.15, -124.5), (323.0, -102.5), (373.0, -72.2),
            (423.0, -50.0), (500.0, -29.8)],
    "ch4": [(150.0, -182.0), (200.0, -105.0), (250.0, -66.4),
            (273.15, -53.4), (298.15, -42.8), (350.0, -27.0),
            (400.0, -15.3), (500.0, -0.5)],
    "ar": [(100.0, -183.5), (150.0, -86.2), (200.0, -47.4),
           (250.0, -27.9), (273.15, -21.1), (298.15, -15.8),
           (400.0, -1.0), (500.0, 7.0)],
    "he": [(20.0, -3.3), (50.0, 7.4), (77.0, 10.5), (100.0, 11.4),
           (200.0, 12.2), (300.0, 11.9), (400.0, 11.4)],
}


def second_virial(species_key: str, temperature: float):
    """Literature B(T) [L/mol] by linear interpolation, or None when the
    species/temperature is outside the compiled table."""
    tab = VIRIAL_B.get(species_key.lower())
    if tab is None or not (tab[0][0] <= temperature <= tab[-1][0]):
        return None
    for (t0, b0), (t1, b1) in zip(tab, tab[1:]):
        if temperature <= t1:
            w = (temperature - t0) / (t1 - t0)
            return (b0 + w * (b1 - b0)) * 1e-3   # cm^3 -> L
    return None


def pr_second_virial(temperature: float, crit: CriticalConstants) -> float:
    """Peng-Robinson's own B(T) = b - a(T)/(R T) [L/mol] — the exact
    low-density limit of the EoS, used to splice in the measured B."""
    tc, pc, w = crit.tc, crit.pc, crit.omega
    r = R_L_ATM_MOL_K
    kappa = 0.37464 + 1.54226 * w - 0.26992 * w * w
    alpha = (1.0 + kappa * (1.0 - math.sqrt(temperature / tc))) ** 2
    a = 0.45724 * r * r * tc * tc / pc * alpha
    b = 0.07780 * r * tc / pc
    return b - a / (r * temperature)


def _cubic_roots(a2, a1, a0):
    """Real roots of z^3 + a2 z^2 + a1 z + a0 = 0 (Cardano)."""
    q = (3 * a1 - a2 * a2) / 9.0
    r = (9 * a2 * a1 - 27 * a0 - 2 * a2 ** 3) / 54.0
    d = q ** 3 + r ** 2
    roots = []
    if d >= 0:
        s = math.copysign(abs(r + math.sqrt(d)) ** (1 / 3), r + math.sqrt(d))
        t = math.copysign(abs(r - math.sqrt(d)) ** (1 / 3), r - math.sqrt(d))
        roots.append(-a2 / 3 + s + t)
    else:
        theta = math.acos(r / math.sqrt(-q ** 3))
        m = 2 * math.sqrt(-q)
        for k in range(3):
            roots.append(m * math.cos((theta + 2 * math.pi * k) / 3)
                         - a2 / 3)
    return roots


def peng_robinson_fugacity(temperature: float, pressure: float,
                           crit: CriticalConstants,
                           a_override: float = None) -> float:
    """Fugacity [atm] of a pure gas at (T [K], P [atm]) via Peng-Robinson.
    ``a_override`` replaces the alpha-function attraction parameter
    a(T) [L^2 atm/mol^2] — used to splice the measured second virial
    coefficient into the EoS (module docstring)."""
    if pressure <= 0:
        return 0.0
    tc, pc, w = crit.tc, crit.pc, crit.omega
    tr = temperature / tc
    kappa = 0.37464 + 1.54226 * w - 0.26992 * w * w
    alpha = (1.0 + kappa * (1.0 - math.sqrt(tr))) ** 2
    r = R_L_ATM_MOL_K
    a = 0.45724 * r * r * tc * tc / pc * alpha
    if a_override is not None:
        a = a_override
    b = 0.07780 * r * tc / pc
    big_a = a * pressure / (r * r * temperature * temperature)
    big_b = b * pressure / (r * temperature)
    # z^3 - (1-B) z^2 + (A - 3B^2 - 2B) z - (AB - B^2 - B^3) = 0
    roots = _cubic_roots(-(1.0 - big_b),
                         big_a - 3 * big_b * big_b - 2 * big_b,
                         -(big_a * big_b - big_b * big_b - big_b ** 3))
    z = max(x for x in roots if x > big_b)
    s2 = math.sqrt(2.0)
    ln_phi = (z - 1.0 - math.log(z - big_b)
              - big_a / (2 * s2 * big_b)
              * math.log((z + (1 + s2) * big_b) / (z + (1 - s2) * big_b)))
    return pressure * math.exp(ln_phi)


def fugacity(species_key: str, temperature: float, pressure: float) -> float:
    """Fugacity [atm] for a named species ('h2','co2','ch4','n2',...):
    Peng-Robinson with its second virial coefficient spliced to the
    measured B(T) (module docstring) where tabulated."""
    key = species_key.lower()
    if key not in SPECIES:
        return pressure   # ideal-gas fallback: f = P
    crit = SPECIES[key]
    b_lit = second_virial(key, temperature)
    if b_lit is None:
        return peng_robinson_fugacity(temperature, pressure, crit)
    # rescale the attraction parameter so the EoS's own low-density
    # limit B = b - a/(RT) reproduces the measured B(T): consistent at
    # every pressure, exact in the truncated-virial regime
    r = R_L_ATM_MOL_K
    b_co = 0.07780 * r * crit.tc / crit.pc
    a_eff = (b_co - b_lit) * r * temperature
    return peng_robinson_fugacity(temperature, pressure, crit,
                                  a_override=a_eff)


def guess_species_key(name: str) -> str:
    """Map a model/molecule name (e.g. 'H2B', 'CO2', 'N2E') to an EoS key."""
    n = name.lower()
    for key in ("co2", "ch4", "h2", "n2", "he", "ar"):
        if n.startswith(key):
            return key
    return n
