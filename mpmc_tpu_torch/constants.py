"""Physical constants and the MPMC unit system.

Unit conventions (SURVEY.md §1, "Units"): lengths in Angstrom, energies in
Kelvin, temperature in Kelvin, pressure in atm, charge in elementary charges,
mass in amu, polarizability in A^3.  The reference hard-codes the
electrostatic conversion e^2/(4*pi*eps0*A*kB) ~ 1.671e5 K*A/e^2 throughout
its coulombic code (SURVEY.md §1); here every derived constant is computed
from CODATA SI values so the provenance is explicit.
"""
from __future__ import annotations

import math

# --- CODATA 2018 SI values (exact where noted) -----------------------------
KB_SI = 1.380649e-23          # J/K (exact)
E_SI = 1.602176634e-19        # C   (exact)
EPS0_SI = 8.8541878128e-12    # F/m
HBAR_SI = 1.054571817e-34     # J*s
AMU_SI = 1.66053906660e-27    # kg
NA = 6.02214076e23            # 1/mol (exact)
ATM_SI = 101325.0             # Pa (exact)

# --- Derived constants in MPMC units ---------------------------------------

#: Coulomb energy prefactor: U[K] = KE * q_i q_j / r  with q in e, r in A.
#: e^2 / (4 pi eps0 * kB) * 1e10  ==  167100.94... K*A/e^2
KE = E_SI * E_SI / (4.0 * math.pi * EPS0_SI * KB_SI) * 1.0e10

#: Pressure conversion: P[K/A^3] = ATM2K_A3 * P[atm]  (so that P*V is in K).
ATM2K_A3 = ATM_SI * 1.0e-30 / KB_SI

#: hbar^2 / (kB * amu * A^2) in K — Feynman–Hibbs prefactor building block:
#: U_FH2 = HBAR2_KB_AMU_A2 / (24 * T * mu_amu) * (V'' + 2 V'/r), V in K, r in A.
HBAR2_KB_AMU_A2 = HBAR_SI * HBAR_SI / (KB_SI * AMU_SI * 1.0e-20)

#: Fourth-order FH needs hbar^4/(kB^2 amu^2 A^4) — just the square of above
#: divided by an extra kB... kept as (HBAR2_KB_AMU_A2)**2 with 1/T^2 usage.
HBAR4_KB2_AMU2_A4 = HBAR2_KB_AMU_A2 * HBAR2_KB_AMU_A2

#: Dipole conversion: 1 e*A = 4.8032047... Debye.
DEBYE_PER_EA = 1.0e-21 / 2.99792458 * E_SI * 1.0e10 / 1.0e-18  # ~4.803
# (1 D = 1e-18 statC*cm; computed via 1 D = (1/299792458)*1e-21 C*m)
# Simpler, standard value:
DEBYE_PER_EA = 4.803204712570263  # e*A -> D

#: Density conversion: rho[g/cm^3] = AMU_A3_TO_G_CM3 * (total amu) / V[A^3].
AMU_A3_TO_G_CM3 = AMU_SI * 1.0e3 / 1.0e-24  # = 1.66053906660

#: Gas constant in L*atm/(mol*K) — used by the fugacity EoS module.
R_L_ATM = 0.0820573660809596

#: Boltzmann constant in units where energy is K: exactly 1 (energies are
#: already temperatures).  Defined for readability at call sites.
KB_K = 1.0

#: Hartree -> Kelvin and bohr -> Angstrom (for Silvera–Goldman constants).
HARTREE_K = 4.3597447222071e-18 / KB_SI      # ~3.1577e5
BOHR_A = 0.529177210903
