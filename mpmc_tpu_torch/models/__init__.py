"""Built-in rigid-molecule models (sorbate force fields; port of
mpmc_tpu/models/__init__.py — host-side templates, no tensors).

The reference ships no model library — users supply per-atom parameters in
PQR files (SURVEY.md §2 "PQR reader") and the community reuses published
parameter sets (Buch H2, BSS/BSSP H2, EPM2 CO2, TraPPE N2...).  These
built-ins are convenience templates for tests/benchmarks, parameterized
from the published literature values cited in each docstring; any system
can equally be described purely via PQR input.

Units: K, Angstrom, e, amu, A^3.
"""
from __future__ import annotations

import numpy as np

from mpmc_tpu_torch.state import Species


def h2_buch() -> Species:
    """Single-site H2 (Buch, J. Chem. Phys. 100, 7610 (1994)):
    eps = 34.2 K, sigma = 2.96 A.  The workhorse for quantum-corrected
    (Feynman-Hibbs) H2 sorption."""
    return Species(
        name="H2B", atom_names=("H2G",), pos=np.zeros((1, 3)),
        mass=np.array([2.016]), charge=np.zeros(1), polar=np.zeros(1),
        eps=np.array([34.2]), sig=np.array([2.96]))


def h2_3site(polarizable: bool = False) -> Species:
    """3-site charged H2 (Darkrim-Levesque-type, J. Chem. Phys. 109, 4981
    (1998)): LJ on the COM (eps 36.7 K, sigma 2.958 A), point charges
    +q on H at +/-0.371 A and -2q at the COM reproducing the H2
    quadrupole (q = 0.4829 e).  ``polarizable=True`` places the isotropic
    molecular polarizability alpha = 0.787 A^3 [CRC] on the COM site for
    Thole-SCF runs (a BSSP-style polar H2 analog)."""
    q = 0.4829
    d = 0.371
    alpha = 0.787 if polarizable else 0.0
    return Species(
        name="H2P" if polarizable else "H2Q",
        atom_names=("H2G", "H2E", "H2E"),
        pos=np.array([[0.0, 0.0, 0.0], [d, 0.0, 0.0], [-d, 0.0, 0.0]]),
        mass=np.array([0.0, 1.008, 1.008]),
        charge=np.array([-2 * q, q, q]),
        polar=np.array([alpha, 0.0, 0.0]),
        eps=np.array([36.7, 0.0, 0.0]),
        sig=np.array([2.958, 0.0, 0.0]))


def helium() -> Species:
    """He (Aziz-style LJ reduction): eps = 10.9 K, sigma = 2.64 A."""
    return Species(
        name="He", atom_names=("He",), pos=np.zeros((1, 3)),
        mass=np.array([4.0026]), charge=np.zeros(1), polar=np.zeros(1),
        eps=np.array([10.9]), sig=np.array([2.64]))


def argon() -> Species:
    """Ar: eps = 119.8 K, sigma = 3.405 A (classic Rahman values)."""
    return Species(
        name="Ar", atom_names=("Ar",), pos=np.zeros((1, 3)),
        mass=np.array([39.948]), charge=np.zeros(1), polar=np.zeros(1),
        eps=np.array([119.8]), sig=np.array([3.405]))


def n2_trappe() -> Species:
    """TraPPE N2 (Potoff & Siepmann, AIChE J. 47, 1676 (2001)): LJ on N
    (eps 36.0 K, sigma 3.31 A), d(N-N) = 1.10 A, charges -0.482 e on N and
    +0.964 e on the COM reproducing the quadrupole."""
    d = 0.55
    return Species(
        name="N2", atom_names=("N2G", "N2E", "N2E"),
        pos=np.array([[0.0, 0.0, 0.0], [d, 0.0, 0.0], [-d, 0.0, 0.0]]),
        mass=np.array([0.0, 14.0067, 14.0067]),
        charge=np.array([0.964, -0.482, -0.482]),
        polar=np.zeros(3),
        eps=np.array([0.0, 36.0, 36.0]),
        sig=np.array([0.0, 3.31, 3.31]))


def co2_epm2() -> Species:
    """EPM2 CO2 (Harris & Yung, J. Phys. Chem. 99, 12021 (1995)):
    C eps 28.129 K sigma 2.757 A q +0.6512; O eps 80.507 K sigma 3.033 A
    q -0.3256; d(C-O) = 1.149 A."""
    d = 1.149
    return Species(
        name="CO2", atom_names=("CO2C", "CO2O", "CO2O"),
        pos=np.array([[0.0, 0.0, 0.0], [d, 0.0, 0.0], [-d, 0.0, 0.0]]),
        mass=np.array([12.011, 15.999, 15.999]),
        charge=np.array([0.6512, -0.3256, -0.3256]),
        polar=np.zeros(3),
        eps=np.array([28.129, 80.507, 80.507]),
        sig=np.array([2.757, 3.033, 3.033]))


def methane_trappe() -> Species:
    """TraPPE-UA CH4 united atom: eps 148.0 K, sigma 3.73 A."""
    return Species(
        name="CH4", atom_names=("CH4",), pos=np.zeros((1, 3)),
        mass=np.array([16.043]), charge=np.zeros(1), polar=np.zeros(1),
        eps=np.array([148.0]), sig=np.array([3.73]))


BUILTINS = {
    "h2_buch": h2_buch,
    "h2_3site": h2_3site,
    "h2_3site_polar": lambda: h2_3site(polarizable=True),
    "he": helium,
    "ar": argon,
    "n2": n2_trappe,
    "co2": co2_epm2,
    "ch4": methane_trappe,
}


def get(name: str) -> Species:
    try:
        return BUILTINS[name.lower()]()
    except KeyError:
        raise KeyError(
            f"unknown built-in model {name!r}; available: "
            f"{sorted(BUILTINS)}") from None
