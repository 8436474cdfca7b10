"""Running observable averages — the rebuild of the reference's
averages/nodestats layer (SURVEY.md §2 "Averages / observables",
src/io/averages.c [L placement]).

Samples are taken once per corrtime block (matching the reference's
cadence); fluctuation-formula observables are computed at report time:

    Qst = kT - (<UN> - <U><N>) / (<N^2> - <N>^2)        [C]
    Cv  = (<E^2> - <E>^2) / (k T^2)
    isothermal compressibility (NPT) = V fluctuations / (kT <V>)

Host-side numpy; tiny data volume (one scalar set per corrtime).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from mpmc_tpu_torch.constants import AMU_A3_TO_G_CM3, ATM2K_A3

KJ_PER_MOL_PER_K = 0.008314462618   # R in kJ/(mol K)


@dataclasses.dataclass
class Averages:
    samples: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def add(self, obs: Dict[str, float]):
        for k, v in obs.items():
            self.samples.setdefault(k, []).append(float(v))

    def mean(self, key: str) -> float:
        v = self.samples.get(key)
        return float(np.mean(v)) if v else float("nan")

    def sem(self, key: str) -> float:
        """Standard error of the mean (uncorrelated-sample estimate)."""
        v = self.samples.get(key)
        if not v or len(v) < 2:
            return float("nan")
        return float(np.std(v, ddof=1) / np.sqrt(len(v)))

    def count(self) -> int:
        return max((len(v) for v in self.samples.values()), default=0)

    # --- fluctuation observables -------------------------------------------
    def qst(self, temperature: float, n_key: str = "N",
            u_key: str = "energy_total") -> float:
        """Isosteric heat [kJ/mol] via the fluctuation formula [C]."""
        n = np.asarray(self.samples.get(n_key, []))
        u = np.asarray(self.samples.get(u_key, []))
        if len(n) < 2:
            return float("nan")
        var_n = n.var()
        if var_n <= 0:
            return float("nan")
        cov = (u * n).mean() - u.mean() * n.mean()
        qst_k = temperature - cov / var_n
        return qst_k * KJ_PER_MOL_PER_K

    def heat_capacity(self, temperature: float,
                      u_key: str = "energy_total") -> float:
        """NVT heat capacity [kJ/(mol K)] from energy fluctuations."""
        u = np.asarray(self.samples.get(u_key, []))
        if len(u) < 2:
            return float("nan")
        return u.var() / (temperature ** 2) * KJ_PER_MOL_PER_K

    def compressibility(self, temperature: float,
                        v_key: str = "volume") -> float:
        """Isothermal compressibility [1/atm] from V fluctuations (NPT)."""
        v = np.asarray(self.samples.get(v_key, []))
        if len(v) < 2:
            return float("nan")
        return v.var() / (v.mean() * temperature) / ATM2K_A3


def sorbed_mass_obs(total_sorbate_amu: float, volume_a3: float,
                    frozen_mass_amu: float, free_volume_a3: float = 0.0):
    """Density / loading observables (SURVEY.md §2: density g/cm^3, wt%,
    wt%(ME), mg/g excess via free_volume)."""
    out = {
        "density_g_cm3": AMU_A3_TO_G_CM3 * total_sorbate_amu / volume_a3,
    }
    if frozen_mass_amu > 0:
        out["wt_pct"] = (100.0 * total_sorbate_amu
                         / (total_sorbate_amu + frozen_mass_amu))
        out["wt_pct_me"] = 100.0 * total_sorbate_amu / frozen_mass_amu
        out["mg_g"] = 1000.0 * total_sorbate_amu / frozen_mass_amu
    return out
