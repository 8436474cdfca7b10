"""Simulation configuration (port of mpmc_tpu/config.py).

``RunConfig`` is the same frozen dataclass with the same fields: static
options that select code paths.  ``Thermo`` holds the continuous per-run
numbers (temperature, pressure, move sizes, fugacities) as 0-d and 1-d
tensors on an explicit device, so they can change between chunks
without touching the step code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device; without one it raises (the CPU is only ever
    chosen explicitly)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # --- job control
    job_name: str = "mpmc_tpu"
    ensemble: str = "nvt"          # uvt | nvt | npt | nve | surf | replay | te
    numsteps: int = 0
    corrtime: int = 1000
    seed: int = 0

    # --- cutoffs / cell
    cutoff: Optional[float] = None   # None -> half min perpendicular width
    wrapall: bool = True
    # derived: the basis is exactly diagonal (set by mc/run.setup and the
    # models/systems.py builders)
    ortho_box: bool = False

    # --- repulsion-dispersion
    rd_potential: str = "lj"       # lj | sg | dreiding | b14_7 | disp_expansion | none
    rd_lrc: bool = True
    rd_only: bool = False
    mixing_rule: str = "lb"        # lb | waldman_hagler
    damp_dispersion: bool = True
    rd_crystal: bool = False
    rd_crystal_order: int = 2
    extrapolate_disp_coeffs: bool = False

    # --- electrostatics
    coulomb: str = "ewald"         # ewald | wolf | cutoff | none
    ewald_alpha: Optional[float] = None   # None -> 3.5 / cutoff
    ewald_kmax: int = 7
    wolf_alpha: Optional[float] = None
    # a TPU matrix-unit layout of S(k) in the reference; here it selects
    # the same half-space S(k), which gives the same energies
    ewald_mxu: bool = False
    allow_charged_cell: bool = False

    # --- polarization
    polarization: bool = False
    polar_solver: str = "cg"
    polar_max_iter: int = 64
    polar_precision: float = 1e-6
    polar_precision_mode: str = "residual"
    polar_damp_type: str = "exponential"
    polar_damp: float = 2.1304
    polar_ewald: bool = False
    polar_wolf: bool = False
    polar_wolf_alpha: Optional[float] = None
    polar_gamma: float = 1.0
    polar_cull: str = "auto"
    mc_cull: str = "off"
    polar_delayed: bool = False

    # --- coupled-dipole many-body vdW
    cdvdw: bool = False
    cdvdw_repulsion: str = "none"

    # --- quantum corrections
    feynman_hibbs: bool = False
    feynman_hibbs_order: int = 2
    feynman_kleinert: bool = False
    quantum_rotation: bool = False
    quantum_vibration: bool = False

    # --- SPECTRE
    spectre: bool = False
    spectre_max_charge: float = 1.0
    spectre_max_target: float = 0.0

    # --- ensembles / moves
    cavity_autoreject_absolute: float = 0.0   # r_min; 0 disables
    insert_species: Tuple[int, ...] = ()      # species eligible for GCMC
    cavity_bias: bool = False
    cavity_grid: int = 10
    cavity_radius: float = 2.5
    tmmc: bool = False
    tmmc_bias: bool = False

    # --- precision / performance
    cell_list: bool = False
    dtype: str = "float32"         # float32 | float64
    pair_chunk: int = 512          # row-block size of the plain O(N^2) pass
    spatial_axis: Optional[Tuple[str, int]] = None
    # accepted for deck compatibility; on a CUDA tensor the pair passes
    # always launch the kernels (ops/cuda/pair_kernel.py)
    use_pallas: bool = True
    pallas_delta: bool = False
    mol_cache: bool = False
    fused_kernels: bool = True
    fused_mc: bool = False

    @property
    def tdtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32


@dataclasses.dataclass(frozen=True)
class Thermo:
    """Continuous knobs consumed by the MC step, as tensors on one device.

    fugacity: per-species fugacity in atm.  Move probabilities follow the
    reference: insert/delete split ``insert_probability`` in half."""
    temperature: torch.Tensor                # K
    pressure: torch.Tensor                   # atm
    fugacity: torch.Tensor                   # [n_species] atm
    move_factor: torch.Tensor                # A, displacement half-width
    rot_factor: torch.Tensor                 # rad, max rotation angle
    insert_probability: torch.Tensor         # P(insert or delete)
    volume_probability: torch.Tensor
    volume_change_factor: torch.Tensor
    spinflip_probability: torch.Tensor
    nve_energy: torch.Tensor = None
    # flat-histogram TMMC bias eta(N) [n_mols_max + 1] (cfg.tmmc_bias),
    # shared by every chain; None = no bias yet
    tmmc_eta: torch.Tensor = None

    @classmethod
    def make(cls, temperature=298.0, pressure=1.0, fugacity=(),
             move_factor=1.0, rot_factor=1.0, insert_probability=0.0,
             volume_probability=0.0, volume_change_factor=0.05,
             spinflip_probability=0.0, nve_energy=0.0, n_species=None,
             dtype=torch.float32, device=None):
        """The knobs as tensors on ``device`` (default: the current CUDA
        device; raises without one)."""
        device = resolve_device(device)
        fug = torch.atleast_1d(torch.as_tensor(fugacity, dtype=dtype,
                                               device=device))
        if n_species is not None and fug.shape[0] < max(n_species, 1):
            fug = torch.cat([fug, torch.zeros(
                max(n_species, 1) - fug.shape[0], dtype=dtype,
                device=device)])

        def s(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return cls(
            temperature=s(temperature), pressure=s(pressure), fugacity=fug,
            move_factor=s(move_factor), rot_factor=s(rot_factor),
            insert_probability=s(insert_probability),
            volume_probability=s(volume_probability),
            volume_change_factor=s(volume_change_factor),
            spinflip_probability=s(spinflip_probability),
            nve_energy=s(nve_energy),
        )

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
