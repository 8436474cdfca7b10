"""Input-script parser: the reference's public API surface.

Rebuild of src/io/input.c (SURVEY.md §2 "Input parser / config" [C], §2.9
option table): plain-text ``option value...`` lines, ``!``/``#`` comments,
parsed into a ``Job`` — the static RunConfig, the continuous Thermo knobs,
file paths, and ensemble extras (annealing, tempering).  The §2.9 grammar
is accepted verbatim so reference input decks carry over; options whose
semantics don't apply on TPU (e.g. ``cuda``) are accepted and ignored with
a warning.

Solver-equivalence note: the reference's polar_gs / polar_gs_ranked /
polar_sor / polar_esor / polar_palmo selections all converge to the same
linear-system fixed point (SURVEY.md §7 "SCF solver equivalence"); here
they all select the masked-CG solver, with polar_gamma retained for the
Jacobi mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from mpmc_tpu_torch.config import RunConfig


def _onoff(v: str) -> bool:
    return v.lower() in ("on", "1", "true", "yes")


@dataclasses.dataclass
class Job:
    cfg: RunConfig
    # continuous knobs (Thermo is built once species count is known)
    temperature: float = 298.0
    pressure: float = 1.0
    fugacities: Optional[List[float]] = None
    fugacity_eos: Dict[str, bool] = dataclasses.field(default_factory=dict)
    move_factor: float = 1.0
    rot_factor: float = 1.0
    insert_probability: float = 0.0
    volume_probability: float = 0.0
    volume_change_factor: float = 0.05
    spinflip_probability: float = 0.0
    # cell
    basis: Optional[np.ndarray] = None
    # files
    pqr_input: Optional[str] = None
    insert_input: Optional[str] = None
    pqr_restart: Optional[str] = None
    pqr_output: Optional[str] = None
    frozen_output: Optional[str] = None   # framework-only PQR, written once
    read_pqr_box: bool = False   # take the cell from the PQR CRYST1 record
    traj_output: Optional[str] = None
    energy_output: Optional[str] = None
    dipole_output: Optional[str] = None
    field_output: Optional[str] = None
    histogram_output: Optional[str] = None
    pop_histogram: bool = False
    hist_resolution: float = 0.7
    polarizability_tensor: bool = False
    checkpoint_output: Optional[str] = None   # exact-resume extension
    checkpoint_input: Optional[str] = None
    # transition-matrix MC collection output (extension; RunConfig.tmmc):
    # JSON with the C[N, stay/up/down] matrix + run metadata, consumed by
    # ``analyze tmmc``
    tmmc_output: Optional[str] = None
    # quantum rotation (SURVEY §2.9 "Quantum")
    quantum_rotation_level_max: int = 4
    # quantum vibration: stretch fundamental [cm^-1] for sorbate species
    # (extension option; see ops/qvib.py)
    vib_omega: float = 0.0
    # more decimals in the per-corrtime log (SURVEY §2.9 "I/O" [M])
    long_output: bool = False
    # per-replica restart files <pqr_restart>-rK (SURVEY §2 [L])
    parallel_restarts: bool = False
    # NVE MC: fixed total energy [K] (Ray's microcanonical acceptance)
    total_energy: float = 0.0
    # multiply every charge by this factor at setup (SURVEY §2.9 "ES" [M])
    scale_charge: float = 1.0
    # adaptive move sizes: rescale move_factor/rot_factor each corrtime
    # toward ~50% displace acceptance (SURVEY §2 "MC main loop" [M])
    adapt_moves: bool = False
    # sampling extras
    simulated_annealing: bool = False
    simulated_annealing_schedule: float = 1.0
    simulated_annealing_target: float = 0.0
    parallel_tempering: bool = False
    max_temperature: float = 0.0
    ptemp_freq: int = 20
    n_replicas: int = 0      # PT ladder size (0 -> one per device)
    pt_fugacity: bool = False   # PT ladder axis = fugacity at fixed T
    max_pressure: float = 0.0   # fugacity-ladder top (atm)
    chains: int = 1          # vmapped chains per device (our extension)
    chain_devices: int = 0   # split the chain batch C/D per device over
    #                          a jax.sharding.Mesh (our extension; the
    #                          dp axis — parallel/multichain *_sharded)
    spatial_devices: int = 0  # shard O(N^2)/recip/SCF passes of
    #                           `ensemble te` — and, r3, the MC step's
    #                           own pair passes (replicated state,
    #                           psum-reduced scalars) — over this many
    #                           mesh devices (parallel/spatial)
    free_volume: float = 0.0
    # replay extras (SURVEY §2 "Replay": calc_pressure via
    # volume-perturbation virial estimate [M])
    calc_pressure: bool = False
    calc_pressure_dv: float = 1e-3
    # surface scan / fitting (SURVEY §2.9 "Fitting" + surf options)
    surf_min: float = 2.0
    surf_max: float = 10.0
    surf_inc: float = 0.25
    surf_ang: float = 0.0
    surf_decomp: bool = False
    surf_preserve: bool = False
    surf_output: Optional[str] = None
    fit_inputs: List[str] = dataclasses.field(default_factory=list)
    fit_schedule: float = 0.999
    fit_start_temp: float = 0.0
    fit_max_energy: float = 0.0
    fit_boltzmann_weight: float = 0.0
    # capacity extension (the reference's linked lists are unbounded; fixed
    # slot pools need a cap — our documented extension)
    max_molecules: int = 256
    # diagnostics
    unknown_options: List[str] = dataclasses.field(default_factory=list)
    ignored_options: List[str] = dataclasses.field(default_factory=list)


_IGNORED = {"cuda", "polar_self", "polar_rrms",
            "adiabatic_probability", "gwp_probability"}

_ENSEMBLES = {"uvt", "nvt", "npt", "nve", "te", "total_energy", "surf",
              "surf_fit", "surf_multi_fit", "replay"}

# corrtime above which stale cached rotor free energies carry a
# measured spinflip-acceptance bias worth warning about (the bias is
# ~0.13 at 200 steps on a deliberately hot/dense system —
# tests/test_qrot.py::test_spinflip_staleness_quantified)
SPINFLIP_CORRTIME_BOUND = 200


def parse(text: str) -> Job:
    """Parse an input script (string contents)."""
    cfg_kw: Dict = {}
    job = Job(cfg=RunConfig())
    basis_rows: Dict[int, np.ndarray] = {}

    for raw in text.splitlines():
        line = raw.split("!")[0].split("#")[0].strip()
        if not line:
            continue
        t = line.split()
        key, vals = t[0].lower(), t[1:]
        v0 = vals[0] if vals else ""

        # --- job control
        if key == "job_name":
            cfg_kw["job_name"] = v0
        elif key == "ensemble":
            e = v0.lower()
            if e not in _ENSEMBLES:
                raise ValueError(f"unknown ensemble {v0!r}")
            cfg_kw["ensemble"] = "te" if e == "total_energy" else e
        elif key == "numsteps":
            cfg_kw["numsteps"] = int(float(v0))
        elif key == "corrtime":
            cfg_kw["corrtime"] = int(float(v0))
        elif key == "seed":
            cfg_kw["seed"] = int(float(v0))
        # --- cell
        elif key in ("basis1", "basis2", "basis3"):
            basis_rows[int(key[-1]) - 1] = np.array(
                [float(x) for x in vals[:3]])
        elif key == "abcbasis":
            from mpmc_tpu_torch.ops.pbc import cell_from_abc
            a, b, c, al, be, ga = (float(x) for x in vals[:6])
            job.basis = np.asarray(cell_from_abc(a, b, c, al, be, ga))
        elif key == "cutoff":
            cfg_kw["cutoff"] = float(v0)
        # --- thermo
        elif key == "temperature":
            job.temperature = float(v0)
        elif key == "pressure":
            job.pressure = float(v0)
        elif key == "free_volume":
            job.free_volume = float(v0)
        elif key == "total_energy":
            # NVE target energy [K] (ensemble nve; mc/metropolis.py)
            job.total_energy = float(v0)
        elif key in ("fugacities", "user_fugacities"):
            job.fugacities = [float(x) for x in vals]
        elif key in ("h2_fugacity", "co2_fugacity", "ch4_fugacity",
                     "n2_fugacity"):
            job.fugacity_eos[key.split("_")[0]] = _onoff(v0)
        # --- moves
        elif key == "move_factor":
            job.move_factor = float(v0)
        elif key == "rot_factor":
            job.rot_factor = float(v0)
        elif key == "insert_probability":
            job.insert_probability = float(v0)
        elif key == "volume_probability":
            job.volume_probability = float(v0)
        elif key == "volume_change_factor":
            job.volume_change_factor = float(v0)
        elif key == "spinflip_probability":
            job.spinflip_probability = float(v0)
        elif key in ("adapt_moves", "adaptive_moves"):
            job.adapt_moves = _onoff(v0)
        elif key == "cavity_autoreject_absolute":
            cfg_kw["cavity_autoreject_absolute"] = float(v0)
        elif key == "cavity_bias":
            cfg_kw["cavity_bias"] = _onoff(v0)
        elif key == "cavity_grid":
            cfg_kw["cavity_grid"] = int(float(v0))
        elif key == "cavity_radius":
            cfg_kw["cavity_radius"] = float(v0)
        elif key == "max_molecules":
            job.max_molecules = int(float(v0))
        elif key == "cell_list":   # our extension: framework cell lists
            cfg_kw["cell_list"] = _onoff(v0)
        elif key == "tmmc":   # our extension: transition-matrix MC
            cfg_kw["tmmc"] = _onoff(v0) if vals else True
        elif key == "tmmc_bias":   # flat-histogram sampling (implies tmmc)
            cfg_kw["tmmc_bias"] = _onoff(v0) if vals else True
        elif key == "tmmc_output":
            job.tmmc_output = v0
        elif key in ("precision", "dtype"):   # our extension: f32|f64
            d = v0.lower()
            cfg_kw["dtype"] = ("float64" if d in ("f64", "float64", "double")
                               else "float32")
        # --- RD
        elif key == "rd_only":
            if _onoff(v0):
                cfg_kw["coulomb"] = "none"
                cfg_kw["rd_only"] = True
        elif key == "rd_lrc":
            cfg_kw["rd_lrc"] = _onoff(v0)
        elif key == "rd_crystal":
            if _onoff(v0):
                cfg_kw["rd_crystal"] = True
                cfg_kw["rd_lrc"] = False   # the image shells are the tail
        elif key == "rd_crystal_order":
            cfg_kw["rd_crystal_order"] = int(float(v0))
        elif key == "sg":
            if _onoff(v0):
                cfg_kw["rd_potential"] = "sg"
        elif key == "dreiding":
            if _onoff(v0):
                cfg_kw["rd_potential"] = "dreiding"
        elif key == "lj_buffered_14_7":
            if _onoff(v0):
                cfg_kw["rd_potential"] = "b14_7"
        elif key == "disp_expansion":
            if _onoff(v0):
                cfg_kw["rd_potential"] = "disp_expansion"
        elif key == "damp_dispersion":
            cfg_kw["damp_dispersion"] = _onoff(v0)
        elif key == "waldmanhagler":
            if _onoff(v0):
                cfg_kw["mixing_rule"] = "waldman_hagler"
        # --- ES
        elif key == "ewald_alpha":
            cfg_kw["ewald_alpha"] = float(v0)
        elif key == "ewald_kmax":
            cfg_kw["ewald_kmax"] = int(float(v0))
        elif key == "wolf":
            if _onoff(v0):
                cfg_kw["coulomb"] = "wolf"
        elif key == "wolf_alpha":
            cfg_kw["wolf_alpha"] = float(v0)
        elif key == "coulomb":
            if v0.lower() == "off":
                cfg_kw["coulomb"] = "none"
        elif key == "gwp":
            if _onoff(v0):
                cfg_kw["coulomb"] = "gwp"
        elif key == "polarizability_tensor":
            job.polarizability_tensor = _onoff(v0) if vals else True
        # --- polarization
        elif key == "polarization":
            cfg_kw["polarization"] = _onoff(v0)
        elif key == "polar_iterative":
            if not _onoff(v0):
                cfg_kw["polar_solver"] = "direct"
        elif key in ("polar_gs", "polar_gs_ranked", "polar_sor",
                     "polar_esor", "polar_palmo"):
            if _onoff(v0):
                cfg_kw["polar_solver"] = "cg"   # same fixed point (§7)
        elif key == "polar_zodid":
            if _onoff(v0):
                cfg_kw["polar_solver"] = "jacobi"
                cfg_kw["polar_max_iter"] = 1
        elif key == "polar_max_iter":
            cfg_kw["polar_max_iter"] = int(float(v0))
        elif key == "polar_precision":
            cfg_kw["polar_precision"] = float(v0)
        elif key == "polar_precision_mode":
            m = v0.lower()
            if m not in ("residual", "dipole"):
                raise ValueError("polar_precision_mode must be "
                                 "'residual' or 'dipole'")
            cfg_kw["polar_precision_mode"] = m
        elif key == "polar_damp":
            cfg_kw["polar_damp"] = float(v0)
        elif key == "polar_damp_type":
            d = v0.lower()
            cfg_kw["polar_damp_type"] = ("none" if d == "off" else d)
        elif key == "polar_gamma":
            cfg_kw["polar_gamma"] = float(v0)
        elif key == "mc_cull":
            # our extension: column-tile culling in the fused MC
            # kernels (exact; see RunConfig.mc_cull) — same tri-state
            # as polar_cull
            if not vals or v0.lower() == "auto":
                cfg_kw["mc_cull"] = "auto"
            elif v0.lower() in ("on", "off"):
                cfg_kw["mc_cull"] = v0.lower()
            else:
                raise ValueError(
                    f"mc_cull expects auto|on|off, got {v0!r}")
        elif key == "polar_cull":
            # our extension: tile-culled SCF matvec (exact; see
            # RunConfig.polar_cull).  auto (default) = engage for
            # explicit-cutoff ortho configs; on = force even at
            # derived rc = L/2; off = always dense.
            if not vals or v0.lower() == "auto":
                cfg_kw["polar_cull"] = "auto"
            elif v0.lower() in ("on", "off"):
                cfg_kw["polar_cull"] = v0.lower()
            else:
                raise ValueError(
                    f"polar_cull expects auto|on|off, got {v0!r}")
        elif key == "polar_delayed":
            # delayed-acceptance polar MC (our extension): zodid
            # surrogate stage-1 filter, SCF only for survivors
            cfg_kw["polar_delayed"] = _onoff(v0) if vals else True
        elif key in ("polar_ewald", "polar_ewald_full"):
            cfg_kw["polar_ewald"] = _onoff(v0) if vals else True
        elif key in ("polar_wolf", "polar_wolf_full"):
            cfg_kw["polar_wolf"] = _onoff(v0) if vals else True
        elif key == "polar_wolf_alpha":
            cfg_kw["polar_wolf_alpha"] = float(v0)
        # --- coupled-dipole vdW
        elif key == "cdvdw":
            cfg_kw["cdvdw"] = _onoff(v0)
        elif key in ("cdvdw_9th_repulsion", "cdvdw_exp_repulsion",
                     "cdvdw_sig_repulsion"):
            if not vals or _onoff(v0):
                cfg_kw["cdvdw_repulsion"] = key.split("_")[1]
        # --- quantum
        elif key == "quantum_rotation":
            cfg_kw["quantum_rotation"] = _onoff(v0)
        elif key in ("quantum_rotation_level_max", "quantum_rotation_l_max",
                     "quantum_rotation_sum_max"):
            job.quantum_rotation_level_max = int(float(v0))
        elif key == "feynman_hibbs":
            cfg_kw["feynman_hibbs"] = _onoff(v0)
        elif key == "feynman_hibbs_order":
            cfg_kw["feynman_hibbs_order"] = int(float(v0))
        elif key == "feynman_kleinert":
            cfg_kw["feynman_kleinert"] = _onoff(v0) if vals else True
        elif key == "quantum_vibration":
            cfg_kw["quantum_vibration"] = _onoff(v0) if vals else True
        elif key == "parallel_restarts":
            # per-replica restart files (the reference's per-MPI-rank
            # staggered restarts, SURVEY §2 "MPI layer" [L])
            job.parallel_restarts = _onoff(v0) if vals else True
        elif key == "fused_mc":
            # fused multi-step translate+rotate kernel (rigid NVT)
            cfg_kw["fused_mc"] = _onoff(v0) if vals else True
        elif key == "allow_charged_cell":
            # downgrade the setup-time net-charge Ewald error to a warning
            cfg_kw["allow_charged_cell"] = _onoff(v0) if vals else True
        elif key == "ewald_mxu":
            # extension: separable MXU structure factor (ops/ewald.py)
            cfg_kw["ewald_mxu"] = _onoff(v0) if vals else True
        elif key == "wrapall":
            cfg_kw["wrapall"] = _onoff(v0) if vals else True
        elif key == "preset_seeds":
            # reference: per-MPI-rank seed list; single-program rebuild
            # takes the first value (replicas derive per-chain streams)
            cfg_kw["seed"] = int(float(v0))
        elif key == "long_output":
            job.long_output = _onoff(v0) if vals else True
        elif key == "scale_charge":
            job.scale_charge = float(v0)
        elif key == "extrapolate_disp_coeffs":
            cfg_kw["extrapolate_disp_coeffs"] = (_onoff(v0) if vals
                                                 else True)
        elif key == "spectre":
            cfg_kw["spectre"] = _onoff(v0) if vals else True
        elif key == "spectre_max_charge":
            cfg_kw["spectre_max_charge"] = float(v0)
        elif key == "spectre_max_target":
            cfg_kw["spectre_max_target"] = float(v0)
        elif key == "vib_omega":
            # extension: stretch fundamental [cm^-1] applied to sorbate
            # species (the reference's PQR has no column for it)
            job.vib_omega = float(v0)
        # --- sampling extras
        elif key == "simulated_annealing":
            job.simulated_annealing = _onoff(v0)
        elif key == "simulated_annealing_schedule":
            job.simulated_annealing_schedule = float(v0)
        elif key == "simulated_annealing_target":
            job.simulated_annealing_target = float(v0)
        elif key == "parallel_tempering":
            job.parallel_tempering = _onoff(v0)
        elif key == "max_temperature":
            job.max_temperature = float(v0)
        elif key == "pt_fugacity":
            job.pt_fugacity = _onoff(v0)
        elif key == "max_pressure":
            job.max_pressure = float(v0)
        elif key == "ptemp_freq":
            job.ptemp_freq = int(float(v0))
        elif key == "n_replicas":
            job.n_replicas = int(float(v0))
        elif key == "chains":
            job.chains = int(float(v0))
        elif key == "chain_devices":
            job.chain_devices = int(float(v0))
        elif key == "spatial_devices":
            job.spatial_devices = int(float(v0))
        # --- surface scan / fitting
        elif key == "surf_min":
            job.surf_min = float(v0)
        elif key == "surf_max":
            job.surf_max = float(v0)
        elif key == "surf_inc":
            job.surf_inc = float(v0)
        elif key == "surf_ang":
            job.surf_ang = float(v0)
        elif key == "surf_decomp":
            job.surf_decomp = _onoff(v0)
        elif key.startswith("surf_preserve"):
            job.surf_preserve = _onoff(v0) if vals else True
        elif key == "surf_output":
            job.surf_output = v0
        elif key == "calc_pressure":
            job.calc_pressure = _onoff(v0)
        elif key == "calc_pressure_dv":
            job.calc_pressure_dv = float(v0)
        elif key == "fit_input":
            job.fit_inputs.append(v0)
        elif key == "fit_schedule":
            job.fit_schedule = float(v0)
        elif key == "fit_start_temp":
            job.fit_start_temp = float(v0)
        elif key == "fit_max_energy":
            job.fit_max_energy = float(v0)
        elif key == "fit_boltzmann_weight":
            job.fit_boltzmann_weight = float(v0)
        # --- I/O
        elif key == "pqr_input":
            job.pqr_input = v0
        elif key == "insert_input":
            job.insert_input = v0
        elif key == "pqr_restart":
            job.pqr_restart = v0
        elif key == "pqr_output":
            job.pqr_output = v0
        elif key == "frozen_output":
            job.frozen_output = v0
        elif key == "read_pqr_box":
            job.read_pqr_box = _onoff(v0) if vals else True
        elif key == "traj_output":
            job.traj_output = v0
        elif key in ("energy_output", "energy_output_csv"):
            job.energy_output = v0
        elif key == "dipole_output":
            job.dipole_output = v0
        elif key == "field_output":
            job.field_output = v0
        elif key in ("histogram_output", "pop_histogram_output"):
            job.histogram_output = v0
        elif key == "pop_histogram":
            job.pop_histogram = _onoff(v0)
        elif key == "hist_resolution":
            job.hist_resolution = float(v0)
        elif key == "checkpoint_output":   # our extension: exact resume
            job.checkpoint_output = v0
        elif key == "checkpoint_input":
            job.checkpoint_input = v0
        elif key in _IGNORED:
            job.ignored_options.append(key)
        else:
            job.unknown_options.append(key)

    if job.basis is None and basis_rows:
        if set(basis_rows) != {0, 1, 2}:
            raise ValueError("need all of basis1, basis2, basis3")
        job.basis = np.stack([basis_rows[i] for i in range(3)])
    if cfg_kw.get("tmmc_bias") and not cfg_kw.get("tmmc"):
        cfg_kw["tmmc"] = True      # tmmc_bias implies collection
    job.cfg = RunConfig(**cfg_kw)
    if job.cfg.tmmc:
        if job.cfg.ensemble != "uvt":
            raise ValueError("tmmc requires ensemble uvt (the collection "
                             "matrix is over the molecule-count macrostate)")
        if job.parallel_tempering or job.pt_fugacity:
            raise ValueError(
                "tmmc with parallel tempering is unsupported (one "
                "collection matrix per thermodynamic state — use "
                "separate runs, or pt_fugacity + 'analyze gcmc-mbar "
                "--ladder' for ladder reweighting)")
        # tmmc + polar_delayed composes since r4: the collection uses
        # the conditionally unbiased estimator 1{stage-1 accept} *
        # min(1, a2) (importance-weighted under tmmc_bias) — see
        # metropolis.make_step's tmmc_on note and the fused-path
        # equivalent in _fused_chunk_uvt_pda.
        if job.simulated_annealing:
            raise ValueError(
                "tmmc with simulated_annealing is unsupported: the "
                "collection matrix would pool attempts across the "
                "temperature schedule while its metadata records one T "
                "(reweighting needs a single thermodynamic state)")
    if (job.spinflip_probability > 0.0 and job.cfg.quantum_rotation
            and job.cfg.corrtime > SPINFLIP_CORRTIME_BOUND):
        # self-enforcing staleness contract (r2 verdict item 7): rotor
        # free energies refresh per corrtime while molecules move every
        # step, and the measured acceptance bias reaches ~0.13 after
        # 200 un-refreshed steps on a hot dense system
        # (tests/test_qrot.py::test_spinflip_staleness_quantified)
        import warnings
        warnings.warn(
            f"spinflip with corrtime {job.cfg.corrtime} > "
            f"{SPINFLIP_CORRTIME_BOUND}: the cached rotor free "
            "energies go stale between refreshes (measured flip-"
            "acceptance bias ~0.13 after 200 un-refreshed steps — "
            "test_spinflip_staleness_quantified); lower corrtime to "
            "tighten the bound")
    return job


def parse_file(path: str) -> Job:
    with open(path) as f:
        return parse(f.read())
