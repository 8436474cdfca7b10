"""Shared set-up of the port's TMMC tests (tests/test_torch_tmmc.py and
tests/test_torch_tmmc_polar.py): the reference's ideal gas and ideal polar
gas, a small He deck, and the run log's TMMC attempt line."""
import dataclasses

import numpy as np
import torch

from mpmc_tpu_torch.config import RunConfig, Thermo
from mpmc_tpu_torch.constants import ATM2K_A3
from mpmc_tpu_torch.io import input_script
from mpmc_tpu_torch.mc import metropolis as tm
from mpmc_tpu_torch.state import Species, build_system


def he(polar=0.0):
    return Species(name="HE", atom_names=("HE",), pos=np.zeros((1, 3)),
                   mass=np.array([4.0]), charge=np.zeros(1),
                   polar=np.array([polar]), eps=np.zeros(1),
                   sig=np.zeros(1))


def ideal_gas(L=20.0, T=300.0, cap=40, n0=5, target_n=8.0,
               dtype="float64", **cfg_kw):
    """The reference's _ideal_gas_tmmc on the port: He with no
    interactions, f such that f V / kT = target_n."""
    f_atm = target_n * T / L ** 3 / ATM2K_A3
    dt = torch.float64 if dtype == "float64" else torch.float32
    params, state = build_system(L * np.eye(3), species=(he(),),
                                 capacity=(cap,), initial_counts=(n0,),
                                 dtype=dt, seed=3, device="cpu")
    cfg = RunConfig(ensemble="uvt", rd_potential="none", coulomb="none",
                    rd_lrc=False, dtype=dtype, insert_species=(0,),
                    tmmc=True, **cfg_kw)
    thermo = Thermo.make(temperature=T, fugacity=(f_atm,),
                         insert_probability=0.5, move_factor=1.0,
                         rot_factor=0.1, n_species=1, dtype=dt, device="cpu")
    return params, tm.initialize(state, params, cfg, thermo), cfg, thermo, \
        f_atm * ATM2K_A3 * L ** 3 / T


def deck(tmp_path, extra, numsteps=900, corrtime=300, fug=0.3):
    pqr = tmp_path / "he.pqr"
    pqr.write_text("ATOM 1 He HEL 1 M 10.0 10.0 10.0 4.0026 0.0 0.0 "
                   "0.0 0.0\nEND\n")
    job = input_script.parse(f"""
ensemble uvt
temperature 300
fugacities {fug}
numsteps {numsteps}
corrtime {corrtime}
move_factor 1.0
insert_probability 0.5
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
pqr_input {pqr}
pqr_restart {tmp_path / 'restart.pqr'}
tmmc on
tmmc_output {tmp_path / 't.json'}
{extra}
""")
    job.cfg = dataclasses.replace(job.cfg, rd_potential="none",
                                  coulomb="none", rd_lrc=False)
    return job


def attempt_line(text):
    """(collected, insert + delete) of the run's TMMC log line."""
    line = [ln for ln in text.splitlines() if "attempts collected" in ln][0]
    words = line.split()
    return (int(words[words.index("attempts") - 1]),
            int(words[words.index("insert") - 1]))


def ideal_polar_gas(dtype, capacity=16, fug=30.0, p_ins=0.5, **cfg_kw):
    """The reference's _ideal_polar_gas: single-site polarizable He with
    no charge, so the zodid surrogate equals the exact polar energy (0)
    and the stage-2 factor min(1, a2) is 1."""
    dt = torch.float64 if dtype == "float64" else torch.float32
    cfg = RunConfig(ensemble="uvt", rd_potential="none", coulomb="none",
                    rd_lrc=False, polarization=True, polar_delayed=True,
                    tmmc=True, insert_species=(0,), ortho_box=True,
                    dtype=dtype, seed=3, **cfg_kw)
    params, state = build_system(np.eye(3) * 20.0, species=(he(0.3),),
                                 capacity=(capacity,), initial_counts=(4,),
                                 dtype=dt, seed=3, device="cpu")
    thermo = Thermo.make(temperature=300.0, pressure=fug, fugacity=[fug],
                         move_factor=1.0, insert_probability=p_ins,
                         n_species=1, dtype=dt, device="cpu")
    return params, tm.initialize(state, params, cfg, thermo), cfg, thermo
