"""The port's NVE block observables against the JAX package: the
reservoir's kinetic temperature T_kinetic = 2(E_nve - U)/F over the alive
movable molecules' degrees of freedom (mpmc_tpu/mc/run.py::observables)."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu.mc import run as jrun  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402

torch.set_num_threads(1)


def _deck(tmp_path, numsteps=400, corrtime=100):
    """Six argon atoms free to move and one frozen, in a 20 A box under
    nve at a fixed total energy (float64, LJ only)."""
    rng = np.random.default_rng(4)
    xyz = rng.uniform(1.0, 19.0, (7, 3))
    lines = [f"ATOM {i + 1} Ar AR {i + 1} {'F' if i == 6 else 'M'} "
             f"{x:.4f} {y:.4f} {z:.4f} 39.948 0.0 0.0 119.8 3.405"
             for i, (x, y, z) in enumerate(xyz)]
    (tmp_path / "ar.pqr").write_text("\n".join(lines) + "\nEND\n")
    deck = tmp_path / "nve.inp"
    deck.write_text(f"""ensemble nve
numsteps {numsteps}
corrtime {corrtime}
temperature 100
total_energy 900
move_factor 1.0
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
cutoff 8
coulomb off
rd_lrc off
precision float64
pqr_input {tmp_path / 'ar.pqr'}
pqr_restart {tmp_path / 'restart.pqr'}
""")
    return deck


def test_t_kinetic_matches_the_reference(tmp_path):
    """On the reference's NVE states after each of four 100-step blocks,
    the port's T_kinetic equals the reference's at rel 1e-12."""
    deck = _deck(tmp_path)
    su_j = jrun.setup(jinput.parse_file(str(deck)))
    su_t = trun.setup(input_script.parse_file(str(deck)), device="cpu")
    st = jm.initialize(su_j.state, su_j.params, su_j.cfg, su_j.thermo)
    seen = []
    for _ in range(4):
        st, _ = jm.run_chunk(st, su_j.params, su_j.cfg, su_j.thermo, 100)
        want = jrun.observables(su_j, st)["T_kinetic"]
        _, st_t, _, _ = convert.from_jax(su_j.params, st, su_j.cfg,
                                         su_j.thermo)
        got = trun.observables(su_t, st_t)["T_kinetic"]
        assert got == pytest.approx(want, rel=1e-12)
        seen.append(want)
    assert len(set(seen)) > 1        # the states moved between blocks


def test_nve_deck_reports_t_kinetic(tmp_path):
    """The port's run of the deck reports T_kinetic in every block and
    in the final averages (tests/test_mc.py's check of the reference)."""
    _, avgs = trun.run(input_script.parse_file(str(_deck(tmp_path))),
                       log=io.StringIO(), device="cpu")
    assert "T_kinetic" in avgs.samples
    assert len(avgs.samples["T_kinetic"]) == 4
    assert np.all(np.isfinite(avgs.samples["T_kinetic"]))
