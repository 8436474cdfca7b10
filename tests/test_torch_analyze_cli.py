"""``python -m mpmc_tpu_torch.analyze``: every subcommand of the
reference's command line, run as a subprocess on the CPU (``--cpu`` on
the frame subcommands), against the reference's main on the same
arguments (``--no-native`` on the frame subcommands): the CSV, the .dx
grid and the printed numbers agree within the precision they are printed
at.  The reference's main runs in this process, where x64 is on: its
``python -m`` entry builds a CRYST1 cell through jnp with x64 off, in
float32 (test_reference_entry_point runs it with JAX_ENABLE_X64=1).
Also: the module imports neither jax nor mpmc_tpu, and the frame
analyzers need a device while the host statistics do not."""
import concurrent.futures
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu import analyze as ref  # noqa: E402
from mpmc_tpu_torch import analyze  # noqa: E402
from mpmc_tpu_torch.io import output as output_io  # noqa: E402
from mpmc_tpu_torch.utils.histogram import read_dx  # noqa: E402
from torch_analyze import (gc_jsonl, gcmc_traj, h2_template,  # noqa: E402
                           pt_ladder_jsonl, triclinic_traj)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = {"rdf", "density", "msd", "loading", "cluster", "orient", "sq",
         "widom", "pore", "asa"}
# (case, argv with {d} the input directory); outputs are relative paths
CASES = {
    "rdf": "rdf {d}/traj.pqr --a AR --b AR --rmax 5 --bins 40 --out o.csv",
    "density": "density {d}/gcmc.pqr --mol H2 --resolution 1.5 --out o.dx",
    "msd": "msd {d}/gcmc.pqr --mol H2 --out o.csv",
    "loading": "loading {d}/gcmc.pqr --mol H2 --out o.csv",
    "cluster": "cluster {d}/gcmc.pqr --mol H2 --rc 4.5 --max-size 8 "
               "--out o.csv",
    "blocking": "blocking {d}/energy.csv --column energy_total --out o.csv",
    "orient": "orient {d}/gcmc.pqr --mol H2 --axis H2E --out o.csv",
    "sq": "sq {d}/traj.pqr --a AR --flag M --qmin 0.5 --qmax 8 --nq 16 "
          "--dr-bin 0.01 --out o.csv",
    "qst": "qst {d}/obs.jsonl -T 77",
    "qst-cc": "qst-cc {d}/i1.csv {d}/i2.csv --t1 77 --t2 97 --out o.csv",
    "isofit": "isofit {d}/iso.csv --model langmuir --sem-column n_sem",
    "iast": "iast {d}/a.csv {d}/b.csv --y1 0.3 --pressures 1.0 5.0 "
            "--out o.csv",
    "widom": "widom {d}/gcmc.pqr --eps 30 --sig 3.1 -T 77 --tries 64 "
             "--rc 6",
    "widom --insert-pqr": "widom {d}/gcmc.pqr --insert-pqr {d}/h2.pqr "
                          "-T 77 --tries 24 --seed 2 --rc 6",
    "mbar": "mbar {d}/ladder.jsonl --nt 9 --out o.csv",
    "gcmc-mbar": "gcmc-mbar {d}/run0.jsonl {d}/run1.jsonl --nf 7 "
                 "--out o.csv",
    "gcmc-mbar --ladder": "gcmc-mbar {d}/fug.jsonl --ladder --nf 5 "
                          "--out o.csv",
    "pore": "pore {d}/gcmc.pqr --flag F --probe 2.0 --points 2000 "
            "--centers 200 --bins 20 --seed 3 --out o.csv",
    "tmmc": "tmmc {d}/a.json --fugacities 0.5,2,8 --out o.csv "
            "--lnpi-out l.csv",
    "asa": "asa {d}/gcmc.pqr --flag F --probe 2.0 --sphere-points 64 "
           "--seed 1",
}
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?inf|nan")


def _argv(case, d):
    return CASES[case].format(d=d).split()


def _inputs(d):
    """Every input file of CASES in directory ``d``."""
    triclinic_traj(d)
    gcmc_traj(d)
    h2_template(d)
    rng = np.random.default_rng(3)
    (d / "energy.csv").write_text("step,energy_total\n" + "\n".join(
        f"{i},{np.sin(i) + 0.1 * rng.standard_normal()}"
        for i in range(256)) + "\n")
    nn = rng.poisson(12.0, 512).astype(float)
    (d / "obs.jsonl").write_text("\n".join(json.dumps(
        {"step": i, "N": v, "energy_total": -500.0 * v
         + 30.0 * rng.standard_normal()}) for i, v in enumerate(nn)) + "\n")
    p = np.geomspace(0.05, 80.0, 20)
    for name, t in (("i1.csv", 77.0), ("i2.csv", 97.0)):
        k = 2e-4 * np.exp(1100.0 / t)
        (d / name).write_text("pressure_atm,n_mean\n" + "\n".join(
            f"{pi},{10 * k * pi / (1 + k * pi)}" for pi in p) + "\n")
    (d / "iso.csv").write_text("pressure_atm,n_mean,n_sem\n" + "\n".join(
        f"{pi},{8.0 * 0.5 * pi / (1 + 0.5 * pi) * (1 + 0.01 * np.sin(pi))}"
        f",0.05" for pi in p) + "\n")
    for name, k in (("a.csv", 1.3), ("b.csv", 0.2)):
        (d / name).write_text("pressure_atm,n_mean\n" + "\n".join(
            f"{pi},{9.0 * k * pi / (1 + k * pi)}" for pi in p) + "\n")
    pt_ladder_jsonl(d / "ladder.jsonl")
    for i, f in enumerate([0.1, 0.4]):
        gc_jsonl(d / f"run{i}.jsonl", 77.0, f, 800, 7 + i, 80.0)
    ladder = np.array([0.1, 0.2, 0.4])
    lines = []
    for blk in range(300):
        fug = ladder[rng.permutation(3)]
        n = rng.poisson(5.0 * fug * np.exp(80.0 / 77.0)).astype(float)
        lines.append(json.dumps({"step": blk, "pt_temps": [77.0] * 3,
                                 "pt_energy": (-80.0 * n).tolist(),
                                 "pt_N": n.tolist(),
                                 "pt_fug": fug.tolist()}))
    (d / "fug.jsonl").write_text("\n".join(lines) + "\n")
    c = np.zeros((16, 4))
    c[:12, 0] = 100.0
    c[:12, 1] = 100.0 * np.linspace(0.9, 0.3, 12)
    c[1:13, 2] = 100.0
    c[1:13, 3] = 100.0 * np.linspace(0.2, 0.8, 12)
    output_io.write_tmmc(str(d / "a.json"), c, temperature=77.0,
                         fugacities=[2.0], volume=1000.0, species=["H2"],
                         insert_species=0)


def _run_port(case, d, out):
    os.makedirs(out, exist_ok=True)
    argv = _argv(case, d) + (["--cpu"] if _argv(case, d)[0] in FRAME
                             else [])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "mpmc_tpu_torch.analyze",
                        *argv], cwd=out, env=env, capture_output=True,
                       text=True, timeout=300)
    return r.returncode, r.stdout, r.stderr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, and every case through ``python -m
    mpmc_tpu_torch.analyze`` (six subprocesses at a time)."""
    d = tmp_path_factory.mktemp("inputs")
    _inputs(d)
    base = tmp_path_factory.mktemp("port")
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        futs = {c: pool.submit(_run_port, c, d,
                               str(base / c.replace(" ", "_")))
                for c in CASES}
        return d, base, {c: f.result() for c, f in futs.items()}


def _same_text(got, want, where):
    """Line by line: equal words, numbers within the printed precision."""
    g, w = got.strip().splitlines(), want.strip().splitlines()
    assert len(g) == len(w), (where, got, want)
    for a, b in zip(g, w):
        if a == b:
            continue
        na, nb = NUM.findall(a), NUM.findall(b)
        assert NUM.sub("#", a) == NUM.sub("#", b), (where, a, b)
        np.testing.assert_allclose(np.array(na, float), np.array(nb, float),
                                   rtol=2e-6, atol=1e-8, err_msg=where)


@pytest.mark.parametrize("case", list(CASES))
def test_subcommand_matches_reference(runs, case, tmp_path, monkeypatch,
                                      capsys):
    d, base, results = runs
    rc, out, err = results[case]
    assert rc == 0, err
    argv = _argv(case, d)
    monkeypatch.chdir(tmp_path)
    assert ref.main(argv + (["--no-native"] if argv[0] in FRAME
                            else [])) == 0
    want = capsys.readouterr().out
    _same_text(out, want, f"{case} stdout")
    port_dir = base / case.replace(" ", "_")
    for name in ("o.csv", "l.csv"):
        if (tmp_path / name).exists():
            _same_text((port_dir / name).read_text(),
                       (tmp_path / name).read_text(), f"{case} {name}")
    if (tmp_path / "o.dx").exists():
        np.testing.assert_array_equal(read_dx(str(port_dir / "o.dx")),
                                      read_dx(str(tmp_path / "o.dx")))
        head = [x for x in (tmp_path / "o.dx").read_text().splitlines()
                if not NUM.fullmatch(x.split()[0] if x.split() else "")]
        got = [x for x in (port_dir / "o.dx").read_text().splitlines()
               if not NUM.fullmatch(x.split()[0] if x.split() else "")]
        assert got == head


def test_reference_entry_point(runs, tmp_path):
    """``python -m mpmc_tpu.analyze rdf --no-native`` (with
    JAX_ENABLE_X64=1 for its float64 cell) writes the port's CSV."""
    d, base, results = runs
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1")
    r = subprocess.run([sys.executable, "-m", "mpmc_tpu.analyze",
                        *_argv("rdf", d), "--no-native"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_text((base / "rdf" / "o.csv").read_text(),
               (tmp_path / "o.csv").read_text(), "rdf")


def test_imports_neither_jax_nor_reference():
    src = open(os.path.join(REPO, "mpmc_tpu_torch", "analyze.py")).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|mpmc_tpu)\b(?!_torch)",
                         src, re.M)
    code = ("import sys, mpmc_tpu_torch.analyze\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mpmc_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_frame_analyzers_need_a_device(runs):
    """Without a CUDA device a frame analyzer raises unless the CPU is
    asked for, on the command line too; the host statistics run without
    one."""
    d, _, _ = runs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device"):
        analyze.loading(str(d / "gcmc.pqr"), "H2")
    with pytest.raises(RuntimeError, match="device"):
        analyze.main(_argv("msd", d))
    assert analyze.main(_argv("blocking", d)[:-2]) == 0
    assert analyze.main(_argv("mbar", d)[:-2]) == 0
