"""Exact checkpoints of the port (io/checkpoint.py and its hooks in
mc/run.py::run_mc), on the CPU: a resumed chunk is bit-identical to an
uninterrupted one — positions, every energy term, the structure factor
and the generator's state —; through the CLI, one block written with
``checkpoint_output`` and one resumed with ``checkpoint_input`` end in the
state and averages of a two-block run on every single-chain route (scan
GCMC and NVT, the fused µVT and NVT kernels' and the fused polar delayed
acceptance's plain versions, the polar scan path); a checkpoint of
another system is refused.  The system of the direct test is built by the
JAX package and carried over (convert.from_jax)."""
import dataclasses
import io
import os

import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.models import systems as jsystems  # noqa: E402
from mpmc_tpu_torch import convert  # noqa: E402
from mpmc_tpu_torch.io import checkpoint, input_script, pqr  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.models import systems as tsystems  # noqa: E402
from mpmc_tpu_torch.state import EnergyBreakdown  # noqa: E402

torch.set_num_threads(1)


def _gcmc_system():
    """The reference's small MOF + H2 GCMC system (Ewald), float64, in the
    port, initialized."""
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8,
                                      ewald_kmax=3, dtype="float64")
    c = dataclasses.replace(c, use_pallas=False)
    P, S, C, T = convert.from_jax(p, s, c, t)
    return P, tm.initialize(S, P, C, T), C, T


def _assert_same_state(a, b):
    assert a.step == b.step
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, EnergyBreakdown):
            for k, v in x.as_dict().items():
                assert torch.equal(v, getattr(y, k)), (f.name, k)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def test_exact_resume_on_the_scan_path(tmp_path):
    """100 steps, a checkpoint, 100 more; the checkpoint loaded into a
    fresh generator and the same 100 steps: bit-identical positions,
    energies, S(k) and generator state."""
    P, S, C, T = _gcmc_system()
    g = torch.Generator().manual_seed(7)
    st1, _ = tm.run_chunk(S, P, C, T, 100, generator=g)
    path = str(tmp_path / "ck.pt")
    checkpoint.save(path, st1, extra={"note": "mid-run"}, generator=g)
    st2, _ = tm.run_chunk(st1, P, C, T, 100, generator=g)

    g2 = torch.Generator().manual_seed(12345)
    st1b, avgs, extra = checkpoint.load(path, S, generator=g2)
    assert extra == {"note": "mid-run"} and avgs.count() == 0
    _assert_same_state(st1b, st1)
    st2b, _ = tm.run_chunk(st1b, P, C, T, 100, generator=g2)
    _assert_same_state(st2b, st2)
    assert torch.equal(g.get_state(), g2.get_state())
    assert st2.step == 200 and not torch.equal(st2.pos, st1.pos)


def test_checkpoint_keeps_the_averages_and_template_state(tmp_path):
    P, S, C, T = _gcmc_system()
    raw = dataclasses.replace(S, e_frozen=None, sk_re=None, sk_im=None)
    full = checkpoint.template_state(raw, C, P, T)
    assert full.e_frozen is not None and full.sk_re is not None
    avgs = trun.Averages()
    avgs.add({"N": 3.0, "energy_total": -12.5})
    avgs.add({"N": 4.0, "energy_total": -13.25})
    path = str(tmp_path / "ck.pt")
    checkpoint.save(path, full, avgs)
    st, back, _ = checkpoint.load(path, S)
    assert back.samples == avgs.samples
    _assert_same_state(st, full)


def test_checkpoint_of_another_system_is_refused(tmp_path):
    """A checkpoint of a 24-atom fluid does not load into a 32-atom one
    (shape), nor into a state without its Ewald caches (field count) or of
    another precision (dtype); a load into a generator needs one saved."""
    p24, s24, c24, t24 = tsystems.lj_fluid(n=24, dtype="float64",
                                           device="cpu")
    s24 = tm.initialize(s24, p24, c24, t24)
    path = str(tmp_path / "ck.pt")
    checkpoint.save(path, s24)
    p32, s32, c32, t32 = tsystems.lj_fluid(n=32, dtype="float64",
                                           device="cpu")
    s32 = tm.initialize(s32, p32, c32, t32)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, s32)
    with pytest.raises(ValueError, match="tensor fields"):
        checkpoint.load(path, s24.replace(e_frozen=None))
    p, s, c, t = tsystems.lj_fluid(n=24, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load(path, tm.initialize(s, p, c, t))
    with pytest.raises(ValueError, match="no generator state"):
        checkpoint.load(path, s24, generator=torch.Generator())


def _mof_deck(tmp_path, precision="float64", *extra):
    params, state, _, _ = tsystems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8,
                                               ewald_kmax=3, device="cpu")
    pqr.write_state(str(tmp_path / "mof.pqr"), params, state, ["H2"])
    L = float(state.box[0, 0])
    return (f"ensemble uvt\ncorrtime 50\nseed 5\ntemperature 77\n"
            f"pressure 20.0\nbasis1 {L} 0 0\nbasis2 0 {L} 0\n"
            f"basis3 0 0 {L}\newald_kmax 3\ninsert_probability 0.5\n"
            "cavity_autoreject_absolute 1.0\nmax_molecules 8\n"
            f"allow_charged_cell on\nprecision {precision}\n"
            f"pqr_input {tmp_path / 'mof.pqr'}\n" + "".join(
                f"{x}\n" for x in extra))


def _lj_deck(tmp_path, precision="float64", *extra):
    params, state, _, _ = tsystems.lj_fluid(n=32, device="cpu")
    pqr.write_state(str(tmp_path / "fluid.pqr"), params, state, ["AR"])
    L = float(state.box[0, 0])
    return (f"ensemble nvt\ncorrtime 50\nseed 3\ntemperature 120\n"
            f"basis1 {L} 0 0\nbasis2 0 {L} 0\nbasis3 0 0 {L}\n"
            f"move_factor 0.5\nrot_factor 0\ncoulomb off\n"
            f"precision {precision}\npqr_input {tmp_path / 'fluid.pqr'}\n"
            + "".join(f"{x}\n" for x in extra))


def _polar_deck(tmp_path, precision="float64", *extra):
    from torch_polar import polar_deck
    job = polar_deck(tmp_path, "corrtime 50\n" + "".join(
        f"{x}\n" for x in extra), precision=precision)
    return (tmp_path / "deck.inp").read_text().replace(
        f"numsteps {job.cfg.numsteps}\n", "")


ROUTES = {
    "scan-uvt": (_mof_deck, "float64", (), None),
    "scan-nvt": (_lj_deck, "float64", (), None),
    "fused-uvt-B1": (_mof_deck, "float32", ("fused_mc on",),
                     "single-chain fused µVT kernel"),
    "fused-nvt-B3": (_lj_deck, "float32", ("fused_mc on",),
                     "single-chain fused NVT kernel"),
    "fused-pda-B6": (_polar_deck, "float32",
                     ("polar_delayed on", "fused_mc on"),
                     "polar delayed-acceptance stage-1 kernel"),
    "polar-scan": (_polar_deck, "float64", (), None),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_resume_equals_an_uninterrupted_run(route, tmp_path):
    """One corrtime block with ``checkpoint_output``, then one block with
    ``checkpoint_input``: the final state (positions, alive mask, every
    energy term, caches, step) and both blocks' averages equal a two-block
    run's, bit for bit."""
    make, precision, extra, route_line = ROUTES[route]
    text = make(tmp_path, precision, *extra)
    ck = tmp_path / "run.ck.pt"

    def run(lines):
        buf = io.StringIO()
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            su, avgs = trun.run(input_script.parse(text + lines), log=buf,
                                device="cpu")
        finally:
            os.chdir(old)
        return su, avgs, buf.getvalue()

    su_a, avgs_a, log_a = run("numsteps 100\n")
    if route_line:
        assert route_line in log_a
    run(f"numsteps 50\ncheckpoint_output {ck}\n")
    assert ck.exists()
    su_c, avgs_c, log_c = run(f"numsteps 50\ncheckpoint_input {ck}\n")
    # the fused polar DA counts the steps its segments did (>= 50)
    step = torch.load(ck, weights_only=True)["step"]
    assert step == 50 or (route == "fused-pda-B6" and 50 <= step < 66)
    assert f"resumed exactly from {ck} at step {step}" in log_c
    _assert_same_state(su_c.state, su_a.state)
    assert avgs_c.samples == avgs_a.samples
    assert avgs_c.count() == 2
