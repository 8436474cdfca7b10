"""The port's NPT batched chains (metropolis.make_batched_step_fn's volume
step, a box per chain; B4 over chains with a [C, 20] header, run here
through its plain version) against its own single-chain scan path and the
JAX package: each chain against the chain run alone over the same rows,
the per-chain header, the batched box constants, the per-chain refresh,
and the CLI ideal-gas deck (tests/test_parallel.py::test_chains_npt_cli)."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpmc_tpu.constants import ATM2K_A3  # noqa: E402
from mpmc_tpu.mc import metropolis as jm  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import moves as tmoves  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.ops import ewald as tewald  # noqa: E402
from mpmc_tpu_torch.ops import pairs as tpairs  # noqa: E402
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk  # noqa: E402
from mpmc_tpu_torch.parallel import multichain  # noqa: E402
from mpmc_tpu_torch.state import slice_chain, stack_chains  # noqa: E402
from torch_npt import hcl_npt, lj_npt, port, table  # noqa: E402

torch.set_num_threads(1)
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl")
SYSTEMS = {"lj": lj_npt, "hcl_ewald": hcl_npt}


def _apart(P, S, C, T, n=3):
    """n chains of S, each moved apart by a scan-path NPT chunk of its own
    (different boxes and positions), stacked."""
    return stack_chains([tm.run_chunk(
        S, P, C, T, 40, generator=torch.Generator().manual_seed(50 + c))[0]
        for c in range(n)])


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_each_chain_is_the_chain_run_alone(system):
    """C = 3 NPT chains in their own boxes over an injected [3, K, 16]
    table: each ends in the positions, box, energy and accept counts of a
    single-chain run_chunk over its own rows with chain 0's lane 8 (the
    shared move type), and its carried energy equals a fresh recompute to
    1e-9 (f64)."""
    _, P, S, C, T = port(SYSTEMS[system](pv=0.25))
    states = _apart(P, S, C, T)
    K = 100
    u = table(K, seed=2, C=3)
    out, stats = multichain.run_chunk_batched(states, P, C, T, K,
                                              uniforms=u)
    st_h = stats.host()
    assert st_h.attempts[0, tm.VOLUME] > 15
    assert (st_h.accepts[:, tm.VOLUME] > 0).all()
    for c in range(3):
        uc = u[c].clone()
        uc[:, 8] = u[0, :, 8]
        one, st1 = tm.run_chunk(slice_chain(states, c), P, C, T, K,
                                uniforms=uc)
        sc = slice_chain(out, c)
        assert st_h.accepts[c].tolist() == st1.host().accepts.tolist()
        torch.testing.assert_close(sc.box, one.box, rtol=1e-14, atol=0)
        torch.testing.assert_close(sc.pos, one.pos, rtol=0, atol=1e-11)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(one.energy, k)), rel=1e-12, abs=1e-10), k
        fresh = tm.initialize(sc, P, C, T)
        for k in TERMS:
            assert float(getattr(sc.energy, k)) == pytest.approx(
                float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k


def test_plain_b4_with_a_header_per_chain():
    """mol_pair_chains (its plain version on the CPU) with a [C, 20]
    header equals mol_pair_plain of each chain with its own header, and
    the batched mol_pair_pass each chain's single pass; a shared [20]
    header still gives each chain the shared header's numbers."""
    _, P, S, C, T = port(hcl_npt())
    states = _apart(P, S, C, T)
    scal = tpairs.pair_scalars(states.box, C)
    assert scal.shape == (3, 20)
    mol = torch.tensor([0, 3, 5])
    rows = tmoves.displace_rows(states.pos, P, mol, table(1, C=3)[:, 0],
                                0.6, 0.8)
    alive = states.mol_alive[:, P.mol_id] & P.atom_ok
    for r in (None, rows):
        got = tpk.mol_pair_chains(states.pos, P.charge, P.eps, P.sig,
                                  P.mol_id32, alive, P.mol_atoms,
                                  P.mol_natoms, mol, r, scal, C)
        shared = tpk.mol_pair_chains(states.pos, P.charge, P.eps, P.sig,
                                     P.mol_id32, alive, P.mol_atoms,
                                     P.mol_natoms, mol, r, scal[0], C)
        terms = tpairs.mol_pair_pass(states.pos, states.box, alive, P, C,
                                     T.temperature, mol, row_pos=r,
                                     scal=scal)
        for c in range(3):
            rc = None if r is None else r[c]
            one = tpk.mol_pair_plain(states.pos[c], P.charge, P.eps, P.sig,
                                     P.mol_id32, alive[c], P.mol_atoms,
                                     P.mol_natoms, mol[c], rc, scal[c], C)
            assert torch.equal(got[c], one)
            assert torch.equal(shared[c], tpk.mol_pair_plain(
                states.pos[c], P.charge, P.eps, P.sig, P.mol_id32,
                alive[c], P.mol_atoms, P.mol_natoms, mol[c], rc, scal[0],
                C))
            single = tpairs.mol_pair_pass(
                states.pos[c], states.box[c], alive[c], P, C, T.temperature,
                mol[c], row_pos=rc)
            for k in ("rd", "es_real", "lrc_coeff", "min_r2"):
                assert torch.equal(getattr(terms, k)[c],
                                   getattr(single, k)), k
        assert not torch.equal(got[1], shared[1])


def test_batched_box_constants_are_each_chains():
    """A chunk of stacked boxes ([C] cutoff and alpha, [C, 20] header, [C,
    Nk, 3] k-vectors, per-chain recip weights) equals each box's own, and
    the batched S(k) delta of one molecule per chain each chain's."""
    _, P, S, C, T = port(hcl_npt())
    states = _apart(P, S, C, T)
    cb = tm._Chunk(states.box, P, C, T)
    mol = torch.tensor([1, 2, 4])
    rows = tmoves.displace_rows(states.pos, P, mol, table(1, C=3)[:, 0],
                                0.6, 0.8)
    d_re, d_im = tm._mol_sf_delta(states.pos, rows, P, mol, cb.kv)
    for c in range(3):
        c1 = tm._Chunk(states.box[c], P, C, T)
        for a, b in ((cb.rc[c], c1.rc), (cb.alpha[c], c1.alpha),
                     (cb.scal[c], c1.scal), (cb.volume[c], c1.volume),
                     (cb.recip_w[0][c], c1.recip_w[0])):
            torch.testing.assert_close(a, b, rtol=1e-15, atol=0)
        torch.testing.assert_close(cb.kv[c], c1.kv, rtol=1e-15, atol=1e-15)
        torch.testing.assert_close(cb.recip_w[1][c], c1.recip_w[1],
                                   rtol=1e-14, atol=0)
        o_re, o_im = tm._mol_sf_delta(states.pos[c], rows[c], P, mol[c],
                                      c1.kv)
        torch.testing.assert_close(d_re[c], o_re, rtol=1e-13, atol=1e-14)
        torch.testing.assert_close(d_im[c], o_im, rtol=1e-13, atol=1e-14)
    assert tewald.kvectors(states.box, C.ewald_kmax).shape == (
        3,) + c1.kv.shape


def test_refresh_uses_each_chains_box():
    """initialize_batched of chains in different boxes: each chain equals
    metropolis.initialize of the chain alone, and mpmc_tpu's initialize of
    the same positions and box (rel 1e-12)."""
    (jp, js, jc, jt), P, S, C, T = port(hcl_npt())
    states = multichain.initialize_batched(_apart(P, S, C, T), P, C, T)
    for c in range(3):
        sc = slice_chain(states, c)
        one = tm.initialize(sc, P, C, T)
        ref = jm.initialize(js.replace(pos=jnp.asarray(sc.pos.numpy()),
                                       box=jnp.asarray(sc.box.numpy())),
                            jp, jc, jt).reported_energy()
        for k in TERMS:
            assert torch.equal(getattr(sc.energy, k),
                               getattr(one.energy, k)), k
            assert float(getattr(sc.reported_energy(), k)) == pytest.approx(
                float(getattr(ref, k)), rel=1e-12, abs=1e-12), (c, k)


def test_npt_chains_cli_ideal_gas(tmp_path, monkeypatch):
    """Batched chains with NPT volume moves stay correct: <V> tracks the
    ideal-gas (N + 1) kT / P within 25 % (tests/test_parallel.py::
    test_chains_npt_cli: three non-interacting atoms, 6 chains, 4,000
    steps; their charges are zero, so the deck turns Coulomb off)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "id.pqr").write_text("\n".join(
        f"ATOM {i+1} He HE {i+1} M {2+3*i} 5.0 5.0 4.0 0.0 0.0 0.0 0.0"
        for i in range(3)) + "\nEND\n")
    t, p_atm = 200.0, 60.0
    job = input_script.parse(f"""
ensemble npt
numsteps 4000
corrtime 500
temperature {t}
pressure {p_atm}
volume_probability 0.3
volume_change_factor 0.3
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
rd_lrc off
coulomb off
chains 6
pair_chunk 32
precision float64
pqr_input id.pqr
""")
    buf = io.StringIO()
    su, avgs = trun.run(job, log=buf, device="cpu")
    assert "batched scan chains (C=6)" in buf.getvalue()
    assert len(set(float(torch.linalg.det(b)) for b in su.states.box)) == 6
    expect = 4 * t / (p_atm * ATM2K_A3)
    got = np.mean(avgs.samples["volume"][2:])
    assert got == pytest.approx(expect, rel=0.25)
