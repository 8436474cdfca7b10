"""Shared set-up of the parity fuzz tier (tests/test_torch_fuzz_*.py): the
committed corpus (tests/torch_fuzz_corpus.json, tools/make_fuzz_corpus.py),
each entry built by the JAX package and carried over to the port, and the
checks every entry gets, float64 unless said otherwise:

(a) gates   — each of the port's gates against the reference's on the
    entry's float32 configuration, and the port's own build of the entry
    (chip_smoke.fuzz_system, what the card phase runs) equal to the
    reference's build carried over;
(b) energies — total_energy term by term, plain and split_frozen, on the
    initial state and on the state the entry's chunk leaves;
(c) moves   — one move of each type the ensemble allows through the port's
    step, its delta against the reference's recompute of the state after;
(d) bookkeeping — after the chunk on the entry's route, carried = fresh;
(e) trajectories — on a fused route, the reference's kernel in Pallas
    interpret mode and the port's plain twin on one numpy table (float32);
(f) scan against fused — the port's scan path and its fused plain twin on
    one table make the same decisions.

A refusal entry (a reference trap the port refuses on purpose) gets (a),
(b) on its initial state, and its route's ValueError in place of (c),
(d) and (f).
"""
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.ops import energy as jenergy
from mpmc_tpu.ops import pairs as jpairs
from mpmc_tpu.ops import thole as jthole
from mpmc_tpu.ops.pallas import mc_kernel as jmk
from mpmc_tpu.ops.pallas import pair_kernel as jpk
from mpmc_tpu.ops.pallas import thole_kernel as jtk
from mpmc_tpu.parallel import spatial as jspatial
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.mc import metropolis as tm
from mpmc_tpu_torch.ops import energy as tenergy
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk
from mpmc_tpu_torch.ops.cuda import pair_kernel as tpk
from mpmc_tpu_torch.ops.cuda import thole_kernel as ttk
from mpmc_tpu_torch.parallel import multichain
from mpmc_tpu_torch.parallel import spatial as tspatial
from mpmc_tpu_torch.state import (mol_rows_update, slice_chain,
                                  stack_chains)
from tools import make_fuzz_corpus as fc

torch.set_num_threads(1)

CORPUS = fc.load()
ENTRIES = {e["id"]: e for e in CORPUS["entries"]}
N_SHARDS = 24   # tests/test_torch_fuzz_00.py .. _23.py
TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl", "polar",
         "vdw")
# the float64 runs solve the SCF to this residual, so that a carried polar
# term and a fresh solve agree far below the bookkeeping rule
POLAR_PRECISION = 1e-13
# (b): the port's terms against the reference's
E_REL, E_ABS = 1e-10, 1e-8
# (c) and (d) hold a difference of energies: each side is a sum of terms
# rounded in float64, so the rule scales with the system's energy
# magnitude (the sum of |terms|, frozen part included)
MOVE_REL, BOOK_REL = 1e-10, 1e-9
# (c): draws a move type gets until one is accepted
MOVE_TRIES = 24


def cost(entry):
    """A rough CPU cost of an entry's checks, in seconds: a polar step
    solves the SCF over every chain."""
    c = entry["cfg"]
    return 2.0 + 0.35 * c["polarization"] * entry["steps"] * entry["chains"]


def shard(k):
    """The ids of shard ``k`` of N_SHARDS: the corpus dealt out by cost,
    heaviest first, each to the lightest shard so far (so that every test
    file takes about the same time, and --dist loadfile spreads them over
    the workers)."""
    load = [0.0] * N_SHARDS
    out = [[] for _ in range(N_SHARDS)]
    for e in sorted(CORPUS["entries"], key=lambda e: (-cost(e), e["id"])):
        i = load.index(min(load))
        load[i] += cost(e)
        out[i].append(e["id"])
    return sorted(out[k])


def shard_tests(k):
    """The tests of shard ``k``'s file (tests/test_torch_fuzz_NN.py):
    (a)-(d) on every entry of the shard, (f) on its entries of
    scan_vs_fused_ids, each parametrized by entry id."""
    ids = shard(k)
    each = pytest.mark.parametrize("eid", ids)

    @each
    def test_gates(eid):
        check_gates(eid)

    @each
    def test_energies(eid):
        check_energies(eid)

    @each
    def test_moves(eid):
        check_moves(eid)

    @each
    def test_bookkeeping(eid):
        check_bookkeeping(eid)

    @pytest.mark.parametrize("eid", scan_vs_fused_ids(ids))
    def test_scan_vs_fused(eid, monkeypatch):
        check_scan_vs_fused(eid, monkeypatch)

    return {f.__name__: f for f in (test_gates, test_energies, test_moves,
                                    test_bookkeeping, test_scan_vs_fused)}


def fused_ids(ids):
    """The entries of ``ids`` on a fused route (no refusal)."""
    return [i for i in ids if ENTRIES[i]["route"] in fc.FUSED + ("pda",)
            and not ENTRIES[i]["refusal"]]


def scan_vs_fused_ids(ids):
    """The fused entries (f) applies to.  Not the fused polar DA under
    polar_ewald: B6's stage-1 surrogate leaves out the k-space part of the
    field delta (the reference's design, mpmc_tpu/ops/pallas/mc_kernel.py
    supported_uvt_polar_da), the scan-path delayed acceptance prices the
    exact zodid delta, so the two filter and correct differently (both
    exact in distribution, not step for step)."""
    return [i for i in fused_ids(ids)
            if not (ENTRIES[i]["route"] == "pda"
                    and ENTRIES[i]["cfg"].get("polar_ewald"))]


def _f64_cfg_kw(entry):
    """The float64 runs' overrides: a tight SCF where the entry is polar."""
    return ({"polar_precision": POLAR_PRECISION}
            if entry["cfg"]["polarization"] else {})


@functools.lru_cache(maxsize=None)
def system(eid, dtype="float64"):
    """((p, s, c, t) of the reference, as built; (P, S, C, T) of the port
    carried over and initialized by it).  NVE: nve_energy = U(initial) +
    the entry's kinetic reservoir."""
    e = ENTRIES[eid]
    p, s, c, t = fc.reference_system(e, dtype)
    if dtype == "float64":
        c = dataclasses.replace(c, **_f64_cfg_kw(e))
    P, S, C, T = convert.from_jax(p, s, c, t)
    S = tm.initialize(S, P, C, T)
    if C.ensemble == "nve":
        u = float(S.energy.total + S.e_frozen.total)
        T = T.replace(nve_energy=torch.tensor(u + e["nve_kinetic"],
                                              dtype=C.tdtype))
    return (p, s, c, t), (P, S, C, T)


@functools.lru_cache(maxsize=None)
def reference_energy(eid, split):
    """The reference's total_energy of the entry's float64 system, jitted
    over (pos, box, mol_alive) with everything else fixed: one compile an
    entry, then each call takes milliseconds (the tier's budget)."""
    (p, s, c, t), _ = system(eid)
    f = jax.jit(lambda pos, box, alive: jenergy.total_energy(
        pos, box, alive, p, c, t, split_frozen=split))

    def call(pos, box, alive):
        out = f(jnp.asarray(np.asarray(pos)), jnp.asarray(np.asarray(box)),
                jnp.asarray(np.asarray(alive)))
        return out[:-1]
    return call


def table(eid, dtype=torch.float64):
    """The entry's [C, K, 16] uniform table (PDA: [n_seg, PDA_SEG, 16],
    ample segments)."""
    e = ENTRIES[eid]
    if e["route"] == "pda":
        shape = (e["steps"] + 1, tmk.PDA_SEG, 16)
    else:
        shape = (e["chains"], e["steps"], 16)
    return torch.as_tensor(fc.uniforms(e, shape), dtype=dtype)


def refusal_match(entry):
    name = entry["refusal"]
    return re.escape(getattr(tm, name)[:40])


def run_route(eid, P, S, C, T, u):
    """(states, stats) of the entry's chunk on its route (the fused
    routes on their plain twins: these tensors lie on the CPU);
    single-chain routes return one state."""
    e = ENTRIES[eid]
    r, K = e["route"], e["steps"]
    if r == "scan":
        return tm.run_chunk(S, P, C, T, K, uniforms=u[0])
    if r.startswith("batched"):
        st = stack_chains([S] * e["chains"])
        return multichain.run_chunk_batched(st, P, C, T, K, uniforms=u)
    if r == "pda":
        return tm.run_chunk_fused_uvt_polar_da(S, P, C, T, K, uniforms=u)
    if r == "fused1":
        fn = {"uvt": tm.run_chunk_fused_uvt, "npt": tm.run_chunk_fused_npt
              }.get(C.ensemble, tm.run_chunk_fused)
        return fn(S, P, C, T, K, uniforms=u[0])
    st = stack_chains([S] * e["chains"])
    fn = (tm.run_chunk_fused_uvt_multi if C.ensemble == "uvt"
          else tm.run_chunk_fused_multi)
    return fn(st, P, C, T, K, uniforms=u)


@functools.lru_cache(maxsize=None)
def chunk(eid):
    """The port's float64 chunk of the entry on its route: (states,
    stats), or the ValueError it raised."""
    _, (P, S, C, T) = system(eid)
    try:
        return run_route(eid, P, S, C, T, table(eid))
    except ValueError as err:
        return err


def first_chain(e, states):
    return slice_chain(states, 0) if e["chains"] > 1 and (
        e["route"] != "pda") else states


def _scale(*energies):
    return max(1.0, sum(abs(float(getattr(x, k))) for x in energies
                        for k in TERMS if x is not None))


# ---------------------------------------------------------------------------
# (a) gates
# ---------------------------------------------------------------------------

def _thole_route(cfg):
    """Whether the port's B5 takes the cfg's damping (it raises for any
    other, ops/cuda/thole_kernel.py damping)."""
    try:
        ttk.damping(torch.ones(1, dtype=torch.float64), 2.0,
                    cfg.polar_damp_type)
    except ValueError:
        return False
    return True


def gates_port(C, P):
    return {"supported_uvt": tmk.supported_uvt(C, P),
            "supported_uvt_polar_da": tmk.supported_uvt_polar_da(C, P),
            "supported_uvt_multi": tmk.supported_uvt_multi(C, P),
            "supported": tmk.supported(C, P),
            "supported_npt": tmk.supported_npt(C, P),
            "supported_multi": tmk.supported_multi(C, P),
            "pair": tpk.supported(C), "thole": _thole_route(C),
            "spatial": tspatial.mc_supported(C)}


def gates_reference(c, p):
    return {"supported_uvt": jmk.supported_uvt(c, p),
            "supported_uvt_polar_da": jmk.supported_uvt_polar_da(c, p),
            "supported_uvt_multi": jmk.supported_uvt_multi(c, p),
            "supported": jmk.supported(c, p),
            "supported_npt": jmk.supported_npt(c, p),
            "supported_multi": jmk.supported_multi(c, p),
            "pair": jpk.supported(c), "thole": jtk.supported(c),
            "spatial": jspatial.mc_supported(c)}


# The documented differences between the gates:
# - PAIR_THOLE_F32: the reference's B2 / B4 gate (pair_kernel.py:313) and
#   its Thole gate (thole_kernel.py:251) hold float32 only; the port
#   launches float64 instances of B2, B4 and B5 (ROADMAP.md, "Deliberate
#   differences"), so on a float64 cfg the port says yes where the
#   reference says no.
# - MULTI_WIDTH_CAP: the reference's C-chain drivers also require C <=
#   MAX_MULTI_CHAINS and multi_width_ok(C, params) (mc_kernel.py:755-772),
#   a VMEM cap; the port's C-chain gates take no C (bounded by device
#   memory only).  Every corpus entry lies inside the cap, so the gate
#   functions are compared as they are.
DOCUMENTED = ("PAIR_THOLE_F32", "MULTI_WIDTH_CAP")


def check_gates(eid):
    e = ENTRIES[eid]
    p, s, c, t = fc.reference_system(e, "float32")
    P, S, C, T = convert.from_jax(p, s, c, t)
    # the card phase's own build of the entry equals the reference's
    import chip_smoke
    P2, S2, C2, T2 = chip_smoke.fuzz_system(e, "float32", "cpu")
    assert C2 == C
    for f in dataclasses.fields(P):
        a, b = getattr(P, f.name), getattr(P2, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b.to(a.dtype)), f.name
    for k in ("pos", "box", "mol_alive", "spin", "rot_f"):
        a, b = getattr(S, k), getattr(S2, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a, b.to(a.dtype)), k
    for k in ("temperature", "fugacity", "insert_probability",
              "spinflip_probability", "tmmc_eta"):
        a, b = getattr(T, k), getattr(T2, k)
        if a is not None:
            assert torch.equal(a, b.to(a.dtype)), k
    want = gates_reference(c, p)
    got = gates_port(C, P)
    assert got == want, (eid, got, want)
    # PAIR_THOLE_F32 on the float64 cfg
    c64 = dataclasses.replace(c, dtype="float64")
    C64 = dataclasses.replace(C, dtype="float64")
    got64, want64 = gates_port(C64, P), gates_reference(c64, p)
    assert not want64["pair"] and not want64["thole"]
    assert got64["pair"] == want["pair"]
    assert got64["thole"] == want["thole"]
    for k in set(got64) - {"pair", "thole"}:
        assert got64[k] == want64[k], k
    # MULTI_WIDTH_CAP: inside the reference's cap at the entry's C
    assert e["chains"] <= jmk.MAX_MULTI_CHAINS
    assert jmk.multi_width_ok(e["chains"], p)
    # the entry's route is open on both sides (the generator kept it so)
    gate = {"pda": "supported_uvt_polar_da",
            "fused1": {"uvt": "supported_uvt", "npt": "supported_npt"}.get(
                c.ensemble, "supported"),
            "fused2": ("supported_uvt_multi" if c.ensemble == "uvt"
                       else "supported_multi")}
    gate["fused5"] = gate["fused2"]
    if e["route"] in gate:
        assert got[gate[e["route"]]]


# ---------------------------------------------------------------------------
# (b) energies
# ---------------------------------------------------------------------------

def _assert_terms(got, want, what):
    for k in TERMS:
        a, b = float(getattr(got, k)), float(getattr(want, k))
        assert a == pytest.approx(b, rel=E_REL, abs=E_ABS), (what, k, a, b)


def _energies_at(eid, P, C, T, pos, box, alive):
    (e_ref,) = reference_energy(eid, False)(pos, box, alive)
    e_port, _ = tenergy.total_energy(pos, box, alive, P, C, T)
    _assert_terms(e_port, e_ref, "plain")
    a_ref, f_ref = reference_energy(eid, True)(pos, box, alive)
    a_port, f_port, _ = tenergy.total_energy(pos, box, alive, P, C, T,
                                             split_frozen=True)
    _assert_terms(a_port, a_ref, "active")
    _assert_terms(f_port, f_ref, "frozen")


def check_energies(eid):
    e = ENTRIES[eid]
    _, (P, S, C, T) = system(eid)
    _energies_at(eid, P, C, T, S.pos, S.box, S.mol_alive)
    out = chunk(eid)
    if e["refusal"]:
        assert isinstance(out, ValueError)
        return
    st = first_chain(e, out[0])
    _energies_at(eid, P, C, T, st.pos, st.box, st.mol_alive)


# ---------------------------------------------------------------------------
# (c) one move of each type
# ---------------------------------------------------------------------------

MOVE_BRANCH = {"displace": tm.DISPLACE, "insert": tm.INSERT,
               "delete": tm.DELETE, "volume": tm.VOLUME,
               "spinflip": tm.SPINFLIP}


def _branch_index(C, move):
    """The position of ``move`` in the ensemble's branch table."""
    _, ids = tm.make_branch_picker(C)
    return ids.index(MOVE_BRANCH[move])


def check_moves(eid):
    """Each move type through the port's step on fresh draws of the
    uniforms (both coins 0), until one is accepted: the first draw at the
    entry's step sizes, the next MOVE_TRIES - 1 at a tenth of them.  On
    every draw the proposal's deltas (the step's trace) against the
    reference's recompute of the proposed state, and after it the carried
    deltas against the reference's recompute of the state the step left
    (a rejected draw: unchanged).  Every move type must be accepted on some
    draw, unless the reference says no draw could be: an insert the state
    cannot take (``_insert_blocked``), or every proposal's reference
    energy change beyond what the coin 0 lets through (``_prohibitive``)."""
    e = ENTRIES[eid]
    _, (P, S, C, T) = system(eid)
    rng = np.random.default_rng(e["useed"] + 1)
    if e["refusal"] == "NPT_FROZEN_TRAP":
        with pytest.raises(ValueError, match=refusal_match(e)):
            tm.make_step_fn(P, C)
        return
    energy = reference_energy(eid, True)
    a0, f0 = energy(S.pos, S.box, S.mol_alive)
    small = T.replace(move_factor=0.1 * T.move_factor,
                      rot_factor=0.1 * T.rot_factor,
                      volume_change_factor=0.1 * T.volume_change_factor)
    ok = {}
    for move in fc.moves(e):
        ok[move] = move == "insert" and _insert_blocked(S, P, C)
        could = False
        for k in range(1 if ok[move] else MOVE_TRIES):
            acc, du_ref, rec = _one_move(S, P, C, small if k else T, move,
                                         rng, energy, a0, f0)
            if acc:
                ok[move] = True
                break
            could |= du_ref is not None and not _prohibitive(
                S, C, T, rec, du_ref)
        ok[move] = ok[move] or (move in ("displace", "insert", "delete")
                                and not could)
    assert all(ok.values()), ok


def _insert_blocked(S, P, C):
    """Whether no insert can be accepted: under cavity bias the grid has
    no open cell (the step rejects every insert, as the reference's
    does), or no insert species has a free slot."""
    if C.cavity_bias and not bool(S.cavity_open.any()):
        return True
    free = ~S.mol_alive & torch.isin(
        P.mol_species, torch.as_tensor(C.insert_species))
    return not bool(free.any())


# the coin 0 is clamped to 1e-38: a move whose log acceptance is below
# log(1e-38) = -87.5 is rejected; the margin covers the TMMC tilt (|d eta|
# < 2) and the delayed acceptance's surrogate
PROHIBITIVE = 87.5 + 10.0


def _prohibitive(S, C, T, rec, du_ref):
    """Whether a proposal whose reference energy change is ``du_ref`` K
    cannot pass the coin 0: under NVE the reservoir cannot pay it, else
    its log acceptance (the step's ln_bias, the reference's du) is below
    -PROHIBITIVE."""
    if C.ensemble == "nve":
        k_old = float(T.nve_energy - (S.energy.total + S.e_frozen.total))
        return du_ref >= k_old
    return float(rec["ln_bias"]) - du_ref / float(T.temperature) < (
        -PROHIBITIVE)


def _proposed(S, P, C, move, rec):
    """(pos, mol_alive) of the proposal in the step's trace ``rec``, or
    None where there is no state to price: a move whose proposal the trace
    does not spell out (volume, spinflip), a target the move cannot take
    (a dead or frozen molecule to move or delete, a live one to insert
    over), or an insert or displacement inside the autoreject radius —
    each judged from the state, not from the step's own reject flag."""
    if move not in ("displace", "insert", "delete"):
        return None
    mol = int(rec["mol"])
    sp = int(P.mol_species[mol])
    live = bool(S.mol_alive[mol]) and not bool(P.mol_frozen[mol])
    if sp < 0 or live != (move != "insert") or (
            move != "displace" and sp not in C.insert_species):
        return None
    pos, alive = S.pos.clone(), S.mol_alive.clone()
    if rec["rows"] is not None:
        mol_rows_update(pos, P, torch.tensor(mol), rec["rows"])
    if move != "displace":
        alive[mol] = move == "insert"
    if move != "delete" and C.cavity_autoreject_absolute > 0.0:
        own = P.mol_id == mol
        other = alive[P.mol_id] & P.atom_ok & ~own
        d = pos[own & P.atom_ok][:, None] - pos[other][None]
        f = d @ torch.linalg.inv(S.box)
        d = (f - torch.round(f)) @ S.box
        if bool((d.norm(dim=-1) < C.cavity_autoreject_absolute).any()):
            return None
    return pos, alive


def _one_move(S, P, C, T, move, rng, energy, a0, f0):
    """One ``move`` of the port's step on a fresh draw, checked: (1 if it
    was accepted, the reference's energy change of the proposal or None,
    the step's trace record).  A rejected draw must leave the state as it
    was; an accepted one's carried deltas are held against the reference's
    energy of the state it left (the proposal's, when that was priced)."""
    u = torch.as_tensor(rng.random(16))
    u[4] = u[12] = 0.0            # the coins (stage 2's under delayed acc.)
    step, carry, cc, _, stats = tm.chunk_setup(S, P, C, T, u[None])
    trace = []
    step(carry, u, _branch_index(C, move), T, cc, stats, trace=trace)
    rec = trace[0]
    acc = int(stats.accepts[MOVE_BRANCH[move]])
    du_ref = None
    e1 = None
    prop = _proposed(S, P, C, move, rec)
    if prop is not None:
        a2, f2 = energy(prop[0], S.box, prop[1])
        du_ref = sum(float(getattr(a2, k) - getattr(a0, k)) for k in TERMS)
        scale = _scale(a0, f0, a2, f2)
        for k in TERMS:
            if k in ("polar", "vdw"):
                continue          # priced outside the trace's d
            d_port = float(getattr(rec["d"], k))
            d_ref = float(getattr(a2, k) - getattr(a0, k))
            assert abs(d_port - d_ref) <= (MOVE_REL * abs(d_ref)
                                           + 1e-12 * scale + 1e-9), (
                "proposal", move, k, d_port, d_ref)
        if torch.equal(carry["pos"], prop[0]) and torch.equal(
                carry["mol_alive"], prop[1]):
            e1 = (a2, f2)
    if not acc:
        assert torch.equal(carry["pos"], S.pos) and torch.equal(
            carry["mol_alive"], S.mol_alive), move
        for k in TERMS:
            assert float(getattr(carry["energy"], k)) == float(
                getattr(S.energy, k)), (move, k)
        return acc, du_ref, rec
    a1, f1 = e1 or energy(carry["pos"], carry["box"], carry["mol_alive"])
    scale = _scale(a0, f0, a1, f1)
    for k in TERMS:
        d_port = float(getattr(carry["energy"], k) - getattr(S.energy, k))
        d_ref = float(getattr(a1, k) - getattr(a0, k))
        assert abs(d_port - d_ref) <= (MOVE_REL * abs(d_ref)
                                       + 1e-12 * scale + 1e-9), (
            move, acc, k, d_port, d_ref)
    return acc, du_ref, rec


# ---------------------------------------------------------------------------
# (d) bookkeeping
# ---------------------------------------------------------------------------

def _assert_book(st, fresh, what):
    scale = _scale(fresh.energy, fresh.e_frozen)
    for k in TERMS:
        a, b = float(getattr(st.energy, k)), float(getattr(fresh.energy, k))
        assert abs(a - b) <= BOOK_REL * scale, (what, k, a, b, scale)


def check_bookkeeping(eid):
    e = ENTRIES[eid]
    _, (P, S, C, T) = system(eid)
    out = chunk(eid)
    if e["refusal"]:
        assert isinstance(out, ValueError)
        assert re.match(refusal_match(e), str(out)), str(out)
        return
    assert not isinstance(out, ValueError), str(out)
    states, stats = out
    att = np.asarray(stats.attempts)
    assert att.sum() > 0
    if e["chains"] > 1 and e["route"] != "pda":
        fresh = multichain.initialize_batched(states, P, C, T)
        for k in range(e["chains"]):
            _assert_book(slice_chain(states, k), slice_chain(fresh, k),
                         f"chain {k}")
    else:
        fresh = tm.initialize(states, P, C, T)
        _assert_book(states, fresh, "chain")


# ---------------------------------------------------------------------------
# (f) scan against fused, inside the port
# ---------------------------------------------------------------------------

def _record_segments(monkeypatch):
    """The n_done of each B6 launch of a PDA chunk."""
    seen = []
    real = tmk.run_steps_uvt_pda

    def rec(*a, **k):
        out = real(*a, **k)
        seen.append(int(out[0, 0]))
        return out

    monkeypatch.setattr(tmk, "run_steps_uvt_pda", rec)
    return seen


def _scan_npt_schedule(P, S, C, T, rows):
    """The scan path over ``rows`` with the hybrid fused NPT chunk's
    fixed schedule (run_chunk_fused_npt: n_v = round(pv K) volume
    attempts, each after its share of displacements) in place of lane
    8's pick."""
    K = len(rows)
    n_v = int(round(float(T.volume_probability) * K))
    base, rem = divmod(K - n_v, n_v)
    branch = []
    for s in range(n_v):
        branch += [0] * (base + 1 if s < rem else base) + [1]
    step, carry, c, _, stats = tm.chunk_setup(S, P, C, T, rows)
    for k, b in enumerate(branch):
        step(carry, carry["u"][k], b, T, c, stats)
    return tm._from_carry(S, carry, K), stats


def check_scan_vs_fused(eid, monkeypatch):
    """The port's scan run_chunk on the rows the fused plain twin
    consumed: equal attempts, accepts and aliveness, positions within 1e-9
    A, the carried energy within the bookkeeping rule.  Every fused route
    consumes the scan step's lanes: µVT row for row (B1), NVT and NVE row
    for row (B3), hybrid NPT row for row with its fixed schedule of volume
    attempts in place of lane 8's pick (_scan_npt_schedule),
    the PDA segments on rows 0..n_done-1 of each (the scan-path delayed
    acceptance; NVT as B6 runs it, µVT at insert_probability 0)."""
    e = ENTRIES[eid]
    _, (P, S, C, T) = system(eid)
    u = table(eid)
    Cs, Ts = C, T
    if e["route"] == "pda":
        # B6 runs NVT as µVT at insert_probability 0 (its spinflip carve on
        # lane 11, where the scan path's NVT step carves lane 8): the scan
        # side runs the same effective cfg
        Cs = tmk.pda_effective_cfg(C, P)
        if C.ensemble == "nvt":
            Ts = T.replace(insert_probability=torch.zeros_like(
                T.insert_probability))
        seen = _record_segments(monkeypatch)
        fused, fstats = tm.run_chunk_fused_uvt_polar_da(S, P, C, T,
                                                        e["steps"],
                                                        uniforms=u)
        rows = torch.cat([u[i, :k] for i, k in enumerate(seen)])
        pairs = [(fused, fstats, rows, None)]
    else:
        fused, fstats = chunk(eid)
        pairs = [((slice_chain(fused, k) if e["chains"] > 1 else fused),
                  fstats, u[k], k) for k in range(e["chains"])]
    for st_f, stats_f, rows, k in pairs:
        if C.ensemble == "npt":
            st_s, stats_s = _scan_npt_schedule(P, S, C, T, rows)
        else:
            st_s, stats_s = tm.run_chunk(S, P, Cs, Ts, len(rows),
                                         uniforms=rows)
        att_f = np.asarray(stats_f.attempts)
        acc_f = stats_f.host().accepts
        if k is not None and np.ndim(att_f) == 2:
            att_f, acc_f = att_f[k], acc_f[k]
        np.testing.assert_array_equal(att_f, stats_s.attempts)
        np.testing.assert_array_equal(acc_f, stats_s.host().accepts)
        assert torch.equal(st_f.mol_alive, st_s.mol_alive)
        np.testing.assert_allclose(st_f.pos.numpy(), st_s.pos.numpy(),
                                   rtol=0, atol=1e-9)
        if C.quantum_rotation:
            assert torch.equal(st_f.spin, st_s.spin)
        scale = _scale(st_s.energy, st_s.e_frozen)
        for t_ in TERMS:
            a = float(getattr(st_f.energy, t_))
            b = float(getattr(st_s.energy, t_))
            assert abs(a - b) <= BOOK_REL * scale, (k, t_, a, b)


# ---------------------------------------------------------------------------
# (e) trajectories across packages: the reference's kernels in Pallas
# interpret mode against the port's plain twins, float32, one numpy table
# ---------------------------------------------------------------------------

# the float32 rules of tests/test_torch_fused_uvt.py and its kin (the
# Pallas kernels' A&S erfc and float32 sums against the plain twins'
# float64 sums): energy sums within rel 1e-4 / abs 5e-2 K, positions within
# 1e-4 A, a TMMC matrix's Sigma a within n (beta 5e-2 + 1e-6)
F32_SUM_ATOL, F32_SUM_RTOL, POS_ATOL = 5e-2, 1e-4, 1e-4
# the entries whose (e) runs in tier-1: one per fused kernel and variant
# (B1 one chain and C, B3 one chain and C, NVE, B6; QC, XT and SF); the
# rest of (e) is marked slow (~5-10 s an entry in interpret mode)
TRAJ_TIER1 = ("f16",   # B1, one chain, XT (cavity, TMMC, bias) + SF
              "f05",   # B1, C = 2, XT + SF
              "f07",   # B3, one chain, NVE, QC (FK)
              "f71",   # B3, one chain, SF
              "f42",   # B3, C = 2, SF
              "f24",   # B3 of the hybrid NPT path
              "f46",   # B6 under nvt, QC (FH2) + SF
              "f57")   # B6, XT + SF
N_TRAJ_FILES = 4


def traj_params(k):
    """The (e) cases of file ``k`` of N_TRAJ_FILES: two of TRAJ_TIER1 each,
    and the other fused entries dealt round robin, marked slow."""
    tier1 = [i for j, i in enumerate(TRAJ_TIER1) if j % N_TRAJ_FILES == k]
    rest = [i for i in fused_ids(list(ENTRIES)) if i not in TRAJ_TIER1]
    slow = [i for j, i in enumerate(rest) if j % N_TRAJ_FILES == k]
    return tier1 + [pytest.param(i, marks=pytest.mark.slow) for i in slow]


def traj_tests(k):
    """The test of (e)'s file ``k`` (tests/test_torch_fuzz_traj_k.py)."""
    @pytest.mark.parametrize("eid", traj_params(k))
    def test_trajectory(eid):
        check_trajectory(eid)

    return {"test_trajectory": test_trajectory}


@functools.lru_cache(maxsize=None)
def system32(eid):
    """The entry in float32, initialized by the reference (its S(k),
    cavity grid and TMMC matrix), and the port's copy of it."""
    e = ENTRIES[eid]
    p, s, c, t = fc.reference_system(e, "float32")
    s = jm.initialize(s, p, c, t)
    if c.ensemble == "nve":
        u = float(s.energy.total + s.e_frozen.total)
        t = t.replace(nve_energy=jnp.asarray(u + e["nve_kinetic"],
                                             jnp.float32))
    return (p, s, c, t), convert.from_jax(p, s, c, t)


def _cols(p, c):
    return dict(mol_mass_atom=jm._fh_mol_mass_atom(p, c), c6=p.c6, c8=p.c8,
                c10=p.c10, gwp_alpha=p.gwp_alpha)


def _reference_b1(p, s, c, t, u):
    """The reference's B1 on u [C, K, 16] as _fused_chunk_uvt(_multi)
    launches it: (pos, slot alive, sums, spins, d_tmmc) numpy, [C, ...]."""
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, c)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    d_self, d_excl, c1, cx, lnfv, kv, kcoef = jm._uvt_chunk_consts(
        s.pos, s.box, p, t, c, A_list, rep)
    thr = c.cavity_autoreject_absolute
    sf = c.quantum_rotation
    rot = s.rot_f[slots].astype(jnp.float32) if sf else None
    spin = s.spin.reshape(-1, 1)[slots][:, 0] if sf else None
    Cn, K = u.shape[0], u.shape[1]
    ew = c.coulomb == "ewald"
    common = dict(A_list=A_list, interpret=True, kvecs=kv, kcoef=kcoef,
                  p_spin=t.spinflip_probability if sf else 0.0,
                  tmmc_eta=t.tmmc_eta if c.tmmc_bias else None,
                  **_cols(p, c))
    lead = (1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
            t.insert_probability, lnfv, d_self, d_excl, c1, cx)
    if Cn == 1:
        out = jmk.run_steps_uvt(
            s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start,
            spidx, s.mol_alive[slots], tmpl, s.box, rc, alpha, *lead,
            jnp.asarray(u[0]), c, K, s.pos.shape[0], sk_re=s.sk_re,
            sk_im=s.sk_im,
            cav_open=s.cavity_open if c.cavity_bias else None,
            rot_f=rot, spin=spin, **common)
        out = [None if x is None else np.asarray(x)[None] for x in out]
    else:
        b = lambda x: None if x is None else jnp.broadcast_to(  # noqa
            x, (Cn,) + x.shape)
        out = jmk.run_steps_uvt_multi(
            b(s.pos), p.eps, p.sig, p.charge, p.mass, b(s.atom_alive(p)),
            start, spidx, b(s.mol_alive[slots]), tmpl, s.box, rc, alpha,
            *lead, jnp.asarray(u.reshape(Cn * K, 16)), c, K, s.pos.shape[0],
            sk_re=b(s.sk_re) if ew else None,
            sk_im=b(s.sk_im) if ew else None,
            cav_open=b(s.cavity_open) if c.cavity_bias else None,
            rot_f=b(rot), spin=b(spin), **common)
        out = [None if x is None else np.asarray(x) for x in out]
    return out[0], out[1], out[2].reshape(Cn, -1), out[5], out[6]


def _check_b1(eid):
    (p, s, c, t), (P, S, C, T) = system32(eid)
    e = ENTRIES[eid]
    u = fc.uniforms(e, (e["chains"], e["steps"], 16)).astype(np.float32)
    pos, sa, sums, spin, d_tm = _reference_b1(p, s, c, t, u)
    states = stack_chains([S] * e["chains"])
    tables = tm.uvt_fused_tables(P, C)
    args, kw = tm.fused_uvt_launch_args(states, P, C, T, torch.as_tensor(u),
                                        tables)
    out = tmk.run_steps_uvt_plain(*args, **kw)
    g_pos, g_sa, g_sums = (x.numpy() for x in out[:3])
    beta = 1.0 / float(T.temperature)
    for ch in range(e["chains"]):
        np.testing.assert_array_equal(g_sums[ch][6:14], sums[ch][6:14])
        np.testing.assert_allclose(g_sums[ch][:6], sums[ch][:6],
                                   rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
        np.testing.assert_array_equal(g_sa[ch], sa[ch])
        np.testing.assert_allclose(g_pos[ch], pos[ch], rtol=0,
                                   atol=POS_ATOL)
        if C.quantum_rotation:
            np.testing.assert_array_equal(out[5][ch].numpy() > 0.5,
                                          spin[ch] > 0.5)
        if C.tmmc:
            got = kw["tmmc_out"][ch].numpy()
            want = np.zeros_like(got)
            R = min(len(got), d_tm.shape[1])
            want[:R] = d_tm[ch][:R]
            np.testing.assert_array_equal(got[:, [0, 2]], want[:, [0, 2]])
            assert np.all(np.abs(got[:, [1, 3]] - want[:, [1, 3]])
                          <= got[:, [0, 2]] * (beta * F32_SUM_ATOL + 1e-6))
    return int(sums[:, 6:9].sum() + sums[:, 12].sum())


def _reference_b3(p, s, c, t, u):
    """The reference's B3 on u [C, K, 16] as _fused_chunk_nvt(_multi)
    launches it: (pos, [C, 4] sums: d_rd d_es d_rec accepted, spins,
    [C, 2] spinflip acc / att) numpy."""
    mov, mova, a_max, mv_slots = jmk.movable_mols(p, np.asarray(s.mol_alive))
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    kv, kcoef = jm._fused_ktable(s.box, c, alpha)
    thr = c.cavity_autoreject_absolute
    sf = c.quantum_rotation
    lanes = 16 if sf else 8
    rot = s.rot_f[mv_slots].astype(jnp.float32) if sf else None
    spin = s.spin.reshape(-1, 1)[mv_slots][:, 0] if sf else None
    Cn, K = u.shape[0], u.shape[1]
    common = dict(a_max=a_max, interpret=True, kvecs=kv, kcoef=kcoef,
                  p_spin=t.spinflip_probability if sf else 0.0,
                  **_cols(p, c))
    if Cn == 1:
        if c.ensemble == "nve":
            u_off = s.energy.total + s.e_frozen.total
            f_dof = jnp.sum(jnp.where(jm._movable_mask(p, s.mol_alive),
                                      p.mol_dof, 0.0))
            common.update(nve_k0=t.nve_energy - u_off,
                          nve_g=0.5 * f_dof - 1.0)
        out = jmk.run_steps(
            s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
            mova, s.box, rc, alpha, 1.0 / t.temperature, t.move_factor,
            t.rot_factor, thr * thr, jnp.asarray(u[0, :, :lanes]), c, K,
            s.pos.shape[0], sk_re=s.sk_re, sk_im=s.sk_im, rot_f=rot,
            spin=spin, **common)
        sums = np.asarray([[float(out[1]), float(out[2]), float(out[3]),
                            float(out[4])]])
        sp = np.asarray([[float(out[8]) if sf else 0.0,
                          float(out[9]) if sf else 0.0]])
        return (np.asarray(out[0])[None], sums,
                None if out[7] is None else np.asarray(out[7])[None], sp)
    b = lambda x: None if x is None else jnp.broadcast_to(  # noqa
        x, (Cn,) + x.shape)
    betas = jnp.full((Cn,), 1.0 / float(t.temperature), jnp.float32)
    ew = c.coulomb == "ewald"
    pos, sums, _, _, spin_new = jmk.run_steps_multi(
        b(s.pos), p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
        mova, s.box, rc, alpha, betas, t.move_factor, t.rot_factor,
        thr * thr, jnp.asarray(u[..., :lanes].reshape(Cn * K, lanes)), c, K,
        s.pos.shape[0], sk_re=b(s.sk_re) if ew else None,
        sk_im=b(s.sk_im) if ew else None, rot_f=b(rot), spin=b(spin),
        **common)
    sums = np.asarray(sums)
    sp = sums[:, 4:6] if sums.shape[1] >= 6 else np.zeros((Cn, 2))
    return (np.asarray(pos), sums[:, :4],
            None if spin_new is None else np.asarray(spin_new), sp)


def _check_b3(eid):
    (p, s, c, t), (P, S, C, T) = system32(eid)
    e = ENTRIES[eid]
    if c.ensemble == "npt":
        # the hybrid path's segments: B3 under nvt on the same state
        c = dataclasses.replace(c, ensemble="nvt")
        C = dataclasses.replace(C, ensemble="nvt")
    u = fc.uniforms(e, (e["chains"], e["steps"], 16)).astype(np.float32)
    pos, sums, spin, sp = _reference_b3(p, s, c, t, u)
    states = stack_chains([S] * e["chains"])
    args, kw = tm.fused_nvt_launch_args(states, P, C, T, torch.as_tensor(u),
                                        tm.nvt_fused_tables(P, S.mol_alive))
    out = tmk.run_steps_plain(*args, **kw)
    g_pos, g_sums = out[0].numpy(), out[1].numpy()
    np.testing.assert_array_equal(g_sums[:, 3], sums[:, 3])
    np.testing.assert_allclose(g_sums[:, :3], sums[:, :3],
                               rtol=F32_SUM_RTOL, atol=F32_SUM_ATOL)
    np.testing.assert_allclose(g_pos, pos, rtol=0, atol=POS_ATOL)
    if C.quantum_rotation:
        np.testing.assert_array_equal(g_sums[:, 4:6], sp)
        np.testing.assert_array_equal(out[4].numpy() > 0.5, spin > 0.5)
    return int(sums[:, 3].sum())


def _reference_b6(p, s, c, t, u):
    """The reference's B6 on one segment table u [PDA_SEG, 16] as
    _fused_chunk_uvt_pda launches it: the record, numpy float64."""
    cfg = jmk.pda_effective_cfg(c, p)
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, cfg)
    rc = jpairs.derived_cutoff(s.box, cfg)
    d_self, d_excl, c1, cx, lnfv, kv, kcoef = jm._uvt_chunk_consts(
        s.pos, s.box, p, t, cfg, A_list, rep)
    paf, pkrc = jthole._field_variant_consts(s.box, cfg, cfg.jdtype)
    sf = cfg.quantum_rotation
    de_ins = de_del = jnp.zeros((), jnp.float32)
    if cfg.tmmc_bias:
        n_c0 = int(np.sum(np.asarray(s.mol_alive)
                          & (np.asarray(p.mol_species)
                             == cfg.insert_species[0])))
        eta = np.asarray(t.tmmc_eta)
        k_e = eta.shape[0]
        de_ins = jnp.asarray(eta[min(n_c0 + 1, k_e - 1)] - eta[n_c0])
        de_del = jnp.asarray(eta[max(min(n_c0 - 1, k_e - 1), 0)]
                             - eta[n_c0])
    return np.asarray(jmk.run_steps_uvt_pda(
        s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start, spidx,
        s.mol_alive[slots], tmpl, s.box, rc, jpairs.derived_alpha(rc, cfg),
        1.0 / t.temperature, t.move_factor, t.rot_factor,
        cfg.cavity_autoreject_absolute ** 2,
        t.insert_probability * (c.ensemble != "nvt"), lnfv, d_self, d_excl,
        c1, cx, jnp.asarray(u, jnp.float32), cfg, u.shape[0], s.pos.shape[0],
        A_list=A_list, interpret=True, kvecs=kv, kcoef=kcoef, sk_re=s.sk_re,
        sk_im=s.sk_im, e0=s.e0, polar=p.polar, polar_damp=cfg.polar_damp,
        cav_open=s.cavity_open if cfg.cavity_bias else None,
        rot_f=s.rot_f[slots].astype(jnp.float32) if sf else None,
        spin=s.spin.reshape(-1, 1)[slots][:, 0] if sf else None,
        p_spin=t.spinflip_probability if sf else 0.0,
        polar_field_alpha=0.0 if paf is None else paf,
        polar_field_krc=0.0 if pkrc is None else pkrc,
        d_eta_ins=de_ins, d_eta_del=de_del, **_cols(p, cfg)), np.float64)


def _assert_records(got, want, natoms):
    """torch_pda.assert_records_match's rules on B6's records, with two
    differences.  The trial rows are compared on the moved species' own
    sites, and not on a spinflip record: the reference writes its padded
    template rows past a species' site count and a rotor's rows into a
    spinflip record, the port zeros, and stage 2 reads neither.  lnb and
    the stage-2 coin get 1e-6 plus one float32 ulp of their size (they
    reach ~100 in the corpus)."""
    np.testing.assert_array_equal(got[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                  want[0, [0, 1, 2, 3, 4, 6, 7, 8]])
    if want[0, 1] > 0.5 and want[0, 2] != 3:
        a = int(natoms[int(want[0, 4])])
        np.testing.assert_allclose(got[2:5, :a], want[2:5, :a], rtol=0,
                                   atol=1e-5)
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_allclose(got[1, i], want[1, i], rtol=1e-4,
                                   atol=1e-3, err_msg=f"delta {i}")
    np.testing.assert_allclose(got[1, 2], want[1, 2], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got[0, 9], want[0, 9], rtol=5e-4, atol=5e-3)
    for i in (5, 10):
        assert abs(got[0, i] - want[0, i]) <= 1e-6 + 1.2e-7 * abs(
            want[0, i]), (i, got[0, i], want[0, i])


def _check_b6(eid):
    """Three segment tables: step 0 a forced stage-1 survivor (the coin
    1e-30; lane 8 a displacement), then two of natural coins: the same
    record (_assert_records)."""
    (p, s, c, t), (P, S, C, T) = system32(eid)
    e = ENTRIES[eid]
    us = fc.uniforms(e, (3, tmk.PDA_SEG, 16)).astype(np.float32)
    us[0, 0, 4], us[0, 0, 8] = 1e-30, 0.9
    Tp = T
    if C.ensemble == "nvt":
        Tp = T.replace(insert_probability=torch.zeros_like(
            T.insert_probability))
    cfg = tmk.pda_effective_cfg(C, P)
    tables = tm.uvt_fused_tables(P, cfg)
    hits = 0
    for u in us:
        want = _reference_b6(p, s, c, t, u)
        args, kw = tm.pda_launch_args(S, P, cfg, Tp, torch.as_tensor(u),
                                      tables)
        got = tmk.run_steps_uvt_pda_plain(*args, **kw).numpy()
        _assert_records(got, want, tables[4].numpy())
        hits += int(want[0, 1])
    return hits


def check_trajectory(eid):
    """(e) on a fused entry: the reference's B1, B3 or B6 (Pallas
    interpret mode) and the port's plain twin on the entry's numpy table
    make the same decisions (counts, aliveness, spins, TMMC counts) with
    positions and sums within the float32 rules above."""
    e = ENTRIES[eid]
    c = e["cfg"]
    if e["route"] == "pda":
        _check_b6(eid)
    elif c["ensemble"] == "uvt":
        assert _check_b1(eid) > 0
    elif c["ensemble"] == "npt":
        _check_b3(eid)
    else:
        assert _check_b3(eid) > 0
