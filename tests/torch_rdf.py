"""Shared set-up of the tests of B1, B3 and B6 under the RD forms and coulomb
gwp (tests/test_torch_rd_fused_*.py): the reference's fused-kernel systems
(tests/test_fused_mc.py: _dispexp_h2, _altrd_h2, _gwp_h2), the MOF + H2
system with its LJ sites mapped to a form (tests/torch_rd.py), the
reference's B1, B3 and B6 in Pallas interpret mode and the port's plain
versions on one numpy-made uniform table, and the fused chunks' float64
bookkeeping."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.ops import pairs as jpairs
from mpmc_tpu.ops import thole as jthole
from mpmc_tpu.ops.pallas import mc_kernel as jmk
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.mc import metropolis as tm
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk
from mpmc_tpu_torch.state import stack_chains
import torch_pda
from test_fused_mc import _altrd_h2, _dispexp_h2, _gwp_h2
from torch_rd import jax_rd, mof

# f32 sums, plain against Pallas: the A&S erfc / Pallas erf and f32
# accumulation of the Pallas kernels (tests/test_torch_fused_uvt.py's
# tolerances)
F32_SUM_ATOL = 5e-2
F32_SUM_RTOL = 1e-4
POS_ATOL = 1e-4
# the forms of the fused kernels: (the reference's H2 system, its
# dispatch key); sg, dreiding and b14_7 on _altrd_h2 (dreiding and b14_7
# with the reference test's well), disp_expansion (damped by default,
# rd_lrc) on _dispexp_h2, gwp (with disp_expansion) on _gwp_h2
ALTRD_WELL = {"eps": [34.2, 0.0, 0.0], "sig": [3.3, 0.0, 0.0]}
FORMS = ("sg", "dreiding", "b14_7", "disp_expansion", "gwp")
# disp_expansion as the decks run it: damped, with its tail
DISP = {"damp_dispersion": True, "rd_lrc": True}


def h2_system(form, ensemble):
    """The reference's fused-kernel H2 fluid of ``form`` under
    ``ensemble`` (nvt or uvt), initialized by the JAX package."""
    if form == "disp_expansion":
        return _dispexp_h2(ensemble)
    if form == "gwp":
        return _gwp_h2(ensemble)
    return _altrd_h2(form, ensemble,
                     **({} if form == "sg" else ALTRD_WELL))


def mof_system(form, ensemble="uvt", dtype="float32", **cfg_kw):
    """The MOF + H2 system at 77 K with its LJ sites mapped to ``form``
    (gwp: LJ kept, coulomb gwp over tests/torch_rd.py's widths;
    disp_expansion damped with its tail), fused_mc, initialized."""
    gwp = form == "gwp"
    kw = dict(fused_mc=True, **cfg_kw)
    if form == "disp_expansion":
        kw.update(DISP)
    if ensemble != "uvt":
        kw.update(ensemble=ensemble, insert_species=())
    p, s, c, t = mof(None if gwp else form, dtype, gwp, **kw)
    return p, jm.initialize(s, p, c, t), c, t


def _cols(p, c):
    """The reference kernels' form columns, and the molecule-mass column
    of a quantum correction (rd lj with coulomb gwp)."""
    return dict(c6=p.c6, c8=p.c8, c10=p.c10, gwp_alpha=p.gwp_alpha,
                mol_mass_atom=jm._fh_mol_mass_atom(p, c))


def pallas_b1(p, s, c, t, u, **xt):
    """The reference B1 (interpret mode, run_steps_uvt_multi) on u [C, K,
    16]: (pos, slot alive, sums) numpy, with the form columns."""
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, c)
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, c, A_list, rep)
    thr = c.cavity_autoreject_absolute
    C, K = u.shape[0], u.shape[1]
    b = lambda x: jnp.broadcast_to(x, (C,) + x.shape)  # noqa: E731
    out = jmk.run_steps_uvt_multi(
        b(s.pos), p.eps, p.sig, p.charge, p.mass, b(s.atom_alive(p)), start,
        spidx, b(s.mol_alive[slots]), tmpl, s.box, rc, alpha,
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability, k[4], k[0], k[1], k[2], k[3],
        jnp.asarray(u.reshape(C * K, 16)), c, K, s.pos.shape[0],
        A_list=A_list, interpret=True, kvecs=k[5], kcoef=k[6],
        sk_re=None if s.sk_re is None else b(s.sk_re),
        sk_im=None if s.sk_im is None else b(s.sk_im), **_cols(p, c),
        **xt)
    return [np.asarray(x) for x in out[:3]] + [out]


def port_b1(P, S, C, T, u):
    """The port's plain B1 through the fused chunk's launch arguments on
    u [C, K, 16]: (pos, slot alive, sums, the keywords) numpy."""
    states = stack_chains([S] * u.shape[0])
    args, kw = tm.fused_uvt_launch_args(states, P, C, T, torch.as_tensor(u),
                                        tm.uvt_fused_tables(P, C))
    out = tmk.run_steps_uvt(*args, **kw)
    return [x.numpy() for x in out[:3]] + [kw]


def pallas_b3(p, s, c, t, u):
    """The reference B3 (interpret mode, run_steps_multi) on u [C, K, 16]:
    (pos, sums [C, 4]) numpy, with the form columns."""
    mov, mova, a_max, _ = jmk.movable_mols(p, np.asarray(s.mol_alive))
    rc = jpairs.derived_cutoff(s.box, c)
    alpha = jpairs.derived_alpha(rc, c)
    kv, kcoef = jm._fused_ktable(s.box, c, alpha)
    thr = c.cavity_autoreject_absolute
    C, K = u.shape[0], u.shape[1]
    betas = jnp.full((C,), 1.0 / float(t.temperature), jnp.float32)
    b = lambda x: jnp.broadcast_to(x, (C,) + x.shape)  # noqa: E731
    w_pos, w_sums, _, _, _ = jmk.run_steps_multi(
        b(s.pos), p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), mov,
        mova, s.box, rc, alpha, betas, t.move_factor, t.rot_factor,
        thr * thr, jnp.asarray(u[..., :8].reshape(C * K, 8)), c, K,
        s.pos.shape[0], a_max=a_max, interpret=True, kvecs=kv, kcoef=kcoef,
        sk_re=None if s.sk_re is None else b(s.sk_re),
        sk_im=None if s.sk_im is None else b(s.sk_im), **_cols(p, c))
    return np.asarray(w_pos), np.asarray(w_sums)[:, :4]


def port_b3(P, S, C, T, u):
    """The port's plain B3 through the fused chunk's launch arguments on
    u [C, K, 16]: (pos, sums [C, 4]) numpy."""
    states = stack_chains([S] * u.shape[0])
    args, kw = tm.fused_nvt_launch_args(states, P, C, T, torch.as_tensor(u),
                                        tm.nvt_fused_tables(P, S.mol_alive))
    pos, sums, _, _ = tmk.run_steps(*args, **kw)
    assert not sums[:, 4:].any()            # no spinflip without the move
    return pos.numpy(), sums.numpy()[:, :4]


def pda_system(form, variant="direct", **cfg_kw):
    """The polar MOF + H2 system of tests/torch_pda.py (fused polar delayed
    acceptance, the field ``variant``) with its LJ sites mapped to
    ``form`` (gwp: LJ kept, coulomb gwp; disp_expansion damped with its
    tail), ``cfg_kw`` on its cfg, initialized by the JAX package."""
    p, s, c, t = torch_pda.jax_system(variant)
    kw = dict(DISP) if form == "disp_expansion" else {}
    kw.update(cfg_kw)
    p, c = jax_rd(p, c, None if form == "gwp" else form, form == "gwp", **kw)
    return p, jm.initialize(s, p, c, t), c, t


def pallas_b6(p, s, c, t, u):
    """The reference B6 (Pallas interpret mode) on the table u [K, 16],
    with the form columns (tests/torch_pda.py jax_rec)."""
    cfg = jmk.pda_effective_cfg(c, p)
    slots, start, spidx, tmpl, A_list, rep = jm.uvt_fused_tables(p, cfg)
    rc = jpairs.derived_cutoff(s.box, cfg)
    k = jm._uvt_chunk_consts(s.pos, s.box, p, t, cfg, A_list, rep)
    paf, pkrc = jthole._field_variant_consts(s.box, cfg, cfg.jdtype)
    thr = cfg.cavity_autoreject_absolute
    return np.asarray(jmk.run_steps_uvt_pda(
        s.pos, p.eps, p.sig, p.charge, p.mass, s.atom_alive(p), start, spidx,
        s.mol_alive[slots], tmpl, s.box, rc, jpairs.derived_alpha(rc, cfg),
        1.0 / t.temperature, t.move_factor, t.rot_factor, thr * thr,
        t.insert_probability * (c.ensemble != "nvt"), k[4], k[0],
        k[1], k[2], k[3], jnp.asarray(u, jnp.float32), cfg, u.shape[0],
        s.pos.shape[0], A_list=A_list, e0=s.e0, polar=p.polar,
        polar_damp=cfg.polar_damp, interpret=True, kvecs=k[5], kcoef=k[6],
        sk_re=s.sk_re, sk_im=s.sk_im,
        polar_field_alpha=0.0 if paf is None else paf,
        polar_field_krc=0.0 if pkrc is None else pkrc, **_cols(p, cfg)),
        np.float64)


def check_b6(form, **cfg_kw):
    """Tables whose step 0 is a forced stage-1 survivor (lane 8: 0.9
    displace, 0.1 insert) and a table of natural coins give the records
    of the reference's B6 in interpret mode (its compile, once per form,
    is most of the time); ``cfg_kw`` as pda_system's."""
    j = pda_system(form, **cfg_kw)
    P, S, C, T = convert.from_jax(*j)
    rng = np.random.default_rng(17)
    hits = 0
    for lane8 in (0.9, 0.1, None):
        u = rng.random((torch_pda.SEG, 16)).astype(np.float32)
        if lane8 is not None:
            u[0, 4], u[0, 8] = 1e-30, lane8
        want = pallas_b6(*j, u)
        torch_pda.assert_records_match(torch_pda.port_rec(P, S, C, T, u),
                                       want)
        hits += int(want[0, 1])
    assert hits >= 2


def assert_sums(got, want, counts):
    """Kernel sums: the ``counts`` columns equal, the energy columns within
    the f32 tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got[..., counts], want[..., counts])
    e = [i for i in range(got.shape[-1]) if i not in counts]
    np.testing.assert_allclose(got[..., e], want[..., e], rtol=F32_SUM_RTOL,
                               atol=F32_SUM_ATOL)


def check_fused_bookkeeping_f64(j, kind, steps=150, seed=4):
    """The fused chunk (kind "uvt": B1; "nvt", also under nve: B3;
    "npt": the hybrid NPT's B3 segments and volume moves) on the plain
    kernel in float64 from the JAX system ``j``: after ``steps`` steps
    every carried term equals a fresh initialize to 1e-9, with moves
    accepted.  Returns (state, stats)."""
    P, S, C, T = convert.from_jax(*j)
    g = torch.Generator().manual_seed(seed)
    chunk = {"uvt": tm.run_chunk_fused_uvt, "nvt": tm.run_chunk_fused,
             "npt": tm.run_chunk_fused_npt}[kind]
    st, stats = chunk(S, P, C, T, steps, generator=g)
    assert int(stats.host().accepts.sum()) > 5
    fresh = tm.initialize(st, P, C, T)
    for k in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl"):
        assert float(getattr(st.energy, k)) == pytest.approx(
            float(getattr(fresh.energy, k)), rel=1e-9, abs=1e-9), k
    return st, stats
