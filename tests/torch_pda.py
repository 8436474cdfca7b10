"""Shared set-up of the port's B6 tests (tests/test_torch_pda.py and
tests/test_torch_pda_fields.py): the polar MOF + H2 system built and
initialized by the JAX package, the reference B6 in Pallas interpret mode
and the port's B6 on one table, the comparison of their records, and the
two checks each field variant gets against the reference."""
import dataclasses
import functools

import numpy as np
import torch

import jax.numpy as jnp

from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.models import systems as jsystems
from mpmc_tpu.ops import pairs as jpairs
from mpmc_tpu.ops import thole as jthole
from mpmc_tpu.ops.pallas import mc_kernel as jmk
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.mc import metropolis as tm
from mpmc_tpu_torch.ops.cuda import mc_kernel as tmk

# the field variants; nvt is the direct system under ensemble nvt (B6's
# all-displace limit: the same initialized state)
VARIANTS = {"direct": {}, "wolf": {"polar_wolf": True},
            "ewald": {"polar_ewald": True}}
SEG = tmk.PDA_SEG
# lane 8 of a displacement, an insertion and a deletion (insert_probability
# 0.5: insert below 0.25, delete below 0.5)
LANE8 = {0: 0.9, 1: 0.1, 2: 0.4}


@functools.lru_cache(maxsize=None)
def _initialized(field, dtype):
    p, s, c, t = jsystems.mof_h2_gcmc(n_side=3, n_h2=6, capacity=10,
                                      polarization=True, dtype=dtype)
    c = dataclasses.replace(c, polar_delayed=True, fused_mc=True,
                            **VARIANTS[field])
    if dtype == "float64":
        c = dataclasses.replace(c, polar_precision=1e-10)
    return p, jm.initialize(s, p, c, t), c, t


def jax_system(variant, dtype="float32"):
    """(params, state, cfg, thermo) of the JAX package: the polar MOF + H2
    system (mof_h2_gcmc(n_side=3, n_h2=6, capacity=10)) with
    polar_delayed and fused_mc, initialized under the variant's field."""
    p, s, c, t = _initialized("direct" if variant == "nvt" else variant,
                              dtype)
    if variant == "nvt":
        c = dataclasses.replace(c, ensemble="nvt", insert_species=())
    return p, s, c, t


def jax_rec(p, s, c, t, u):
    """The reference B6 (Pallas interpret mode) on the table u [K,16]."""
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
        polar_field_krc=0.0 if pkrc is None else pkrc,
        mol_mass_atom=jm._fh_mol_mass_atom(p, cfg)), np.float64)


def port_rec(P, S, C, T, u):
    """The port's B6 (the plain version on these CPU tensors), with the
    chunk function's arguments (insert_probability 0 under nvt)."""
    if C.ensemble == "nvt":
        T = T.replace(insert_probability=torch.zeros_like(
            T.insert_probability))
    cfg = tmk.pda_effective_cfg(C, P)
    args, kw = tm.pda_launch_args(S, P, cfg, T, torch.as_tensor(u),
                                  tm.uvt_fused_tables(P, cfg))
    return tmk.run_steps_uvt_pda(*args, **kw).numpy()


def assert_records_match(got, want):
    """Equal: n_done, hit, mtype, slot_idx, species, the attempts; the
    trial rows within 1e-5 A; the deltas of rd, es_real, es_self,
    es_excl and lrc within rel 1e-4 / abs 1e-3 K, es_recip within rel
    1e-4 / abs 5e-3 K (both float32 versions sum the reciprocal delta over
    phases k.r of up to ~44 rad, spaced 3.8e-6 rad in float32, against the
    lattice's large |S(k)|: each lies ~2e-3 K from a float64 evaluation of
    a ~15 K delta); d* within rel 5e-4 / abs 5e-3 K; lnb and the stage-2
    coin within 1e-6."""
    np.testing.assert_array_equal(got[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                  want[0, [0, 1, 2, 3, 4, 6, 7, 8]])
    np.testing.assert_allclose(got[2:5], want[2:5], rtol=0, atol=1e-5)
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_allclose(got[1, i], want[1, i], rtol=1e-4,
                                   atol=1e-3, err_msg=f"delta {i}")
    np.testing.assert_allclose(got[1, 2], want[1, 2], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got[0, 9], want[0, 9], rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(got[0, [5, 10]], want[0, [5, 10]], rtol=0,
                               atol=1e-6)


def check_forced_survivor(variant):
    """K = 16 tables whose step 0 has the stage-1 coin 1e-30 (lane 4), one
    move type each: the reference and the port make the same record on
    every table, and each move type gives a survivor at step 0 (an
    insertion near an atom is still rejected by its energy or the
    autoreject: such tables are drawn again, up to 12 times)."""
    p, s, c, t = jax_system(variant)
    P, S, C, T = convert.from_jax(p, s, c, t)
    rng = np.random.default_rng(11)
    for mt, lane8 in LANE8.items():
        for _ in range(12):
            u = rng.random((SEG, 16)).astype(np.float32)
            u[0, 4], u[0, 8] = 1e-30, lane8
            want = jax_rec(p, s, c, t, u)
            assert_records_match(port_rec(P, S, C, T, u), want)
            if want[0, 1] > 0.5:
                break
        assert want[0, 1] > 0.5 and want[0, 0] == 1
        # under nvt every row is a displacement
        assert want[0, 2] == (0 if variant == "nvt" else mt)


def check_natural_freeze(variant):
    """Tables of natural coins: the reference and the port freeze at the
    same step (n_done) with the same record."""
    p, s, c, t = jax_system(variant)
    P, S, C, T = convert.from_jax(p, s, c, t)
    rng = np.random.default_rng(5)
    froze = []
    for _ in range(4):
        u = rng.random((SEG, 16)).astype(np.float32)
        want = jax_rec(p, s, c, t, u)
        assert_records_match(port_rec(P, S, C, T, u), want)
        froze.append(int(want[0, 0]))
    assert max(froze) > 1          # the freeze fell after step 0 somewhere
