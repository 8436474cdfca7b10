"""Shared set-up of the RD-form and GWP tests (test_torch_rd_kernels.py,
test_torch_rd_runs.py): the JAX package's MOF + H2 system with its LJ
sites mapped to an RD form (mpmc_tpu_torch.models.systems.rd_form_columns,
the same columns on both sides) and, for coulomb gwp, numpy-seeded GWP
widths on every charged site."""
import dataclasses
import functools

import numpy as np

import jax.numpy as jnp

from mpmc_tpu.mc import metropolis as jm
from mpmc_tpu.models import systems as jsystems
from mpmc_tpu_torch import convert
from mpmc_tpu_torch.models.systems import rd_form_columns

FORMS = ("sg", "dreiding", "b14_7", "disp_expansion")


def gwp_widths(charge, seed=11):
    """Numpy-seeded GWP widths 0.2-0.6 A on every charged site, 0 on the
    rest (point charges)."""
    q = np.asarray(charge, np.float64)
    w = np.random.default_rng(seed).uniform(0.2, 0.6, q.shape)
    return np.where(q != 0.0, w, 0.0)


@functools.lru_cache(maxsize=None)
def _built(n_side, n_h2, capacity, dtype):
    """The JAX package's mof_h2_gcmc system, built once per shape and
    type (its arrays are immutable)."""
    return jsystems.mof_h2_gcmc(n_side=n_side, n_h2=n_h2, capacity=capacity,
                                dtype=dtype)


def jax_rd(params, cfg, form, gwp=False, **cfg_kw):
    """(params, cfg) of a JAX system with its LJ sites mapped to ``form``
    (``None``: kept LJ) and, with ``gwp``, coulomb gwp over
    gwp_widths."""
    dt = params.eps.dtype
    kw = {}
    if form is not None:
        cols = rd_form_columns(np.asarray(params.eps), np.asarray(params.sig),
                               form)
        kw = {k: jnp.asarray(v, dt)
              for k, v in zip(("eps", "sig", "c6", "c8", "c10"), cols)}
        cfg_kw["rd_potential"] = form
    if gwp:
        kw["gwp_alpha"] = jnp.asarray(gwp_widths(params.charge), dt)
        cfg_kw["coulomb"] = "gwp"
    return (dataclasses.replace(params, **kw),
            dataclasses.replace(cfg, **cfg_kw))


def mof(form, dtype, gwp=False, n_side=4, n_h2=8, capacity=16,
        initialize=False, **cfg_kw):
    """The JAX MOF + H2 system (77 K, 1 atm) under ``form`` (and gwp):
    (params, state, cfg, thermo), the state initialized on request."""
    p, s, c, t = _built(n_side, n_h2, capacity, dtype)
    p, c = jax_rd(p, c, form, gwp, **cfg_kw)
    if initialize:
        s = jm.initialize(s, p, c, t)
    return p, s, c, t


def port(form, dtype, gwp=False, **kw):
    """(jax system, port P, S, C, T) of ``mof``, initialized on the JAX
    side and carried over."""
    j = mof(form, dtype, gwp, initialize=True, **kw)
    return j, convert.from_jax(*j)
