"""The numpy-only recipe of a parity fuzz corpus entry
(tests/torch_fuzz_corpus.json, written by tools/make_fuzz_corpus.py):
its system as builder keywords and stored numbers, its skewed cell, GWP
widths, rotor table, tmmc_bias eta and uniform table.  It imports neither
package: tools/make_fuzz_corpus.py finishes an entry with mpmc_tpu, the
port's card phase (chip_smoke.py fuzz_system) with mpmc_tpu_torch.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "torch_fuzz_corpus.json")
SPACING = 5.0       # the framework lattice of a build_system entry, in A
RD_FORMS = ("sg", "dreiding", "b14_7", "disp_expansion")


def load(path=CORPUS):
    """The committed corpus: {"seed", "entries"}."""
    with open(path) as f:
        return json.load(f)


def _framework(n_side, spacing, polar):
    """The charge-alternating cubic framework of both packages'
    systems._framework_lattice, as numpy: (pos, per-atom params, edge)."""
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    pos = (ijk + 0.5) * spacing
    sign = (-1.0) ** ijk.sum(axis=1)
    F = len(pos)
    fp = {"charge": 0.30 * sign, "mass": np.full(F, 60.0),
          "polar": np.full(F, polar), "eps": np.full(F, 25.0),
          "sig": np.full(F, 3.0)}
    return pos, fp, n_side * spacing


def _rotation(rng):
    """A uniform random rotation matrix (Shoemake)."""
    u1, u2, u3 = rng.random(3)
    a, b = math.sqrt(1 - u1), math.sqrt(u1)
    x, y, z, w = (a * math.sin(2 * math.pi * u2), a * math.cos(2 * math.pi * u2),
                  b * math.sin(2 * math.pi * u3), b * math.cos(2 * math.pi * u3))
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def system_recipe(entry):
    """(kind, kwargs) of an entry's system, numpy only: ``("builder",
    {"name", "args"})`` for a named builder of models/systems.py, or
    ``("build_system", kw)`` with build_system's keywords (box,
    frozen_pos, frozen_params, capacity, initial_counts, initial_pos, seed)
    and ``kw["species"]`` the templates as dicts of numbers (each
    package makes its Species of them)."""
    sysd = entry["system"]
    if sysd["builder"] != "build_system":
        return "builder", {"name": sysd["builder"], "args": sysd["args"]}
    a = sysd["args"]
    species = sysd["species"]
    counts, caps = a["initial_counts"], a["capacity"]
    rng = np.random.default_rng(a["seed"])
    kw = dict(capacity=tuple(caps), initial_counts=tuple(counts),
              seed=a["seed"], species=species)
    if a.get("frame"):
        fr = a["frame"]
        fpos, fp, edge = _framework(fr["n_side"], SPACING, fr["polar"])
        kw.update(box=np.eye(3) * edge, frozen_pos=fpos, frozen_params=fp)
        n = fr["n_side"]
        ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
        sites = (ijk[rng.permutation(len(ijk))[:sum(counts)]] + 1.0) * SPACING
        init, k = {}, 0
        for i, (sp, c) in enumerate(zip(species, counts)):
            tmpl = np.asarray(sp["pos"], np.float64)
            m = np.asarray(sp["mass"], np.float64)
            tmpl = tmpl - (m[:, None] * tmpl).sum(0) / m.sum()
            rows = [sites[k + j] + tmpl @ _rotation(rng).T for j in range(c)]
            init[i] = np.asarray(rows).reshape(c, len(m), 3)
            k += c
        kw["initial_pos"] = init
    else:
        kw.update(box=np.eye(3) * a["edge"], frozen_pos=None,
                  frozen_params=None, initial_pos=None)
    return "build_system", kw


def species_kwargs(d):
    """A stored template (a dict of numbers) as the keywords of either
    package's Species."""
    return {k: (tuple(v) if k == "atom_names" else v if k == "name"
                else np.asarray(v, np.float64)) for k, v in d.items()}


def gwp_widths(charge, seed):
    """Seeded GWP widths 0.2-0.6 A on every charged site, 0 elsewhere."""
    q = np.asarray(charge, np.float64)
    w = np.random.default_rng(seed).uniform(0.2, 0.6, q.shape)
    return np.where(q != 0.0, w, 0.0)


def skewed_box(box, skew):
    """The cell with basis vector 2 sheared by ``skew`` A along x and
    basis vector 3 by skew / 2 along y (0: the box as it is)."""
    b = np.array(box, np.float64, copy=True)
    if skew:
        b[1, 0] += skew
        b[2, 1] += 0.5 * skew
    return b


def rotor_table(n_mols, seed):
    """(spins [M] 0/1, rot_f [M, 2] K) of a quantum_rotation entry: a
    seeded table standing for the rotor free energies (F_para, F_ortho),
    which the kernels and the step read as data."""
    rng = np.random.default_rng(seed)
    spins = (rng.random(n_mols) < 0.5).astype(np.int32)
    rot_f = rng.uniform(-60.0, 60.0, (n_mols, 2))
    return spins, rot_f


def tmmc_eta(n_macro, seed):
    """A seeded tmmc_bias eta in [-1, 1) per macrostate."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n_macro)


def uniforms(entry, shape):
    """The entry's numpy uniform table of ``shape`` (float64, in [0, 1))."""
    return np.random.default_rng(entry["useed"]).random(shape)


def cfg_fields(entry, dtype):
    """The RunConfig fields an entry sets, ``dtype`` included."""
    kw = dict(entry["cfg"])
    kw["insert_species"] = tuple(kw["insert_species"])
    kw["dtype"] = dtype
    return kw
