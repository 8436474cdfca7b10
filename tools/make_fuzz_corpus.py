"""The parity fuzz corpus: seeded random configurations over the port's gate
surface, written as plain JSON (tests/torch_fuzz_corpus.json).

    python3 tools/make_fuzz_corpus.py            # write the corpus
    python3 tools/make_fuzz_corpus.py --check    # regenerate and compare

Each entry names a system (a builder of both packages' models/systems.py
with its arguments, or build_system with its species stored as numbers),
a box skew, the RunConfig and Thermo fields that were drawn, the route
(scan, batched chains, fused one chain or C chains, fused polar delayed
acceptance), the chunk length and a uniform-table seed.  The draws are
balanced: each axis value of AXES is taken where it is compatible and has
been taken least, so every value appears at least twice.  A draw is kept
only where the reference builds it and, on a fused route, its fused gate
accepts it; a draw that meets a trap the port refuses on purpose keeps its
route and names the refusal (``refusal``).

The numpy-only recipe of an entry is tools/fuzz_recipe.py, which the
port's card phase reads too; this module finishes an entry with the
reference (``reference_system``), and only ``draw_entries`` and
``reference_system`` import it.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from tools.fuzz_recipe import (  # noqa: E402,F401
    CORPUS, RD_FORMS, SPACING, cfg_fields, gwp_widths, load, rotor_table,
    skewed_box, species_kwargs, system_recipe, tmmc_eta, uniforms)

SEED = 20231019
N_MIN = 72

# the axes every value of which the corpus holds at least twice
AXES = {
    "ensemble": ("uvt", "nvt", "nve", "npt"),
    "route": ("scan", "batched2", "batched3", "fused1", "fused2", "fused5",
              "pda"),
    "rd_potential": ("lj", "none", "sg", "dreiding", "b14_7",
                     "disp_expansion"),
    "coulomb": ("none", "cutoff", "wolf", "ewald", "gwp"),
    "mixing_rule": ("lb", "waldman_hagler"),
    "rd_lrc": ("on", "off"),
    "quantum": ("none", "fh2", "fh4", "fk"),
    "polar": ("off", "on"),
    "polar_solver": ("cg", "direct", "jacobi"),
    "polar_damp": ("exponential", "linear", "none"),
    "polar_field": ("direct", "ewald", "wolf"),
    "polar_mode": ("residual", "dipole"),
    "polar_delayed": ("on", "off"),
    "cavity_bias": ("on",),
    "tmmc": ("on",),
    "tmmc_bias": ("on",),
    "quantum_rotation": ("on",),
    "pair_route": ("dense", "cell_list", "mol_cache"),
    "insert_species": (1, 2, 3),
    "sites": (1, 2, 3, 5, 8),
    "cell": ("orthorhombic", "triclinic"),
    "tile": ("partial",),
    "refusal": ("NPT_FROZEN_TRAP", "CELL_LIST_FUSED_LRC_TRAP"),
}
ROUTE_CHAINS = {"scan": 1, "batched2": 2, "batched3": 3, "fused1": 1,
                "fused2": 2, "fused5": 5, "pda": 1}
ROUTE_ENSEMBLES = {"scan": ("uvt", "nvt", "nve", "npt"),
                   "batched2": ("uvt", "nvt", "nve", "npt"),
                   "batched3": ("uvt", "nvt", "nve", "npt"),
                   "fused1": ("uvt", "nvt", "nve", "npt"),
                   "fused2": ("uvt", "nvt"), "fused5": ("uvt", "nvt"),
                   "pda": ("uvt", "nvt")}
FUSED = ("fused1", "fused2", "fused5")
# the draw favours the GCMC main path
ENSEMBLE_WEIGHT = {"uvt": 2.5, "nvt": 1.5}
TILE = 128          # the kernels' tile width (B2's, B5's)

def _species_menu():
    """Rigid neutral templates by site count, as numbers: 1 CH4 (united
    atom), 2 a polar diatomic, 3 H2 (BSS, two zero-sigma sites), 5 an
    all-atom tetrahedral molecule, 8 an ethane-like one; every site but
    H2's protons has sigma > 0 (Waldman-Hagler mixing of two zero-sigma
    sites is NaN in float32, a reference trap)."""
    d = 0.371
    h2 = dict(name="H2", atom_names=["H2G", "H2E", "H2E"],
              pos=[[0.0, 0.0, 0.0], [0.0, 0.0, d], [0.0, 0.0, -d]],
              mass=[0.0, 1.008, 1.008], charge=[-0.93634, 0.46817, 0.46817],
              polar=[0.6938, 0.0, 0.0], eps=[34.2, 0.0, 0.0],
              sig=[2.96, 0.0, 0.0])
    ch4 = dict(name="CH4", atom_names=["CH4"], pos=[[0.0, 0.0, 0.0]],
               mass=[16.043], charge=[0.0], polar=[0.0], eps=[148.0],
               sig=[3.73])
    di = dict(name="DI", atom_names=["DC", "DO"],
              pos=[[0.0, 0.0, -0.564], [0.0, 0.0, 0.564]],
              mass=[12.011, 15.999], charge=[0.21, -0.21],
              polar=[0.8, 0.5], eps=[40.0, 60.0], sig=[3.2, 3.0])
    t = 1.09 / math.sqrt(3.0)
    tet = [[t, t, t], [t, -t, -t], [-t, t, -t], [-t, -t, t]]
    penta = dict(name="TET", atom_names=["TC"] + ["TH"] * 4,
                 pos=[[0.0, 0.0, 0.0]] + tet, mass=[12.011] + [1.008] * 4,
                 charge=[-0.24] + [0.06] * 4, polar=[1.0] + [0.4] * 4,
                 eps=[33.0] + [10.0] * 4, sig=[3.4] + [2.5] * 4)
    octa_pos = [[0.0, 0.0, -0.77], [0.0, 0.0, 0.77]]
    for z, s in ((-1.13, 1.0), (1.13, -1.0)):
        for k in range(3):
            a = 2.0 * math.pi * k / 3.0 + (0.0 if s > 0 else math.pi / 3.0)
            octa_pos.append([1.03 * math.cos(a), 1.03 * math.sin(a), z])
    octa = dict(name="ETH", atom_names=["EC", "EC"] + ["EH"] * 6,
                pos=octa_pos, mass=[12.011] * 2 + [1.008] * 6,
                charge=[-0.18] * 2 + [0.06] * 6,
                polar=[1.2] * 2 + [0.3] * 6, eps=[33.0] * 2 + [10.0] * 6,
                sig=[3.4] * 2 + [2.5] * 6)
    return {1: ch4, 2: di, 3: h2, 5: penta, 8: octa}


SPECIES = _species_menu()


def moves(entry):
    """The move types the entry's ensemble allows, by name."""
    c = entry["cfg"]
    out = ["displace"]
    if c["ensemble"] == "uvt":
        out += ["insert", "delete"]
    if c["ensemble"] == "npt":
        out.append("volume")
    if c.get("quantum_rotation") and c["ensemble"] != "nve":
        out.append("spinflip")
    return out


def entry_axes(entry):
    """{axis: [values]} an entry covers (AXES)."""
    c, r = entry["cfg"], entry["route"]
    q = ("fk" if c.get("feynman_kleinert") else
         ("fh4" if c.get("feynman_hibbs_order") == 4 else "fh2")
         if c.get("feynman_hibbs") else "none")
    out = {"ensemble": [c["ensemble"]], "route": [r],
           "ensemble@" + r: [c["ensemble"]],
           "rd_potential": [c["rd_potential"]], "coulomb": [c["coulomb"]],
           "mixing_rule": [c["mixing_rule"]],
           "rd_lrc": ["on" if c["rd_lrc"] else "off"], "quantum": [q],
           "polar": ["on" if c.get("polarization") else "off"],
           "pair_route": ["cell_list" if c.get("cell_list") else
                          "mol_cache" if c.get("mol_cache") else "dense"],
           "sites": sorted({len(s["atom_names"])
                            for s in entry["system"]["species"]}),
           "cell": ["triclinic" if entry["skew"] else "orthorhombic"],
           "tile": ["partial"] if entry["n_atoms"] % TILE else []}
    if c["ensemble"] == "uvt":
        out["insert_species"] = [len(c["insert_species"])]
    if c.get("polarization"):
        out.update(polar_solver=[c["polar_solver"]],
                   polar_damp=[c["polar_damp_type"]],
                   polar_field=["ewald" if c.get("polar_ewald") else
                                "wolf" if c.get("polar_wolf") else "direct"],
                   polar_mode=[c["polar_precision_mode"]],
                   polar_delayed=["on" if c.get("polar_delayed") else "off"])
    for k in ("cavity_bias", "tmmc", "tmmc_bias", "quantum_rotation"):
        out[k] = ["on" if c.get(k) else "off"]
    out["refusal"] = [entry.get("refusal") or "none"]
    return out


def coverage(entries):
    """{axis: {value: count}} over ``entries``."""
    cov = {a: {v: 0 for v in vs} for a, vs in AXES.items()}
    for e in entries:
        for a, vs in entry_axes(e).items():
            for v in vs:
                if v in cov.get(a, {}):
                    cov[a][v] += 1
    return cov


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

class _Picker:
    """Least-taken choice among the compatible values of an axis, ties
    broken by the seeded generator."""

    def __init__(self, rng, counts):
        self.rng, self.counts = rng, counts

    def __call__(self, axis, allowed, weights=None):
        allowed = list(allowed)
        c = self.counts.get(axis, {})
        w = weights or {}
        score = [c.get(v, 0) / w.get(v, 1.0) for v in allowed]
        best = [v for v, s in zip(allowed, score) if s == min(score)]
        return best[int(self.rng.integers(len(best)))]


def _draw(rng, pick):
    """One candidate entry (not yet checked against the reference)."""
    r = lambda lo, hi: float(round(rng.uniform(lo, hi), 4))  # noqa: E731
    refusal = None
    if rng.random() < 0.08:
        refusal = pick("refusal", AXES["refusal"])
    if refusal == "NPT_FROZEN_TRAP":
        route = pick("route", ("scan", "batched2", "batched3"))
        ens = "npt"
    elif refusal == "CELL_LIST_FUSED_LRC_TRAP":
        route = pick("route", FUSED)
        ens = "uvt"
    else:
        route = pick("route", AXES["route"])
        ens = pick("ensemble@" + route, ROUTE_ENSEMBLES[route],
                   ENSEMBLE_WEIGHT)
    fused = route in FUSED
    polar = ("on" if route == "pda" else "off" if fused
             else pick("polar", ("off", "on")))
    polar = polar == "on"
    mixing = pick("mixing_rule", AXES["mixing_rule"])
    frame = ens != "npt" or refusal == "NPT_FROZEN_TRAP"
    if ens == "nvt" or ens == "nve":
        frame = bool(rng.random() < 0.7)
    if ens == "uvt":
        n_sp = pick("insert_species", (1, 2, 3))
    else:
        n_sp = 1 + int(rng.random() < 0.3)
    # species: site counts least taken first; H2's zero-sigma protons not
    # under Waldman-Hagler; a polar entry needs one polarizable species
    menu = [s for s in (1, 2, 3, 5, 8)
            if not (mixing == "waldman_hagler" and s == 3)]
    sites = []
    if (ens in ("uvt", "nvt") and mixing == "lb" and frame
            and rng.random() < 0.4):
        sites = [3, 1][:n_sp]       # H2 (and CH4): the MOF builders
    for _ in range(n_sp - len(sites)):
        s = pick("sites", [m for m in menu if m not in sites])
        sites.append(s)
    if polar and all(max(SPECIES[s]["polar"]) == 0.0 for s in sites):
        sites[0] = 3 if mixing == "lb" else 5
    rd = pick("rd_potential", AXES["rd_potential"])
    quantum = pick("quantum", ("none", "fh2", "fh4", "fk") if rd == "lj"
                   else ("none",))
    coul_ok = [c for c in AXES["coulomb"] if not (polar and c == "gwp")]
    coulomb = pick("coulomb", coul_ok)
    lrc = pick("rd_lrc", ("on", "off")) == "on"
    cfg = dict(ensemble=ens, rd_potential=rd, coulomb=coulomb,
               mixing_rule=mixing, rd_lrc=lrc, dtype="float32",
               ewald_kmax=int(rng.integers(3, 6)), corrtime=1000,
               fused_mc=route in FUSED or route == "pda",
               feynman_hibbs=quantum in ("fh2", "fh4"),
               feynman_hibbs_order=4 if quantum == "fh4" else 2,
               feynman_kleinert=quantum == "fk", polarization=polar,
               cavity_autoreject_absolute=1.0 if frame else 0.0)
    if rd == "disp_expansion":
        cfg["damp_dispersion"] = bool(rng.random() < 0.5)
    if polar:
        solver = "cg" if route == "pda" else pick(
            "polar_solver", ("cg", "direct", "jacobi"))
        fields = ("direct", "wolf") + (("ewald",) if coulomb == "ewald"
                                       else ())
        field = pick("polar_field", fields)
        # undamped Jacobi sweeps diverge at the sites' close contacts
        # (a polarization catastrophe the reference runs into as well)
        damps = (("exponential", "linear") if solver == "jacobi"
                 else AXES["polar_damp"])
        cfg.update(polar_solver=solver,
                   polar_damp_type=pick("polar_damp", damps),
                   polar_ewald=field == "ewald", polar_wolf=field == "wolf",
                   polar_precision_mode=pick("polar_mode",
                                             ("residual", "dipole")),
                   polar_delayed=(route == "pda" or pick(
                       "polar_delayed", ("on", "off")) == "on"),
                   polar_max_iter=60)
    rotors = [s for s in sites if s >= 2]
    if ens == "uvt":
        cfg["insert_species"] = list(range(n_sp))
        if pick("cavity_bias", ("on", "off")) == "on":
            cfg.update(cavity_bias=True,
                       cavity_grid=int(rng.integers(4, 9)),
                       cavity_radius=r(1.5, 2.6))
        if n_sp == 1 and pick("tmmc", ("on", "off")) == "on":
            cfg["tmmc"] = True
            cfg["tmmc_bias"] = pick("tmmc_bias", ("on", "off")) == "on"
    else:
        cfg["insert_species"] = []
    qrot_ok = (ens in ("uvt", "nvt") and rotors
               and (len(rotors) == len(sites) or not (fused or
                                                      route == "pda")))
    if qrot_ok and pick("quantum_rotation", ("on", "off")) == "on":
        cfg["quantum_rotation"] = True
    pair = "dense"
    if refusal == "CELL_LIST_FUSED_LRC_TRAP":
        pair = "cell_list"
        cfg["rd_lrc"] = True
        if rd not in ("lj", "disp_expansion"):
            cfg["rd_potential"] = rd = "lj"
    else:
        routes = ["dense"]
        if frame and ens != "npt" and route in ("scan", "batched2",
                                                "batched3", "fused1"):
            routes.append("cell_list")
        if (ens in ("nvt", "uvt", "nve") and not polar
                and route in ("scan", "batched2", "batched3")):
            routes.append("mol_cache")
        pair = (pick("pair_route", routes[1:]) if len(routes) > 1
                and rng.random() < 0.3 else "dense")
        if pair == "cell_list" and fused and cfg["rd_lrc"] and rd in (
                "lj", "disp_expansion"):
            cfg["rd_lrc"] = False
    if pair == "cell_list":
        cfg["cell_list"] = True
        cfg["cutoff"] = 6.0
    if pair == "mol_cache":
        cfg["mol_cache"] = True
    skew = 0.0
    if pair != "cell_list" and pick("cell", AXES["cell"]) == "triclinic":
        skew = r(0.3, 1.0)
    cfg["ortho_box"] = skew == 0.0
    # the system
    seed = int(rng.integers(0, 2 ** 31))
    caps = [int(rng.integers(4, 8)) for _ in sites]
    counts = [int(rng.integers(1, c - 1)) for c in caps]
    pol_frame = 0.35 if polar else 0.0
    if pair == "cell_list":
        n_side = 4
    else:
        n_side = int(rng.integers(3, 5))
    if frame and sites == [3] and mixing == "lb":
        system = {"builder": "mof_h2_gcmc",
                  "args": dict(n_side=n_side, n_h2=counts[0],
                               capacity=caps[0], seed=seed,
                               polarization=polar)}
    elif frame and sites == [3, 1] and mixing == "lb":
        caps = [caps[0], caps[0]]
        counts = [counts[0], min(counts[1], caps[0] - 1)]
        system = {"builder": "mof_h2_ch4_gcmc",
                  "args": dict(n_side=n_side, n_h2=counts[0],
                               n_ch4=counts[1], capacity=caps[0], seed=seed)}
    elif not frame and sites == [1] and not polar:
        n = int(rng.integers(20, 41))
        system = {"builder": "lj_fluid",
                  "args": dict(n=n, density=r(0.012, 0.02), seed=seed)}
        sites, counts, caps = [1], [n], [n]
    else:
        args = dict(capacity=caps, initial_counts=counts, seed=seed)
        if frame:
            args["frame"] = {"n_side": n_side, "polar": pol_frame}
        else:
            args["edge"] = float(5.0 * math.ceil(sum(caps) ** (1 / 3)) + 2.0)
        system = {"builder": "build_system", "args": args}
    species = [copy.deepcopy(SPECIES[s]) for s in sites]
    if system["builder"] == "lj_fluid":
        species = [dict(name="AR", atom_names=["AR"], pos=[[0.0, 0.0, 0.0]],
                        mass=[39.948], charge=[0.0], polar=[0.0],
                        eps=[119.8], sig=[3.405])]
    system["species"] = species
    temp = r(60.0, 300.0)
    thermo = dict(temperature=temp, pressure=r(0.5, 5.0),
                  fugacity=[r(0.2, 5.0) for _ in sites],
                  move_factor=r(0.3, 1.2), rot_factor=r(0.5, math.pi),
                  insert_probability=r(0.3, 0.7) if ens == "uvt" else 0.0)
    if ens == "npt":
        thermo.update(pressure=r(50.0, 2000.0), volume_probability=r(0.1, 0.3),
                      volume_change_factor=r(0.02, 0.08))
    if cfg.get("quantum_rotation"):
        thermo["spinflip_probability"] = r(0.15, 0.4)
    chains = ROUTE_CHAINS[route]
    # chunks sized for the CPU tier (a polar step solves the SCF)
    if route == "pda":
        steps = 16 * int(rng.integers(1, 3))
    elif fused:
        steps = int(rng.integers(60, 121))
    elif polar:
        steps = int(rng.integers(12, 31)) // chains
    else:
        steps = int(rng.integers(30, 81))
    return dict(route=route, chains=chains, steps=steps,
                useed=int(rng.integers(0, 2 ** 31)), skew=skew,
                system=system, cfg=cfg, thermo=thermo,
                nve_kinetic=(r(5.0, 20.0) * temp if ens == "nve" else None),
                rseed=int(rng.integers(0, 2 ** 31)),
                gwp_seed=(int(rng.integers(0, 2 ** 31))
                          if coulomb == "gwp" else None),
                refusal=refusal)


def reference_system(entry, dtype="float64"):
    """(params, state, cfg, thermo) of the entry built by mpmc_tpu (not
    initialized): the builder or build_system, the RD form's columns
    (mpmc_tpu_torch.models.systems.rd_form_columns, numpy), GWP widths,
    the skewed box, the cfg and thermo fields, the tmmc_bias eta, the
    seeded rotor table, and under cell_list the reference's index
    (celllist.attach, min_reduction None).  chip_smoke.py fuzz_system is
    the port's build of the same recipe."""
    import jax.numpy as jnp
    from mpmc_tpu.config import RunConfig, Thermo
    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import celllist
    from mpmc_tpu.state import Species, build_system
    from mpmc_tpu_torch.models.systems import rd_form_columns
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    arr = lambda a: jnp.asarray(np.asarray(a), jdt)  # noqa: E731
    kind, kw = system_recipe(entry)
    if kind == "builder":
        p, s, c, _ = getattr(systems, kw["name"])(**kw["args"], dtype=dtype)
    else:
        kw = dict(kw)
        sp = tuple(Species(**species_kwargs(d)) for d in kw.pop("species"))
        p, s = build_system(species=sp, dtype=jdt, **kw)
        c = RunConfig()
    c = dataclasses.replace(c, **cfg_fields(entry, dtype))
    rep = {}
    if c.rd_potential in RD_FORMS:
        cols = rd_form_columns(np.asarray(p.eps), np.asarray(p.sig),
                               c.rd_potential)
        rep.update({k: arr(v) for k, v in
                    zip(("eps", "sig", "c6", "c8", "c10"), cols)})
    if c.coulomb == "gwp":
        rep["gwp_alpha"] = arr(gwp_widths(np.asarray(p.charge),
                                          entry["gwp_seed"]))
    if rep:
        p = dataclasses.replace(p, **rep)
    if entry["skew"]:
        s = s.replace(box=arr(skewed_box(np.asarray(s.box), entry["skew"])))
    t = Thermo.make(**entry["thermo"],
                    n_species=len(entry["system"]["species"]), dtype=jdt)
    if c.tmmc_bias:
        t = t.replace(tmmc_eta=arr(tmmc_eta(int(p.n_mols_max) + 1,
                                            entry["rseed"])))
    if c.quantum_rotation:
        spins, rot_f = rotor_table(int(p.n_mols_max), entry["rseed"])
        s = s.replace(spin=jnp.asarray(spins), rot_f=arr(rot_f))
    if c.cell_list:
        p = celllist.attach(p, s.pos, s.box, c, min_reduction=None)
    return p, s, c, t


def _fused_gate(entry, p, c):
    """The reference's gate of the entry's fused route (None elsewhere)."""
    from mpmc_tpu.ops.pallas import mc_kernel as jmk
    r, e = entry["route"], c.ensemble
    if r == "pda":
        return jmk.supported_uvt_polar_da(c, p)
    if r == "fused1":
        return (jmk.supported_uvt(c, p) if e == "uvt" else
                jmk.supported_npt(c, p) if e == "npt" else
                jmk.supported(c, p))
    if r in ("fused2", "fused5"):
        return (jmk.supported_uvt_multi(c, p) if e == "uvt" else
                jmk.supported_multi(c, p))
    return None


def _accept(entry):
    """Build the entry with the reference (float32, the fused gates'
    type) and keep it where the reference builds it, its fused gate
    accepts it, a cell_list entry gets an index, and its initial
    molecules are apart (no site pair inside the autoreject radius)."""
    try:
        p, s, c, t = reference_system(entry, "float32")
    except ValueError:
        return False
    entry["n_atoms"] = int(np.asarray(p.charge).shape[0])
    if _fused_gate(entry, p, c) is False:
        return False
    if c.cell_list and p.cell_index is None:
        return False
    return True


def draw_entries(seed=SEED, n_min=N_MIN):
    """The corpus's entries: balanced draws until there are ``n_min`` and
    every value of AXES is covered twice."""
    rng = np.random.default_rng(seed)
    entries = []
    counts = {}     # every value taken, of AXES' axes or not
    pick = _Picker(rng, counts)
    tries = 0
    while True:
        cov_ok = all(counts.get(a, {}).get(v, 0) >= 2
                     for a, vs in AXES.items() for v in vs)
        if len(entries) >= n_min and cov_ok:
            break
        tries += 1
        if tries > 20 * n_min:
            raise RuntimeError("the corpus draw does not converge")
        e = _draw(rng, pick)
        if not _accept(e):
            continue
        e = {"id": f"f{len(entries):02d}", **e}
        entries.append(e)
        for a, vs in entry_axes(e).items():
            for v in vs:
                counts.setdefault(a, {})
                counts[a][v] = counts[a].get(v, 0) + 1
    return entries


def corpus(seed=SEED):
    return {"seed": seed, "generator": "tools/make_fuzz_corpus.py",
            "entries": draw_entries(seed)}


def dumps(obj):
    return json.dumps(obj, indent=1, sort_keys=True) + "\n"


def main(argv):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    text = dumps(corpus())
    if argv[1:2] == ["--check"]:
        with open(CORPUS) as f:
            same = f.read() == text
        print("corpus", "matches" if same else "DIFFERS", CORPUS)
        return 0 if same else 1
    with open(CORPUS, "w") as f:
        f.write(text)
    n = len(json.loads(text)["entries"])
    print(f"wrote {n} entries to {CORPUS}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv))
