"""Surface-scan and force-field-fitting drivers (port of
mpmc_tpu/mc/surface.py).

- ``ensemble surf``: a rigid two-molecule PES scan.  Molecule A sits at
  the origin in its input orientation, molecule B at separation r along
  +x, r from surf_min to surf_max in steps of surf_inc.  With ``surf_ang``
  > 0 (and no ``surf_preserve``) both molecules' orientations sweep a z-y-z
  Euler grid of that increment (degrees), every pair of the product, and
  each separation reports the minimum and the mean over them;
  ``surf_decomp`` adds the terms (rd, es, polar, vdw) at the minimum.
- ``ensemble surf_fit`` / ``surf_multi_fit``: simulated annealing of the
  per-site-type LJ eps and sig (a walk in log space) against one or more
  curves ("r E" lines) or sets of configurations ("E <energy>" blocks of
  x y z lines, one per movable atom), minimizing the Boltzmann-weighted
  chi^2 (fit_schedule, fit_start_temp, fit_max_energy,
  fit_boltzmann_weight).

The energies are the production ones, evaluated over a batch of
geometries at once (ops/energy.total_energy_chains, where the reference
vmaps total_energy): each scan batch of up to 512 orientation pairs and
each chi^2 evaluation (all curve points, or all configurations) is one
launch of B2 over the batch.  The annealing walk draws from the
reference's host stream, numpy.random.default_rng(seed), in the
reference's order, so a float64 fit takes the reference's accept / reject
path.
"""
from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.ops import energy as energy_mod
from mpmc_tpu_torch.state import Params, molecule_com
from mpmc_tpu_torch.utils import quaternion as quat

# orientation pairs of one scan batch (one B2 launch), the reference's
BATCH = 512


# ---------------------------------------------------------------------------
# geometry builders
# ---------------------------------------------------------------------------

def _dimer_slots(params: Params, mol_alive) -> Tuple[int, int]:
    """The two alive movable molecule slots of a dimer system."""
    alive = mol_alive.cpu().numpy()
    frozen = params.mol_frozen.cpu().numpy()
    spec = params.mol_species.cpu().numpy()
    slots = [m for m in range(len(alive))
             if alive[m] and not frozen[m] and spec[m] >= 0]
    if len(slots) != 2:
        raise ValueError(
            f"surface scan needs exactly 2 movable molecules, got "
            f"{len(slots)}")
    return slots[0], slots[1]


def _qmul(a, b):
    """Hamilton product of two quaternions (w, x, y, z), numpy."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _euler_quat(a, b, c):
    """z-y-z Euler rotation as a quaternion (host-side, numpy)."""
    qz1 = np.array([np.cos(a / 2), 0.0, 0.0, np.sin(a / 2)])
    qy = np.array([np.cos(b / 2), 0.0, np.sin(b / 2), 0.0])
    qz2 = np.array([np.cos(c / 2), 0.0, 0.0, np.sin(c / 2)])
    return _qmul(qz1, _qmul(qy, qz2))


def dimer_positions(params: Params, pos0, mol_a: int, mol_b: int, r,
                    q_b=None, q_a=None):
    """[C, N, 3] positions, one per entry of ``r`` [C]: molecule A at the
    origin and molecule B at (r, 0, 0), each re-oriented from its input
    orientation by its quaternion [C, 4] (None: kept), every other row
    as in ``pos0`` [N, 3]."""
    C = r.shape[0]
    ia = params.mol_atoms[mol_a]
    ib = params.mol_atoms[mol_b]
    pa = (pos0[ia] - molecule_com(pos0, params, mol_a)).expand(C, -1, 3)
    pb = (pos0[ib] - molecule_com(pos0, params, mol_b)).expand(C, -1, 3)
    if q_a is not None:
        pa = quat.rotate(pa, q_a[:, None, :])
    if q_b is not None:
        pb = quat.rotate(pb, q_b[:, None, :])
    offset = torch.stack([r, torch.zeros_like(r), torch.zeros_like(r)], -1)
    pos = pos0.expand(C, -1, 3).clone()
    pos[:, ia] = pa
    pos[:, ib] = pb + offset[:, None, :]
    return pos


# ---------------------------------------------------------------------------
# ensemble surf
# ---------------------------------------------------------------------------

def _orientations(job):
    """(qa, qb) [P, 4] numpy: the product of A's and B's Euler grids
    (surf_ang > 0 without surf_preserve), else the input orientations."""
    if job.surf_ang > 0 and not job.surf_preserve:
        step = np.deg2rad(job.surf_ang)
        als = np.arange(0.0, 2 * np.pi - 1e-9, step)
        bes = np.arange(0.0, np.pi + 1e-9, step)
        gas = np.arange(0.0, 2 * np.pi - 1e-9, step)
        one = np.stack([_euler_quat(a, b, c)
                        for a in als for b in bes for c in gas])
        return (np.repeat(one, len(one), axis=0),
                np.tile(one, (len(one), 1)))
    q = np.array([[1.0, 0.0, 0.0, 0.0]])
    return q, q


def run_surface(job, log=None, device=None):
    """The PES scan; returns a list of result dicts (also written to
    surf_output, or the log), in the reference's format."""
    from mpmc_tpu_torch.mc import run as run_mod
    su = run_mod.setup(job, device=device)
    params, state, cfg, thermo = su.params, su.state, su.cfg, su.thermo
    mol_a, mol_b = _dimer_slots(params, state.mol_alive)
    rs = np.arange(job.surf_min, job.surf_max + 1e-9, job.surf_inc)
    if len(rs) == 0:
        raise ValueError("empty surface scan range")
    dev, dt = state.pos.device, cfg.tdtype
    qa, qb = (torch.as_tensor(q, dtype=dt, device=dev)
              for q in _orientations(job))
    consts = energy_mod.box_constants(state.box, cfg)

    out = open(job.surf_output, "w") if job.surf_output else (log or
                                                              sys.stdout)
    cols = "# r_A  E_min_K  E_mean_K"
    if job.surf_decomp:
        cols += "  rd  es  polar  vdw   (at E_min orientation)"
    print(cols, file=out)
    results = []
    for r in rs:
        parts = []
        for i in range(0, qa.shape[0], BATCH):
            a, b = qa[i:i + BATCH], qb[i:i + BATCH]
            pos = dimer_positions(params, state.pos, mol_a, mol_b,
                                  torch.full((a.shape[0],), float(r),
                                             dtype=dt, device=dev), b, a)
            e = energy_mod.total_energy_chains(pos, state.box,
                                               state.mol_alive, params, cfg,
                                               thermo, consts)
            parts.append(torch.stack([e.total, e.rd + e.lrc, e.es, e.polar,
                                      e.vdw], -1))
        e = torch.cat(parts).cpu().numpy()
        totals = e[:, 0]
        k = int(np.argmin(totals))
        row = {"r": float(r), "min": float(totals[k]),
               "mean": float(np.mean(totals)), "rd": float(e[k, 1]),
               "es": float(e[k, 2]), "polar": float(e[k, 3]),
               "vdw": float(e[k, 4])}
        results.append(row)
        line = f"{row['r']:10.4f} {row['min']:16.6f} {row['mean']:16.6f}"
        if job.surf_decomp:
            line += (f" {row['rd']:14.6f} {row['es']:14.6f}"
                     f" {row['polar']:14.6f} {row['vdw']:14.6f}")
        print(line, file=out)
    if job.surf_output:
        out.close()
        print(f"surface scan written to {job.surf_output}",
              file=log or sys.stdout)
    return results


# ---------------------------------------------------------------------------
# ensemble surf_fit / surf_multi_fit
# ---------------------------------------------------------------------------

def read_fit_curve(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(r [K], E [K]) of a fit_input curve: "r E" lines, '#'/'!'
    comments."""
    rs, es = [], []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#")[0].split("!")[0].strip()
            if not line:
                continue
            t = line.split()
            rs.append(float(t[0]))
            es.append(float(t[1]))
    if not rs:
        raise ValueError(f"no data points in fit input {path}")
    return np.asarray(rs), np.asarray(es)


def _fit_groups_rows(params: Params, rows) -> List[List[int]]:
    """Atom rows grouped by (eps, sig) type, eps > 0 only (massless
    charge sites keep eps = sig = 0)."""
    eps = params.eps.cpu().numpy()
    sig = params.sig.cpu().numpy()
    groups = {}
    for i in rows:
        if eps[i] <= 0:
            continue
        key = (round(float(eps[i]), 8), round(float(sig[i]), 8))
        groups.setdefault(key, []).append(int(i))
    return list(groups.values())


def _fit_groups(params: Params, mol_a: int, mol_b: int):
    """The dimer's atoms grouped by (eps, sig) type (_fit_groups_rows)."""
    idx = np.unique(np.concatenate([params.mol_atoms[mol_a].cpu().numpy(),
                                    params.mol_atoms[mol_b].cpu().numpy()]))
    return _fit_groups_rows(params, idx)


def read_multi_fit_configs(path: str):
    """A surf_multi_fit configuration file: blocks of

        E <target energy in K>
        x y z          (one line per movable atom, PQR slot order)
        ...

    '#'/'!' comments allowed.  Returns (coords [K, n, 3], energies
    [K])."""
    configs: List[List[List[float]]] = []
    energies: List[float] = []
    cur: List[List[float]] = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#")[0].split("!")[0].strip()
            if not line:
                continue
            t = line.split()
            if t[0].upper() == "E":
                if cur:
                    configs.append(cur)
                    cur = []
                energies.append(float(t[1]))
            else:
                cur.append([float(t[0]), float(t[1]), float(t[2])])
    if cur:
        configs.append(cur)
    if not energies or len(configs) != len(energies):
        raise ValueError(
            f"fit input {path}: expected 'E <energy>' blocks each "
            f"followed by one x-y-z line per movable atom "
            f"(got {len(energies)} energies / {len(configs)} geometry "
            f"blocks)")
    n = len(configs[0])
    if any(len(c) != n for c in configs):
        raise ValueError(f"fit input {path}: inconsistent atom counts "
                         "across configuration blocks")
    return np.asarray(configs, np.float64), np.asarray(energies)


def _movable_atom_rows(params: Params, mol_alive) -> np.ndarray:
    """Atom-slot indices of every alive movable molecule, slot order."""
    alive = mol_alive.cpu().numpy()
    frozen = params.mol_frozen.cpu().numpy()
    natoms = params.mol_natoms.cpu().numpy()
    start = params.mol_start.cpu().numpy()
    out = []
    for m in range(len(alive)):
        if alive[m] and not frozen[m]:
            s0 = int(start[m])
            out.extend(range(s0, s0 + int(natoms[m])))
    return np.asarray(out, np.int64)


def _weights(e_ref, job):
    """(the capped targets, normalized Boltzmann weights) of a fit."""
    cap = job.fit_max_energy
    e = np.minimum(e_ref, cap) if cap > 0 else e_ref
    w = (np.exp(-e / job.fit_boltzmann_weight)
         if job.fit_boltzmann_weight > 0 else np.ones_like(e))
    return e, w / w.sum()


def _chi2_fn(params, state, cfg, thermo, groups, pos, e_ref, w, cap):
    """chi2(vec) -> float: vec = [log eps_g..., log sig_g...] substituted
    into every site of group g, every geometry of ``pos`` [K, N, 3] in one
    batched energy (one B2 launch), the Boltzmann-weighted squared error
    against ``e_ref`` (model energies capped at ``cap`` > 0)."""
    dev, dt = pos.device, cfg.tdtype
    g = len(groups)
    masks = torch.zeros((g, params.n_atoms_max), dtype=torch.bool,
                        device=dev)
    for k, idxs in enumerate(groups):
        masks[k, idxs] = True
    eref_t = torch.as_tensor(e_ref, dtype=dt, device=dev)
    w_t = torch.as_tensor(w, dtype=dt, device=dev)
    consts = energy_mod.box_constants(state.box, cfg)     # the box stays

    def chi2(vec):
        v = torch.as_tensor(vec, dtype=dt, device=dev)
        eps_g, sig_g = torch.exp(v[:g]), torch.exp(v[g:])
        eps, sig = params.eps, params.sig
        for k in range(g):
            eps = torch.where(masks[k], eps_g[k], eps)
            sig = torch.where(masks[k], sig_g[k], sig)
        p = params.replace(eps=eps, sig=sig)
        e = energy_mod.total_energy_chains(pos, state.box, state.mol_alive,
                                           p, cfg, thermo, consts).total
        if cap > 0:
            e = torch.clamp(e, max=cap)
        return float(torch.sum(w_t * (e - eref_t) ** 2))

    return chi2


def _anneal(chi2, vec0, job, cfg, out, head):
    """The simulated-annealing walk over a parameter vector, on the
    reference's host stream (numpy default_rng(seed): a normal(0, 0.02)
    proposal, then a uniform only where the proposal is not downhill);
    returns (best vector, best chi2)."""
    rng = np.random.default_rng(cfg.seed)
    vec = vec0.copy()
    cur = chi2(vec)
    best_vec, best = vec.copy(), cur
    t_anneal = job.fit_start_temp if job.fit_start_temp > 0 else cur
    n_steps = max(job.cfg.numsteps, 2000)
    print(f"{head}chi2_0={cur:.6g}, T0={t_anneal:.4g}", file=out)
    for _ in range(n_steps):
        prop = vec + rng.normal(0.0, 0.02, size=vec.shape)
        c = chi2(prop)
        if c < cur or rng.random() < np.exp(-(c - cur)
                                            / max(t_anneal, 1e-30)):
            vec, cur = prop, c
            if c < best:
                best_vec, best = prop.copy(), c
        t_anneal *= job.fit_schedule
    return best_vec, best


def _fit_result(tag, groups, best_vec, best, out):
    """The fitted types as a dict, logged in the reference's format."""
    g = len(groups)
    result = {}
    for k, gr in enumerate(groups):
        result[f"type{k}"] = {"atoms": gr,
                              "eps": float(np.exp(best_vec[k])),
                              "sig": float(np.exp(best_vec[g + k]))}
    print(f"{tag}: best chi2 = {best:.6g}", file=out)
    for k, v in result.items():
        print(f"  {k}: eps = {v['eps']:.6f} K   sig = {v['sig']:.6f} A",
              file=out)
    return result


def _vec0(params, groups):
    eps = params.eps.cpu().numpy()
    sig = params.sig.cpu().numpy()
    return np.concatenate([np.log([eps[gr[0]] for gr in groups]),
                           np.log([sig[gr[0]] for gr in groups])])


def run_surface_multi_fit(job, log=None, device=None):
    """The multi-configuration fit (``ensemble surf_multi_fit``): every
    fit_input holds geometries of the movable atoms with target energies
    (read_multi_fit_configs), one chi^2 over all of them, each evaluation
    one batched energy.  Returns (best_params_dict, best_chi2)."""
    from mpmc_tpu_torch.mc import run as run_mod
    out = log or sys.stdout
    if not job.fit_inputs:
        raise ValueError("surf_multi_fit requires at least one fit_input")
    su = run_mod.setup(job, device=device)
    params, state, cfg, thermo = su.params, su.state, su.cfg, su.thermo
    rows = _movable_atom_rows(params, state.mol_alive)
    coords, erefs = [], []
    for p in job.fit_inputs:
        c, e = read_multi_fit_configs(p)
        if c.shape[1] != len(rows):
            raise ValueError(
                f"fit input {p}: {c.shape[1]} atoms per configuration, "
                f"but the system has {len(rows)} movable atoms")
        coords.append(c)
        erefs.append(e)
    coords = np.concatenate(coords)           # [K, n, 3]
    e_capped, w = _weights(np.concatenate(erefs), job)
    groups = _fit_groups_rows(params, rows)
    if not groups:
        raise ValueError("no LJ sites to fit (all eps == 0)")
    K = coords.shape[0]
    pos = state.pos.expand(K, -1, 3).clone()
    pos[:, torch.as_tensor(rows, device=pos.device)] = torch.as_tensor(
        coords, dtype=cfg.tdtype, device=pos.device)
    chi2 = _chi2_fn(params, state, cfg, thermo, groups, pos, e_capped, w,
                    job.fit_max_energy)
    tag = (f"surf_multi_fit: {len(groups)} LJ types, {K} configurations")
    best_vec, best = _anneal(chi2, _vec0(params, groups), job, cfg, out,
                             f"{tag}: ")
    return _fit_result("surf_multi_fit", groups, best_vec, best, out), best


def run_surface_fit(job, log=None, device=None):
    """The curve fit (``ensemble surf_fit``): the dimer at every curve
    point's separation, each evaluation one batched energy.  Returns
    (best_params_dict, best_chi2)."""
    from mpmc_tpu_torch.mc import run as run_mod
    out = log or sys.stdout
    if not job.fit_inputs:
        raise ValueError("surf_fit requires at least one fit_input")
    curves = [read_fit_curve(p) for p in job.fit_inputs]
    su = run_mod.setup(job, device=device)
    params, state, cfg, thermo = su.params, su.state, su.cfg, su.thermo
    mol_a, mol_b = _dimer_slots(params, state.mol_alive)
    groups = _fit_groups(params, mol_a, mol_b)
    if not groups:
        raise ValueError("no LJ sites to fit (all eps == 0)")
    all_r = np.concatenate([c[0] for c in curves])
    e_capped, w = _weights(np.concatenate([c[1] for c in curves]), job)
    # the curve's geometries do not depend on the parameters: built once
    pos = dimer_positions(params, state.pos, mol_a, mol_b,
                          torch.as_tensor(all_r, dtype=cfg.tdtype,
                                          device=state.pos.device))
    chi2 = _chi2_fn(params, state, cfg, thermo, groups, pos, e_capped, w,
                    job.fit_max_energy)
    best_vec, best = _anneal(
        chi2, _vec0(params, groups), job, cfg, out,
        f"surf_fit: {len(groups)} LJ types, {len(all_r)} points, ")
    return _fit_result("surf_fit", groups, best_vec, best, out), best
