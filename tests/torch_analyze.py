"""Trajectories and streams for the tests of mpmc_tpu_torch/analyze.py
(tests/test_torch_analyze_*.py): the systems of the reference's
tests/test_analyze.py, written with the port's PQR writer and read by
both packages."""
import json

import numpy as np

from mpmc_tpu_torch.io import pqr


def atom(serial, name, mol_name, mol_id, flag, xyz, mass=1.0):
    return pqr.PqrAtom(serial=serial, name=name, mol_name=mol_name,
                       mol_id=mol_id, flag=flag,
                       xyz=np.asarray(xyz, np.float64), mass=mass,
                       charge=0.0, polar=0.0, eps=10.0, sig=3.0)


def write_traj(path, frames, box):
    for k, atoms in enumerate(frames):
        pqr.write(str(path), atoms, mode="w" if k == 0 else "a",
                  remark=f"frame {k}", box=box)


def triclinic_traj(tmp_path, n_frames=4, n_ar=40, n_he=12, seed=3):
    """Mixed Ar/He fluid + a frozen AR site, triclinic cell."""
    box = np.array([[14.0, 0.0, 0.0],
                    [2.0, 13.0, 0.0],
                    [1.0, -1.5, 12.0]])
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        atoms, serial = [], 1
        for _ in range(n_ar):
            frac = rng.uniform(0, 1, 3)
            atoms.append(atom(serial, "AR", "AR", serial, "M", frac @ box,
                              mass=39.9))
            serial += 1
        for _ in range(n_he):
            frac = rng.uniform(0, 1, 3)
            atoms.append(atom(serial, "HE", "HE", serial, "M", frac @ box,
                              mass=4.0))
            serial += 1
        atoms.append(atom(serial, "AR", "MOF", serial, "F",
                          [0.5, 0.5, 0.5]))
        frames.append(atoms)
    path = tmp_path / "traj.pqr"
    write_traj(path, frames, box)
    return str(path), box, frames


def gcmc_traj(tmp_path, n_frames=6, seed=4):
    """Rigid 3-site molecules (H2G centre, two H2E) in a triclinic cell,
    molecules vanishing and appearing between frames (GCMC), each
    rotated at random, plus a frozen charged lattice."""
    box = np.array([[15.0, 0.0, 0.0],
                    [1.5, 14.0, 0.0],
                    [-1.0, 2.0, 13.0]])
    rng = np.random.default_rng(seed)
    alive = set(range(1, 25))
    frames = []
    for _ in range(n_frames):
        for m in list(alive):
            if rng.uniform() < 0.15:
                alive.discard(m)
        for m in range(1, 31):
            if m not in alive and rng.uniform() < 0.1:
                alive.add(m)
        atoms, serial = [], 1
        for k in range(8):
            a = atom(serial, "ZN", "MOF", 1000 + k, "F",
                     rng.uniform(0, 1, 3) @ box, mass=65.4)
            a.charge = 0.4 if k % 2 else -0.4
            a.eps, a.sig = 62.0, 2.46
            atoms.append(a)
            serial += 1
        for m in sorted(alive):
            c = rng.uniform(0, 1, 3) @ box
            v = rng.normal(size=3)
            v *= 0.371 / np.linalg.norm(v)
            for name, off, mass, q in (("H2G", 0 * v, 0.0, -0.936),
                                       ("H2E", v, 1.008, 0.468),
                                       ("H2E", -v, 1.008, 0.468)):
                a = atom(serial, name, "H2", m, "M", c + off, mass=mass)
                a.charge = q
                a.eps, a.sig = (34.2, 2.96) if name == "H2G" else (0.0, 0.0)
                atoms.append(a)
                serial += 1
        frames.append(atoms)
    path = tmp_path / "gcmc.pqr"
    write_traj(path, frames, box)
    return str(path), box, frames


def drift_traj(tmp_path, n_frames=6, v=(0.9, 0.0, 0.0)):
    """One molecule drifting v per frame across the boundary, a
    molecule that vanishes mid-trajectory and another appearing after."""
    box = np.eye(3) * 5.0
    v = np.asarray(v)
    frames = []
    for k in range(n_frames):
        atoms = [atom(1, "AR", "AR", 1, "M",
                      (np.array([0.5, 2.5, 2.5]) + k * v) % 5.0)]
        if k < 3:
            atoms.append(atom(2, "HE", "HE", 2, "M", [1.0, 1.0, 1.0]))
        if k >= 4:
            atoms.append(atom(3, "HE", "HE", 3, "M", [4.0, 4.0, 4.0]))
        frames.append(atoms)
    path = tmp_path / "drift.pqr"
    write_traj(path, frames, box)
    return str(path), box, frames


def dimer_traj(tmp_path, n_frames=12, dtheta=2 * np.pi / 12):
    """One rigid dimer rotating dtheta per frame in the xy plane, a
    dimer that vanishes after 3 frames and a lone single-atom
    molecule."""
    box = np.eye(3) * 20.0
    frames = []
    for k in range(n_frames):
        th = k * dtheta
        u = np.array([np.cos(th), np.sin(th), 0.0])
        c = np.array([10.0, 10.0, 10.0])
        atoms = [atom(1, "H", "H2", 1, "M", c - 0.37 * u),
                 atom(2, "H", "H2", 1, "M", c + 0.37 * u),
                 atom(5, "X", "XE", 5, "M", [3.0, 3.0, 3.0])]
        if k < 3:
            atoms += [atom(3, "H", "H2", 2, "M", [5.0, 5.0, 4.63]),
                      atom(4, "H", "H2", 2, "M", [5.0, 5.0, 5.37])]
        frames.append(atoms)
    path = tmp_path / "dimer.pqr"
    write_traj(path, frames, box)
    return str(path), box, frames


def charged_traj(tmp_path):
    """Frozen framework with LJ and net-neutral charges."""
    box = np.eye(3) * 12.0
    rng = np.random.default_rng(9)
    frames = []
    for _ in range(3):
        atoms = []
        for i in range(14):
            a = atom(i + 1, "O", "MOF", i + 1, "F", rng.uniform(0, 12, 3),
                     mass=16.0)
            a.charge = 0.3 if i % 2 == 0 else -0.3
            atoms.append(a)
        frames.append(atoms)
    path = tmp_path / "charged.pqr"
    write_traj(path, frames, box)
    return str(path), box


def h2_template(tmp_path):
    """An insert_input-style 3-site charged H2 template."""
    h = atom(1, "H2G", "H2", 1, "M", [0.0, 0.0, 0.0], mass=0.0)
    h.charge, h.eps, h.sig = -0.84, 34.2, 3.0
    h1 = atom(2, "H2E", "H2", 1, "M", [0.0, 0.0, -0.37], mass=1.008)
    h1.charge, h1.eps = 0.42, 0.0
    h2 = atom(3, "H2E", "H2", 1, "M", [0.0, 0.0, 0.37], mass=1.008)
    h2.charge, h2.eps = 0.42, 0.0
    tpl = tmp_path / "h2.pqr"
    pqr.write(str(tpl), [h, h1, h2])
    return str(tpl)


def posquat(n, seed=5):
    rng = np.random.default_rng(seed)
    pq = np.empty((n, 7))
    pq[:, :3] = rng.uniform(0, 1, (n, 3))
    q = rng.standard_normal((n, 4))
    pq[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return pq


def sphere_struct(tmp_path, atoms_spec, box_edge=20.0, name="struct.pqr"):
    """One frame of frozen hard spheres [(name, xyz, sig), ...] in a
    cube."""
    box = np.eye(3) * box_edge
    atoms = []
    for k, (nm, xyz, sig) in enumerate(atoms_spec):
        a = atom(k + 1, nm, "MOF", k + 1, "F", xyz, mass=12.0)
        a.sig = sig
        atoms.append(a)
    path = tmp_path / name
    write_traj(path, [atoms], box)
    return str(path), box


def cluster_frame(tmp_path, box_l=14.0):
    """Molecules 1 + 2 bond directly, 3 bonds to 1 across the boundary
    (min-image 0.8 A), 4 is isolated."""
    atoms = [atom(1, "He", "HE", 1, "M", [0.5, 1.0, 1.0]),
             atom(2, "He", "HE", 2, "M", [2.0, 1.0, 1.0]),
             atom(3, "He", "HE", 3, "M", [13.7, 1.0, 1.0]),
             atom(4, "He", "HE", 4, "M", [8.0, 8.0, 8.0])]
    path = tmp_path / "clu.pqr"
    write_traj(path, [atoms], box_l * np.eye(3))
    return str(path)


def gc_jsonl(path, temperature, fugacity, n_samples, seed, eps_bind,
             species=("MOF", "H2")):
    """A synthetic GCMC stream with a run_meta header: the lattice gas
    U = -eps_bind N, Poisson occupancy lambda = 5 f exp(eps_bind / T)."""
    rng = np.random.default_rng(seed)
    lam = 5.0 * fugacity * np.exp(eps_bind / temperature)
    lines = [json.dumps({"run_meta": {
        "species": list(species), "ensemble": "uvt",
        "temperature": temperature, "pressure": fugacity,
        "fugacities": [0.0, fugacity], "volume": 1000.0}})]
    for i in range(n_samples):
        n = int(rng.poisson(lam))
        lines.append(json.dumps({
            "step": (i + 1) * 10, "energy_total": -eps_bind * n,
            "N": float(n), f"N_{species[1]}": float(n)}))
    path.write_text("\n".join(lines) + "\n")
    return lam


def pt_ladder_jsonl(path, seed=9, blocks=400):
    """Synthetic PT ladder records (temps permuted across blocks) of the
    harmonic mode U | T ~ (T/2) chi2_1."""
    rng = np.random.default_rng(seed)
    ladder = np.array([80.0, 100.0, 125.0, 156.25])
    lines = []
    for blk in range(blocks):
        temps = ladder[rng.permutation(4)]
        us = 0.5 * temps * rng.normal(0.0, 1.0, 4) ** 2
        lines.append(json.dumps({
            "step": blk, "pt_temps": temps.tolist(),
            "pt_energy": us.tolist(), "pt_N": [2.0, 2.0, 2.0, 2.0]}))
    path.write_text("\n".join(lines) + "\n")
