"""MPMC-extended PQR geometry I/O.

Rebuild of the reference's molecule reader/writer (SURVEY.md §2 "PQR
reader" / "Output writer", src/io/input.c read_molecules() [M],
src/io/output.c write_molecules() [M]).

Since the reference mount was empty (SURVEY.md §0), the column layout below
is this framework's documented contract, covering the same per-atom fields
the reference stores [C fields, M column order]:

    ATOM serial atom_name mol_name mol_id flag x y z mass charge polar eps sig [omega c6 c8 c10 gwp_alpha]

- ``flag``: F = frozen (framework), M = movable (adsorbate), S = spectre.
- ``mol_id``: integer; atoms sharing a mol_id form one rigid molecule.
- trailing omega/c6/c8/c10 are optional (PHAHST dispersion-expansion).
- ``#``/``!``/``REMARK`` lines are comments; ``END``/``ENDMDL`` terminate a
  frame (multi-frame files = trajectories).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class PqrAtom:
    serial: int
    name: str
    mol_name: str
    mol_id: int
    flag: str
    xyz: np.ndarray
    mass: float
    charge: float
    polar: float
    eps: float
    sig: float
    omega: float = 0.0
    c6: float = 0.0
    c8: float = 0.0
    c10: float = 0.0
    gwp_alpha: float = 0.0   # Gaussian-wave-packet width (quantum nuclei)


@dataclasses.dataclass
class PqrFrame:
    atoms: List[PqrAtom]
    box: Optional[np.ndarray] = None   # from a CRYST1 record, if present

    @property
    def frozen(self):
        return [a for a in self.atoms if a.flag.upper().startswith("F")]

    @property
    def movable(self):
        return [a for a in self.atoms if not a.flag.upper().startswith("F")]

    def movable_molecules(self) -> Dict[int, List[PqrAtom]]:
        mols: Dict[int, List[PqrAtom]] = {}
        for a in self.movable:
            mols.setdefault(a.mol_id, []).append(a)
        return mols


def parse_atom_line(line: str) -> Optional[PqrAtom]:
    t = line.split()
    if not t or t[0] not in ("ATOM", "HETATM"):
        return None
    if len(t) < 14:
        raise ValueError(
            f"PQR atom line needs >=14 fields "
            f"(ATOM serial name mol_name mol_id flag x y z mass charge "
            f"polar eps sig), got {len(t)}: {line.rstrip()!r}")
    extra = [float(x) for x in t[14:19]]
    extra += [0.0] * (5 - len(extra))
    return PqrAtom(
        serial=int(t[1]), name=t[2], mol_name=t[3], mol_id=int(t[4]),
        flag=t[5].upper(),
        xyz=np.array([float(t[6]), float(t[7]), float(t[8])]),
        mass=float(t[9]), charge=float(t[10]), polar=float(t[11]),
        eps=float(t[12]), sig=float(t[13]),
        omega=extra[0], c6=extra[1], c8=extra[2], c10=extra[3],
        gwp_alpha=extra[4])


def read_first_frame(path: str) -> PqrFrame:
    """First frame only — stops at the first END/ENDMDL, so metadata
    lookups (framework mass, cell) on multi-GB trajectories never
    materialize the whole file (analyze.widom)."""
    atoms: List[PqrAtom] = []
    box = None
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("CRYST"):
                t = s.split()
                if len(t) >= 7:
                    from mpmc_tpu_torch.ops.pbc import cell_from_abc
                    box = np.asarray(cell_from_abc(
                        *[float(x) for x in t[1:7]]))
                continue
            if not s or s.startswith(("#", "!", "REMARK")):
                continue
            if s.startswith(("END", "ENDMDL")):
                if atoms:
                    break
                continue
            a = parse_atom_line(line)
            if a is not None:
                atoms.append(a)
    if not atoms:
        raise ValueError(f"no atoms found in {path}")
    return PqrFrame(atoms, box=box)


def read_frames(path: str) -> List[PqrFrame]:
    frames: List[PqrFrame] = []
    atoms: List[PqrAtom] = []
    box = None
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("CRYST"):
                t = s.split()
                if len(t) >= 7:
                    from mpmc_tpu_torch.ops.pbc import cell_from_abc
                    box = np.asarray(cell_from_abc(
                        *[float(x) for x in t[1:7]]))
                continue
            if not s or s.startswith(("#", "!", "REMARK")):
                continue
            if s.startswith(("END", "ENDMDL")):
                if atoms:
                    frames.append(PqrFrame(atoms, box=box))
                    atoms, box = [], None
                continue
            a = parse_atom_line(line)
            if a is not None:
                atoms.append(a)
    if atoms:
        frames.append(PqrFrame(atoms, box=box))
    return frames


def read(path: str) -> PqrFrame:
    frames = read_frames(path)
    if not frames:
        raise ValueError(f"no atoms found in {path}")
    return frames[0]


_FMT = ("ATOM  {serial:6d} {name:<5s} {mol:<5s} {mid:5d} {flag:>1s} "
        "{x:11.5f} {y:11.5f} {z:11.5f} {mass:9.4f} {q:10.6f} {pol:8.4f} "
        "{eps:10.5f} {sig:8.5f}")
_FMT_EXT = _FMT + " {omega:9.5f} {c6:11.5f} {c8:11.5f} {c10:12.5f}"


def format_atom(a: PqrAtom, extended: bool = False) -> str:
    fmt = _FMT_EXT if extended else _FMT
    return fmt.format(serial=a.serial, name=a.name, mol=a.mol_name,
                      mid=a.mol_id, flag=a.flag, x=a.xyz[0], y=a.xyz[1],
                      z=a.xyz[2], mass=a.mass, q=a.charge, pol=a.polar,
                      eps=a.eps, sig=a.sig, omega=a.omega, c6=a.c6,
                      c8=a.c8, c10=a.c10)


def cryst_record(box) -> str:
    from mpmc_tpu_torch.ops.pbc import abc_from_cell
    a, b, c, al, be, ga = abc_from_cell(box)
    return (f"CRYST1 {a:9.4f} {b:9.4f} {c:9.4f} "
            f"{al:7.2f} {be:7.2f} {ga:7.2f}")


def write(path: str, atoms: List[PqrAtom], mode: str = "w",
          remark: str = "", extended: bool = False, box=None):
    header = ""
    if box is not None:
        header = cryst_record(box) + "\n"
    with open(path, mode) as f:
        if remark:
            f.write(f"REMARK {remark}\n")
        f.write(header)
        for a in atoms:
            f.write(format_atom(a, extended) + "\n")
        f.write("END\n")


def _host(x):
    """numpy view of a host array or a (possibly CUDA) torch tensor."""
    import numpy as onp
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def wrapped_positions(params, state):
    """Positions with every movable molecule's COM translated into the
    unit cell (molecule-wise, so bonds never straddle an image) — the
    reference's ``wrapall`` output behavior (SURVEY.md §2.9 "Cell")."""
    import numpy as onp

    from mpmc_tpu_torch.state import all_molecule_coms
    pos = onp.array(_host(state.pos), onp.float64, copy=True)
    box = _host(state.box).astype(onp.float64)
    coms = _host(all_molecule_coms(state.pos, params))
    frac = coms @ onp.linalg.inv(box)
    shift = onp.floor(frac) @ box                          # [M,3]
    movable = ~_host(params.mol_frozen)
    shift[~movable] = 0.0
    return pos - shift[_host(params.mol_id)]


def write_state(path: str, params, state, species_names=None,
                mode: str = "w", remark: str = "",
                extended: bool = False, wrap: bool = False) -> None:
    """Write the current (alive) system state as one PQR frame: the
    REMARK and CRYST1 records here, then the atoms through the native
    writer (io/native.py) from one host copy of the alive rows — no
    per-atom Python object.  ``wrap``: write molecule-wise wrapped
    coordinates (wrapall).  ``write(path, snapshot_atoms(...))`` is the
    plain version (the same bytes)."""
    import numpy as onp
    import torch

    from mpmc_tpu_torch.io import native
    with open(path, mode) as fh:
        if remark:
            fh.write(f"REMARK {remark}\n")
        fh.write(cryst_record(_host(state.box)) + "\n")
    alive = state.atom_alive(params)
    mid = params.mol_id
    cols = [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2], params.mass,
            params.charge, params.polar, params.eps, params.sig,
            params.omega, params.c6, params.c8, params.c10,
            params.gwp_alpha, mid, params.mol_frozen[mid],
            params.mol_species[mid]]
    if wrap:
        cols.append(torch.arange(len(mid), device=mid.device))
    # the one host copy: the alive rows of every column
    rows = torch.nonzero(alive).reshape(-1)
    tab = torch.stack([c.double() for c in cols], 1).index_select(
        0, rows).cpu().numpy()
    n = tab.shape[0]
    num = onp.ascontiguousarray(tab[:, :13])
    if wrap:
        num[:, :3] = wrapped_positions(params, state)[
            tab[:, 16].astype(onp.int64)]
    ids = onp.stack([onp.arange(1, n + 1, dtype=onp.int64),
                     tab[:, 13].astype(onp.int64)], axis=1)
    frozen = tab[:, 14] > 0.5
    spec = tab[:, 15].astype(onp.int64)
    flags = onp.where(frozen, ord("F"), ord("M")).astype(onp.uint8).tobytes()
    n_spec = int(spec.max()) + 1 if n else 1
    name_table = onp.array(
        [(species_names[s] if species_names and 0 <= s < len(species_names)
          else f"A{s}").encode()[:native.NAME_LEN - 1]
         for s in range(max(n_spec, 1))], dtype=f"S{native.NAME_LEN}")
    sp_names = name_table[onp.maximum(spec, 0)]
    names = onp.where(frozen, b"FRM", sp_names).astype(f"S{native.NAME_LEN}")
    mol_names = onp.where(frozen, b"FRZ", sp_names).astype(
        f"S{native.NAME_LEN}")
    native.write_frame_arrays(path, num, ids, flags, names.tobytes(),
                              mol_names.tobytes(), mode="a",
                              extended=extended)


def snapshot_atoms(params, state, species_names=None,
                   pos=None) -> List[PqrAtom]:
    """Build the PqrAtom list for the current (alive) system state —
    the restart/trajectory writer's source (SURVEY.md §5
    "Checkpoint / resume": restart file rewritten each corrtime).
    ``pos``: host positions overriding ``state.pos`` (wrapped output)."""
    pos = _host(state.pos) if pos is None else pos
    alive = _host(state.atom_alive(params))
    mol_id = _host(params.mol_id)
    mol_frozen = _host(params.mol_frozen)
    mol_species = _host(params.mol_species)
    charge = _host(params.charge)
    mass = _host(params.mass)
    polar = _host(params.polar)
    eps = _host(params.eps)
    sig = _host(params.sig)
    omega = _host(params.omega)
    c6 = _host(params.c6)
    c8 = _host(params.c8)
    c10 = _host(params.c10)
    out = []
    serial = 0
    for i in range(pos.shape[0]):
        if not alive[i]:
            continue
        serial += 1
        m = int(mol_id[i])
        sp = int(mol_species[m])
        if sp < 0 or species_names is None:
            name = "FRM" if mol_frozen[m] else f"A{sp}"
        else:
            name = species_names[sp]
        out.append(PqrAtom(
            serial=serial, name=name,
            mol_name=("FRZ" if mol_frozen[m] else name),
            mol_id=m, flag=("F" if mol_frozen[m] else "M"),
            xyz=pos[i], mass=float(mass[i]), charge=float(charge[i]),
            polar=float(polar[i]), eps=float(eps[i]), sig=float(sig[i]),
            omega=float(omega[i]), c6=float(c6[i]), c8=float(c8[i]),
            c10=float(c10[i])))
    return out
