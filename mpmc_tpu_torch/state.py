"""Core data model: padded-array system state (port of mpmc_tpu/state.py).

Fixed-capacity, masked tensors so every MC step has static shapes:

- Atoms live in one padded array of length ``n_atoms_max``.  Frozen
  (framework) atoms occupy a fixed prefix; each sorbate species gets a pool
  of fixed "slots", each slot sized to that species' template atom count.
- GCMC insert = claim a dead slot of the right species and write template
  coordinates; delete = clear the slot's alive flag.
- Static per-atom parameters live in ``Params``; the mutable part in
  ``SimState``.  Both are dataclasses of tensors on one device.

Index tensors (mol_id, mol_atoms, ...) are int64, the torch indexing
type; the JAX package keeps them int32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mpmc_tpu_torch.config import resolve_device

# ---------------------------------------------------------------------------
# Species template (host-side description of one rigid molecule type)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Species:
    """A rigid molecule template (the analog of the reference's
    ``insert_input`` PQR template)."""
    name: str
    atom_names: tuple
    pos: np.ndarray          # (A,3) template coords, COM at origin
    mass: np.ndarray         # (A,) amu
    charge: np.ndarray       # (A,) e
    polar: np.ndarray        # (A,) A^3
    eps: np.ndarray          # (A,) K
    sig: np.ndarray          # (A,) A
    omega: np.ndarray = None
    c6: np.ndarray = None
    c8: np.ndarray = None
    c10: np.ndarray = None
    gwp_alpha: np.ndarray = None
    vib_omega: float = 0.0

    def __post_init__(self):
        a = len(self.atom_names)
        for f in ("omega", "c6", "c8", "c10", "gwp_alpha"):
            if getattr(self, f) is None:
                object.__setattr__(self, f, np.zeros(a))
        # re-center template on its center of mass
        m = np.asarray(self.mass, dtype=np.float64)
        p = np.asarray(self.pos, dtype=np.float64).reshape(a, 3)
        if m.sum() > 0:
            p = p - (m[:, None] * p).sum(0) / m.sum()
        object.__setattr__(self, "pos", p)

    @property
    def natoms(self):
        return len(self.atom_names)

    @property
    def total_mass(self):
        return float(np.sum(self.mass))


# ---------------------------------------------------------------------------
# Params: immutable tensors describing the padded system
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Params:
    """Constant (per-run) tensors.  N = n_atoms_max, M = n_mols_max,
    A = max atoms per movable molecule."""
    charge: torch.Tensor
    mass: torch.Tensor
    polar: torch.Tensor
    eps: torch.Tensor
    sig: torch.Tensor
    omega: torch.Tensor
    c6: torch.Tensor
    c8: torch.Tensor
    c10: torch.Tensor
    gwp_alpha: torch.Tensor
    mol_id: torch.Tensor       # [N] int64 owning molecule slot
    atom_ok: torch.Tensor      # [N] bool: structural mask (real atom row)
    mol_species: torch.Tensor  # [M] int64: species index, -1 = frozen
    mol_frozen: torch.Tensor   # [M] bool
    mol_atoms: torch.Tensor    # [M, A] int64 atom rows (padded with first)
    mol_natoms: torch.Tensor   # [M] int64
    mol_start: torch.Tensor    # [M] int64 first atom row (contiguous slots)
    mol_dof: torch.Tensor      # [M] kinetic degrees of freedom
    mol_mass: torch.Tensor     # [M] total mass
    species_pos: torch.Tensor  # [S, A, 3] COM-centered templates
    species_natoms: torch.Tensor  # [S] int64
    # [P] int64 rows of the coupled-dipole vdW sites (alpha > 0 and
    # omega > 0), fixed at build: ops/vdw.py's 3P x 3P eigensolve
    vdw_sites: Optional[torch.Tensor] = None
    # the framework cell index (ops/celllist.CellIndex), attached by
    # celllist.attach when cfg.cell_list is on and culling applies
    cell_index: Optional[object] = None
    # int32 copy of mol_id, the type the CUDA pair kernels read (derived)
    mol_id32: torch.Tensor = dataclasses.field(init=False, repr=False)
    # [N] each atom's molecular mass mol_mass[mol_id]: the molecule-pair
    # reduced mass of the Feynman-Hibbs/Kleinert terms (derived)
    mol_mass_atom: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "mol_id32", self.mol_id.to(torch.int32))
        object.__setattr__(self, "mol_mass_atom", self.mol_mass[self.mol_id])

    @property
    def n_atoms_max(self):
        return self.charge.shape[0]

    @property
    def n_mols_max(self):
        return self.mol_species.shape[0]

    @property
    def max_atoms_per_mol(self):
        return self.mol_atoms.shape[1]

    @property
    def device(self):
        return self.charge.device

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# EnergyBreakdown / SimState
# ---------------------------------------------------------------------------

_SLOTS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
          "polar", "vdw")


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Per-term energy slots (0-d tensors): rd, lrc, es real/recip/self/
    excl, polar, vdw."""
    rd: torch.Tensor
    lrc: torch.Tensor
    es_real: torch.Tensor
    es_recip: torch.Tensor
    es_self: torch.Tensor
    es_excl: torch.Tensor
    polar: torch.Tensor
    vdw: torch.Tensor

    @property
    def es(self):
        return self.es_real + self.es_recip + self.es_self + self.es_excl

    @property
    def total(self):
        return (self.rd + self.lrc + self.es_real + self.es_recip
                + self.es_self + self.es_excl + self.polar + self.vdw)

    @classmethod
    def zero(cls, dtype=torch.float32, device=None):
        """All slots 0 on ``device`` (default: the current CUDA device;
        raises without one)."""
        device = resolve_device(device)
        return cls(*(torch.zeros((), dtype=dtype, device=device)
                     for _ in _SLOTS))

    def add(self, other):
        return EnergyBreakdown(*(getattr(self, k) + getattr(other, k)
                                 for k in _SLOTS))

    @classmethod
    def stack(cls, energies):
        """One breakdown of [C] slots from C breakdowns."""
        return cls(*(torch.stack([getattr(e, k) for e in energies])
                     for k in _SLOTS))

    def sub(self, other):
        return EnergyBreakdown(*(getattr(self, k) - getattr(other, k)
                                 for k in _SLOTS))

    def select(self, pred, other):
        """Field-wise ``pred ? self : other`` (pred a 0-d bool tensor)."""
        return EnergyBreakdown(*(torch.where(pred, getattr(self, k),
                                             getattr(other, k))
                                 for k in _SLOTS))

    def as_dict(self):
        return {k: getattr(self, k) for k in _SLOTS}


@dataclasses.dataclass(frozen=True)
class SimState:
    pos: torch.Tensor        # [N,3]
    box: torch.Tensor        # [3,3] row-vector cell
    mol_alive: torch.Tensor  # [M] bool (frozen molecules always True)
    energy: EnergyBreakdown  # active (sorbate-involving) part
    step: int = 0
    # Ewald structure factor cache (None outside coulomb ewald)
    sk_re: Optional[torch.Tensor] = None
    sk_im: Optional[torch.Tensor] = None
    # constant frozen-framework energy, kept out of the delta accumulators
    e_frozen: Optional[EnergyBreakdown] = None
    # polarization: induced dipoles [N,3] (the SCF warm start; zeros from
    # build_system, None after initialize without polarization), the
    # cached static field [N,3], and the last solve's CG residual
    # b - A mu [N,3] (the next move's r_old; None unless
    # thole.residual_supported)
    mu: Optional[torch.Tensor] = None
    e0: Optional[torch.Tensor] = None
    r_pol: Optional[torch.Tensor] = None
    # cavity bias: the open cells of the G^3 grid [G^3] bool, rebuilt at
    # every refresh (None unless cfg.cavity_bias)
    cavity_open: Optional[torch.Tensor] = None
    # TMMC collection matrix [n_mols_max + 1, 4]: per macrostate N (the
    # insert species' alive count before the move) n_ins, sum a_ins,
    # n_del, sum a_del; allocated by the first refresh and never reset by
    # a later one (None unless cfg.tmmc)
    tmmc_c: Optional[torch.Tensor] = None
    # quantum rotation (the spinflip move): each molecule's nuclear-spin
    # species [M] int32 (1 ortho, 0 para) and its rotor's free energies
    # [M, 2] (F_para, F_ortho) in the state's dtype, rebuilt at every
    # refresh (ops/qrot.py; zeros for a slot that is not an alive rotor);
    # None unless cfg.quantum_rotation
    spin: Optional[torch.Tensor] = None
    rot_f: Optional[torch.Tensor] = None
    # molecule-pair energy cache (ops/pairs.pair_matrix; cfg.mol_cache):
    # [M, M] symmetric rd, es_real and tail-coefficient sums between
    # molecule slots, kept exact by the accept-time row and column
    # scatters; None unless metropolis.cache_eligible
    cache_rd: Optional[torch.Tensor] = None
    cache_es: Optional[torch.Tensor] = None
    cache_lrc: Optional[torch.Tensor] = None

    def atom_alive(self, params: Params):
        return self.mol_alive[params.mol_id] & params.atom_ok

    def reported_energy(self) -> EnergyBreakdown:
        """Full physical energy: accumulated active part + frozen part."""
        if self.e_frozen is None:
            return self.energy
        return self.energy.add(self.e_frozen)

    def n_molecules(self, params: Params):
        """Number of alive, non-frozen molecules (0-d tensor)."""
        return torch.sum(self.mol_alive & ~params.mol_frozen
                         & (params.mol_species >= 0))

    def n_molecules_of(self, params: Params, species: int):
        return torch.sum(self.mol_alive & (params.mol_species == species))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def map_state(fn, states):
    """A SimState whose tensor fields (energy slots included) are
    ``fn([field of each state])``; ``step`` and absent fields are taken
    from the first state."""
    kw = {}
    for f in dataclasses.fields(SimState):
        vals = [getattr(s, f.name) for s in states]
        if isinstance(vals[0], EnergyBreakdown):
            kw[f.name] = EnergyBreakdown(*(fn([getattr(v, k) for v in vals])
                                           for k in _SLOTS))
        elif isinstance(vals[0], torch.Tensor):
            kw[f.name] = fn(vals)
        else:
            kw[f.name] = vals[0]
    return SimState(**kw)


def stack_chains(states) -> SimState:
    """One state with a leading [C] on every tensor field, from a list of
    C states at the same step (the multi-chain layout)."""
    return map_state(torch.stack, states)


def slice_chain(states: SimState, k: int) -> SimState:
    """Chain ``k`` of a stacked state (views, no copy)."""
    return map_state(lambda xs: xs[0][k], [states])


def chain_block(states: SimState, lo: int, hi: int) -> SimState:
    """Chains [lo, hi) of a stacked state (views, no copy)."""
    return map_state(lambda xs: xs[0][lo:hi], [states])


# ---------------------------------------------------------------------------
# System builder (host side numpy, then tensors on ``device``)
# ---------------------------------------------------------------------------

def _round_up(x, m):
    return ((x + m - 1) // m) * m


def build_system(box, frozen_pos=None, frozen_params: Optional[dict] = None,
                 species: tuple = (), capacity: tuple = (),
                 initial_counts: tuple = (),
                 initial_pos: Optional[dict] = None,
                 dtype=torch.float32, pad_atoms_to: int = 8, seed: int = 0,
                 device=None):
    """Build (Params, SimState) from a frozen framework + sorbate species —
    the same padded layout as mpmc_tpu.state.build_system (frozen prefix,
    contiguous per-species slot pools, pad rows at the end) — on
    ``device`` (default: the current CUDA device; raises without one)."""
    device = resolve_device(device)
    box = np.asarray(box, dtype=np.float64)
    F = 0 if frozen_pos is None else len(frozen_pos)
    fp = frozen_params or {}

    def fget(name, default=0.0):
        v = fp.get(name)
        return (np.full(F, default, np.float64) if v is None
                else np.asarray(v, np.float64))

    n_sorb_atoms = sum(s.natoms * c for s, c in zip(species, capacity))
    N_real = F + n_sorb_atoms
    n_frozen_mols = 1 if F > 0 else 0
    M = n_frozen_mols + sum(capacity)
    # per-molecule atom-table width: the largest MOVABLE species (the
    # frozen framework molecule is never moved)
    A = max([1] + [s.natoms for s in species])
    # pad so mol_start[m] + A stays in bounds for every molecule
    N = _round_up(max(N_real, 1) + max(0, A - 1), pad_atoms_to)

    def zeros():
        return np.zeros(N, np.float64)

    charge, mass, polar, eps, sig = zeros(), zeros(), zeros(), zeros(), zeros()
    omega, c6, c8, c10, gwp_alpha = (zeros(), zeros(), zeros(), zeros(),
                                     zeros())
    mol_id = np.full(N, max(M - 1, 0), np.int64)
    atom_ok = np.zeros(N, bool)
    pos = np.zeros((N, 3), np.float64)

    if F > 0:
        pos[:F] = np.asarray(frozen_pos, np.float64)
        charge[:F] = fget("charge")
        mass[:F] = fget("mass")
        polar[:F] = fget("polar")
        eps[:F] = fget("eps")
        sig[:F] = fget("sig")
        omega[:F] = fget("omega")
        c6[:F] = fget("c6")
        c8[:F] = fget("c8")
        c10[:F] = fget("c10")
        gwp_alpha[:F] = fget("gwp_alpha")
        mol_id[:F] = 0
        atom_ok[:F] = True

    mol_species = np.full(M, -1, np.int64)
    mol_frozen = np.zeros(M, bool)
    mol_natoms = np.zeros(M, np.int64)
    mol_start = np.zeros(M, np.int64)
    mol_dof = np.zeros(M, np.float64)
    mol_mass = np.zeros(M, np.float64)
    mol_alive = np.zeros(M, bool)
    if F > 0:
        mol_frozen[0] = True
        mol_natoms[0] = F
        mol_mass[0] = float(fget("mass").sum())
        mol_alive[0] = True

    cursor = F
    mslot = n_frozen_mols
    counts = list(initial_counts) + [0] * (len(species) - len(initial_counts))
    grid_n = int(np.ceil(max(sum(counts), 1) ** (1 / 3)))
    grid_pts = np.stack(np.meshgrid(*[(np.arange(grid_n) + 0.5) / grid_n] * 3,
                                    indexing="ij"), -1).reshape(-1, 3)
    gp = 0
    for si, (sp, cap) in enumerate(zip(species, capacity)):
        a = sp.natoms
        for j in range(cap):
            sl = slice(cursor, cursor + a)
            charge[sl] = sp.charge
            mass[sl] = sp.mass
            polar[sl] = sp.polar
            eps[sl] = sp.eps
            sig[sl] = sp.sig
            omega[sl] = sp.omega
            c6[sl] = sp.c6
            c8[sl] = sp.c8
            c10[sl] = sp.c10
            gwp_alpha[sl] = sp.gwp_alpha
            mol_id[sl] = mslot
            atom_ok[sl] = True
            mol_species[mslot] = si
            mol_natoms[mslot] = a
            mol_start[mslot] = cursor
            mol_mass[mslot] = sp.total_mass
            mol_dof[mslot] = _species_dof(sp)
            if j < counts[si]:
                mol_alive[mslot] = True
                if initial_pos is not None and si in initial_pos:
                    pos[sl] = np.asarray(initial_pos[si][j], np.float64)
                else:
                    com = grid_pts[gp % len(grid_pts)] @ box
                    gp += 1
                    pos[sl] = sp.pos + com
            else:
                # park dead slots at the origin; they are masked out anyway
                pos[sl] = sp.pos
            cursor += a
            mslot += 1

    mol_atoms = np.zeros((M, A), np.int64)
    for m in range(M):
        s0, na = int(mol_start[m]), int(mol_natoms[m])
        idx = np.arange(s0, s0 + na)[:A]   # frozen molecule truncates to A
        if len(idx) == 0:
            idx = np.zeros(1, np.int64)
        mol_atoms[m] = np.concatenate(
            [idx, np.full(A - len(idx), idx[0])])[:A]

    S = max(len(species), 1)
    species_pos = np.zeros((S, A, 3), np.float64)
    species_natoms = np.zeros(S, np.int64)
    for si, sp in enumerate(species):
        species_pos[si, :sp.natoms] = sp.pos
        species_natoms[si] = sp.natoms

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def t(x):
        return torch.as_tensor(x, device=device)

    params = Params(
        charge=f(charge), mass=f(mass), polar=f(polar), eps=f(eps),
        sig=f(sig), omega=f(omega), c6=f(c6), c8=f(c8), c10=f(c10),
        gwp_alpha=f(gwp_alpha), mol_id=t(mol_id), atom_ok=t(atom_ok),
        mol_species=t(mol_species), mol_frozen=t(mol_frozen),
        mol_atoms=t(mol_atoms), mol_natoms=t(mol_natoms),
        mol_start=t(mol_start), mol_dof=f(mol_dof), mol_mass=f(mol_mass),
        species_pos=f(species_pos), species_natoms=t(species_natoms),
        vdw_sites=t(np.nonzero((polar > 0) & (omega > 0))[0]))
    state = SimState(pos=f(pos), box=f(box), mol_alive=t(mol_alive),
                     energy=EnergyBreakdown.zero(dtype, device),
                     mu=torch.zeros((N, 3), dtype=dtype, device=device))
    return params, state


def _species_dof(sp) -> float:
    """Kinetic degrees of freedom of a rigid species: 3 (point mass),
    5 (linear rotor), 6 (nonlinear)."""
    m = np.asarray(sp.mass, np.float64)
    p = np.asarray(sp.pos, np.float64)[m > 0]
    if len(p) <= 1:
        return 3.0
    d = p - p[0]
    n = d[np.argmax(np.sum(d * d, 1))]
    nn = np.linalg.norm(n)
    if nn < 1e-9:
        return 3.0
    n = n / nn
    perp = d - np.outer(d @ n, n)
    return 5.0 if np.max(np.abs(perp)) < 1e-8 else 6.0


def take(arr, i):
    """``arr[i]`` for an int or an index tensor, without a host sync:
    indexing with a 0-d tensor reads it on the host, so a 0-d index goes
    through ``index_select`` instead; an index tensor of shape [C] (one
    per chain) gathers [C, ...]."""
    if isinstance(i, torch.Tensor):
        if i.ndim:
            return arr[i]
        return arr.index_select(0, i.reshape(1))[0]
    return arr[i]


def row_valid(params: Params, mol):
    """[A] bool: which of molecule ``mol``'s padded rows are real atoms
    ([C, A] for one molecule per chain, ``mol`` [C])."""
    return (torch.arange(params.max_atoms_per_mol,
                         device=params.mol_natoms.device)
            < take(params.mol_natoms, mol)[..., None])


def mol_rows(arr, params: Params, mol):
    """[A, ...] rows of molecule ``mol`` (int or 0-d device tensor — no
    host sync; [C, A, ...] for ``mol`` [C], from a shared ``arr``).
    Padded entries duplicate the molecule's first atom row; consumers
    mask rows by ``arange(A) < mol_natoms[mol]``."""
    return arr[take(params.mol_atoms, mol)]


def chain_rows(arr, params: Params, mol):
    """[C, A, ...] rows of molecule ``mol[c]`` of each chain's own
    ``arr[c]`` (``arr`` [C, N, ...], ``mol`` [C])."""
    idx = take(params.mol_atoms, mol)
    return arr[torch.arange(arr.shape[0], device=arr.device)[:, None], idx]


def mol_rows_update(arr, params: Params, mol, rows_new):
    """Write an [A, ...] row window back at molecule ``mol``'s slots, IN
    PLACE (``arr`` is modified and returned — on the card this saves an
    [N,3] copy per step).  Rows beyond natoms are forced to duplicate
    ``rows_new[0]``, so every write to a duplicated index carries the
    same value."""
    valid = row_valid(params, mol)
    if rows_new.ndim > 1:
        valid = valid.reshape((-1,) + (1,) * (rows_new.ndim - 1))
    rows_new = torch.where(valid, rows_new, rows_new[0])
    arr.index_copy_(0, take(params.mol_atoms, mol), rows_new)
    return arr


def chain_rows_update(arr, params: Params, mol, rows_new):
    """``mol_rows_update`` over chains: write each chain's [A, ...] row
    window ``rows_new[c]`` at molecule ``mol[c]``'s slots of its own
    ``arr[c]``, IN PLACE (``arr`` [C, N, ...], ``mol`` [C])."""
    idx = take(params.mol_atoms, mol)                     # [C, A]
    valid = row_valid(params, mol)
    valid = valid.reshape(valid.shape + (1,) * (rows_new.ndim - 2))
    rows_new = torch.where(valid, rows_new, rows_new[:, :1])
    ar = torch.arange(arr.shape[0], device=arr.device)[:, None]
    arr.index_put_((ar.expand_as(idx), idx), rows_new)
    return arr


def molecule_com(pos, params: Params, mol):
    """Center of mass of one molecule slot."""
    idx = take(params.mol_atoms, mol)
    m = params.mass[idx][:, None] * row_valid(params, mol)[:, None]
    denom = torch.clamp(torch.sum(m), min=1e-30)
    return torch.sum(m * pos[idx], dim=0) / denom


def all_molecule_coms(pos, params: Params):
    """[M,3] centers of mass for every molecule slot."""
    idx = params.mol_atoms                     # [M,A]
    amask = (torch.arange(idx.shape[1], device=pos.device)[None, :]
             < params.mol_natoms[:, None])     # [M,A]
    m = params.mass[idx] * amask               # [M,A]
    denom = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1e-30)
    return torch.einsum("ma,maj->mj", m, pos[idx]) / denom
