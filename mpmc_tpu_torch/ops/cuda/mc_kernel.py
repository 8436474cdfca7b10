"""The fused Monte Carlo step loops — B1 (µVT, csrc/uvt_kernel.cu), B3
(NVT/NVE, csrc/nvt_kernel.cu) and B6 (the polar delayed acceptance's
stage 1, csrc/pda_kernel.cu): wrappers, plain versions and host helpers.

B1 ``run_steps_uvt`` replaces mpmc_tpu/ops/pallas/mc_kernel.py::_kernel_uvt
(through ``run_steps_uvt``/``run_steps_uvt_multi``): K whole GCMC steps
(displace | insert | delete) per launch for C chains, each step one old+new
pass over all atoms, the S(k) delta, the acceptance test with per-species
constants, and the in-place commit.

B1, B3 and B6 run one thread-block cluster of G CTAs per chain, each CTA
with a slice of the chain's columns and k-vectors in its shared memory
(csrc/mc_cluster.cuh; B6's slice adds the polar planes).
``cluster_size`` picks G from the chain count, the system's size and the
clusters the card holds at once; ``cluster=`` overrides it.  A chain's
result depends on G, not on C.

B3 ``run_steps`` replaces mpmc_tpu/ops/pallas/mc_kernel.py::_kernel (through
``run_steps``/``run_steps_multi``): K translate+rotate steps per launch for
C chains that share the parameters, the box and the aliveness (the NVT
contract), each with its own positions, S(k) and beta; under ensemble nve
the acceptance is Ray's microcanonical rule against a kinetic reservoir
carried across the launch's steps.  One wrapper of each kernel serves every
C >= 1; the single-chain call is C = 1.

B6 ``run_steps_uvt_pda`` replaces
mpmc_tpu/ops/pallas/mc_kernel.py::_kernel_uvt_pda (through
``run_steps_uvt_pda``): up to PDA_SEG µVT proposals of one chain from a
fixed state that it reads and never writes, each with B1's move, pair
terms and S(k) delta plus the zodid surrogate delta d* of the
polarization energy, frozen at the first proposal that passes the
stage-1 test; it returns that survivor's record for the exact SCF stage
2 (metropolis.run_chunk_fused_uvt_polar_da).

Randomness is one [C, K, 16] uniform table in the lane layout of
mc_kernel.draw_uniforms(lanes=16) (chain c's step k reads row [c, k]):
lane 8 the move type, 9 the species of an insert/delete, 0 the slot rank
(B3: the molecule), 1-3 the translation or the inserted COM, 4 the
acceptance coin (B6: of stage 1), 5-7 the rotation or the inserted
orientation, 10 under cavity bias the open cell of an insert (by rank
among the grid's open cells, lanes 1-3 then the point inside it), 12 B6's
stage-2 coin, 11 under quantum_rotation B1's and B6's spinflip carve
(lane 11 < p_spin, before the move type; B3 carves on lane 8 < p_spin).
B3 reads lanes 0-8; B6 takes one chain's [K, 16].

Spinflip (``cfg.quantum_rotation``, not nve): the move picks a rotor (B3:
lane 0's molecule; B1 and B6: lane 0's slot among the alive ones, the
displacement's pick), moves nothing, and is accepted with ln u4 < -beta
d_f, d_f = F[1 - s] - F[s] from ``rot_f`` (the refresh's (F_para,
F_ortho) of each molecule, in the kernels' dtype) at the rotor's spin
``spin``; an accept flips the spin only.  The kernels skip the step's
pass, exchange and barriers (every CTA of the chain reads the same lane,
so all skip alike), keep a replica of the chain's spins per CTA (B1, B3:
a [C, G, M] scratch row each; B6 reads them, its state being fixed) and
return rank 0's.  B3 builds the move into its own instances
(nvt_sf_kernel.cu, an SF flag crossed with QC); B1 and B6 into their XT
instances.

B1 and B6 have the µVT extras of the reference (mpmc_tpu/ops/pallas/
mc_kernel.py:941-976, :2118-2124) behind a compile-time flag, an instance
of its own (csrc/mc_common.cuh XtArgs): cavity-biased insertion (the
chunk's open-cell list from ``pack_cavity``, +-ln(n_open/G^3) in the
acceptance, an insert into an empty grid rejected) and, in B1, the TMMC
collection (every insert or delete attempt adds (1, a) to row N of the
chain's ``tmmc_out`` block, a the unbiased acceptance probability) with
the ``tmmc_bias`` tilt eta(N') - eta(N) in the acceptance; B6 takes the
tilt of an insert and of a delete as two scalars (its state is fixed for
the launch) and keeps the record's lnb unbiased.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for CUDA tensors; anything else raises.  There is no fallback
from a kernel to its plain version.  ``run_steps_uvt.launches``,
``run_steps.launches`` and ``run_steps_uvt_pda.launches`` count the
kernel launches, and nothing else.

The pair terms of all three carry the Feynman-Hibbs (order 2 or 4) or
Feynman-Kleinert correction under rd lj (``cfg.feynman_hibbs`` /
``feynman_kleinert``, FK first when both are set): the wrappers then take
``mol_mass``, each atom's molecular mass (Params.mol_mass_atom), which
the kernels hold as a seventh column plane of the slice, the moved
molecule's mass being the sum of its slot's site masses, at the chain's
beta.

The host helpers (``supported_uvt``, ``supported``, ``supported_multi``,
``movable_slots``, ``movable_mols``) are the gates and tables of the
reference's fused paths, restricted to the surface the port has: rd
lj/none (FH and FK with lj), lb/waldman_hagler mixing, coulomb
ewald/wolf/cutoff/none, f32, rigid molecules of up to MAX_SITES sites
(B1: up to MAX_SPECIES insert species; TMMC with exactly one; spinflip
where every movable molecule, or insert species, is a rotor of two or
more sites).  The RD forms beyond lj/none and coulomb gwp are the
reference's fused surface but not yet these kernels' (ROADMAP A12a-2b):
the gates stay closed to them, and ``refuse_fused_forms`` raises where the
reference's gate would have taken a fused path with them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from mpmc_tpu_torch.constants import HBAR2_KB_AMU_A2, KE
from mpmc_tpu_torch.ops import lj as lj_ops
from mpmc_tpu_torch.ops import pairs, potentials, thole
from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
from mpmc_tpu_torch.mc.moves import cell_frac
from mpmc_tpu_torch.ops.cuda.pair_kernel import (_MIX, _check, _ptr,
                                                 _raise_on, _stream, _suffix)

MAX_SITES = 8      # most sites of a movable molecule (kernel row registers)
MAX_SPECIES = 8    # most insert species (kernel shared-memory tables)
PDA_SEG = 16       # B6 steps per launch (the reference's segment)
CLUSTER_SIZES = (2, 4, 8, 16)   # CTAs per chain of B1, B3, B6 (16: non-portable)
SMEM_BYTES = 232448   # shared memory one block can use (227 KB)
SMEM_STATIC = 8192    # held back for B1/B3's static tables (< 6 KB)
SMEM_STATIC_PDA = 28672   # for B6's (< 25 KB: the exchange rows of 8 sites)
N_SUMS = 14        # d_rd d_es_real d_es_recip d_es_self d_es_excl d_lrc,
#                    acc disp/ins/del, att disp/ins/del, acc/att spinflip
N_SUMS_NVT = 6     # d_rd d_es_real d_es_recip, accepted moves,
#                    acc/att spinflip
# the RD and Coulomb forms of B1, B3 and B6 (their option ints); the
# reference's fused gate (mpmc_tpu/ops/pallas/mc_kernel.py:2898-2921) also
# admits the RD forms of ops/potentials.py and coulomb gwp, which these
# kernels do not carry yet (ROADMAP A12a-2b)
_RD = {"none": 0, "lj": 1}
_ES = {"none": 0, "ewald": 1, "wolf": 2, "cutoff": 3}


def refuse_fused_forms(cfg, params, gates, what="fused_mc"):
    """Raise NotImplementedError (ROADMAP A12a-2b) where ``cfg`` carries
    an RD form or coulomb gwp that B1, B3 and B6 lack and one of
    ``gates`` (this module's gate functions, in the caller's order) would
    hold with it: the reference's fused gate admits these forms, so its
    run would take a fused kernel where the port's would silently take
    the scan path.  The gates read the RD form only as lj or not lj and
    the Coulomb form only as ewald or not, so each gate is evaluated on a
    copy of ``cfg`` with the form replaced by one they treat alike: rd
    none, coulomb none."""
    rd_new = cfg.rd_potential in potentials.FORMS
    es_new = cfg.coulomb == "gwp"
    if not (rd_new or es_new):
        return
    stand_in = dataclasses.replace(
        cfg, rd_potential="none" if rd_new else cfg.rd_potential,
        coulomb="none" if es_new else cfg.coulomb)
    for gate in gates:
        if gate(stand_in, params):
            forms = [f"rd_potential {cfg.rd_potential}"] * rd_new + \
                [f"coulomb {cfg.coulomb}"] * es_new
            raise NotImplementedError(
                f"{what}: {' and '.join(forms)} in the fused kernels "
                f"({gate.__name__}) is not yet ported — ROADMAP A12a-2b")


def _supported_physics(cfg) -> bool:
    """The physics surface of the fused kernels in the port: the
    reference's gate (mc_kernel._supported_physics) restricted to the RD
    and Coulomb forms the port carries.  Feynman-Hibbs and
    Feynman-Kleinert are allowed, both on the LJ derivatives only."""
    return (cfg.rd_potential in _RD and cfg.coulomb in _ES
            and cfg.mixing_rule in _MIX
            and not ((cfg.feynman_hibbs or cfg.feynman_kleinert)
                     and cfg.rd_potential != "lj")
            and not cfg.polarization and not cfg.cdvdw
            and cfg.cdvdw_repulsion == "none" and not cfg.rd_crystal
            and cfg.dtype == "float32")


def quantum_option(cfg) -> int:
    """The kernels' quantum correction (csrc/mc_common.cuh Opts.qc): 0
    none (and without rd lj, pairs.quantum), 1 Feynman-Hibbs order 2, 2
    order 4, 3 Feynman-Kleinert, which takes precedence when both are set
    (as in the reference)."""
    if not pairs.quantum(cfg):
        return 0
    if cfg.feynman_kleinert:
        return 3
    return 2 if cfg.feynman_hibbs_order >= 4 else 1


def supported_uvt(cfg, params) -> bool:
    """Static gate for the fused µVT path (the reference's supported_uvt,
    mpmc_tpu/ops/pallas/mc_kernel.py:2979-3030): GCMC over 1..MAX_SPECIES
    insert species (TMMC: exactly one), every movable slot of one of them,
    uniform rigid slots of <= MAX_SITES sites per species, and no charged
    template under Ewald (its jellium delta is quadratic in the cell
    charge, which per-species constants cannot carry); cavity bias, TMMC
    and spinflip ride along (spinflip where every insert species is a
    rotor, natoms >= 2).  Host-side, once per run."""
    if not (cfg.ensemble == "uvt"
            and 1 <= len(cfg.insert_species) <= MAX_SPECIES
            and _supported_physics(cfg)):
        return False
    if cfg.tmmc and len(cfg.insert_species) != 1:
        return False
    frozen = params.mol_frozen.cpu().numpy()
    spec = params.mol_species.cpu().numpy()
    natoms = params.mol_natoms.cpu().numpy()
    mov = ~frozen & (spec >= 0)
    if not mov.any() or not np.isin(spec[mov],
                                    list(cfg.insert_species)).all():
        return False
    charge = params.charge.cpu().numpy().astype(np.float64)
    mol_id = params.mol_id.cpu().numpy()
    atom_ok = params.atom_ok.cpu().numpy()
    for si in cfg.insert_species:
        a = natoms[mov & (spec == si)]
        if a.size == 0:        # a species with no slot cannot insert
            return False
        if not (a == a[0]).all() or int(a[0]) > MAX_SITES:
            return False
        if cfg.quantum_rotation and int(a[0]) < 2:
            return False        # a monatomic species is not a rotor
        if cfg.coulomb == "ewald":
            m0 = int(np.flatnonzero(mov & (spec == si))[0])
            qnet = float(np.where((mol_id == m0) & atom_ok, charge,
                                  0.0).sum())
            if abs(qnet) > 1e-6:
                return False
    return True


def pda_effective_cfg(cfg, params):
    """The cfg the fused polar delayed-acceptance path runs (the
    reference's pda_effective_cfg): µVT as it is; NVT as µVT with every
    movable species a nominal insert species (B6's all-displace limit,
    run with insert_probability 0); None for any other ensemble."""
    if cfg.ensemble == "uvt":
        return cfg
    if cfg.ensemble == "nvt":
        spec = params.mol_species.cpu().numpy()
        mov = ~params.mol_frozen.cpu().numpy() & (spec >= 0)
        if not mov.any():
            return None
        ins = tuple(sorted({int(s) for s in spec[mov]}))
        return dataclasses.replace(cfg, ensemble="uvt", insert_species=ins)
    return None


def supported_uvt_polar_da(cfg, params) -> bool:
    """The reference's gate of the fused polar delayed-acceptance path
    (mpmc_tpu/ops/pallas/mc_kernel.py:2841-2897): polarization +
    polar_delayed with the CG solver, a supported damping, a delta-able
    static field (thole.field_delta_supported) and no cdvdw, over the
    fused µVT surface (pda_effective_cfg, without polarization; cavity
    bias, TMMC and its bias compose, the collection on the host).  Where
    it holds, ``fused_mc`` runs
    metropolis.run_chunk_fused_uvt_polar_da: B6 proposes and filters, the
    exact SCF decides each survivor."""
    if not (cfg.polarization and cfg.polar_delayed
            and cfg.polar_solver == "cg"
            and cfg.polar_damp_type in ("exponential", "linear", "none")
            and thole.field_delta_supported(cfg) and not cfg.cdvdw):
        return False
    cfg_eff = pda_effective_cfg(cfg, params)
    if cfg_eff is None:
        return False
    return supported_uvt(dataclasses.replace(cfg_eff, polarization=False),
                         params)


def supported_uvt_multi(cfg, params) -> bool:
    """Gate of the C-chain launch: the same surface as one chain (C is
    bounded only by device memory)."""
    return supported_uvt(cfg, params)


def supported(cfg, params) -> bool:
    """Static gate for the fused NVT/NVE path (the reference's
    ``supported``, mpmc_tpu/ops/pallas/mc_kernel.py:2922-2946): ensemble
    nvt or nve, the port's physics surface, and every movable molecule
    rigid with <= MAX_SITES sites; spinflip under nvt where every movable
    molecule is a rotor (natoms >= 2, so the displacement's pick and the
    rotor pick agree), never under nve.  Host-side, once per run."""
    if not (cfg.ensemble in ("nvt", "nve") and _supported_physics(cfg)
            and not cfg.tmmc):
        return False
    if cfg.ensemble == "nve" and cfg.quantum_rotation:
        return False
    natoms = params.mol_natoms.cpu().numpy()
    mov = (~params.mol_frozen.cpu().numpy()
           & (params.mol_species.cpu().numpy() >= 0))
    if not mov.any() or not bool((natoms[mov] <= MAX_SITES).all()):
        return False
    return not (cfg.quantum_rotation and int(natoms[mov].min()) < 2)


def supported_npt(cfg, params) -> bool:
    """Static gate for the hybrid fused NPT path (the reference's
    supported_npt, mpmc_tpu/ops/pallas/mc_kernel.py:2957-2973;
    metropolis.run_chunk_fused_npt): B3's physics surface for the
    displacement segments, no spinflip or TMMC, no frozen molecule (a
    volume move rescales every molecule's centre of mass), and rigid
    molecules of at most MAX_SITES sites.  Host-side, once per run."""
    if not (cfg.ensemble == "npt" and _supported_physics(cfg)
            and not cfg.quantum_rotation and not cfg.tmmc):
        return False
    if bool(params.mol_frozen.any()):
        return False
    natoms = params.mol_natoms.cpu().numpy()
    mov = params.mol_species.cpu().numpy() >= 0
    return bool(mov.any()) and bool((natoms[mov] <= MAX_SITES).all())


def supported_multi(cfg, params) -> bool:
    """Gate of the C-chain NVT launch: the single-chain surface without
    NVE (the reference keeps one kinetic reservoir per launch, and its
    batched chains take the scan path)."""
    return supported(cfg, params) and cfg.ensemble == "nvt"


def movable_slots(params, insert_species=None):
    """([Ms] slot indices, [Ms] first atom rows, [Ms] species index into
    ``insert_species`` order, A_list) of every movable molecule slot,
    alive or dead, as host numpy arrays.  ``A_list`` is the per-species
    site-count tuple; ``insert_species=None`` takes every movable species
    in ascending id order."""
    frozen = params.mol_frozen.cpu().numpy()
    spec = params.mol_species.cpu().numpy()
    mov = np.where(~frozen & (spec >= 0))[0]
    start = params.mol_start.cpu().numpy()[mov].astype(np.int32)
    natoms = params.mol_natoms.cpu().numpy()
    if insert_species is None:
        insert_species = tuple(sorted(set(spec[mov].tolist())))
    order = {int(si): i for i, si in enumerate(insert_species)}
    species_idx = np.asarray([order[int(s)] for s in spec[mov]], np.int32)
    A_list = tuple(int(natoms[mov][species_idx == i][0])
                   for i in range(len(insert_species)))
    return mov.astype(np.int32), start, species_idx, A_list


def movable_mols(params, mol_alive):
    """([Mv] first atom row, [Mv] atom count, a_max, [Mv] molecule slot
    index) of each alive movable molecule, as host numpy arrays (int32)."""
    alive = mol_alive.cpu().numpy()
    mv = (alive & ~params.mol_frozen.cpu().numpy()
          & (params.mol_species.cpu().numpy() >= 0))
    natoms = params.mol_natoms.cpu().numpy()
    a_max = int(natoms[mv].max()) if mv.any() else 1
    return (params.mol_start.cpu().numpy()[mv].astype(np.int32),
            natoms[mv].astype(np.int32), a_max,
            np.flatnonzero(mv).astype(np.int32))


def _refuse_cfg(cfg, what="run_steps_uvt"):
    """Raise on what neither kernel nor its plain version implements."""
    if not (cfg.rd_potential in _RD and cfg.coulomb in _ES
            and cfg.mixing_rule in _MIX):
        raise NotImplementedError(
            f"{what}: rd {cfg.rd_potential!r} / coulomb "
            f"{cfg.coulomb!r} / mixing {cfg.mixing_rule!r} is not yet "
            "ported — ROADMAP A12a-2b")
    if ((cfg.feynman_hibbs or cfg.feynman_kleinert)
            and cfg.rd_potential != "lj"):
        raise ValueError(f"{what}: feynman_hibbs / feynman_kleinert "
                         "correct the LJ pair energy; rd_potential is "
                         f"{cfg.rd_potential!r}")


def _spin_inputs(cfg, rot_f, spin, lead, m, dt, dev, what):
    """Whether a launch carries the spinflip move: ``rot_f`` [*lead, m, 2]
    of the kernel's dtype and ``spin`` [*lead, m] int32 given (checked)
    under quantum_rotation; refused under nve and without the tables."""
    if not cfg.quantum_rotation:
        return False
    if cfg.ensemble == "nve":
        raise ValueError(f"{what}: no spinflip under ensemble nve")
    if rot_f is None or spin is None:
        raise ValueError(f"{what}: quantum_rotation needs rot_f and spin")
    _check("rot_f", rot_f, dt, tuple(lead) + (m, 2), dev)
    _check("spin", spin, torch.int32, tuple(lead) + (m,), dev)
    return True


def _spin_flip(spin, sel, accept, spin_step):
    """The spins of ``sel``'s entries flipped where a spinflip step was
    accepted (plain versions)."""
    cur = spin[sel]
    spin[sel] = torch.where(accept & spin_step, 1 - cur, cur)


def _quantum_cols(mol_mass, cfg, n, dt, dev, what):
    """(the kernels' qc, the molecule-mass plane's pointer): ``mol_mass``
    [n] checked when a quantum correction is on, a null pointer
    otherwise."""
    qc = quantum_option(cfg)
    if not qc:
        return 0, ctypes.c_void_p(None)
    if mol_mass is None:
        raise ValueError(f"{what}: feynman_hibbs / feynman_kleinert need "
                         "mol_mass, each atom's molecular mass")
    _check("mol_mass", mol_mass, dt, (n,), dev)
    return qc, _ptr(mol_mass)


def slice_bytes(n, dtype, G, nk=0, ms=0, polar=False, quantum=False):
    """Dynamic shared memory of one CTA of a B1/B3 cluster of G CTAs over
    n columns, nk k-vectors and ms slots (csrc/mc_cluster.cuh
    slice_bytes): six column planes (``quantum``: seven, with the
    molecular masses of a Feynman-Hibbs/Kleinert deck) and eight k-vector
    planes of ``dtype``, the slot species (int32) and the column and slot
    alive flags, each segment rounded up to 16 bytes.  ``polar``: B6's
    slice (polar_slice_bytes), four more column planes (polar, e0
    x/y/z)."""
    sz = torch.finfo(dtype).bits // 8
    nloc, kloc = -(-n // G), -(-nk // G)

    def seg(b):
        return (b + 15) // 16 * 16

    return (seg((7 if quantum else 6) * nloc * sz) + seg(8 * kloc * sz)
            + seg(4 * ms) + seg(nloc) + seg(ms)
            + (seg(4 * nloc * sz) if polar else 0))


def _fits(n, dtype, G, nk, ms, polar=False, quantum=False):
    return slice_bytes(n, dtype, G, nk, ms, polar, quantum) <= SMEM_BYTES - (
        SMEM_STATIC_PDA if polar else SMEM_STATIC)


def fitting_cluster_sizes(n, dtype, nk=0, ms=0, polar=False, quantum=False):
    """The G of CLUSTER_SIZES, ascending, whose slice fits in shared
    memory (``polar``: B6's; ``quantum``: with the molecule-mass plane)."""
    return [G for G in CLUSTER_SIZES
            if _fits(n, dtype, G, nk, ms, polar, quantum)]


def cluster_size(C, n, dtype, resident, nk=0, ms=0, polar=False,
                 quantum=False):
    """CTAs per chain (G) of a B1/B3 launch of C chains over n columns (nk
    k-vectors, ms slots; ``polar``: of B6, C = 1): the largest G in
    CLUSTER_SIZES whose slice fits in shared memory and of which the card
    holds C clusters at once; when none holds C, the smallest G that fits
    (the clusters then run in waves).  ``resident``: {G: clusters of G
    CTAs the card holds at once}, which the wrappers take from
    cudaOccupancyMaxActiveClusters (a cluster lies within one GPC, so an
    H100 holds fewer than 132 // G).  Raises when no G fits."""
    fits = fitting_cluster_sizes(n, dtype, nk, ms, polar, quantum)
    if not fits:
        raise ValueError(f"{n} columns of {dtype} do not fit in "
                         f"{max(CLUSTER_SIZES)} CTAs' shared memory")
    within = [G for G in fits if C <= resident[G]]
    return max(within) if within else min(fits)


def _check_cluster(cluster, n, dtype, nk, ms, what, polar=False,
                   quantum=False):
    """``cluster`` checked against CLUSTER_SIZES and shared memory."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"{what}: cluster={cluster!r}, the kernel takes "
                         f"one of {CLUSTER_SIZES}")
    if not _fits(n, dtype, cluster, nk, ms, polar, quantum):
        static = SMEM_STATIC_PDA if polar else SMEM_STATIC
        raise ValueError(
            f"{what}: cluster={cluster} needs "
            f"{slice_bytes(n, dtype, cluster, nk, ms, polar, quantum)} "
            f"bytes of shared memory per CTA, more than "
            f"{SMEM_BYTES - static}")
    return int(cluster)


def pda_partial_len(na, field):
    """Length of the partial vector each B6 CTA pushes to every other per
    step (csrc/pda_kernel.cu partial_len): d_rd, d_es, z_others, d_rec,
    the trial rows' field en [3 na], under polar_ewald (``field`` 2) the
    old rows' eo [3 na], and min r^2."""
    return 4 + 3 * na * (2 if field == 2 else 1) + 1


def _scalar(x, dt, dev):
    """A [1] tensor of a launch's scalar header: a view of a tensor, or a
    device fill of a number — no host-to-device copy, which would wait for
    the stream."""
    if torch.is_tensor(x):
        return x.to(dev, dt).reshape(1)
    return torch.full((1,), float(x), dtype=dt, device=dev)


# clusters resident at once, per (entry, dtype, shape, G), from
# cudaOccupancyMaxActiveClusters before a shape's first launch
occupancy: dict = {}


def _resident(lib, entry, dt, shape, G, what):
    """Clusters of G CTAs of this shape the card holds at once."""
    key = (entry, _suffix(dt)) + tuple(shape) + (G,)
    if key not in occupancy:
        out = ctypes.c_int(0)
        err = getattr(lib, f"{entry}_{_suffix(dt)}")(*shape, G,
                                                     ctypes.byref(out))
        _raise_on(err, what)
        occupancy[key] = out.value
    return occupancy[key]


def _launch_cluster(lib, entry, cluster, C, n, dt, nk, ms, shape, what,
                    polar=False, quantum=False):
    """The G of a card launch (``cluster``, or ``cluster_size`` over the
    card's resident counts), after checking that at least one cluster of
    that shape can be resident; raises if none can."""
    if cluster is None:
        G = cluster_size(C, n, dt, {
            g: _resident(lib, entry, dt, shape, g, what)
            for g in fitting_cluster_sizes(n, dt, nk, ms, polar, quantum)},
            nk, ms, polar, quantum)
    else:
        G = _check_cluster(cluster, n, dt, nk, ms, what, polar, quantum)
    if _resident(lib, entry, dt, shape, G, what) == 0:
        raise RuntimeError(f"{what}: no cluster of {G} CTAs of this shape "
                           "can be resident on the card")
    return G


def pack_cavity(cavity_open):
    """(open-cell list, n_open) of the kernels' cavity bias from a grid
    ``cavity_open`` [..., G^3] bool: each grid's open cell ids in rank
    order, padded with 0, int32 [..., G^3], and their count int32 [...]
    (the reference's _pack_cav without its (R, 128) planes).  On the
    device, no host sync."""
    m = cavity_open.to(torch.int64)
    g3 = m.shape[-1]
    rank = torch.cumsum(m, -1) - 1
    tgt = torch.where(cavity_open, rank, torch.full_like(rank, g3))
    lst = torch.zeros(m.shape[:-1] + (g3 + 1,), dtype=torch.int32,
                      device=m.device)
    ids = torch.arange(g3, dtype=torch.int32, device=m.device).expand_as(m)
    lst.scatter_(-1, tgt, ids.contiguous())
    return lst[..., :g3].contiguous(), m.sum(-1).to(torch.int32)


def _xt_check(cfg, what, C, cav_list, cav_n, eta, tmmc_out, ms, dev,
              tmmc=True):
    """The cavity and TMMC inputs of a B1 (C chains) or B6 (C = None, one
    chain) launch checked against ``cfg``; returns (g, g3, eta length,
    TMMC rows, cav, tm, bias) for the kernel."""
    lead = () if C is None else (C,)
    g = g3 = ke = rows = 0
    if cfg.cavity_bias:
        g = int(cfg.cavity_grid)
        g3 = g ** 3
        if cav_list is None or cav_n is None:
            raise ValueError(f"{what}: cavity_bias needs cav_list and cav_n "
                             "(pack_cavity)")
        _check("cav_list", cav_list, torch.int32, lead + (g3,), dev)
        _check("cav_n", cav_n, torch.int32, lead if lead else (1,), dev)
    tm = bool(cfg.tmmc) and tmmc
    if tm:
        if tmmc_out is None:
            raise ValueError(f"{what}: tmmc needs tmmc_out")
        rows = tmmc_out.shape[1]
        if rows < ms + 1:
            raise ValueError(f"{what}: tmmc_out has {rows} rows for {ms} "
                             "slots")
        _check("tmmc_out", tmmc_out, torch.float64, (C, rows, 4), dev)
    bias = tm and bool(cfg.tmmc_bias) and eta is not None
    if bias:
        ke = eta.shape[0]
        if ke < 1:
            raise ValueError(f"{what}: empty eta")
    return g, g3, ke, rows, int(bool(cfg.cavity_bias)), int(tm), int(bias)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _trial_rows(old, mass, ins, u, tmpl, box, move_factor, rot_factor,
                frac=None):
    """[C,A,3] trial rows from each chain's uniform row u [C,16]:
    displace = translation (lanes 1-3) + axis-angle rotation (lanes 5-7)
    about the mass-weighted COM; insert = the template ``tmpl`` [C,A,3]
    at fractional COM lanes 1-3 (``frac`` [C,3] when given: the
    cavity-biased COM) with a Shoemake orientation from lanes 5-7.
    ``mass`` [C,A] is 0 on sites beyond the molecule's count."""
    disp = (2.0 * u[:, 1:4] - 1.0) * move_factor                  # [C,3]
    fr = u[:, 1:4] if frac is None else frac
    com_new = (fr[:, 0:1] * box[0] + fr[:, 1:2] * box[1]
               + fr[:, 2:3] * box[2])                               # [C,3]
    isel = ins[:, None, None]
    if old.shape[1] == 1:
        return torch.where(isel, com_new[:, None, :],
                           old + disp[:, None, :])
    msum = torch.sum(mass, dim=1)
    com = (torch.sum(mass[..., None] * old, dim=1)
           / torch.clamp(msum, min=1e-30)[:, None])
    two_pi = 2.0 * math.pi
    u5, u6, u7 = u[:, 5], u[:, 6], u[:, 7]
    az = 2.0 * u5 - 1.0
    aphi = two_pi * u6
    s = torch.sqrt(torch.clamp(1.0 - az * az, min=0.0))
    ax, ay = s * torch.cos(aphi), s * torch.sin(aphi)
    ang = u7 * rot_factor
    ca, sa = torch.cos(ang), torch.sin(ang)
    omc = 1.0 - ca
    rd = torch.stack([
        torch.stack([ca + ax * ax * omc, ax * ay * omc - az * sa,
                     ax * az * omc + ay * sa], -1),
        torch.stack([ay * ax * omc + az * sa, ca + ay * ay * omc,
                     ay * az * omc - ax * sa], -1),
        torch.stack([az * ax * omc - ay * sa, az * ay * omc + ax * sa,
                     ca + az * az * omc], -1)], -2)                # [C,3,3]
    sq1 = torch.sqrt(torch.clamp(1.0 - u5, min=0.0))
    sq2 = torch.sqrt(torch.clamp(u5, min=0.0))
    th1, th2 = two_pi * u6, two_pi * u7
    qx, qy = sq1 * torch.sin(th1), sq1 * torch.cos(th1)
    qz, qw = sq2 * torch.sin(th2), sq2 * torch.cos(th2)
    ri = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1)], -2)
    rm = torch.where(isel, ri, rd)
    tr = torch.where(ins[:, None], com_new, com + disp)
    rel = torch.where(isel, tmpl, old - com[:, None, :])
    return tr[:, None, :] + (rm[:, None, :, 0] * rel[..., 0:1]
                             + rm[:, None, :, 1] * rel[..., 1:2]
                             + rm[:, None, :, 2] * rel[..., 2:3])


def _column_pass(rows, use, pos, ok, site_ok, qi, ei, si, charge, eps, sig,
                 box, box_inv, rc, alpha, cfg, qc=None):
    """(rd [C] f64, es [C] f64 without the Coulomb constant, min r2 [C],
    pairs within rc [C], the sums of the squares of the rd and es terms
    [C, 2] f64) of each chain's rows [C,A,3] against its columns: pairs
    within rc for the energies, every pair for the closest approach;
    chains with ``use`` false give zeros, inf and 0.  ``qc``: (the
    molecule's mass [C], the molecule-mass plane [N], beta [C]) under a
    quantum correction."""
    dr = pbc_ops.min_image(rows[:, :, None, :] - pos[:, None, :, :], box,
                           box_inv)
    r2 = torch.sum(dr * dr, dim=-1)                                # [C,A,N]
    m = ok[:, None, :] & site_ok[:, :, None] & use[:, None, None]
    return _pair_sums(r2, m, qi, ei, si, charge, eps, sig, rc, alpha, cfg,
                      qc)


def quantum_pairs(r2s, eps, sig, mm_i, mm_j, beta, cfg):
    """The Feynman-Hibbs or Feynman-Kleinert correction of each pair at the
    guarded squared distance r2s, with the mixed (eps, sig), in the
    kernels' arithmetic (csrc/mc_common.cuh quantum_pair; the reference
    kernel's _pair_terms): the LJ derivatives from (sig^2/r2s)^3 and 1/r,
    the molecule-pair reduced mass mm_i mm_j / max(mm_i + mm_j, 1e-30),
    FH at ``beta``, FK at 1/beta."""
    red = mm_i * mm_j / torch.clamp(mm_i + mm_j, min=1e-30)
    r = torch.sqrt(r2s)
    inv_r = 1.0 / r
    s2 = sig * sig / r2s
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e4 = 4.0 * eps
    v1 = e4 * (6.0 * s6 - 12.0 * s12) * inv_r
    v2 = e4 * (156.0 * s12 - 42.0 * s6) * (inv_r * inv_r)
    inv3 = inv_r * inv_r * inv_r
    v3 = e4 * (336.0 * s6 - 2184.0 * s12) * inv3
    v4 = e4 * (32760.0 * s12 - 3024.0 * s6) * (inv3 * inv_r)
    if cfg.feynman_kleinert:
        return lj_ops.feynman_kleinert_from_derivs(r, v1, v2, v3, v4, red,
                                                   1.0 / beta)
    c2 = (HBAR2_KB_AMU_A2 / 24.0) * beta / torch.clamp(red, min=1e-30)
    u = c2 * (v2 + 2.0 * v1 * inv_r)
    if cfg.feynman_hibbs_order >= 4:
        c4 = ((HBAR2_KB_AMU_A2 * HBAR2_KB_AMU_A2 / 1152.0) * beta * beta
              / torch.clamp(red * red, min=1e-30))
        u = u + c4 * (15.0 * v1 * inv3 + 4.0 * v3 * inv_r + v4)
    return u


def _pair_sums(r2, m, qi, ei, si, charge, eps, sig, rc, alpha, cfg,
               qc=None):
    """The sums of ``_column_pass`` from the squared distances r2 [C,A,N]
    and the pair mask m [C,A,N]; ``qc`` as there."""
    act = m & (r2 < rc * rc)
    rd_u, es_u, _, _ = pairs._tile_values(
        r2, qi[..., None], ei[..., None], si[..., None], charge, eps, sig,
        cfg, rc, alpha)
    if qc is not None and rd_u is not None:
        mm_i, mm_j, beta = qc
        e_m, s_m = lj_ops.mix(ei[..., None], eps, si[..., None], sig,
                              cfg.mixing_rule)
        rd_u = rd_u + quantum_pairs(
            torch.where(r2 > 1e-12, r2, torch.ones_like(r2)), e_m, s_m,
            mm_i[:, None, None], mm_j, beta[:, None, None], cfg)
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)

    def s(v, p=1):
        if v is None:
            return torch.zeros(r2.shape[0], dtype=torch.float64,
                               device=r2.device)
        return (torch.where(act, v, zero).double() ** p).sum(dim=(1, 2))

    mn = torch.where(m, r2, torch.full_like(r2, math.inf)).amin(dim=(1, 2))
    return (s(rd_u), s(es_u), mn, act.sum(dim=(1, 2)),
            torch.stack([s(rd_u, 2), s(es_u, 2)], -1))


def run_steps_uvt_plain(pos, alive, eps, sig, charge, mass, slot_start,
                        slot_species, slot_alive, tmpl, natoms, box, rc,
                        alpha, betas, move_factor, rot_factor, thr2, p_ins,
                        lnfvs, d_self, d_excl, c1, cx, uniforms, cfg,
                        kvecs=None, kcoef=None, sk_re=None, sk_im=None,
                        cluster=None, mol_mass=None, cav_list=None,
                        cav_n=None, eta=None, tmmc_out=None, rot_f=None,
                        spin=None, p_spin=0.0, trace=None):
    """Plain B1: a loop over the K steps of batched tensor ops over the C
    chains and the N columns, with the kernel's arithmetic (the same
    per-species constants, the pair sums and the acceptance in float64).
    Arguments and results as ``run_steps_uvt``; ``cluster`` is ignored
    (the plain sums do not depend on it); the inputs but ``tmmc_out`` are
    not modified; a spinflip step's pass runs masked (the kernel skips
    it).  ``trace``: a list that gets one dict per step —
    ``accept`` [C], ``margin`` [C] = ln u - ln(acceptance), and the work
    the kernel does for it, ``pairs``, ``pairs_in``, ``cols`` and
    ``phases`` [C] (pair evaluations, those within rc, columns passed and
    k-vector phases), and ``rss`` [C, 2], the root sum of squares of the
    rd and es terms summed into the step's deltas, in K (the scale of
    their rounding)."""
    _refuse_cfg(cfg)
    quantum = _quantum_cols(mol_mass, cfg, pos.shape[1], pos.dtype,
                            pos.device, "run_steps_uvt")[0]
    dt, dev = pos.dtype, pos.device
    C, N = alive.shape
    K = uniforms.shape[1]
    S, A = tmpl.shape[0], tmpl.shape[1]
    ew = cfg.coulomb == "ewald"
    pos, alive, slot_alive = pos.clone(), alive.clone(), slot_alive.clone()
    if ew:
        sk_re, sk_im = sk_re.clone(), sk_im.clone()

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    rc, alpha, mf, rotf = t(rc), t(alpha), t(move_factor), t(rot_factor)
    thr2, p_ins = t(thr2), t(p_ins)
    p_half = 0.5 * p_ins
    box_inv = torch.linalg.inv(box)
    ar = torch.arange(C, device=dev)
    site = torch.arange(A, device=dev)
    col = torch.arange(N, device=dev)
    sl_sp = slot_species.long()
    sl_start = slot_start.long()
    na_s = natoms.long()
    sp_ids = torch.arange(S, device=dev)
    n_valid = (sl_sp[:, None] == sp_ids).sum(0)                    # [S]
    n_alive = (slot_alive[:, :, None]
               & (sl_sp[None, :, None] == sp_ids)).sum(1)          # [C,S]
    beta = betas.double()
    lnfv = lnfvs.double()
    dself, dexcl = d_self.double(), d_excl.double()
    c1d, cxd = c1.double(), cx.double()
    sums = torch.zeros((C, N_SUMS), dtype=torch.float64, device=dev)
    rss_units = torch.tensor([1.0, KE], dtype=torch.float64, device=dev)
    g, g3, _, _, cav, tm, bias = _xt_check(cfg, "run_steps_uvt_plain", C,
                                           cav_list, cav_n, eta, tmmc_out,
                                           slot_start.shape[0], dev)
    sf = _spin_inputs(cfg, rot_f, spin, (C,), slot_start.shape[0], dt, dev,
                      "run_steps_uvt_plain")
    no_spin = torch.zeros(C, dtype=torch.bool, device=dev)
    if sf:
        spin, p_sp = spin.clone(), t(p_spin)
    if cav:
        n_open = cav_n.long()
        n_open_t = n_open.to(dt)
        cav_lnf = (torch.log(torch.clamp(n_open.double(), min=1e-30))
                   - math.log(float(g3)))
    for k in range(K):
        u = uniforms[:, k]
        u8 = u[:, 8]
        sp_k = (u[:, 11] < p_sp) if sf else no_spin   # before the move type
        ins = ~sp_k & (u8 < p_half)
        dele = ~sp_k & ~ins & (u8 < p_ins)
        disp = ~sp_k & ~ins & ~dele
        su = (torch.clamp((u[:, 9] * S).long(), max=S - 1) if S > 1
              else torch.zeros(C, dtype=torch.int64, device=dev))
        n_su = n_alive[ar, su]
        cnt = torch.where(ins, n_valid[su] - n_su,
                          torch.where(dele, n_su, n_alive.sum(1)))
        cnt_t = cnt.to(dt)
        j = torch.minimum(torch.floor(u[:, 0] * cnt_t), cnt_t - 1.0).long()
        same = sl_sp[None, :] == su[:, None]
        elig = torch.where(ins[:, None], ~slot_alive & same,
                           torch.where(dele[:, None], slot_alive & same,
                                       slot_alive))
        rank = torch.cumsum(elig.long(), dim=1)
        slot = torch.argmax((elig & (rank == (j + 1)[:, None])).to(
            torch.int8), dim=1)           # 0 where cnt == 0 (rejected)
        start = sl_start[slot]
        spf = torch.where(disp | sp_k, sl_sp[slot], su)
        na = na_s[spf]
        site_ok = site[None, :] < na[:, None]                      # [C,A]
        rows = torch.clamp(start[:, None] + site[None, :], max=N - 1)
        old = pos[ar[:, None], rows]                               # [C,A,3]
        qi, ei, si = charge[rows], eps[rows], sig[rows]
        mi = torch.where(site_ok, mass[rows], torch.zeros_like(qi))
        frac = None
        if cav:          # the open cell of rank j, a point inside it
            jc = torch.minimum(torch.floor(u[:, 10] * n_open_t),
                               n_open_t - 1.0).long().clamp(min=0)
            frac = cell_frac(cav_list.long()[ar, jc], u, g)
        new = _trial_rows(old, mi, ins, u, tmpl[spf], box, mf, rotf, frac)
        own = ((col[None, :] >= start[:, None])
               & (col[None, :] < (start + na)[:, None]))
        ok = alive & ~own
        has_old, has_new = ~ins & ~sp_k, ~dele & ~sp_k
        # the molecule's mass: the sum of its slot's site masses
        qc = (mi.sum(1), mol_mass, betas) if quantum else None
        rd_o, es_o, _, in_o, sq_o = _column_pass(
            old, has_old, pos, ok, site_ok, qi, ei, si, charge, eps, sig,
            box, box_inv, rc, alpha, cfg, qc)
        rd_n, es_n, mr2, in_n, sq_n = _column_pass(
            new, has_new, pos, ok, site_ok, qi, ei, si, charge, eps, sig,
            box, box_inv, rc, alpha, cfg, qc)
        drd = rd_n - rd_o
        des = KE * (es_n - es_o)
        if ew:
            qa = torch.where(site_ok, qi, torch.zeros_like(qi))[..., None]

            def trig(r, use):
                ph = (r[..., 0:1] * kvecs[:, 0] + r[..., 1:2] * kvecs[:, 1]
                      + r[..., 2:3] * kvecs[:, 2])                # [C,A,Nk]
                z = torch.zeros_like(ph)
                on = use[:, None, None]
                return (torch.where(on, torch.cos(ph), z),
                        torch.where(on, torch.sin(ph), z))

            cn, sn = trig(new, has_new)
            co, so = trig(old, has_old)
            dsr = torch.sum(qa * (cn - co), dim=1)                 # [C,Nk]
            dsi = torch.sum(qa * (sn - so), dim=1)
            drec = (kcoef * ((2.0 * sk_re + dsr) * dsr
                             + (2.0 * sk_im + dsi) * dsi)).double().sum(1)
        else:
            drec = torch.zeros(C, dtype=torch.float64, device=dev)
        fins, fdel = ins.double(), dele.double()
        sgn = fins - fdel
        dslf = sgn * dself[spf]
        dexc = sgn * dexcl[spf]
        cx_dot = torch.sum(cxd[spf] * n_alive.double(), dim=1)
        dlrc = (fins * (c1d[spf] + cx_dot)
                - fdel * (c1d[spf] + cx_dot - cxd[spf, spf]))
        du = drd + des + drec + dslf + dexc + dlrc
        if sf:            # the rotor's d_f, in the kernel's dtype
            s_cur = spin[ar, slot]
            f = rot_f[ar, slot]
            d_f = torch.where(s_cur > 0, f[:, 0] - f[:, 1],
                              f[:, 1] - f[:, 0]).double()
            du = torch.where(sp_k, d_f, du)
        n_s = n_su.double()
        lnb = torch.where(
            ins, lnfv[ar, spf] + torch.log(beta) - torch.log(n_s + 1.0),
            torch.where(dele, torch.log(torch.clamp(n_s, min=1e-30))
                        - torch.log(beta) - lnfv[ar, spf],
                        torch.zeros_like(n_s)))
        reject = (cnt == 0) | ((thr2 > 0) & has_new & (mr2 < thr2))
        if cav:
            lnb = lnb + (fins - fdel) * cav_lnf
            reject = reject | (ins & (n_open == 0))
        ln_t = lnb - beta * du                                # unbiased
        ln_eff = ln_t
        if bias:          # the flat-histogram tilt eta(N') - eta(N)
            ke = eta.shape[0]
            n0 = torch.clamp(n_su, max=ke - 1)
            n1 = torch.clamp(n0 + ins.long() - dele.long(), 0, ke - 1)
            ln_eff = torch.where(ins | dele, ln_t + (eta[n1].double()
                                                     - eta[n0].double()),
                                 ln_t)
        ln_u = torch.log(torch.clamp(u[:, 4].double(), min=1e-38))
        accept = ~reject & (ln_u < ln_eff)
        if tm:            # (1, a) at row N of the insert / delete columns
            a_pr = torch.where(reject, torch.zeros_like(ln_t),
                               torch.exp(torch.clamp(ln_t, max=0.0)))
            xd = ins | dele
            c0 = torch.where(ins, 0, 2)
            tmmc_out[ar[xd], n_su[xd], c0[xd]] += 1.0
            tmmc_out[ar[xd], n_su[xd], c0[xd] + 1] += a_pr[xd]
        if trace is not None:
            run = (cnt > 0) & ~sp_k          # the steps that make a pass
            passes = torch.where(run, (has_old.long() + has_new.long())
                                 * na, 0)
            trace.append({"accept": accept, "margin": ln_u - ln_eff,
                          "pairs": passes * ok.sum(1),
                          "pairs_in": torch.where(run, in_o + in_n, 0),
                          "cols": torch.where(run, ok.sum(1), 0),
                          "phases": passes * (kvecs.shape[0] if ew else 0),
                          "rss": torch.sqrt(sq_o + sq_n) * rss_units})
        acc_pos = accept & ~sp_k         # a spinflip moves nothing
        vals = torch.stack([drd, des, drec, dslf, dexc, dlrc], dim=1)
        sums[:, :6] += torch.where(acc_pos[:, None], vals,
                                   torch.zeros_like(vals))
        mt = torch.where(sp_k, 3, torch.where(disp, 0,
                                              torch.where(ins, 1, 2)))
        att_col = torch.where(sp_k, 13, 9 + mt)
        sums[ar, att_col] += 1.0
        sums[ar, att_col - 1 - 2 * (~sp_k).long()] += accept.double()
        # commit
        wr = (acc_pos & ~dele)[:, None] & site_ok
        pos[ar[:, None], rows] = torch.where(wr[..., None], new, old)
        alive[ar[:, None], rows] = torch.where(
            acc_pos[:, None] & site_ok, ~dele[:, None],
            alive[ar[:, None], rows])
        flip = acc_pos & ~disp & ~sp_k
        slot_alive[ar, slot] = torch.where(flip, ins, slot_alive[ar, slot])
        n_alive[ar, su] += (flip & ins).long() - (flip & dele).long()
        if ew:
            keep = acc_pos[:, None]
            sk_re = torch.where(keep, sk_re + dsr, sk_re)
            sk_im = torch.where(keep, sk_im + dsi, sk_im)
        if sf:
            _spin_flip(spin, (ar, slot), accept, sp_k)
    if sf:
        return pos, slot_alive, sums, sk_re, sk_im, spin
    return pos, slot_alive, sums, sk_re, sk_im


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def run_steps_uvt(pos, alive, eps, sig, charge, mass, slot_start,
                  slot_species, slot_alive, tmpl, natoms, box, rc, alpha,
                  betas, move_factor, rot_factor, thr2, p_ins, lnfvs, d_self,
                  d_excl, c1, cx, uniforms, cfg, kvecs=None, kcoef=None,
                  sk_re=None, sk_im=None, cluster=None, mol_mass=None,
                  cav_list=None, cav_n=None, eta=None, tmmc_out=None,
                  rot_f=None, spin=None, p_spin=0.0):
    """B1: K fused µVT steps for C chains, one cluster of G CTAs each.

    Per chain: ``pos`` [C,N,3], atom ``alive`` [C,N] bool, ``slot_alive``
    [C,Ms] bool, ``uniforms`` [C,K,16], ``betas`` [C] (1/T), ``lnfvs``
    [C,S] (ln of fugacity*V in K/A^3 units), ``sk_re``/``sk_im`` [C,Nk]
    (ewald).  Shared: per-atom ``eps``/``sig``/``charge``/``mass`` [N];
    the slot table ``slot_start``/``slot_species`` [Ms] int32 (first atom
    row, species index 0..S-1); ``tmpl`` [S,A,3] COM-centred templates
    and ``natoms`` [S] int32 site counts; the per-species ``d_self``,
    ``d_excl``, ``c1`` [S] and ``cx`` [S,S] (an insert of species s at
    per-species counts N_t changes the LRC by c1[s] + sum_t cx[s,t] N_t);
    ``box`` [3,3]; the scalars ``rc``, ``alpha``, ``move_factor``,
    ``rot_factor``, ``thr2`` (autoreject radius squared, 0 = off) and
    ``p_ins``; ``kvecs`` [Nk,3] with ``kcoef`` [Nk] the folded reciprocal
    coefficients (ewald).  ``cluster``: G, one of CLUSTER_SIZES whose
    slice fits in shared memory (None: ``cluster_size``).  ``mol_mass``
    [N]: each atom's molecular mass, needed under feynman_hibbs /
    feynman_kleinert (the terms at each chain's beta).

    Under ``cfg.cavity_bias``: ``cav_list`` [C, G^3] int32 and ``cav_n``
    [C] int32, each chain's open cells (``pack_cavity`` of its grid, G =
    cfg.cavity_grid).  Under ``cfg.tmmc`` (one species): ``tmmc_out`` [C,
    R, 4] float64, R > Ms, to which each insert or delete attempt adds
    (1, a) at row N, its chain's alive count before the move, in columns
    (0, 1) for an insert and (2, 3) for a delete, a the unbiased
    acceptance probability (0 on a reject); under ``cfg.tmmc_bias``
    ``eta`` [K'] (shared; None: no tilt) adds eta(N') - eta(N) to the
    acceptance.  Under ``cfg.quantum_rotation`` (spinflip): ``rot_f`` [C,
    Ms, 2] each slot's (F_para, F_ortho) in the kernel's dtype, ``spin``
    [C, Ms] int32 and the probability ``p_spin`` (a number or a device
    scalar), lane 11 < p_spin carving the move out before the move type.
    These run the kernel's XT instance.

    Returns (pos [C,N,3], slot_alive [C,Ms] bool, sums [C,14] float64,
    sk_re [C,Nk], sk_im [C,Nk]), and under spinflip spin [C,Ms] int32 as
    a sixth, sums in the reference order (d_rd, d_es_real, d_es_recip,
    d_es_self, d_es_excl, d_lrc, acc disp/ins/del, att disp/ins/del,
    acc/att spinflip).  The inputs are not modified."""
    C, N = alive.shape
    ms = slot_start.shape[0]
    ew = cfg.coulomb == "ewald"
    nk = kvecs.shape[0] if ew else 0
    quantum = quantum_option(cfg) > 0
    if pos.device.type == "cpu":
        if cluster is not None:      # checked, then ignored by the plain
            _check_cluster(cluster, N, pos.dtype, nk, ms, "run_steps_uvt",
                           quantum=quantum)
        return run_steps_uvt_plain(
            pos, alive, eps, sig, charge, mass, slot_start, slot_species,
            slot_alive, tmpl, natoms, box, rc, alpha, betas, move_factor,
            rot_factor, thr2, p_ins, lnfvs, d_self, d_excl, c1, cx,
            uniforms, cfg, kvecs=kvecs, kcoef=kcoef, sk_re=sk_re,
            sk_im=sk_im, cluster=cluster, mol_mass=mol_mass,
            cav_list=cav_list, cav_n=cav_n, eta=eta, tmmc_out=tmmc_out,
            rot_f=rot_f, spin=spin, p_spin=p_spin)
    if pos.device.type != "cuda":
        raise ValueError(f"run_steps_uvt: no kernel for {pos.device}")
    _refuse_cfg(cfg)
    dt, dev = pos.dtype, pos.device
    qc, mm_ptr = _quantum_cols(mol_mass, cfg, N, dt, dev, "run_steps_uvt")
    S, A = tmpl.shape[0], tmpl.shape[1]
    K = uniforms.shape[1]
    if A > MAX_SITES or S > MAX_SPECIES:
        raise ValueError(f"run_steps_uvt: {S} species of {A} sites (the "
                         f"kernel takes <= {MAX_SPECIES} of <= {MAX_SITES})")
    _check("pos", pos, dt, (C, N, 3), dev)
    _check("alive", alive, torch.bool, (C, N), dev)
    for nm, x in (("eps", eps), ("sig", sig), ("charge", charge),
                  ("mass", mass)):
        _check(nm, x, dt, (N,), dev)
    _check("slot_start", slot_start, torch.int32, (ms,), dev)
    _check("slot_species", slot_species, torch.int32, (ms,), dev)
    _check("slot_alive", slot_alive, torch.bool, (C, ms), dev)
    _check("tmpl", tmpl, dt, (S, A, 3), dev)
    _check("natoms", natoms, torch.int32, (S,), dev)
    _check("betas", betas, dt, (C,), dev)
    _check("lnfvs", lnfvs, dt, (C, S), dev)
    for nm, x in (("d_self", d_self), ("d_excl", d_excl), ("c1", c1)):
        _check(nm, x, dt, (S,), dev)
    _check("cx", cx, dt, (S, S), dev)
    _check("uniforms", uniforms, dt, (C, K, 16), dev)
    _check("box", box, dt, (3, 3), dev)
    if ew:
        _check("kvecs", kvecs, dt, (nk, 3), dev)
        _check("kcoef", kcoef, dt, (nk,), dev)
        _check("sk_re", sk_re, dt, (C, nk), dev)
        _check("sk_im", sk_im, dt, (C, nk), dev)
        sk = torch.stack([sk_re, sk_im], dim=1).contiguous()      # [C,2,Nk]
    else:
        sk = torch.empty((C, 2, 0), dtype=dt, device=dev)

    g, g3, ke_eta, rows, cav, tm, bias = _xt_check(
        cfg, "run_steps_uvt", C, cav_list, cav_n, eta, tmmc_out, ms, dev)
    if bias:
        _check("eta", eta, dt, (ke_eta,), dev)
    sf = int(_spin_inputs(cfg, rot_f, spin, (C,), ms, dt, dev,
                          "run_steps_uvt"))
    xt = int(bool(cav or tm or sf))
    # the XT instance reads p_spin at scal[24]
    scal = torch.cat([_scalar(x, dt, dev) for x in (rc, alpha, move_factor,
                                                     rot_factor, thr2, p_ins)]
                     + [box.reshape(-1),
                        torch.linalg.inv_ex(box)[0].reshape(-1)]
                     + ([_scalar(p_spin if sf else 0.0, dt, dev)]
                        if xt else [])).contiguous()
    out_pos, out_alive = pos.clone(), alive.clone()
    out_slot = slot_alive.clone()
    sums = torch.empty((C, N_SUMS), dtype=torch.float64, device=dev)
    ortho = int(bool(cfg.ortho_box))
    from mpmc_tpu_torch.ops.cuda import _build
    lib = _build.library("uvt_xt_kernel" if xt else "uvt_kernel")
    G = _launch_cluster(lib, "uvt_occupancy", cluster, C, N, dt, nk, ms,
                        (N, nk, ms, int(quantum), xt), "run_steps_uvt",
                        quantum=quantum)
    fn = getattr(lib, "run_steps_uvt_" + _suffix(dt))
    nullp = ctypes.c_void_p(None)
    # each CTA's replica of its chain's spins; rank 0's is the result
    spins = (spin[:, None, :].expand(C, G, ms).contiguous() if sf
             else None)
    err = fn(_ptr(out_pos), _ptr(out_alive), _ptr(eps), _ptr(sig),
             _ptr(charge), _ptr(mass), mm_ptr, _ptr(slot_start),
             _ptr(slot_species), _ptr(out_slot), _ptr(tmpl), _ptr(natoms),
             _ptr(scal), _ptr(betas), _ptr(lnfvs), _ptr(d_self),
             _ptr(d_excl), _ptr(c1), _ptr(cx), _ptr(uniforms),
             _ptr(kvecs) if ew else nullp, _ptr(kcoef) if ew else nullp,
             _ptr(sk) if ew else nullp, _ptr(sums),
             _ptr(cav_list) if cav else nullp, _ptr(cav_n) if cav else nullp,
             _ptr(eta) if bias else nullp, _ptr(tmmc_out) if tm else nullp,
             _ptr(rot_f) if sf else nullp, _ptr(spins) if sf else nullp,
             C, N, ms, S, A, K, nk, G, _RD[cfg.rd_potential],
             _MIX[cfg.mixing_rule], _ES[cfg.coulomb], ortho, qc, g, g3,
             ke_eta, rows, cav, tm, bias, sf, ctypes.c_double(KE),
             ctypes.c_double(HBAR2_KB_AMU_A2), _stream(dev))
    run_steps_uvt.launches += 1
    run_steps_uvt.last_cluster = G
    _raise_on(err, "run_steps_uvt")
    out = (out_pos, out_slot, sums) + ((sk[:, 0], sk[:, 1]) if ew
                                       else (sk_re, sk_im))
    return out + (spins[:, 0].contiguous(),) if sf else out


run_steps_uvt.launches = 0
run_steps_uvt.last_cluster = None     # G of the last kernel launch


# ---------------------------------------------------------------------------
# B3: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def _k0_rows(nve_k0, C, dev):
    """The kinetic reservoir at launch entry as a [C] float64 tensor."""
    if not torch.is_tensor(nve_k0):
        return torch.full((C,), float(nve_k0), dtype=torch.float64,
                          device=dev)
    return nve_k0.to(dev, torch.float64).reshape(-1).expand(C).contiguous()


def run_steps_plain(pos, alive, eps, sig, charge, mass, mv_start, mv_natoms,
                    box, rc, alpha, betas, move_factor, rot_factor, thr2,
                    uniforms, cfg, kvecs=None, kcoef=None, sk_re=None,
                    sk_im=None, nve_k0=None, nve_g=0.0, a_max=None,
                    cluster=None, mol_mass=None, rot_f=None, spin=None,
                    p_spin=0.0, trace=None):
    """Plain B3: a loop over the K steps of batched tensor ops over the C
    chains and the N columns, with the kernel's arithmetic (the pair sums,
    the acceptance and the NVE reservoir in float64).  Arguments and
    results as ``run_steps``; ``cluster`` is ignored; the inputs are not
    modified; a spinflip step's pass runs and is masked (the kernel skips
    it).  ``trace``: a
    list that gets one dict per step — ``accept`` [C], ``margin`` [C] = ln
    u - ln(acceptance), and the work the kernel does for it, ``pairs``,
    ``pairs_in``, ``cols`` and ``phases`` [C] (pair evaluations, those
    within rc, columns passed and k-vector phases), and ``rss`` [C, 2] as
    for B1."""
    _refuse_cfg(cfg, "run_steps")
    quantum = _quantum_cols(mol_mass, cfg, pos.shape[1], pos.dtype,
                            pos.device, "run_steps")[0]
    dt, dev = pos.dtype, pos.device
    C, N = pos.shape[0], pos.shape[1]
    K = uniforms.shape[1]
    n_mv = mv_start.shape[0]
    A = int(mv_natoms.max()) if a_max is None else int(a_max)
    ew = cfg.coulomb == "ewald"
    nve = cfg.ensemble == "nve"
    pos = pos.clone()
    if ew:
        sk_re, sk_im = sk_re.clone(), sk_im.clone()

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    rc, alpha, mf, rotf, thr2 = (t(rc), t(alpha), t(move_factor),
                                 t(rot_factor), t(thr2))
    mv_t = t(float(n_mv))
    box_inv = torch.linalg.inv(box)
    ar = torch.arange(C, device=dev)
    site = torch.arange(A, device=dev)
    col = torch.arange(N, device=dev)
    st, nat = mv_start.long(), mv_natoms.long()
    beta = betas.double()
    k_cur = _k0_rows(nve_k0, C, dev) if nve else None
    no_ins = torch.zeros(C, dtype=torch.bool, device=dev)
    use = ~no_ins
    sums = torch.zeros((C, N_SUMS_NVT), dtype=torch.float64, device=dev)
    rss_units = torch.tensor([1.0, KE], dtype=torch.float64, device=dev)
    sf = _spin_inputs(cfg, rot_f, spin, (C,), n_mv, dt, dev, "run_steps")
    if sf:
        spin, p_sp = spin.clone(), t(p_spin)
    for k in range(K):
        u = uniforms[:, k]
        sp_k = (u[:, 8] < p_sp) if sf else no_ins     # the spinflip carve
        m = torch.minimum(torch.floor(u[:, 0] * mv_t), mv_t - 1.0).long()
        start, na = st[m], nat[m]
        site_ok = site[None, :] < na[:, None]                      # [C,A]
        rows = torch.clamp(start[:, None] + site[None, :], max=N - 1)
        old = pos[ar[:, None], rows]                               # [C,A,3]
        qi, ei, si = charge[rows], eps[rows], sig[rows]
        mi = torch.where(site_ok, mass[rows], torch.zeros_like(qi))
        new = _trial_rows(old, mi, no_ins, u, old, box, mf, rotf)
        own = ((col[None, :] >= start[:, None])
               & (col[None, :] < (start + na)[:, None]))
        ok = alive[None, :] & ~own
        qc = (mi.sum(1), mol_mass, betas) if quantum else None
        rd_o, es_o, _, in_o, sq_o = _column_pass(
            old, use, pos, ok, site_ok, qi, ei, si, charge, eps, sig, box,
            box_inv, rc, alpha, cfg, qc)
        rd_n, es_n, mr2, in_n, sq_n = _column_pass(
            new, use, pos, ok, site_ok, qi, ei, si, charge, eps, sig, box,
            box_inv, rc, alpha, cfg, qc)
        drd = rd_n - rd_o
        des = KE * (es_n - es_o)
        if ew:
            qa = torch.where(site_ok, qi, torch.zeros_like(qi))[..., None]

            def trig(r):
                ph = (r[..., 0:1] * kvecs[:, 0] + r[..., 1:2] * kvecs[:, 1]
                      + r[..., 2:3] * kvecs[:, 2])                # [C,A,Nk]
                return torch.cos(ph), torch.sin(ph)

            cn, sn = trig(new)
            co, so = trig(old)
            dsr = torch.sum(qa * (cn - co), dim=1)                 # [C,Nk]
            dsi = torch.sum(qa * (sn - so), dim=1)
            drec = (kcoef * ((2.0 * sk_re + dsr) * dsr
                             + (2.0 * sk_im + dsi) * dsi)).double().sum(1)
        else:
            drec = torch.zeros(C, dtype=torch.float64, device=dev)
        du = drd + des + drec
        reject = (thr2 > 0) & (mr2 < thr2) & ~sp_k
        if sf:            # the rotor's d_f, in the kernel's dtype
            s_cur = spin[ar, m]
            f = rot_f[ar, m]
            du = torch.where(sp_k, torch.where(
                s_cur > 0, f[:, 0] - f[:, 1], f[:, 1] - f[:, 0]).double(),
                du)
        ln_u = torch.log(torch.clamp(u[:, 4].double(), min=1e-38))
        if nve:
            # Ray: P = min(1, (K_new / K_old)^g), K_new > 0
            k_new = k_cur - du
            live = (k_new > 0) & (k_cur > 0)
            one = torch.ones_like(k_new)
            ln_t = torch.where(
                live, nve_g * (torch.log(torch.where(live, k_new, one))
                               - torch.log(torch.where(live, k_cur, one))),
                torch.full_like(k_new, -math.inf))
            accept = ~reject & live & (ln_u < ln_t)
            k_cur = torch.where(accept, k_new, k_cur)
        else:
            ln_t = -beta * du
            accept = ~reject & (ln_u < ln_t)
        if trace is not None:
            passes = torch.where(sp_k, 0, 2 * na)
            trace.append({"accept": accept, "margin": ln_u - ln_t,
                          "pairs": passes * ok.sum(1),
                          "pairs_in": torch.where(sp_k, 0, in_o + in_n),
                          "cols": torch.where(sp_k, 0, ok.sum(1)),
                          "phases": passes * (kvecs.shape[0] if ew else 0),
                          "rss": torch.sqrt(sq_o + sq_n) * rss_units})
        acc_pair = accept & ~sp_k        # a spinflip moves nothing
        vals = torch.stack([drd, des, drec], dim=1)
        sums[:, :3] += torch.where(acc_pair[:, None], vals,
                                   torch.zeros_like(vals))
        sums[:, 3] += acc_pair.double()
        sums[:, 4] += (accept & sp_k).double()
        sums[:, 5] += sp_k.double()
        wr = acc_pair[:, None] & site_ok
        pos[ar[:, None], rows] = torch.where(wr[..., None], new, old)
        if ew:
            keep = acc_pair[:, None]
            sk_re = torch.where(keep, sk_re + dsr, sk_re)
            sk_im = torch.where(keep, sk_im + dsi, sk_im)
        if sf:
            _spin_flip(spin, (ar, m), accept, sp_k)
    if sf:
        return pos, sums, sk_re, sk_im, spin
    return pos, sums, sk_re, sk_im


def run_steps(pos, alive, eps, sig, charge, mass, mv_start, mv_natoms, box,
              rc, alpha, betas, move_factor, rot_factor, thr2, uniforms, cfg,
              kvecs=None, kcoef=None, sk_re=None, sk_im=None, nve_k0=None,
              nve_g=0.0, a_max=None, cluster=None, mol_mass=None,
              rot_f=None, spin=None, p_spin=0.0):
    """B3: K fused NVT (or NVE) steps for C chains, one cluster of G CTAs
    each.

    Per chain: ``pos`` [C,N,3], ``uniforms`` [C,K,16], ``betas`` [C] (1/T),
    ``sk_re``/``sk_im`` [C,Nk] (ewald).  Shared: atom ``alive`` [N] bool;
    per-atom ``eps``/``sig``/``charge``/``mass`` [N]; the table of alive
    movable molecules ``mv_start``/``mv_natoms`` [Mv] int32 (first atom
    row, site count; ``movable_mols``) and its largest site count
    ``a_max`` (computed from ``mv_natoms`` when None: a molecule turns
    about its COM only when a_max > 1); ``box`` [3,3]; the scalars ``rc``,
    ``alpha``, ``move_factor``, ``rot_factor``, ``thr2`` (autoreject
    radius squared, 0 = off); ``kvecs`` [Nk,3] with ``kcoef`` [Nk] the
    folded reciprocal coefficients (ewald).  Under ``cfg.ensemble ==
    "nve"``: ``nve_k0`` the kinetic reservoir at entry ([C] or a scalar,
    E_total - U) and ``nve_g`` the exponent f_dof/2 - 1.  ``cluster``: G,
    one of CLUSTER_SIZES whose slice fits in shared memory (None:
    ``cluster_size``).  ``mol_mass`` [N]: each atom's molecular mass,
    needed under feynman_hibbs / feynman_kleinert (at each chain's beta).
    Under ``cfg.quantum_rotation`` (spinflip, nvt): ``rot_f`` [C, Mv, 2]
    each table molecule's (F_para, F_ortho) in the kernel's dtype,
    ``spin`` [C, Mv] int32 and ``p_spin``, lane 8 < p_spin carving the
    move out (the kernel's SF instance).

    Returns (pos [C,N,3], sums [C,6] float64 = (d_rd, d_es_real,
    d_es_recip, accepted moves, accepted and attempted spinflips), sk_re
    [C,Nk], sk_im [C,Nk]), and under spinflip spin [C,Mv] int32 as a
    fifth.  The inputs are not modified."""
    C, N = pos.shape[0], pos.shape[1]
    ew = cfg.coulomb == "ewald"
    nk = kvecs.shape[0] if ew else 0
    quantum = quantum_option(cfg) > 0
    if pos.device.type == "cpu":
        if cluster is not None:      # checked, then ignored by the plain
            _check_cluster(cluster, N, pos.dtype, nk, 0, "run_steps",
                           quantum=quantum)
        return run_steps_plain(
            pos, alive, eps, sig, charge, mass, mv_start, mv_natoms, box, rc,
            alpha, betas, move_factor, rot_factor, thr2, uniforms, cfg,
            kvecs=kvecs, kcoef=kcoef, sk_re=sk_re, sk_im=sk_im,
            nve_k0=nve_k0, nve_g=nve_g, a_max=a_max, cluster=cluster,
            mol_mass=mol_mass, rot_f=rot_f, spin=spin, p_spin=p_spin)
    if pos.device.type != "cuda":
        raise ValueError(f"run_steps: no kernel for {pos.device}")
    _refuse_cfg(cfg, "run_steps")
    dt, dev = pos.dtype, pos.device
    qc, mm_ptr = _quantum_cols(mol_mass, cfg, N, dt, dev, "run_steps")
    n_mv = mv_start.shape[0]
    K = uniforms.shape[1]
    nve = cfg.ensemble == "nve"
    A = int(mv_natoms.max()) if a_max is None else int(a_max)
    if n_mv == 0 or A > MAX_SITES:
        raise ValueError(f"run_steps: {n_mv} movable molecules of up to {A} "
                         f"sites (the kernel takes >= 1 of <= {MAX_SITES})")
    _check("pos", pos, dt, (C, N, 3), dev)
    _check("alive", alive, torch.bool, (N,), dev)
    for nm, x in (("eps", eps), ("sig", sig), ("charge", charge),
                  ("mass", mass)):
        _check(nm, x, dt, (N,), dev)
    _check("mv_start", mv_start, torch.int32, (n_mv,), dev)
    _check("mv_natoms", mv_natoms, torch.int32, (n_mv,), dev)
    _check("betas", betas, dt, (C,), dev)
    _check("uniforms", uniforms, dt, (C, K, 16), dev)
    _check("box", box, dt, (3, 3), dev)
    if ew:
        _check("kvecs", kvecs, dt, (nk, 3), dev)
        _check("kcoef", kcoef, dt, (nk,), dev)
        _check("sk_re", sk_re, dt, (C, nk), dev)
        _check("sk_im", sk_im, dt, (C, nk), dev)
        sk = torch.stack([sk_re, sk_im], dim=1).contiguous()      # [C,2,Nk]
    else:
        sk = torch.empty((C, 2, 0), dtype=dt, device=dev)
    k0 = _k0_rows(nve_k0, C, dev) if nve else None
    sf = int(_spin_inputs(cfg, rot_f, spin, (C,), n_mv, dt, dev,
                          "run_steps"))
    # the SF instance reads p_spin at scal[23]
    scal = torch.cat([_scalar(x, dt, dev) for x in (rc, alpha, move_factor,
                                                     rot_factor, thr2)]
                     + [box.reshape(-1),
                        torch.linalg.inv_ex(box)[0].reshape(-1)]
                     + ([_scalar(p_spin, dt, dev)] if sf else [])
                     ).contiguous()
    out_pos = pos.clone()
    sums = torch.empty((C, N_SUMS_NVT), dtype=torch.float64, device=dev)
    from mpmc_tpu_torch.ops.cuda import _build
    lib = _build.library("nvt_sf_kernel" if sf else "nvt_kernel")
    G = _launch_cluster(lib, "nvt_occupancy", cluster, C, N, dt, nk, 0,
                        (N, nk, int(quantum)), "run_steps", quantum=quantum)
    fn = getattr(lib, "run_steps_nvt_" + _suffix(dt))
    nullp = ctypes.c_void_p(None)
    # each CTA's replica of its chain's spins; rank 0's is the result
    spins = (spin[:, None, :].expand(C, G, n_mv).contiguous() if sf
             else None)
    err = fn(_ptr(out_pos), _ptr(alive), _ptr(eps), _ptr(sig), _ptr(charge),
             _ptr(mass), mm_ptr, _ptr(mv_start), _ptr(mv_natoms), _ptr(scal),
             _ptr(betas), _ptr(uniforms), _ptr(kvecs) if ew else nullp,
             _ptr(kcoef) if ew else nullp, _ptr(sk) if ew else nullp,
             _ptr(k0) if nve else nullp, _ptr(sums),
             _ptr(rot_f) if sf else nullp, _ptr(spins) if sf else nullp,
             C, N, n_mv, A, K, nk, G, _RD[cfg.rd_potential],
             _MIX[cfg.mixing_rule], _ES[cfg.coulomb],
             int(bool(cfg.ortho_box)), int(nve), qc, sf, ctypes.c_double(KE),
             ctypes.c_double(float(nve_g)), ctypes.c_double(HBAR2_KB_AMU_A2),
             _stream(dev))
    run_steps.launches += 1
    run_steps.last_cluster = G
    _raise_on(err, "run_steps")
    out = (out_pos, sums) + ((sk[:, 0], sk[:, 1]) if ew else (sk_re, sk_im))
    return out + (spins[:, 0].contiguous(),) if sf else out


run_steps.launches = 0
run_steps.last_cluster = None         # G of the last kernel launch


# ---------------------------------------------------------------------------
# B6: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def _pda_field(cfg):
    """B6's field kernel: 0 direct, 1 wolf, 2 ewald (its real-space part)."""
    return 2 if cfg.polar_ewald else (1 if cfg.polar_wolf else 0)


def _pda_bias(cfg) -> bool:
    """Whether B6's stage-1 test takes the tmmc_bias tilt."""
    return bool(cfg.tmmc and cfg.tmmc_bias)


def _refuse_pda(cfg):
    """Raise on what neither B6 nor its plain version implements."""
    _refuse_cfg(cfg, "run_steps_uvt_pda")
    if cfg.polar_damp_type not in tk._DAMP:
        raise ValueError(f"run_steps_uvt_pda: polar_damp_type "
                         f"{cfg.polar_damp_type!r} not supported")


def pda_rec_terms(old, new, q, has_old, has_new, kvecs, kcoef, sk_re,
                  sk_im):
    """The reciprocal-space terms [Nk] of plain B6's d_rec: sites of charge
    ``q`` [A] moved from ``old`` to ``new`` [A,3] (``has_old``/``has_new``
    false: the row is absent, an insert or a delete), against S(k) =
    (``sk_re``, ``sk_im``): kcoef ((2 S + dS) dS), real and imaginary
    parts, in the rows' dtype."""
    def trig(r, use):
        ph = (r[:, 0:1] * kvecs[:, 0] + r[:, 1:2] * kvecs[:, 1]
              + r[:, 2:3] * kvecs[:, 2])                           # [A,Nk]
        if not use:
            return torch.zeros_like(ph), torch.zeros_like(ph)
        return torch.cos(ph), torch.sin(ph)

    qa = q[:, None]
    cn, sn = trig(new, has_new)
    co, so = trig(old, has_old)
    dsr = torch.sum(qa * (cn - co), 0)
    dsi = torch.sum(qa * (sn - so), 0)
    return kcoef * ((2.0 * sk_re + dsr) * dsr + (2.0 * sk_im + dsi) * dsi)


def run_steps_uvt_pda_plain(pos, alive, eps, sig, charge, mass, polar, e0,
                            slot_start, slot_species, slot_alive, tmpl,
                            natoms, box, rc, alpha, beta, move_factor,
                            rot_factor, thr2, p_ins, lnfv, d_self, d_excl, c1,
                            cx, uniforms, cfg, kvecs=None, kcoef=None,
                            sk_re=None, sk_im=None, field_alpha=0.0,
                            field_krc=0.0, cluster=None, mol_mass=None,
                            cav_list=None, cav_n=None, d_eta_ins=0.0,
                            d_eta_del=0.0, rot_f=None, spin=None,
                            p_spin=0.0, trace=None):
    """Plain B6: a loop over the K rows of tensor ops over the N columns
    that stops at the freeze, with the kernel's arithmetic (the pair,
    surrogate and field sums, the constants and the stage-1 test in
    float64); the move decisions are read on the host.  Arguments and
    result as ``run_steps_uvt_pda``; ``cluster`` is ignored.  ``trace``:
    a list that gets one dict
    per step — ``hit``, ``margin`` = ln u - ln(stage-1 acceptance), and
    the work the kernel does for it, ``pairs``, ``in_old``, ``in_new``,
    ``phases`` and ``cols`` (pair evaluations, those of the current and
    of the trial rows within rc, k-vector phases and surrogate columns),
    and ``rss``, the root sum of squares of the terms summed into d_rd,
    d_es_real, d_es_recip and d* (the scale of their rounding)."""
    _refuse_pda(cfg)
    dt, dev = pos.dtype, pos.device
    N = pos.shape[0]
    S, A = tmpl.shape[0], tmpl.shape[1]
    ew = cfg.coulomb == "ewald"
    field = _pda_field(cfg)
    quantum = _quantum_cols(mol_mass, cfg, N, dt, dev,
                            "run_steps_uvt_pda")[0]

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    beta_t = t(beta).reshape(1)              # the quantum terms' beta

    rc, alpha, mf, rotf, thr2 = (t(rc), t(alpha), t(move_factor),
                                 t(rot_factor), t(thr2))
    paf, pkrc = (t(field_alpha), t(field_krc)) if field else (None, None)
    rc2 = rc * rc
    p_ins_h = float(t(p_ins))
    p_half_h = 0.5 * p_ins_h                 # a halving: exact in T too
    box_inv = torch.linalg.inv(box)
    u_h = uniforms.cpu()
    sl_sp = slot_species.long().cpu()
    sl_start = slot_start.long().cpu()
    na_s = natoms.long().cpu()
    sa = slot_alive.cpu()
    same_sp = sl_sp[:, None] == torch.arange(S)
    n_valid = same_sp.sum(0)
    n_alive = (sa[:, None] & same_sp).sum(0)
    beta = float(t(beta))
    lnfv, dself, dexcl = lnfv.double(), d_self.double(), d_excl.double()
    c1d, cxd = c1.double(), cx.double()
    col = torch.arange(N, device=dev)
    site = torch.arange(A, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    rec = torch.zeros((8, 16), dtype=torch.float64, device=dev)
    att = [0, 0, 0, 0]
    n_done = 0
    g, g3, _, _, cav, _, _ = _xt_check(cfg, "run_steps_uvt_pda_plain", None,
                                       cav_list, cav_n, None, None,
                                       slot_start.shape[0], dev, tmmc=False)
    sf = _spin_inputs(cfg, rot_f, spin, (), slot_start.shape[0], dt, dev,
                      "run_steps_uvt_pda_plain")
    p_sp = float(t(p_spin)) if sf else 0.0
    xt = cav or _pda_bias(cfg)
    de = (float(t(d_eta_ins)), float(t(d_eta_del))) if xt else (0.0, 0.0)
    if cav:
        n_open = int(cav_n.reshape(-1)[0])
        cav_lnf = math.log(max(float(n_open), 1e-30)) - math.log(float(g3))
        cav_l = cav_list.long().cpu()

    def coef(r2):
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        d1, _ = tk.damping(r, cfg.polar_damp, cfg.polar_damp_type)
        return thole._field_coef(r, r2s, d1, paf, pkrc)

    for k in range(uniforms.shape[0]):
        uk = u_h[k]
        spin_k = sf and float(uk[11]) < p_sp      # before the move type
        ins = not spin_k and float(uk[8]) < p_half_h
        dele = not spin_k and not ins and float(uk[8]) < p_ins_h
        mt = 3 if spin_k else (1 if ins else (2 if dele else 0))
        su = min(int(uk[9] * S), S - 1) if S > 1 else 0
        n_done += 1
        att[mt] += 1
        cnt = int(n_valid[su] - n_alive[su] if ins
                  else (n_alive[su] if dele else n_alive.sum()))
        if spin_k and cnt > 0:
            # the rotor of the displacement's pick; no pass (d* = 0, du =
            # d_f, lnb = 0): the full spinflip acceptance
            cnt_t = torch.tensor(float(cnt), dtype=dt)
            j = int(torch.minimum(torch.floor(uk[0] * cnt_t), cnt_t - 1.0))
            slot = int(torch.nonzero(sa)[j, 0])
            f = rot_f[slot]
            d_f = float(f[0] - f[1] if int(spin[slot]) > 0 else f[1] - f[0])
            margin = math.log(max(float(uk[4]), 1e-38)) + beta * d_f
            if trace is not None:
                trace.append({"hit": margin < 0.0, "margin": margin,
                              "pairs": 0, "in_old": 0, "in_new": 0,
                              "phases": 0, "cols": 0})
            if margin < 0.0:
                rec[0, 1:6] = torch.tensor(
                    [1.0, 3.0, slot, float(sl_sp[slot]), float(uk[12])],
                    dtype=torch.float64)
                break
            continue
        if cnt == 0 or (cav and ins and n_open == 0):
            # nothing to move, or no open cell: a stage-1 rejection
            if trace is not None:
                trace.append({"hit": False, "margin": math.inf, "pairs": 0,
                              "in_old": 0, "in_new": 0, "phases": 0,
                              "cols": 0})
            continue
        cnt_t = torch.tensor(float(cnt), dtype=dt)
        j = int(torch.minimum(torch.floor(uk[0] * cnt_t), cnt_t - 1.0))
        same = sl_sp == su
        elig = ~sa & same if ins else (sa & same if dele else sa)
        slot = int(torch.nonzero(elig)[j, 0])
        start = int(sl_start[slot])
        spf = su if ins or dele else int(sl_sp[slot])
        na = int(na_s[spf])
        rows = torch.clamp(start + site, max=N - 1)
        site_ok = site < na
        old = pos[rows]                                            # [A,3]
        qi, ei, si = charge[rows], eps[rows], sig[rows]
        mi = torch.where(site_ok, mass[rows], zero)
        frac = None
        if cav and ins:      # the open cell of rank j, a point inside it
            n_t = torch.tensor(float(n_open), dtype=dt)
            jc = int(torch.minimum(torch.floor(uk[10] * n_t), n_t - 1.0))
            frac = cell_frac(cav_l[jc].to(dev), uniforms[k:k + 1],
                             g).reshape(1, 3)
        new = _trial_rows(old[None], mi[None],
                          torch.tensor([ins], device=dev), uniforms[k:k + 1],
                          tmpl[spf][None], box, mf, rotf, frac)[0]
        has_old, has_new = not ins, not dele
        own = (col >= start) & (col < start + na)
        ok = alive & ~own
        m = ok[None, :] & site_ok[:, None]                         # [A,N]
        dr_o = pbc_ops.min_image(old[:, None, :] - pos[None], box, box_inv)
        dr_n = pbc_ops.min_image(new[:, None, :] - pos[None], box, box_inv)
        r2_o = torch.sum(dr_o * dr_o, -1)
        r2_n = torch.sum(dr_n * dr_n, -1)
        m_o, m_n = m & has_old, m & has_new
        qc = ((mi.sum().reshape(1), mol_mass, beta_t) if quantum else None)
        sums = [_pair_sums(r2[None], mm[None], qi[None], ei[None], si[None],
                           charge, eps, sig, rc, alpha, cfg, qc)
                for r2, mm in ((r2_o, m_o), (r2_n, m_n))]
        drd = float(sums[1][0] - sums[0][0])
        des = KE * float(sums[1][1] - sums[0][1])
        mr2 = float(sums[1][2])
        # the damped charge-field delta of the moved sites at every column,
        # summed over the sites before it is squared (tile (a) of
        # thole.field_delta, dr = r_a - r_j), and the column charges' field
        # at the trial rows (tile (b)) and, for polar_ewald, at the old rows
        in_o, in_n = m_o & (r2_o < rc2), m_n & (r2_n < rc2)
        c_o = torch.where(in_o, coef(r2_o), zero)
        c_n = torch.where(in_n, coef(r2_n), zero)
        d_e = torch.sum(qi[:, None, None] * (c_o[..., None] * dr_o
                                             - c_n[..., None] * dr_n), 0)
        z_cols = torch.where(ok, polar, zero) * (
            2.0 * torch.sum(e0 * d_e, 1) + torch.sum(d_e * d_e, 1))
        z_others = float(z_cols.double().sum())
        f = (torch.where(in_n, charge * c_n, zero)[..., None]
             * dr_n).double().sum(1)                               # [A,3]
        e0_old = e0[rows].double()
        if field == 2 and has_old:
            f = e0_old + f - (torch.where(in_o, charge * c_o, zero)[..., None]
                              * dr_o).double().sum(1)
        pol_i = torch.where(site_ok, polar[rows], zero).double()
        z_new = float(torch.sum(pol_i * torch.sum(f * f, 1)))
        z_old = float(torch.sum(pol_i * torch.sum(e0_old * e0_old, 1)))
        d_surr = -0.5 * KE * (z_others + (z_new if has_new else 0.0)
                              - (z_old if has_old else 0.0))
        nk = kvecs.shape[0] if ew else 0
        if ew:
            rec_t = pda_rec_terms(old, new, torch.where(site_ok, qi, zero),
                                  has_old, has_new, kvecs, kcoef, sk_re,
                                  sk_im)
        else:
            rec_t = torch.zeros(0, dtype=dt, device=dev)
        drec = float(rec_t.double().sum())
        fins, fdel = float(ins), float(dele)
        dslf = (fins - fdel) * float(dself[spf])
        dexc = (fins - fdel) * float(dexcl[spf])
        cx_dot = float(torch.sum(cxd[spf] * n_alive.to(cxd)))
        c1s, cxs = float(c1d[spf]), float(cxd[spf, spf])
        dlrc = fins * (c1s + cx_dot) - fdel * (c1s + cx_dot - cxs)
        du = drd + des + drec + dslf + dexc + dlrc
        n_s = float(n_alive[su])
        lnb = 0.0
        if ins:
            lnb = float(lnfv[spf]) + math.log(beta) - math.log(n_s + 1.0)
        elif dele:
            lnb = (math.log(max(n_s, 1e-30)) - math.log(beta)
                   - float(lnfv[spf]))
        reject = float(thr2) > 0.0 and has_new and mr2 < float(thr2)
        if cav:
            lnb = lnb + (fins - fdel) * cav_lnf
        ln1 = lnb - beta * (du + d_surr)
        if xt:               # the tmmc_bias tilt; the record keeps lnb
            ln1 = ln1 + (fins * de[0] + fdel * de[1])
        margin = math.log(max(float(uk[4]), 1e-38)) - ln1
        hit = not reject and margin < 0.0
        if trace is not None:
            def rss(*terms):         # root sum of squares of a sum's terms
                return math.sqrt(sum(float(torch.sum(torch.where(
                    a, v, zero).double() ** 2)) for a, v in terms
                    if v is not None))

            (rd_o, es_o, _, _), (rd_n, es_n, _, _) = [
                pairs._tile_values(r2, qi[:, None], ei[:, None], si[:, None],
                                   charge, eps, sig, cfg, rc, alpha)
                for r2 in (r2_o, r2_n)]
            if quantum and rd_o is not None:
                e_m, s_m = lj_ops.mix(ei[:, None], eps, si[:, None], sig,
                                      cfg.mixing_rule)
                rd_o, rd_n = [rd + quantum_pairs(
                    torch.where(r2 > 1e-12, r2, torch.ones_like(r2)), e_m,
                    s_m, mi.sum(), mol_mass, beta_t, cfg)
                    for rd, r2 in ((rd_o, r2_o), (rd_n, r2_n))]
            passes = (has_old + has_new) * na
            trace.append({"hit": hit, "margin": margin,
                          "pairs": passes * int(ok.sum()),
                          "in_old": int(in_o.sum()), "in_new": int(in_n.sum()),
                          "phases": passes * nk, "cols": int(ok.sum()),
                          "rss": [rss((in_o, rd_o), (in_n, rd_n)),
                                  KE * rss((in_o, es_o), (in_n, es_n)),
                                  rss((rec_t == rec_t, rec_t)),
                                  0.5 * KE * rss((ok, z_cols))]})
        if hit:
            rec[0, 1:6] = torch.tensor([1.0, mt, slot, spf, float(uk[12])],
                                       dtype=torch.float64)
            rec[0, 9:11] = torch.tensor([d_surr, lnb], dtype=torch.float64)
            rec[1, :6] = torch.tensor([drd, des, drec, dslf, dexc, dlrc],
                                      dtype=torch.float64)
            rec[2:5, :na] = new[:na].T.double()
            break
    rec[0, 0] = float(n_done)
    rec[0, 6:9] = torch.tensor(att[:3], dtype=torch.float64)
    rec[0, 11] = float(att[3])
    return rec


def run_steps_uvt_pda(pos, alive, eps, sig, charge, mass, polar, e0,
                      slot_start, slot_species, slot_alive, tmpl, natoms,
                      box, rc, alpha, beta, move_factor, rot_factor, thr2,
                      p_ins, lnfv, d_self, d_excl, c1, cx, uniforms, cfg,
                      kvecs=None, kcoef=None, sk_re=None, sk_im=None,
                      field_alpha=0.0, field_krc=0.0, cluster=None,
                      mol_mass=None, cav_list=None, cav_n=None, d_eta_ins=0.0,
                      d_eta_del=0.0, rot_f=None, spin=None, p_spin=0.0):
    """B6: up to K propose-and-filter µVT steps of one chain from a fixed
    state, frozen at the first stage-1 survivor of the polar delayed
    acceptance (csrc/pda_kernel.cu), on one cluster of G CTAs.

    The state: ``pos`` [N,3], atom ``alive`` [N] bool, ``slot_alive``
    [Ms] bool, the static field ``e0`` [N,3], ``sk_re``/``sk_im`` [Nk]
    (ewald) — read, never written.  As B1 (``run_steps_uvt``, one chain):
    per-atom ``eps``/``sig``/``charge``/``mass``, the slot table, ``tmpl``
    [S,A,3], ``natoms`` [S], the per-species ``lnfv``, ``d_self``,
    ``d_excl``, ``c1`` [S] and ``cx`` [S,S], ``box``, the scalars ``rc``,
    ``alpha``, ``beta`` (1/T), ``move_factor``, ``rot_factor``, ``thr2``,
    ``p_ins``, and ``kvecs``/``kcoef``.  Besides: the polarizabilities
    ``polar`` [N], and ``field_alpha``/``field_krc``, the screened field
    kernel's alpha and shift at rc (thole._field_variant_consts; unused
    for the direct field).  ``uniforms`` [K,16]: lane 4 the stage-1 coin,
    lane 12 the stage-2 coin recorded for the survivor.  ``cfg`` gives
    the physics (rd, coulomb, mixing, the Thole damping, polar_wolf /
    polar_ewald, ortho_box).  ``cluster``: G, one of CLUSTER_SIZES whose
    slice (with the polar planes) fits in shared memory (None:
    ``cluster_size`` for one chain).  ``mol_mass`` [N]: each atom's
    molecular mass, needed under feynman_hibbs / feynman_kleinert (at
    ``beta``).  Under ``cfg.cavity_bias``: ``cav_list`` [G^3] and
    ``cav_n`` [1] int32, the open cells (``pack_cavity``); under
    ``cfg.tmmc_bias``: ``d_eta_ins`` / ``d_eta_del``, eta(N + 1) - eta(N)
    and eta(N - 1) - eta(N) at the state's N (numbers or device scalars),
    added to the stage-1 test of an insert / a delete.  These run the
    kernel's XT instance; the record's lnb stays unbiased (with the
    cavity term).  Under ``cfg.quantum_rotation``: ``rot_f`` [Ms, 2]
    each slot's (F_para, F_ortho) in the kernel's dtype, ``spin`` [Ms]
    int32 and ``p_spin``: lane 11 < p_spin is a spinflip, which runs its
    full acceptance here (du = d_f, d* = 0, no pass); a surviving flip is
    recorded as move type 3 with zero deltas and rows (the XT instance).

    Returns the [8,16] float64 record in the reference's field order: row
    0 n_done, hit, mtype (0/1/2/3 displace/insert/delete/spinflip),
    slot_idx, species, u2, the attempts of displace/insert/delete, d_surr,
    lnb, the spinflip attempts; row 1 the deltas of rd, es_real,
    es_recip, es_self, es_excl and lrc; rows 2-4 the survivor's trial rows
    x/y/z in lanes 0..natoms-1.  Zero where no step survived."""
    args = (pos, alive, eps, sig, charge, mass, polar, e0, slot_start,
            slot_species, slot_alive, tmpl, natoms, box, rc, alpha, beta,
            move_factor, rot_factor, thr2, p_ins, lnfv, d_self, d_excl, c1,
            cx, uniforms, cfg)
    N = pos.shape[0]
    ms = slot_start.shape[0]
    ew = cfg.coulomb == "ewald"
    nk = kvecs.shape[0] if ew else 0
    quantum = quantum_option(cfg) > 0
    if pos.device.type == "cpu":
        if cluster is not None:      # checked, then ignored by the plain
            _check_cluster(cluster, N, pos.dtype, nk, ms,
                           "run_steps_uvt_pda", polar=True, quantum=quantum)
        return run_steps_uvt_pda_plain(
            *args, kvecs=kvecs, kcoef=kcoef, sk_re=sk_re, sk_im=sk_im,
            field_alpha=field_alpha, field_krc=field_krc, cluster=cluster,
            mol_mass=mol_mass, cav_list=cav_list, cav_n=cav_n,
            d_eta_ins=d_eta_ins, d_eta_del=d_eta_del, rot_f=rot_f,
            spin=spin, p_spin=p_spin)
    if pos.device.type != "cuda":
        raise ValueError(f"run_steps_uvt_pda: no kernel for {pos.device}")
    _refuse_pda(cfg)
    dt, dev = pos.dtype, pos.device
    qc, mm_ptr = _quantum_cols(mol_mass, cfg, N, dt, dev, "run_steps_uvt_pda")
    S, A = tmpl.shape[0], tmpl.shape[1]
    K = uniforms.shape[0]
    if A > MAX_SITES or S > MAX_SPECIES:
        raise ValueError(f"run_steps_uvt_pda: {S} species of {A} sites (the "
                         f"kernel takes <= {MAX_SPECIES} of <= {MAX_SITES})")
    _check("pos", pos, dt, (N, 3), dev)
    _check("alive", alive, torch.bool, (N,), dev)
    for nm, x in (("eps", eps), ("sig", sig), ("charge", charge),
                  ("mass", mass), ("polar", polar)):
        _check(nm, x, dt, (N,), dev)
    _check("e0", e0, dt, (N, 3), dev)
    _check("slot_start", slot_start, torch.int32, (ms,), dev)
    _check("slot_species", slot_species, torch.int32, (ms,), dev)
    _check("slot_alive", slot_alive, torch.bool, (ms,), dev)
    _check("tmpl", tmpl, dt, (S, A, 3), dev)
    _check("natoms", natoms, torch.int32, (S,), dev)
    for nm, x in (("lnfv", lnfv), ("d_self", d_self), ("d_excl", d_excl),
                  ("c1", c1)):
        _check(nm, x, dt, (S,), dev)
    _check("cx", cx, dt, (S, S), dev)
    _check("uniforms", uniforms, dt, (K, 16), dev)
    _check("box", box, dt, (3, 3), dev)
    if ew:
        _check("kvecs", kvecs, dt, (nk, 3), dev)
        _check("kcoef", kcoef, dt, (nk,), dev)
        sk = torch.stack([sk_re, sk_im]).to(dt).contiguous()       # [2,Nk]

    g, g3, _, _, cav, _, _ = _xt_check(cfg, "run_steps_uvt_pda", None,
                                       cav_list, cav_n, None, None, ms, dev,
                                       tmmc=False)
    bias = int(_pda_bias(cfg))
    sf = int(_spin_inputs(cfg, rot_f, spin, (), ms, dt, dev,
                          "run_steps_uvt_pda"))
    xt = int(bool(cav or bias or sf))
    # the XT instance reads the two tilts at scal[28], scal[29] and p_spin
    # at scal[30]
    scal = torch.cat([_scalar(x, dt, dev) for x in (
        rc, alpha, move_factor, rot_factor, thr2, p_ins, beta,
        cfg.polar_damp, field_alpha, field_krc)]
        + [box.reshape(-1), torch.linalg.inv_ex(box)[0].reshape(-1)]
        + ([_scalar(d_eta_ins, dt, dev), _scalar(d_eta_del, dt, dev),
            _scalar(p_spin if sf else 0.0, dt, dev)]
           if xt else [])).contiguous()
    rec = torch.zeros((8, 16), dtype=torch.float64, device=dev)
    field = _pda_field(cfg)
    from mpmc_tpu_torch.ops.cuda import _build
    lib = _build.library("pda_xt_kernel" if xt else "pda_kernel")
    G = _launch_cluster(lib, "pda_occupancy", cluster, 1, N, dt, nk, ms,
                        (N, nk, ms, A, field, int(quantum), xt),
                        "run_steps_uvt_pda", polar=True, quantum=quantum)
    fn = getattr(lib, "run_steps_uvt_pda_" + _suffix(dt))
    nullp = ctypes.c_void_p(None)
    err = fn(_ptr(pos), _ptr(alive), _ptr(eps), _ptr(sig), _ptr(charge),
             _ptr(mass), mm_ptr, _ptr(polar), _ptr(e0), _ptr(slot_start),
             _ptr(slot_species), _ptr(slot_alive), _ptr(tmpl), _ptr(natoms),
             _ptr(scal), _ptr(lnfv), _ptr(d_self), _ptr(d_excl), _ptr(c1),
             _ptr(cx), _ptr(uniforms), _ptr(kvecs) if ew else nullp,
             _ptr(kcoef) if ew else nullp, _ptr(sk) if ew else nullp,
             _ptr(rec), _ptr(cav_list) if cav else nullp,
             _ptr(cav_n) if cav else nullp, _ptr(rot_f) if sf else nullp,
             _ptr(spin) if sf else nullp, N, ms, S, A, K, nk, G,
             _RD[cfg.rd_potential], _MIX[cfg.mixing_rule], _ES[cfg.coulomb],
             int(bool(cfg.ortho_box)), tk._DAMP[cfg.polar_damp_type], field,
             qc, g, g3, cav, bias, sf, ctypes.c_double(KE),
             ctypes.c_double(HBAR2_KB_AMU_A2), _stream(dev))
    run_steps_uvt_pda.launches += 1
    run_steps_uvt_pda.last_cluster = G
    _raise_on(err, "run_steps_uvt_pda")
    return rec


run_steps_uvt_pda.launches = 0
run_steps_uvt_pda.last_cluster = None     # G of the last kernel launch


def reset_counts():
    """Zero the fused kernels' launch counters (B1, B3 and B6)."""
    run_steps_uvt.launches = 0
    run_steps.launches = 0
    run_steps_uvt_pda.launches = 0
