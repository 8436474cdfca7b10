"""Wrappers and plain versions of the two pair kernels (csrc/pair_kernel.cuh).

B2 ``pair_terms`` replaces ops/pallas/pair_kernel.py::_kernel (through
``pair_terms_tiles``/``pair_pass_pallas``): the triangular i<j pass over
all atoms, optionally restricted to rows >= row_start.  Raw output [9]:
[rd, es_real, es_excl, lrc] active, the same four frozen-frozen, min_r2
(no Coulomb constant).  One launch per call over a work list of the
TI x TJ tiles that hold a counted pair (``work_list``, built once per
(n, row_start, device) and kept), on as many CTAs as the card holds; each
tile's partials go to a kept slot (``pair_terms_scratch``) and the last
CTA adds them.

B4 ``mol_pair`` replaces ops/pallas/pair_kernel.py::_mol_kernel (through
``mol_pair_tiles``/``mol_pair_pass_pallas``): one molecule's <= 8 rows
(current or trial) against every column, its own columns masked.  Raw
output [4]: [rd, es_real, lrc, min_r2].  One launch per call, and it
allocates only its output: no partials leave the kernel.
``mol_pair_chains`` launches it over C chains (the batched scan chains,
the NPT chains, the rotor grid), raw output [C, 4].  Its scalar header is
one [20] row for every chain or a [C, 20] row per chain (NPT chains, each
its own box).  Its positions are each chain's own, or (position stride 0)
one system's that every chain reads: the C placements of one molecule
that ops/qrot.py prices over its orientation grid.  Two regimes
(``mol_pair_plan`` says which a launch takes): at stride 0 with C at or
above the card's ``grid_min`` a CTA holds 32 chains and streams the
columns through shared memory, each chunk serving all of them; every
other launch gives each chain a cluster of CTAs that meet in distributed
shared memory.  Both sum in one order, so chain c of any launch has the
bits of chain c launched alone.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor; anything else raises.  There is no
fallback from the kernel to the plain version.  ``launches`` on each
wrapper counts the kernel launches, and nothing else.

``supported(cfg)`` is the reference's static gate of both kernels
(ops/pallas/pair_kernel.py::supported without its float32 clause: these
kernels are templated on double too).  It refuses Feynman-Hibbs,
Feynman-Kleinert and coulomb gwp, so the reference's scan path runs its
jnp tile pass for them; ops/pairs.py then calls the plain versions here,
on the tensors' device, with ``qc`` — the atoms' molecular masses and the
temperature — or ``gwp``, the GWP widths.

The RD form is a compile-time parameter of both kernel bodies
(csrc/pair_kernel.cuh): ``pair_kernel.cu`` builds the classical instance
(rd none or lj, read at run time), ``pair_sg_kernel.cu``,
``pair_dreiding_kernel.cu``, ``pair_b14_7_kernel.cu`` and
``pair_disp_kernel.cu`` one form each (``FORM_LIBRARY``), whose entries
take the C6/C8/C10 columns (``disp``; disp_expansion reads them) and the
damping flag.

Both kernels are templated on float and double, so float64 decks run
through them too.  They use the exact erfc/erf, exp, pow and sqrt (the
Pallas kernels use a polynomial erfc; the plain versions and the jnp
reference use the exact one).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mpmc_tpu_torch.ops import pairs
from mpmc_tpu_torch.state import take

A_PAD = 8        # most rows a molecule may have (B4 row registers)
PT = 128         # B2 tile edge: rows = columns per tile (TI = TJ)
PLAIN_ROWS = 256  # row chunk of the plain full pass ([256, N] temporaries)
PLAIN_PAIRS = 1 << 23   # pairs of a block of B4's plain version at stride 0

_RD = {"none": 0, "lj": 1}       # the classical instance's run-time forms
_MIX = {"lb": 0, "waldman_hagler": 1}
_ES = {"none": 0, "ewald": 1, "wolf": 2, "cutoff": 3}
# the other RD forms, each the library of its own instance
FORM_LIBRARY = {"sg": "pair_sg_kernel", "dreiding": "pair_dreiding_kernel",
                "b14_7": "pair_b14_7_kernel",
                "disp_expansion": "pair_disp_kernel"}


def supported(cfg) -> bool:
    """Static gate: the configurations B2 and B4 cover — the reference's
    (mpmc_tpu/ops/pallas/pair_kernel.py:313-321) but for its float32
    clause."""
    return (cfg.rd_potential in ("lj", "none", "sg", "dreiding", "b14_7",
                                 "disp_expansion")
            and cfg.coulomb in ("ewald", "wolf", "cutoff", "none")
            and not cfg.feynman_hibbs
            and not cfg.feynman_kleinert
            and cfg.cdvdw_repulsion == "none")


def _opts(cfg):
    """(library, entry suffix, option ints) of a cfg's instance: the
    classical library's (rd, mix, es, lrc), or a form library's (damp,
    mix, es, lrc) — its form is its own, its first option the damping of
    disp_expansion.  Raises where the gate refuses."""
    if not supported(cfg) or cfg.mixing_rule not in _MIX:
        raise ValueError("pair kernels: refused by their gate (supported); "
                         "feynman_hibbs / feynman_kleinert / coulomb gwp "
                         "run the plain pass")
    tail = (_MIX[cfg.mixing_rule], _ES[cfg.coulomb],
            int(pairs.lrc_on(cfg)))
    if cfg.rd_potential in _RD:
        return "pair_kernel", "", (_RD[cfg.rd_potential],) + tail
    return (FORM_LIBRARY[cfg.rd_potential], "_rd",
            (int(bool(cfg.damp_dispersion)),) + tail)


def _disp_args(cfg, disp, n, dt, dev):
    """The C6/C8/C10 column pointers of a form library's launch: ``disp``
    (checked) or, for a form that reads none, null pointers;
    disp_expansion needs them."""
    if disp is None:
        if cfg.rd_potential == "disp_expansion":
            raise ValueError("pair kernels: disp_expansion needs the "
                             "C6/C8/C10 columns (disp=)")
        return [ctypes.c_void_p(None)] * 3
    for nm, t in zip(("c6", "c8", "c10"), disp):
        _check(nm, t, dt, (n,), dev)
    return [_ptr(t) for t in disp]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _rows_of(idx, disp, gwp):
    """(disp, gwp) of pairs._block_terms for the rows ``idx`` against
    every column, from the per-atom columns (each None where off)."""
    return (None if disp is None
            else (tuple(c[idx] for c in disp), tuple(disp)),
            None if gwp is None else (gwp[idx], gwp))


def pair_terms_plain(pos, charge, eps, sig, mol_id, alive, frozen, scal,
                     cfg, row_start=0, qc=None, disp=None, gwp=None):
    """Plain B2: row blocks of dense [B, N] masks (pairs._block_terms).
    ``qc``: (the atoms' molecular masses [N], the temperature) for a
    Feynman-Hibbs/Kleinert cfg; ``disp``: the (c6, c8, c10) columns [N]
    for disp_expansion; ``gwp``: the GWP widths [N] for coulomb gwp."""
    n = pos.shape[0]
    out = torch.zeros(pairs.N_SLOTS, dtype=pos.dtype, device=pos.device)
    out[8] = float("inf")
    for i0 in range(row_start, n, PLAIN_ROWS):
        rows = torch.arange(i0, min(i0 + PLAIN_ROWS, n), device=pos.device)
        d, g = _rows_of(rows, disp, gwp)
        t = pairs._block_terms(
            pos[rows], rows, alive[rows], mol_id[rows], frozen[rows],
            charge[rows], eps[rows], sig[rows], pos, alive, mol_id, frozen,
            charge, eps, sig, scal, cfg, triangular=True,
            row_start=row_start,
            qc=None if qc is None else (qc[0][rows], qc[0], qc[1]),
            disp=d, gwp=g)
        out = torch.cat([out[:8] + t[:8], torch.minimum(out[8:], t[8:])])
    return out


def mol_pair_plain(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                   mol_natoms, mol, rows, scal, cfg, qc=None, disp=None,
                   gwp=None):
    """Plain B4: the molecule's [A, N] block (pairs._block_terms).
    ``qc``: (the atoms' molecular masses [N], the temperature) for a
    Feynman-Hibbs/Kleinert cfg; ``disp``, ``gwp`` as in
    pair_terms_plain."""
    idx = take(mol_atoms, mol)
    a = idx.shape[0]
    valid = torch.arange(a, device=pos.device) < take(mol_natoms, mol)
    row_pos = pos[idx] if rows is None else rows
    col_ok = alive & (mol_id != mol)
    no = torch.zeros(a, dtype=torch.bool, device=pos.device)
    d, g = _rows_of(idx, disp, gwp)
    t = pairs._block_terms(
        row_pos, None, valid, mol_id[idx], no, charge[idx], eps[idx],
        sig[idx], pos, col_ok, mol_id, torch.zeros_like(alive), charge, eps,
        sig, scal, cfg, triangular=False,
        qc=None if qc is None else (qc[0][idx], qc[0], qc[1]), disp=d,
        gwp=g)
    return t[[0, 1, 3, 8]]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, t, dtype, shape=None, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, kernel runs on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"pair kernels take float32 or float64, not {dtype}")


def tiles_with_pairs(n, row_start):
    """The tiles (I, J) of PT x PT that hold a pair B2 counts — i >=
    row_start, and j > i or j < row_start — as int32 I * nt + J in
    row-major order (nt = ceil(n / PT)), a host numpy array.  Row tile I
    holds rows [max(I PT, row_start), min((I + 1) PT, n)), column tile J
    columns [J PT, min((J + 1) PT, n)): a pair j > i exists when the last
    column exceeds the first row, one j < row_start when the first column
    lies below row_start."""
    nt = -(-n // PT)
    tiles = np.arange(nt * nt, dtype=np.int64)
    I, J = tiles // max(nt, 1), tiles % max(nt, 1)
    lo = np.maximum(I * PT, row_start)
    hi = np.minimum((I + 1) * PT, n) - 1
    jhi = np.minimum((J + 1) * PT, n) - 1
    has = (lo <= hi) & ((jhi > lo) | (J * PT < row_start))
    return tiles[has].astype(np.int32)


_lists: dict = {}


def work_list(n, row_start, device):
    """B2's work list of ``tiles_with_pairs(n, row_start)`` on ``device``
    (int32 [W]), built once per (n, row_start, device) and kept: the list
    depends on nothing else, so a call copies nothing to the card."""
    key = (int(n), int(row_start), torch.device(device))
    if key not in _lists:
        _lists[key] = torch.as_tensor(tiles_with_pairs(n, row_start),
                                      device=device)
    return _lists[key]


_pair_scratch: dict = {}
_pair_config: dict = {}


def pair_terms_scratch(device, dtype, w):
    """(part [>= w, 8] double, pmin [>= w], ticket [1] int32, zero
    between launches): B2's tile partials on ``device``, grown to the
    largest list and kept.  Calls share them in stream order (the port
    launches every kernel on one stream)."""
    have = _pair_scratch.get((device, dtype))
    if have is None or have[1].numel() < w:
        have = (torch.empty((w, 8), dtype=torch.float64, device=device),
                torch.empty(w, dtype=dtype, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        _pair_scratch[(device, dtype)] = have
    return have


def card_ctas(device, dtype, library="pair_kernel", sfx=""):
    """The B2 CTAs the card holds at once, queried once per device, type
    and instance (``library``: pair_kernel or a FORM_LIBRARY one, whose
    entries end in ``sfx`` "_rd")."""
    key = (device, dtype, library)
    if key not in _pair_config:
        from mpmc_tpu_torch.ops.cuda import _build
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(device):
            err = getattr(_build.library(library),
                          f"pair_config{sfx}_" + _suffix(dtype))(out)
        _raise_on(err, "pair_config")
        if out[0] <= 0:
            raise RuntimeError("pair_terms: no CTA fits on the card")
        _pair_config[key] = out[0]
    return _pair_config[key]


def pair_terms(pos, charge, eps, sig, mol_id, alive, frozen, scal, cfg,
               row_start=0, disp=None):
    """B2: raw [9] full-pass sums (module docstring).  ``mol_id`` int32,
    ``alive``/``frozen`` bool, ``scal`` = pairs.pair_scalars, ``disp``
    the (c6, c8, c10) columns [N] (disp_expansion needs them)."""
    if pos.device.type == "cpu":
        return pair_terms_plain(pos, charge, eps, sig, mol_id, alive,
                                frozen, scal, cfg, row_start=row_start,
                                disp=disp)
    if pos.device.type != "cuda":
        raise ValueError(f"pair_terms: no kernel for {pos.device}")
    n = pos.shape[0]
    dt, dev = pos.dtype, pos.device
    _check("pos", pos, dt, (n, 3))
    for nm, t in (("charge", charge), ("eps", eps), ("sig", sig)):
        _check(nm, t, dt, (n,), dev)
    _check("mol_id", mol_id, torch.int32, (n,), dev)
    _check("alive", alive, torch.bool, (n,), dev)
    _check("frozen", frozen, torch.bool, (n,), dev)
    _check("scal", scal, dt, (20,), dev)
    lib, sfx, opts = _opts(cfg)
    extra = _disp_args(cfg, disp, n, dt, dev) if sfx else []
    out = torch.empty(pairs.N_SLOTS, dtype=dt, device=dev)
    wl = work_list(n, row_start, dev)
    w = wl.numel()
    if w == 0:                        # no row at or past row_start
        out.zero_()
        out[8] = float("inf")
        return out
    part, pmin, ticket = pair_terms_scratch(dev, dt, w)
    grid = min(card_ctas(dev, dt, lib, sfx), w)
    from mpmc_tpu_torch.ops.cuda import _build
    fn = getattr(_build.library(lib), f"pair_terms{sfx}_" + _suffix(dt))
    err = fn(_ptr(pos), _ptr(charge), _ptr(eps), _ptr(sig), _ptr(mol_id),
             _ptr(alive), _ptr(frozen), _ptr(scal), _ptr(wl), w, -(-n // PT),
             n, int(row_start), *opts, grid, _ptr(part), _ptr(pmin),
             _ptr(ticket), _ptr(out), *extra, _stream(dev))
    pair_terms.launches += 1
    _raise_on(err, "pair_terms")
    return out


pair_terms.launches = 0


def _launch_mol_pair(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                     mol_natoms, mol, rows, scal, cfg, disp=None):
    """One B4 launch over C = mol.shape[0] chains (mol [C], rows [C, A, 3]
    or None, scal [20] shared or [C, 20] per chain): raw [C, 4].  ``pos``
    [C, N, 3] with ``alive`` [C, N] gives each chain its own (position
    stride N 3); ``pos`` [N, 3] with ``alive`` [N] is read by every chain
    (stride 0: one molecule's orientations, qrot.potentials_on_grid)."""
    C = mol.shape[0]
    shared = pos.ndim == 2
    n = pos.shape[-2]
    dt, dev = pos.dtype, pos.device
    m, a = mol_atoms.shape
    if a > A_PAD:
        raise ValueError(f"mol_pair: molecules of {a} atoms > A_PAD={A_PAD}")
    if C < 1:
        raise ValueError(f"mol_pair: {C} chains")
    _check("pos", pos, dt, (n, 3) if shared else (C, n, 3))
    for nm, t in (("charge", charge), ("eps", eps), ("sig", sig)):
        _check(nm, t, dt, (n,), dev)
    _check("mol_id", mol_id, torch.int32, (n,), dev)
    _check("alive", alive, torch.bool, (n,) if shared else (C, n), dev)
    _check("mol_atoms", mol_atoms, torch.int64, (m, a), dev)
    _check("mol_natoms", mol_natoms, torch.int64, (m,), dev)
    _check("mol", mol, torch.int64, (C,), dev)
    if rows is not None:
        _check("rows", rows, dt, (C, a, 3), dev)
    _check("scal", scal, dt, (C, 20) if scal.ndim == 2 else (20,), dev)
    lib, sfx, opts = _opts(cfg)
    extra = _disp_args(cfg, disp, n, dt, dev) if sfx else []
    out = torch.empty((C, 4), dtype=dt, device=dev)
    from mpmc_tpu_torch.ops.cuda import _build
    fn = getattr(_build.library(lib), f"mol_pair{sfx}_" + _suffix(dt))
    err = fn(_ptr(pos), _ptr(charge), _ptr(eps), _ptr(sig), _ptr(mol_id),
             _ptr(alive), 0 if shared else 3 * n, _ptr(mol_atoms),
             _ptr(mol_natoms), _ptr(mol),
             ctypes.c_void_p(None if rows is None else rows.data_ptr()),
             a, _ptr(scal), 20 if scal.ndim == 2 else 0, n, C, *opts,
             _ptr(out), *extra, _stream(dev))
    _raise_on(err, "mol_pair")
    return out


def mol_pair_plan(n, C, shared, dtype, cfg):
    """B4's launch shape on the card for n columns and C chains
    (``shared``: position stride 0), from the kernel library of ``cfg``'s
    form: {"regime": 1 or 2, "per": chains a warp (regime 1) or CTAs a
    chain (regime 2), "ctas", "smem" (dynamic shared memory bytes),
    "grid_min" (the fewest stride-0 chains that take regime 1)}."""
    from mpmc_tpu_torch.ops.cuda import _build
    lib, sfx, _ = _opts(cfg)
    out = (ctypes.c_int * 5)()
    err = getattr(_build.library(lib), f"mol_pair_plan{sfx}_"
                  + _suffix(dtype))(int(n), int(C), int(bool(shared)), out)
    _raise_on(err, "mol_pair_plan")
    return dict(zip(("regime", "per", "ctas", "smem", "grid_min"),
                    list(out)))


def mol_pair(pos, charge, eps, sig, mol_id, alive, mol_atoms, mol_natoms,
             mol, rows, scal, cfg, disp=None):
    """B4: raw [4] one-molecule sums (module docstring).  ``mol`` is a
    0-d int64 tensor (read on the device — no host sync); ``rows`` are
    trial coordinates [A, 3] or None for the molecule's current rows;
    ``disp`` the (c6, c8, c10) columns [N] (disp_expansion needs them)."""
    if pos.device.type == "cpu":
        return mol_pair_plain(pos, charge, eps, sig, mol_id, alive,
                              mol_atoms, mol_natoms, mol, rows, scal, cfg,
                              disp=disp)
    if pos.device.type != "cuda":
        raise ValueError(f"mol_pair: no kernel for {pos.device}")
    _check("mol", mol, torch.int64, (), pos.device)
    out = _launch_mol_pair(pos[None], charge, eps, sig, mol_id, alive[None],
                           mol_atoms, mol_natoms, mol.reshape(1),
                           None if rows is None else rows[None], scal, cfg,
                           disp)
    mol_pair.launches += 1
    return out[0]


mol_pair.launches = 0


def mol_pair_chains_plain(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                          mol_natoms, mol, rows, scal, cfg, qc=None,
                          disp=None, gwp=None):
    """Plain B4 over chains: ``mol_pair_plain`` of each chain with its
    header row (``scal`` [C, 20]) or the shared one ([20]), stacked;
    ``qc``'s temperature 0-d or one per chain [C]; ``disp``, ``gwp`` as
    in pair_terms_plain.  With ``pos`` [N, 3] and ``alive`` [N] shared by
    every chain (position stride 0) and trial ``rows`` [C, A, 3], one
    batched [C, A, N] block (``_mol_pair_shared_plain``)."""
    if pos.ndim == 2:
        return _mol_pair_shared_plain(pos, charge, eps, sig, mol_id, alive,
                                      mol_atoms, mol_natoms, mol, rows,
                                      scal, cfg, qc, disp, gwp)

    def chain_qc(c):
        if qc is None:
            return None
        t = qc[1]
        return qc[0], (t[c] if torch.is_tensor(t) and t.ndim else t)

    return torch.stack([
        mol_pair_plain(pos[c], charge, eps, sig, mol_id, alive[c],
                       mol_atoms, mol_natoms, mol[c],
                       None if rows is None else rows[c],
                       scal[c] if scal.ndim == 2 else scal, cfg,
                       qc=chain_qc(c), disp=disp, gwp=gwp)
        for c in range(mol.shape[0])])


def _mol_pair_shared_plain(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                           mol_natoms, mol, rows, scal, cfg, qc=None,
                           disp=None, gwp=None):
    """Plain B4 at position stride 0: each chain's rows [C, A, 3] against
    the one ``pos`` [N, 3] and ``alive`` [N], the masks and sums of
    ``pairs._block_terms`` (rd, es within rc; the tail coefficient and
    the closest approach over every inter pair), raw [C, 4]; a shared
    [20] header.  Under a Feynman-Hibbs/Kleinert cfg ``qc`` = (the atoms'
    molecular masses [N], the temperature).  The chains go in blocks of
    [c, A, N] <= PLAIN_PAIRS pairs, each chain's row the same in any
    block."""
    a = mol_atoms.shape[1]
    step = max(1, PLAIN_PAIRS // max(a * pos.shape[0], 1))
    if mol.shape[0] <= step:
        return _mol_pair_block_plain(pos, charge, eps, sig, mol_id, alive,
                                     mol_atoms, mol_natoms, mol, rows, scal,
                                     cfg, qc, disp, gwp)
    return torch.cat([
        _mol_pair_block_plain(pos, charge, eps, sig, mol_id, alive,
                              mol_atoms, mol_natoms, mol[c0:c0 + step],
                              None if rows is None else rows[c0:c0 + step],
                              scal, cfg, qc, disp, gwp)
        for c0 in range(0, mol.shape[0], step)])


def _mol_pair_block_plain(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                          mol_natoms, mol, rows, scal, cfg, qc, disp, gwp):
    """_mol_pair_shared_plain of one block of chains."""
    from mpmc_tpu_torch.ops import pbc
    idx = mol_atoms[mol]                                           # [C,A]
    a = idx.shape[1]
    valid = (torch.arange(a, device=pos.device)[None, :]
             < mol_natoms[mol][:, None])
    row_pos = pos[idx] if rows is None else rows
    rc, alpha = scal[0], scal[1]
    dr = pbc.min_image(row_pos[:, :, None, :] - pos[None, None, :, :],
                       scal[2:11].reshape(3, 3), scal[11:20].reshape(3, 3))
    r2 = torch.sum(dr * dr, dim=-1)                                # [C,A,N]
    col_ok = alive[None, :] & (mol_id[None, :] != mol[:, None])     # [C,N]
    inter = valid[:, :, None] & col_ok[:, None, :]
    act = inter & (r2 < rc * rc)
    q3 = None
    if pairs.quantum(cfg):
        if qc is None:
            raise ValueError("feynman_hibbs / feynman_kleinert pair terms "
                             "need the molecular masses and the temperature")
        q3 = (qc[0][idx][..., None], qc[0], qc[1])
    d, g = _rows_of(idx, disp, gwp)
    if d is not None:
        d = (tuple(c[..., None] for c in d[0]), d[1])
    if g is not None:
        g = (g[0][..., None], g[1])
    rd_u, es_u, _, tc = pairs._tile_values(
        r2, charge[idx][..., None], eps[idx][..., None], sig[idx][..., None],
        charge, eps, sig, cfg, rc, alpha, q3, d, g)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

    def s(values, mask):
        if values is None:
            return torch.zeros(mol.shape[0], dtype=pos.dtype,
                               device=pos.device)
        return torch.sum(torch.where(mask, values, zero), dim=(1, 2))

    mn = torch.where(inter, r2, torch.full_like(r2, math.inf)).amin(
        dim=(1, 2))
    return torch.stack([s(rd_u, act), s(es_u, act), s(tc, inter), mn], -1)


def mol_pair_chains(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                    mol_natoms, mol, rows, scal, cfg, disp=None):
    """B4 over C chains in one launch (the batched scan step's per-move
    delta): pos [C, N, 3], alive [C, N], mol [C] int64, rows [C, A, 3] or
    None; the parameter columns are shared; ``scal`` a shared [20] header
    or one [C, 20] row per chain.  Raw [C, 4]; chain c's row is
    ``mol_pair`` of chain c with its header, bit for bit.  With ``pos``
    [N, 3] and ``alive`` [N] every chain reads the same positions
    (position stride 0; the rotor grid of qrot.potentials_on_grid): C =
    mol.shape[0] rows of trial coordinates against one system, each
    chain's row ``mol_pair`` of its rows bit for bit.  ``disp`` as in
    mol_pair."""
    if pos.device.type == "cpu":
        return mol_pair_chains_plain(pos, charge, eps, sig, mol_id, alive,
                                     mol_atoms, mol_natoms, mol, rows, scal,
                                     cfg, disp=disp)
    if pos.device.type != "cuda":
        raise ValueError(f"mol_pair_chains: no kernel for {pos.device}")
    out = _launch_mol_pair(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                           mol_natoms, mol, rows, scal, cfg, disp)
    mol_pair_chains.launches += 1
    mol_pair_chains.shared_launches += int(pos.ndim == 2)
    return out


mol_pair_chains.launches = 0
mol_pair_chains.shared_launches = 0     # of them at position stride 0


def reset_counts():
    """Zero the kernels' launch counters."""
    pair_terms.launches = 0
    mol_pair.launches = 0
    mol_pair_chains.launches = 0
    mol_pair_chains.shared_launches = 0
