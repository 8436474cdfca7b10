"""Wrappers and plain versions of the two pair kernels (csrc/pair_kernel.cu).

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
output [4]: [rd, es_real, lrc, min_r2].  One launch per call: its last
block reduces the blocks' partials, held in scratch kept per device and
type (``mol_pair_scratch``), so a move allocates only its output.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor; anything else raises.  There is no
fallback from the kernel to the plain version.  ``launches`` on each
wrapper counts the kernel launches, and nothing else.

Both kernels are templated on float and double, so float64 decks run
through them too.  They use the exact erfc/erf (the Pallas kernels use a
polynomial; the plain versions and the jnp reference use the exact one).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mpmc_tpu_torch.ops import pairs
from mpmc_tpu_torch.state import take

A_PAD = 8        # most rows a molecule may have (B4 row registers)
PT = 128         # B2 tile edge: rows = columns per tile (TI = TJ)
MT = 256         # B4 columns per block
PLAIN_ROWS = 256  # row chunk of the plain full pass ([256, N] temporaries)

_RD = {"none": 0, "lj": 1}
_MIX = {"lb": 0, "waldman_hagler": 1}
_ES = {"none": 0, "ewald": 1, "wolf": 2, "cutoff": 3}


def _opts(cfg):
    """Kernel option ints (rd, mix, es, lrc); raises on what the kernels
    do not implement."""
    if cfg.rd_potential not in _RD or cfg.coulomb not in _ES:
        raise NotImplementedError(
            f"pair kernels: rd {cfg.rd_potential!r} / coulomb "
            f"{cfg.coulomb!r} not ported")
    return (_RD[cfg.rd_potential], _MIX[cfg.mixing_rule],
            _ES[cfg.coulomb], int(cfg.rd_lrc and cfg.rd_potential == "lj"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pair_terms_plain(pos, charge, eps, sig, mol_id, alive, frozen, scal,
                     cfg, row_start=0):
    """Plain B2: row blocks of dense [B, N] masks (pairs._block_terms)."""
    n = pos.shape[0]
    out = torch.zeros(pairs.N_SLOTS, dtype=pos.dtype, device=pos.device)
    out[8] = float("inf")
    for i0 in range(row_start, n, PLAIN_ROWS):
        rows = torch.arange(i0, min(i0 + PLAIN_ROWS, n), device=pos.device)
        t = pairs._block_terms(
            pos[rows], rows, alive[rows], mol_id[rows], frozen[rows],
            charge[rows], eps[rows], sig[rows], pos, alive, mol_id, frozen,
            charge, eps, sig, scal, cfg, triangular=True,
            row_start=row_start)
        out = torch.cat([out[:8] + t[:8], torch.minimum(out[8:], t[8:])])
    return out


def mol_pair_plain(pos, charge, eps, sig, mol_id, alive, mol_atoms,
                   mol_natoms, mol, rows, scal, cfg):
    """Plain B4: the molecule's [A, N] block (pairs._block_terms)."""
    idx = take(mol_atoms, mol)
    a = idx.shape[0]
    valid = torch.arange(a, device=pos.device) < take(mol_natoms, mol)
    row_pos = pos[idx] if rows is None else rows
    col_ok = alive & (mol_id != mol)
    no = torch.zeros(a, dtype=torch.bool, device=pos.device)
    t = pairs._block_terms(
        row_pos, None, valid, mol_id[idx], no, charge[idx], eps[idx],
        sig[idx], pos, col_ok, mol_id, torch.zeros_like(alive), charge, eps,
        sig, scal, cfg, triangular=False)
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


def card_ctas(device, dtype):
    """The B2 CTAs the card holds at once, queried once per device and
    type."""
    key = (device, dtype)
    if key not in _pair_config:
        from mpmc_tpu_torch.ops.cuda import _build
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(device):
            err = getattr(_build.library("pair_kernel"),
                          "pair_config_" + _suffix(dtype))(out)
        _raise_on(err, "pair_config")
        if out[0] <= 0:
            raise RuntimeError("pair_terms: no CTA fits on the card")
        _pair_config[key] = out[0]
    return _pair_config[key]


def pair_terms(pos, charge, eps, sig, mol_id, alive, frozen, scal, cfg,
               row_start=0):
    """B2: raw [9] full-pass sums (module docstring).  ``mol_id`` int32,
    ``alive``/``frozen`` bool, ``scal`` = pairs.pair_scalars."""
    if pos.device.type == "cpu":
        return pair_terms_plain(pos, charge, eps, sig, mol_id, alive,
                                frozen, scal, cfg, row_start=row_start)
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
    rd, mix, es, lrc = _opts(cfg)
    out = torch.empty(pairs.N_SLOTS, dtype=dt, device=dev)
    wl = work_list(n, row_start, dev)
    w = wl.numel()
    if w == 0:                        # no row at or past row_start
        out.zero_()
        out[8] = float("inf")
        return out
    part, pmin, ticket = pair_terms_scratch(dev, dt, w)
    grid = min(card_ctas(dev, dt), w)
    from mpmc_tpu_torch.ops.cuda import _build
    fn = getattr(_build.library("pair_kernel"), "pair_terms_" + _suffix(dt))
    err = fn(_ptr(pos), _ptr(charge), _ptr(eps), _ptr(sig), _ptr(mol_id),
             _ptr(alive), _ptr(frozen), _ptr(scal), _ptr(wl), w, -(-n // PT),
             n, int(row_start), rd, mix, es, lrc, grid, _ptr(part),
             _ptr(pmin), _ptr(ticket), _ptr(out), _stream(dev))
    pair_terms.launches += 1
    _raise_on(err, "pair_terms")
    return out


pair_terms.launches = 0


_mol_scratch: dict = {}


def mol_pair_scratch(device, dtype, nb):
    """(part [>= nb, 3] double, pmin [>= nb], ticket [1] int32, zero
    between launches): B4's block partials on ``device``, grown to the
    largest call and kept.  Calls share them in stream order (the port
    launches every kernel on one stream)."""
    have = _mol_scratch.get((device, dtype))
    if have is None or have[1].numel() < nb:
        have = (torch.empty((nb, 3), dtype=torch.float64, device=device),
                torch.empty(nb, dtype=dtype, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        _mol_scratch[(device, dtype)] = have
    return have


def mol_pair(pos, charge, eps, sig, mol_id, alive, mol_atoms, mol_natoms,
             mol, rows, scal, cfg):
    """B4: raw [4] one-molecule sums (module docstring).  ``mol`` is a
    0-d int64 tensor (read on the device — no host sync); ``rows`` are
    trial coordinates [A, 3] or None for the molecule's current rows."""
    if pos.device.type == "cpu":
        return mol_pair_plain(pos, charge, eps, sig, mol_id, alive,
                              mol_atoms, mol_natoms, mol, rows, scal, cfg)
    if pos.device.type != "cuda":
        raise ValueError(f"mol_pair: no kernel for {pos.device}")
    n = pos.shape[0]
    dt, dev = pos.dtype, pos.device
    m, a = mol_atoms.shape
    if a > A_PAD:
        raise ValueError(f"mol_pair: molecules of {a} atoms > A_PAD={A_PAD}")
    _check("pos", pos, dt, (n, 3))
    for nm, t in (("charge", charge), ("eps", eps), ("sig", sig)):
        _check(nm, t, dt, (n,), dev)
    _check("mol_id", mol_id, torch.int32, (n,), dev)
    _check("alive", alive, torch.bool, (n,), dev)
    _check("mol_atoms", mol_atoms, torch.int64, (m, a), dev)
    _check("mol_natoms", mol_natoms, torch.int64, (m,), dev)
    _check("mol", mol, torch.int64, (), dev)
    if rows is not None:
        _check("rows", rows, dt, (a, 3), dev)
    _check("scal", scal, dt, (20,), dev)
    rd, mix, es, lrc = _opts(cfg)
    part, pmin, ticket = mol_pair_scratch(dev, dt, max(-(-n // MT), 1))
    out = torch.empty(4, dtype=dt, device=dev)
    from mpmc_tpu_torch.ops.cuda import _build
    fn = getattr(_build.library("pair_kernel"), "mol_pair_" + _suffix(dt))
    err = fn(_ptr(pos), _ptr(charge), _ptr(eps), _ptr(sig), _ptr(mol_id),
             _ptr(alive), _ptr(mol_atoms), _ptr(mol_natoms), _ptr(mol),
             ctypes.c_void_p(None if rows is None else rows.data_ptr()),
             a, _ptr(scal), n, rd, mix, es, lrc, _ptr(part), _ptr(pmin),
             _ptr(ticket), _ptr(out), _stream(dev))
    mol_pair.launches += 1
    _raise_on(err, "mol_pair")
    return out


mol_pair.launches = 0


def reset_counts():
    """Zero both kernels' launch counters."""
    pair_terms.launches = 0
    mol_pair.launches = 0
