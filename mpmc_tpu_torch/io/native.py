"""ctypes bindings of the port's native PQR writer (csrc/pqr_io.cpp).

The per-corrtime restart, trajectory and per-chain writes go through one
C call per frame: ``write_frame_arrays`` takes the packed arrays that
io/pqr.py::write_state builds from one host copy of the alive rows;
``write_frame`` packs a list of PqrAtom for it.  The library is built with
g++ at first use into ``build/mpmc_tpu_torch/`` (ops/cuda/_build.py::
host_library) and a failed build raises: there is no fallback to the
Python writer, which stays as the plain version the tests compare with.
"""
from __future__ import annotations

import ctypes

import numpy as np

NAME_LEN = 8     # fixed width of a name in the packed name buffers


def _lib():
    from mpmc_tpu_torch.ops.cuda import _build
    return _build.host_library("pqr_io")


def fixed_names(names) -> bytes:
    """``names`` as one buffer of NAME_LEN bytes each (cut to 7 characters
    and NUL-padded, as the writer reads them)."""
    return np.asarray([n.encode()[:NAME_LEN - 1] for n in names],
                      dtype=f"S{NAME_LEN}").tobytes()


def write_frame_arrays(path: str, num: np.ndarray, ids: np.ndarray,
                       flags: bytes, names: bytes, mol_names: bytes,
                       mode: str = "w", remark: str = "",
                       extended: bool = False) -> None:
    """One PQR frame from packed arrays: num [n,13] float64 (x y z mass
    charge polar eps sig omega c6 c8 c10 gwp_alpha), ids [n,2] int64
    (serial, mol_id), flags [n] bytes, names/mol_names [n * NAME_LEN]
    fixed-width bytes.  Raises if the file cannot be written."""
    n = num.shape[0]
    num = np.ascontiguousarray(num, np.float64)
    ids = np.ascontiguousarray(ids, np.int64)
    if num.shape != (n, 13) or ids.shape != (n, 2):
        raise ValueError(f"write_frame_arrays: num {num.shape}, ids "
                         f"{ids.shape}; expected ({n}, 13), ({n}, 2)")
    if not (len(flags) == n and len(names) == len(mol_names)
            == n * NAME_LEN):
        raise ValueError("write_frame_arrays: flags/names of the wrong "
                         "length")
    r = _lib().pqr_write_frame(
        path.encode(), mode.encode(), remark.encode(), n,
        ctypes.c_void_p(num.ctypes.data), ctypes.c_void_p(ids.ctypes.data),
        flags, names, mol_names, int(extended))
    if r != n:
        raise OSError(f"native PQR writer: cannot write {path}")


def write_frame(path: str, atoms, mode: str = "w", remark: str = "",
                extended: bool = False) -> None:
    """One PQR frame from a list of PqrAtom (the reference's
    io/native.py::write_frame)."""
    n = len(atoms)
    num = np.empty((n, 13), np.float64)
    ids = np.empty((n, 2), np.int64)
    flags = bytearray(n)
    for k, a in enumerate(atoms):
        num[k, :3] = a.xyz
        num[k, 3:] = (a.mass, a.charge, a.polar, a.eps, a.sig, a.omega,
                      a.c6, a.c8, a.c10, a.gwp_alpha)
        ids[k] = (a.serial, a.mol_id)
        flags[k] = ord(a.flag[0]) if a.flag else ord("M")
    write_frame_arrays(path, num, ids, bytes(flags),
                       fixed_names([a.name for a in atoms]),
                       fixed_names([a.mol_name for a in atoms]),
                       mode=mode, remark=remark, extended=extended)
