"""ctypes bindings of the port's native PQR codec (csrc/pqr_io.cpp).

Reading: ``stream_frames_arrays`` parses a trajectory one frame at a time
into packed arrays (``ensemble replay``, mc/run.py::run_replay);
``frame_from_arrays`` turns one into a PqrFrame.  Writing: the
per-corrtime restart, trajectory and per-chain writes go through one C
call per frame: ``write_frame_arrays`` takes the packed arrays that
io/pqr.py::write_state builds from one host copy of the alive rows;
``write_frame`` packs a list of PqrAtom for it.  The library is built with
g++ at first use into ``build/mpmc_tpu_torch/`` (ops/cuda/_build.py::
host_library) and a failed build raises: there is no fallback to the
Python reader or writer (io/pqr.py), which stay as the plain versions the
tests compare with.
"""
from __future__ import annotations

import ctypes
import os

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


def _frame_arrays(lib, h, n: int):
    """The packed arrays of the handle's current frame of ``n`` atoms."""
    num = np.empty((n, 13), np.float64)
    ids = np.empty((n, 2), np.int64)
    flags = ctypes.create_string_buffer(max(n, 1))
    names = ctypes.create_string_buffer(max(NAME_LEN * n, 1))
    mnames = ctypes.create_string_buffer(max(NAME_LEN * n, 1))
    lib.pqr_frame_data(h, ctypes.c_void_p(num.ctypes.data),
                       ctypes.c_void_p(ids.ctypes.data), flags, names,
                       mnames)
    box = None
    cell = (ctypes.c_double * 6)()
    if lib.pqr_frame_cell(h, cell):
        from mpmc_tpu_torch.ops.pbc import cell_from_abc
        box = cell_from_abc(*list(cell))
    return {"num": num, "ids": ids, "flags": flags.raw[:n],
            "names": names.raw[:NAME_LEN * n],
            "mol_names": mnames.raw[:NAME_LEN * n], "box": box}


def stream_frames_arrays(path: str):
    """Generator of one dict per frame of the trajectory at ``path``, ONE
    frame in memory at a time: num [n,13] float64 (x y z mass charge polar
    eps sig omega c6 c8 c10 gwp_alpha), ids [n,2] int64 (serial, mol_id),
    flags bytes [n], names / mol_names bytes [n * NAME_LEN], box (3,3)
    from the frame's CRYST1 record or None.  Raises FileNotFoundError for
    a missing file and ValueError on a malformed line."""
    lib = _lib()
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    def gen():
        h = lib.pqr_open_stream(path.encode())
        if not h:
            raise FileNotFoundError(path)
        try:
            while True:
                n = lib.pqr_stream_advance(h)
                if n == 0:
                    return
                if n < 0:
                    err = lib.pqr_error(h)
                    raise ValueError(
                        f"{path}: {err.decode() if err else 'parse error'}")
                yield _frame_arrays(lib, h, n)
        finally:
            lib.pqr_close(h)

    return gen()


def decode_name(buf: bytes, k: int) -> str:
    """The k-th NUL-padded name of a packed name buffer."""
    return buf[k * NAME_LEN:(k + 1) * NAME_LEN].split(b"\0")[0].decode()


def frame_from_arrays(arr):
    """One frame of stream_frames_arrays as a PqrFrame (the object API
    that run.setup reads)."""
    from mpmc_tpu_torch.io.pqr import PqrAtom, PqrFrame
    num, ids, flags = arr["num"], arr["ids"], arr["flags"]
    atoms = []
    for k in range(num.shape[0]):
        atoms.append(PqrAtom(
            serial=int(ids[k, 0]), name=decode_name(arr["names"], k),
            mol_name=decode_name(arr["mol_names"], k),
            mol_id=int(ids[k, 1]), flag=chr(flags[k]),
            xyz=num[k, :3].copy(), mass=num[k, 3], charge=num[k, 4],
            polar=num[k, 5], eps=num[k, 6], sig=num[k, 7],
            omega=num[k, 8], c6=num[k, 9], c8=num[k, 10], c10=num[k, 11],
            gwp_alpha=num[k, 12]))
    return PqrFrame(atoms, box=arr["box"])
