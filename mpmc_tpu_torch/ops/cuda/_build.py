"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/mpmc_tpu_torch/`` at the repository root, one shared library
with a plain C interface, keyed by a hash of the sources (a changed source
builds a new library; an unchanged one is reused).  Loaded with ctypes:
every pointer and the stream are ``c_void_p``, every count a ``c_int``,
and every entry returns its ``cudaGetLastError()``.

Nothing here runs at import: the first kernel launch calls ``library()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mpmc_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pos q eps sig mol alive frozen scal | n row_start rd mix es lrc |
    # part pmin out | stream
    "pair_terms": [_P] * 8 + [_I] * 6 + [_P] * 3 + [_P],
    # pos q eps sig mol alive mol_atoms natoms mol rows | A | scal | n rd
    # mix es lrc | part pmin out | stream
    "mol_pair": [_P] * 10 + [_I] + [_P] + [_I] * 5 + [_P] * 3 + [_P],
}

_lib = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest():
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH).encode())
    return h.hexdigest()[:16]


def nvcc():
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force=False):
    """Compile csrc/*.cu into the hashed shared library; returns its path.
    ptxas's register/shared-memory/spill report lands beside it in
    ``<library>.ptxas.txt``."""
    out = BUILD_DIR / f"libmpmc_tpu_torch_{_digest()}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([nvcc()] + ARCH + ["-std=c++17", "-O3", "-shared",
                              "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                              "-o", str(tmp)]
           + [str(p) for p in sources() if p.suffix == ".cu"])
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    out.with_suffix(".ptxas.txt").write_text(r.stderr)
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for base, args in _SIGNATURES.items():
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"{base}_{sfx}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib
