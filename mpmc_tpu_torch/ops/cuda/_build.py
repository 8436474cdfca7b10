"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source ``csrc/<name>.cu`` becomes its own shared library with a plain
C interface, ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/mpmc_tpu_torch/`` at the repository root,
keyed by a hash of the source and the headers (a changed source builds a
new library; an unchanged one is reused).  ``build`` starts one nvcc per
source, all at once, and waits for them together.  The libraries load
with ctypes: every pointer and the stream are ``c_void_p``, every count a
``c_int``, a constant a ``c_double``, an output count a pointer to a
``c_int``, and every entry returns a CUDA error code (0: none).

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
_PI = ctypes.POINTER(ctypes.c_int)
# source stem -> entry -> argtypes (each entry exists as <entry>_f32 and
# <entry>_f64)
_SIGNATURES = {
    "pair_kernel": {
        # pos q eps sig mol alive frozen scal wl | W nt n row_start rd mix
        # es lrc grid | part pmin ticket out | stream
        "pair_terms": [_P] * 9 + [_I] * 9 + [_P] * 4 + [_P],
        # [CTAs resident on the card] out
        "pair_config": [_PI],
        # pos q eps sig mol alive mol_atoms natoms mol rows | A | scal | n
        # rd mix es lrc | part pmin ticket out | stream
        "mol_pair": [_P] * 10 + [_I] + [_P] + [_I] * 5 + [_P] * 4 + [_P],
    },
    "uvt_kernel": {
        # pos alive eps sig q mass slot_start slot_species slot_alive tmpl
        # natoms scal betas lnfvs d_self d_excl c1 cx u kvec kcoef sk sums |
        # C n ms S A K nk G rd mix es ortho | ke | stream
        "run_steps_uvt": [_P] * 23 + [_I] * 12 + [ctypes.c_double] + [_P],
        # n nk ms G | clusters out
        "uvt_occupancy": [_I] * 4 + [_PI],
    },
    "nvt_kernel": {
        # pos alive eps sig q mass mv_start mv_natoms scal betas u kvec
        # kcoef sk nve_k0 sums | C n mv A K nk G rd mix es ortho nve | ke
        # nve_g | stream
        "run_steps_nvt": [_P] * 16 + [_I] * 12 + [ctypes.c_double] * 2
        + [_P],
        # n nk G | clusters out
        "nvt_occupancy": [_I] * 3 + [_PI],
    },
    "pda_kernel": {
        # pos alive eps sig q mass polar e0 slot_start slot_species
        # slot_alive tmpl natoms scal lnfv d_self d_excl c1 cx u kvec kcoef
        # sk rec | n ms S A K nk G rd mix es ortho damp field | ke | stream
        "run_steps_uvt_pda": [_P] * 24 + [_I] * 13 + [ctypes.c_double]
        + [_P],
        # n nk ms A field G | clusters out
        "pda_occupancy": [_I] * 6 + [_PI],
    },
    "thole_kernel": {
        # pos src ok mol scal wl | n ni nj dipole damp ortho grid | part
        # ticket out | stream
        "thole_field": [_P] * 6 + [_I] * 7 + [_P] * 3 + [_P],
        # dipole | [CTAs resident on the card] out
        "thole_config": [_I, _PI],
    },
}

_libs: dict = {}


def _digest(src: Path):
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH).encode())
    return h.hexdigest()[:16]


def target(name: str) -> Path:
    """Path of the shared library built from ``csrc/<name>.cu``."""
    return BUILD_DIR / f"lib{name}_{_digest(CSRC / (name + '.cu'))}.so"


def nvcc():
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def command(name: str, out: Path, defines=()):
    """nvcc's command line for ``csrc/<name>.cu`` into ``out``, with the
    preprocessor ``defines`` (``NAME=value`` strings)."""
    return ([nvcc()] + ARCH + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                               "-fPIC", "-Xptxas", "-v", "-I", str(CSRC)]
            + [f"-D{d}" for d in defines]
            + ["-o", str(out), str(CSRC / (name + ".cu"))])


def build(force=False):
    """Compile every csrc/*.cu into its hashed shared library, one nvcc
    per source, all started together; returns {name: path}.  ptxas's
    register/shared-memory/spill report lands beside each library in
    ``<library>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in _SIGNATURES:
        out = target(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        err = open(out.with_suffix(".ptxas.txt"), "w")
        running[name] = (subprocess.Popen(command(name, tmp), stdout=err,
                                          stderr=err),
                         err, tmp, out)
    failed = []
    for name, (proc, err, tmp, out) in running.items():
        rc = proc.wait()
        err.close()
        if rc != 0:
            failed.append(f"{name}.cu ({rc}):\n"
                          + out.with_suffix(".ptxas.txt").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return {name: target(name) for name in _SIGNATURES}


def load(name: str, path: Path):
    """Load ``path`` as the library of ``csrc/<name>.cu``, its entries
    typed from _SIGNATURES, and use it from now on."""
    lib = ctypes.CDLL(str(path))
    for base, args in _SIGNATURES[name].items():
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def library(name: str):
    """The loaded library of ``csrc/<name>.cu`` (every source is built on
    the first call)."""
    if name not in _libs:
        for nm, path in build().items():
            if nm not in _libs:
                load(nm, path)
    return _libs[name]
