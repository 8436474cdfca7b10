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

The host library of ``csrc/pqr_io.cpp`` (the native PQR codec: the
trajectory reader and the frame writer) builds the
same way with ``g++ -O2 -shared -fPIC`` (``host_library``), keyed by a
hash of its source.

Nothing here runs at import: the first kernel launch calls ``library()``,
the first native read or write ``host_library()``.
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
        # pos q eps sig mol alive | pos_stride | mol_atoms natoms mol rows
        # | A | scal | scal_stride n C rd mix es lrc | part pmin ticket out
        # | stream
        "mol_pair": [_P] * 6 + [_I] + [_P] * 4 + [_I] + [_P] + [_I] * 7
        + [_P] * 4 + [_P],
    },
    "uvt_kernel": {
        # pos alive eps sig q mass mmass slot_start slot_species slot_alive
        # tmpl natoms scal betas lnfvs d_self d_excl c1 cx u kvec kcoef sk
        # sums cav_list cav_n eta tmmc rot spin | C n ms S A K nk G rd mix
        # es ortho qc g g3 ke_eta rows cav tm bias sf | ke hb2 | stream
        "run_steps_uvt": [_P] * 30 + [_I] * 21 + [ctypes.c_double] * 2
        + [_P],
        # n nk ms qc xt G | clusters out
        "uvt_occupancy": [_I] * 6 + [_PI],
    },
    "nvt_kernel": {
        # pos alive eps sig q mass mmass mv_start mv_natoms scal betas u
        # kvec kcoef sk nve_k0 sums rot spin | C n mv A K nk G rd mix es
        # ortho nve qc sf | ke nve_g hb2 | stream
        "run_steps_nvt": [_P] * 19 + [_I] * 14 + [ctypes.c_double] * 3
        + [_P],
        # n nk qc G | clusters out
        "nvt_occupancy": [_I] * 4 + [_PI],
    },
    "pda_kernel": {
        # pos alive eps sig q mass mmass polar e0 slot_start slot_species
        # slot_alive tmpl natoms scal lnfv d_self d_excl c1 cx u kvec kcoef
        # sk rec cav_list cav_n rot spin | n ms S A K nk G rd mix es ortho
        # damp field qc g g3 cav bias sf | ke hb2 | stream
        "run_steps_uvt_pda": [_P] * 29 + [_I] * 19 + [ctypes.c_double] * 2
        + [_P],
        # n nk ms A field qc xt G | clusters out
        "pda_occupancy": [_I] * 8 + [_PI],
    },
    # B2 and B4 with the RD forms sg, dreiding, b14_7, disp_expansion: one
    # instance each (csrc/pair_kernel.cuh), the classical entries'
    # arguments (rd: the damping flag) and the C6, C8, C10 columns before
    # the stream
    "pair_sg_kernel": {
        "pair_terms_rd": [_P] * 9 + [_I] * 9 + [_P] * 7 + [_P],
        "pair_config_rd": [_PI],
        "mol_pair_rd": [_P] * 6 + [_I] + [_P] * 4 + [_I] + [_P] + [_I] * 7
        + [_P] * 7 + [_P],
    },
    "pair_dreiding_kernel": {},
    "pair_b14_7_kernel": {},
    "pair_disp_kernel": {},
    # B1 and B6 with the µVT extras (cavity bias, TMMC, spinflip), B3 with
    # spinflip: the same entries from their own sources, so that they
    # compile beside the others
    "uvt_xt_kernel": {},
    "pda_xt_kernel": {},
    "nvt_sf_kernel": {},
    "thole_kernel": {
        # pos src ok mol scal wl chains | K n ni nj dipole damp ortho grid
        # | part ticket out | stream
        "thole_field": [_P] * 7 + [_I] * 8 + [_P] * 3 + [_P],
        # dipole | [CTAs resident on the card] out
        "thole_config": [_I, _PI],
    },
}

# host sources (csrc/<name>.cpp, built with g++) -> entry -> (argtypes,
# restype)
_HOST_SIGNATURES = {
    "pqr_io": {
        # path mode remark | n | num ids | flags names mol_names | extended
        "pqr_write_frame": ([ctypes.c_char_p] * 3 + [ctypes.c_long]
                            + [_P] * 2 + [ctypes.c_char_p] * 3
                            + [ctypes.c_int], ctypes.c_long),
        # path -> stream handle
        "pqr_open_stream": ([ctypes.c_char_p], _P),
        # handle -> atoms of the next frame, 0 at EOF, -3 on a parse error
        "pqr_stream_advance": ([_P], ctypes.c_long),
        "pqr_error": ([_P], ctypes.c_char_p),
        # handle, out[6] -> 1 if the frame has a cell
        "pqr_frame_cell": ([_P, _P], ctypes.c_long),
        # handle | num ids | flags names mol_names (caller's buffers)
        "pqr_frame_data": ([_P] * 6, ctypes.c_long),
        "pqr_close": ([_P], None),
    },
}

_SIGNATURES.update({f"pair_{form}_kernel": _SIGNATURES["pair_sg_kernel"]
                    for form in ("dreiding", "b14_7", "disp")})
_SIGNATURES["uvt_xt_kernel"] = _SIGNATURES["uvt_kernel"]
_SIGNATURES["pda_xt_kernel"] = _SIGNATURES["pda_kernel"]
_SIGNATURES["nvt_sf_kernel"] = _SIGNATURES["nvt_kernel"]

_libs: dict = {}


def _digest(src: Path, headers=True):
    h = hashlib.sha256()
    for p in [src] + (sorted(CSRC.glob("*.cuh")) if headers else []):
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


def gxx():
    """Path of the host C++ compiler: g++ on PATH."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native PQR codec cannot be "
                           "built")
    return found


def host_target(name: str) -> Path:
    """Path of the shared library built from ``csrc/<name>.cpp``."""
    src = CSRC / (name + ".cpp")
    return BUILD_DIR / f"lib{name}_{_digest(src, headers=False)}.so"


def host_library(name: str):
    """The loaded library of ``csrc/<name>.cpp``, built with g++ on the
    first call (``g++ -O2 -shared -fPIC``); raises if g++ fails."""
    if name in _libs:
        return _libs[name]
    out = host_target(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [gxx(), "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
             str(CSRC / (name + ".cpp"))], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cpp "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for entry, (args, res) in _HOST_SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = args
        fn.restype = res
    _libs[name] = lib
    return lib
