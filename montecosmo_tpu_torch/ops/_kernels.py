"""Build and load the port's hand-written kernels.

CUDA sources (`montecosmo_tpu_torch/csrc/*.cu` and the `*.cuh` they share,
plain C interface) are compiled at first use with nvcc for sm_90a, one nvcc
per source, all started together, and linked into one library in
`montecosmo_tpu_torch/_build/` (named by a hash of the sources and flags, so
a rebuild happens only after an edit), loaded with ctypes.  Nothing here
runs at import; a missing nvcc or a failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_INFO = {"seconds": None, "log": ""}
# kernel launches per (kernel, window, order): each wrapper adds one where it
# launches (ops/paint.py, ops/background.py, ops/segment.py, ops/bispectrum.py)
LAUNCHES = Counter()
_LIB = None

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_D = ctypes.c_double
# mesh, lattice, stride, clamp bound, clamp, n_shift, order, NGP tie span and
# margin, then the window: Kaiser-Bessel (else B-spline), beta, 1 / norm
_GEOM = [_I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _F, _F]
# the lattice-brick kernels' plan (ops/paint.py::tile_plan): brick, margin
# R, tile, shared-memory bytes
_TILE = [_I] * 8


def nvcc_path():
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{CSRC} with the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")
    return path


def cuda_library(rebuild=False):
    """The loaded kernel library, built first if needed (or always, with
    `rebuild`, as the GPU smoke run does to show the sources compile)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cu*")))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD / f"libmontecosmo_kernels_{digest}.so"
    if rebuild or not so.exists():
        BUILD.mkdir(exist_ok=True)
        tmp = BUILD / f".{so.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        objs = [BUILD / f".{p.stem}.{os.getpid()}.o" for p in srcs]
        logs = [o.with_suffix(".log") for o in objs]
        outs = [open(log, "w") for log in logs]
        procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                                  stdout=f, stderr=subprocess.STDOUT)
                 for p, o, f in zip(srcs, objs, outs)]
        codes = [proc.wait() for proc in procs]
        for f in outs:
            f.close()
        if not any(codes):
            link = subprocess.run([nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            codes.append(link.returncode)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["log"] = "".join(log.read_text() for log in logs)
        if not any(codes):
            BUILD_INFO["log"] += link.stdout + link.stderr
        for f in objs + logs:
            f.unlink(missing_ok=True)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{BUILD_INFO['log']}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.paint_cic_forward.argtypes = [_P, _P, _L, *_GEOM, _P, _P, _P]
    lib.paint_cic_forward.restype = _I
    lib.paint_cic_adjoint.argtypes = [_P, _P, _P, _L, *_GEOM, _P, _P, _P]
    lib.paint_cic_adjoint.restype = _I
    lib.read_cic_forward.argtypes = [_P, _P, _L, _I, *_GEOM, _P, _P]
    lib.read_cic_forward.restype = _I
    lib.read_cic_adjoint.argtypes = [_P, _P, _P, _L, _I, *_GEOM, _P, _P, _P, _P]
    lib.read_cic_adjoint.restype = _I
    lib.paint_cic_tiled_forward.argtypes = [_P, _P, *_GEOM, *_TILE, _P, _P, _P, _P]
    lib.paint_cic_tiled_forward.restype = _I
    lib.read_cic_adjoint_tiled.argtypes = [_P, _P, _P, _I, *_GEOM, *_TILE, _P, _P, _P, _P,
                                              _P]
    lib.read_cic_adjoint_tiled.restype = _I
    lib.read_cic_tiled.argtypes = [_P, _P, _I, *_GEOM, *_TILE, _P, _P, _P]
    lib.read_cic_tiled.restype = _I
    lib.nufft_epilogue.argtypes = [_P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P, _P, _P,
                                   _P]
    lib.nufft_epilogue.restype = _I
    lib.paint_cic_grad.argtypes = [_P, _P, _P, _L, _I, *_GEOM, _P, _P, _P]
    lib.paint_cic_grad.restype = _I
    lib.read_cic_hess.argtypes = [_P, _P, _P, _L, _I, *_GEOM, _P, _P, _P]
    lib.read_cic_hess.restype = _I
    lib.paint_cic_grad_tiled.argtypes = [_P, _P, _P, _I, *_GEOM, *_TILE, _P, _P, _P, _P]
    lib.paint_cic_grad_tiled.restype = _I
    lib.read_cic_hess_tiled.argtypes = [_P, _P, _P, _I, *_GEOM, *_TILE, _P, _P, _P, _P]
    lib.read_cic_hess_tiled.restype = _I
    lib.background_tables.argtypes = [_P, _P, _P, _I, _D, _D, _D, _P, _P, _P, _I, _P]
    lib.background_tables.restype = _I
    lib.fp64_chain.argtypes = [_L, _D, _P, _P]
    lib.fp64_chain.restype = _I
    lib.segment_sum.argtypes = [_P, _P, _L, _I, _L, _I, _I, _P, _P, _P, _P]
    lib.segment_sum.restype = _I
    lib.bispectrum_sums.argtypes = [_P, _P, _L, _I, _P, _I, _I, _L, _I, _P, _P, _P]
    lib.bispectrum_sums.restype = _I
    _LIB = lib
    return lib

