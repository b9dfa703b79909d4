"""Build and load the port's hand-written kernels.

CUDA sources (`montecosmo_tpu_torch/csrc/*.cu`, plain C interface) are
compiled at first use with nvcc for sm_90a into `montecosmo_tpu_torch/_build/`
(named by a hash of the sources and flags, so a rebuild happens only after
an edit) and loaded with ctypes.  The Triton epilogue compiles at its first
launch.  Nothing here runs at import; a missing nvcc or a failed build
raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_INFO = {"seconds": None, "log": ""}
_LIB = None

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# mesh, lattice, stride, clamp bound, clamp, n_shift, order, NGP tie span and
# margin, then the window: Kaiser-Bessel (else B-spline), beta, 1 / norm
_GEOM = [_I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _F, _F]


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
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD / f"libmontecosmo_kernels_{digest}.so"
    if rebuild or not so.exists():
        BUILD.mkdir(exist_ok=True)
        tmp = BUILD / f".{so.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
                              capture_output=True, text=True)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_INFO['log']}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.paint_cic_forward.argtypes = [_P, _P, _L, *_GEOM, _P, _P]
    lib.paint_cic_forward.restype = _I
    lib.paint_cic_adjoint.argtypes = [_P, _P, _P, _L, *_GEOM, _P, _P, _P]
    lib.paint_cic_adjoint.restype = _I
    lib.read_cic_forward.argtypes = [_P, _P, _L, _I, *_GEOM, _P, _P]
    lib.read_cic_forward.restype = _I
    lib.read_cic_adjoint.argtypes = [_P, _P, _P, _L, _I, *_GEOM, _P, _P, _P]
    lib.read_cic_adjoint.restype = _I
    _LIB = lib
    return lib


def launch_nufft_epilogue(src, dst, geom, backward):
    """K3 (Triton) on the current stream."""
    from montecosmo_tpu_torch.csrc import nufft_epilogue

    nufft_epilogue.launch(src, dst, geom.shape, geom.n_shift, geom.scale, geom.order,
                          backward, geom.kcut)
