"""The FP64 tensor cores' rate on a CUDA card, by mma.sync shape.

    python3 tools/dmma_rate.py

Builds tools/dmma_rate.cu with nvcc (sm_90a) in a temporary directory and
times `dmma_loop` for each shape (two CTAs of 8 warps an SM, each warp 8
independent MMAs a round on operands in registers) with CUDA events, the
best of 3.  Prints the card's name and power limit, then one JSON line of
TFLOP/s by shape.  This is the measurement behind K10's choice of
m16n8k8 (csrc/bispectrum.cu).
"""
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SHAPES = {"m8n8k4": (0, 8 * 8 * 4), "m16n8k4": (1, 16 * 8 * 4), "m16n8k8": (2, 16 * 8 * 8),
          "m16n8k16": (3, 16 * 8 * 16)}


def main():
    if not torch.cuda.is_available():
        sys.exit("dmma_rate.py needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from montecosmo_tpu_torch.ops._kernels import nvcc_path

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "dmma_rate.so"
        subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                        str(Path(__file__).with_suffix(".cu"))], check=True)
        lib = ctypes.CDLL(str(so))
    lib.dmma_loop.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
    blocks, iters = 2 * torch.cuda.get_device_properties(0).multi_processor_count, 2000
    out = torch.empty(blocks * 256, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, (shape, macs) in SHAPES.items():
        times = []
        for _ in range(4):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            assert lib.dmma_loop(shape, blocks, iters, out.data_ptr(), stream) == 0
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        ms = min(times[1:])
        rates[name] = blocks * 8 * iters * 8 * 2 * macs / (ms * 1e-3) / 1e12
    print(json.dumps({"fp64_mma_tflops": rates}))


if __name__ == "__main__":
    main()
