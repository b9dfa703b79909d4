"""K9 `segment_sum` of two checkouts of this repo, measured in turns on one
card.

    python3 tools/k9_turns.py OTHER_DIR [--out chiprun_out/k9_turns.json]

OTHER_DIR is another checkout of the repo (say an earlier commit, unpacked
with `git archive` into a git-ignored directory).  Four processes run in
turn: OTHER_DIR, this checkout, this checkout, OTHER_DIR.  Each imports
`montecosmo_tpu_torch` from its own checkout (and builds its kernels
there), but measures with this checkout's `chip_smoke.py` helpers, so both
are measured by the same code:

* at K9's call sites (`chip_smoke.K9_SHAPES`, the site's own ids and
  uniform ids, `chip_smoke._k9_ids`): the call's time (CUDA events around
  10 back-to-back calls, `cuda_ms`), its device time and its host time
  (calls queued behind a spin kernel, `queued_ms`), its device launches
  (a CUDA graph of one call, `graph_launches`), and the device time and
  kernels the profiler records for 10 calls;
* the TSC N-body light cone's value+grad at 128^3 (`chip_smoke.flagship`):
  the median wall of 5, then one value+grad profiled: the device time of
  K9's kernels (those of csrc/segment_sum.cu), K9's calls, and the device
  kernels in all.

Profiler sessions come last in each process (a session slows the host's
launches timed after it).  Prints each process's lines, then a table of
the two checkouts' means; writes every number to --out.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the device kernels of csrc/segment_sum.cu, before and after its redesign
K9_KERNELS = ("segment_sum_kernel", "abs_max_kernel", "fixed_to_float_kernel")


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(fn, reps):
    """(device ms of every kernel, device ms of K9's, kernels, K9's sum
    kernels) over `reps` calls of fn(), from one torch.profiler session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    k9 = [e for e in dev if any(k in e.key for k in K9_KERNELS)]
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            sum(e.self_device_time_total for e in k9) / 1e3, sum(e.count for e in dev),
            sum(e.count for e in dev if "segment_sum_kernel" in e.key))


def measure(tree):
    """One process's measurements with `montecosmo_tpu_torch` from `tree`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import montecosmo_tpu_torch
    from montecosmo_tpu_torch.ops import _kernels, segment as S

    assert Path(montecosmo_tpu_torch.__file__).resolve().is_relative_to(tree.resolve())
    cs = _smoke()
    t0 = time.perf_counter()
    _kernels.cuda_library()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0, "sites": {}}
    inputs = {}
    for k, (where, (n, rows, cols)) in enumerate(cs.K9_SHAPES.items()):
        for kind in ("runs", "uniform"):
            gen = torch.Generator(device="cuda").manual_seed(100 + 2 * k + (kind == "uniform"))
            idx = cs._k9_ids(where, kind, n, rows, gen)
            src = torch.randn(n, cols, generator=gen, device="cuda")
            call = lambda src=src, idx=idx, rows=rows: S.segment_sum_kernel(src, idx, rows)
            dev_ms, host_ms = cs.queued_ms(call)
            launches, nodes = cs.graph_launches(call)
            row = {"ms": cs.cuda_ms(call, 10, 2), "device_ms": dev_ms, "host_ms": host_ms,
                   "launches": launches, "graph_nodes": nodes}
            row["ms_again"] = cs.cuda_ms(call, 10, 0)
            out["sites"][f"{where} ({kind})"] = row
            inputs[f"{where} ({kind})"] = call
            print(f"# {tree.name} K9 {where} ({kind}): {row}", flush=True)

    m, leaves, obs, value_and_grad = cs.flagship("nbody", a_obs=None, paint_order=3)
    for _ in range(2):
        value_and_grad()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        value_and_grad()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    cone = {"wall_ms": walls, "median_wall_ms": float(np.median(walls))}

    for name, call in inputs.items():
        total, k9, kernels, sums = _profile(call, 10)
        out["sites"][name] |= {"profiler_device_ms": total / 10, "profiler_kernels": kernels / 10,
                               "profiler_sum_kernels": sums / 10}
    for attempt in range(3):
        before = sum(v for (k, _, _), v in S.LAUNCHES.items() if k == "segment_sum")
        total, k9, kernels, sums = _profile(value_and_grad, 1)
        calls = sum(v for (k, _, _), v in S.LAUNCHES.items() if k == "segment_sum") - before
        cone |= {"k9_device_ms": k9, "k9_calls": calls, "k9_sum_kernels": sums,
                 "device_ms": total, "device_kernels": kernels, "sessions": attempt + 1}
        if sums == calls:  # every K9 call's sum kernel recorded
            break
    out["light_cone"] = cone
    print(f"# {tree.name} TSC light cone value+grad: {cone}", flush=True)
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "k9_turns.json")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.other)
    import torch

    if not torch.cuda.is_available():
        sys.exit("k9_turns.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = []
    for tree in (args.other, HERE, HERE, args.other):
        proc = subprocess.run([sys.executable, __file__, str(tree.resolve()), "--measure"],
                              capture_output=True, text=True)
        print(proc.stdout, proc.stderr[-4000:], sep="\n", flush=True)
        if proc.returncode:
            sys.exit(f"the run in {tree} failed ({proc.returncode})")
        runs.append(json.loads(next(line[7:] for line in proc.stdout.splitlines()
                                    if line.startswith("RESULT "))))
    other, this = (runs[0], runs[3]), (runs[1], runs[2])
    mean = lambda pair, f: sum(f(r) for r in pair) / 2
    print(f"# means of two runs each: {args.other.name} | this checkout")
    for site in runs[0]["sites"]:
        cells = []
        for key in ("ms", "device_ms", "host_ms", "profiler_device_ms", "launches"):
            a, b = (mean(p, lambda r: r["sites"][site][key]) for p in (other, this))
            cells.append(f"{key} {a:.4f} | {b:.4f}")
        print(f"# K9 {site}: " + "; ".join(cells))
    for key in ("median_wall_ms", "k9_device_ms", "k9_calls", "device_kernels", "device_ms"):
        a, b = (mean(p, lambda r: r["light_cone"][key]) for p in (other, this))
        print(f"# TSC light cone value+grad {key}: {a:.4f} | {b:.4f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"order": [r["tree"] for r in runs], "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
