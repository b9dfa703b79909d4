"""K9 `segment_sum`, the deterministic segment sum, and the table gather
whose adjoint it is.

* `segment_sum(src, idx, R)`: out[r] = the sum of the rows src[q] with
  idx[q] = r, for r < R; ids outside [0, R) are dropped.  The power
  spectrum bins its modes with it (`metrics._segment_reduce`).
* `take_rows(tab, i)`: tab[i], the gather of every table lookup
  (`ops/interp.py::uniform_interp`, `set_radial_count`).

The two are each other's adjoint, as paint and read are: the backward of
`take_rows` is `segment_sum` at the same ids, and the backward of
`segment_sum` is `take_rows`, so derivatives of any order go through them
(the Laplace seed's and `lapprox`'s Hessian-vector products are reverse
over reverse through every lookup).

On the card `segment_sum` is K9 (`csrc/segment_sum.cu`), one launch a
call: a warp reads 32 consecutive queries at a time and sums each run of
equal ids by a segmented warp scan in float64; each run's sum is added once
to its CTA's table as a fixed-point integer (integer atomics, so the order
of the adds does not matter; the scale is the CTA's own, from the largest
value it has met); the last CTAs to finish (ticket counters) sum the CTAs'
float64 partials in a pairwise order and write the output.  So the result
is the same bit for bit from launch to launch (`index_add_`, the backward
of `index_select`, sums with float atomics in whatever order they land).
On the CPU it is its plain version, `segment_sum_plain`, `index_add_` in
order.  The gather itself is `index_select` (`jnp.take` in the JAX package,
no Pallas kernel).

Parity: `montecosmo_tpu/metrics.py:104` (`jax.ops.segment_sum` with the
trash segment) and the VJP of `jnp.take` in `montecosmo_tpu/ops/interp.py:20`.
"""
from functools import lru_cache

import torch

from montecosmo_tpu_torch.ops import _kernels
from montecosmo_tpu_torch.ops._kernels import LAUNCHES

_DTYPES = (torch.float32, torch.float64)
_IDS = (torch.int32, torch.int64)

MAX_COLS = 8                # csrc/segment_sum.cu kMaxCols: columns a launch carries
WARPS = 8                   # csrc/segment_sum.cu kWarps: warps a CTA
TABLE_BYTES = 112 * 1024    # a CTA's fixed-point table in shared memory, at most
SMEM_PER_SM = 233472        # shared memory an SM of sm_90 holds (228 KB)
STATIC_BYTES = 1024         # the kernel's static shared memory and a CTA's reserve
CTAS_PER_SM = 2             # the kernel's __launch_bounds__(256, 2)
GROUP = 16                  # csrc/segment_sum.cu kGroup: CTAs a group finisher sums
UNROLL = {1: 16, 2: 8, 4: 4, 8: 2}  # queries a lane loads ahead, by columns carried
MAX_GROUPS = 64             # csrc/segment_sum.cu kMaxGroups: groups a launch may have


def segment_sum_plain(src, idx, rows):
    """K9's plain version: (rows, C) sums of the rows of `src` (N, C) by
    `idx` (N,), ids outside [0, rows) dropped; `index_add_` into a trash
    row, sequential on the CPU."""
    valid = (idx >= 0) & (idx < rows)
    out = torch.zeros((rows + 1,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    return out.index_add_(0, torch.where(valid, idx, rows), src)[:rows]


def _cdiv(a, b):
    return -(-a // b)


def _carried(nc):
    """The columns a launch of `nc` columns carries in registers (the
    kernel's CM: 1, 2, 4 or 8)."""
    return next(c for c in (1, 2, 4, 8) if c >= nc)


@lru_cache(maxsize=256)
def segment_plan(n, rows, cols, sms=132, words=2):
    """K9's launch plan for N queries into an (R, C) output on a card of
    `sms` SMs (see csrc/segment_sum.cu), for a fixed point of `words` 32-bit
    words an entry (2 for float32 src, 4 for float64).  A launch carries at
    most MAX_COLS columns and `row_chunk` rows (the CTA's table of
    row_chunk x columns x words within TABLE_BYTES); `ctas` CTAs of WARPS
    warps a launch, as many as are resident (shared memory, CTAS_PER_SM),
    but no more than give each warp one load of UNROLL x 32 queries;
    `per_warp[cm]` the queries of each warp, a multiple of 32 UNROLL[cm],
    for a launch that carries cm columns.  The partials of the `ctas` CTAs
    are summed by `groups` group finishers of GROUP CTAs, then by the last
    of them.  One launch a call while R x min(C, 8) entries fit.  `scratch`
    is the float64 partials' length (their row ranges follow them in the
    same allocation), `args` the plan's launch arguments."""
    nc = min(cols, MAX_COLS)
    row_chunk = min(rows, TABLE_BYTES // (4 * words * nc))
    per_sm = max(1, min(CTAS_PER_SM, SMEM_PER_SM // (4 * words * row_chunk * nc + STATIC_BYTES)))
    ctas = max(1, min(per_sm * sms, _cdiv(n, WARPS * 32 * UNROLL[_carried(nc)])))
    per_warp = {cm: _cdiv(_cdiv(n, ctas * WARPS), 32 * u) * 32 * u for cm, u in UNROLL.items()}
    groups = _cdiv(ctas, GROUP)
    scratch = (ctas + groups) * row_chunk * nc
    args = (row_chunk, ctas, *(per_warp[c] for c in (1, 2, 4, 8)))
    return {"row_chunk": row_chunk, "ctas": ctas, "groups": groups, "per_warp": per_warp,
            "launches": _cdiv(cols, MAX_COLS) * _cdiv(rows, row_chunk), "scratch": scratch,
            "args": args}


_COUNTERS = {}
_SMS = {}


def _counters(device):
    """The device's ticket counters: zeroed once here, and left at 0 by
    every launch (atomicInc wraps each to 0 when its last CTA arrives)."""
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros(1 + MAX_GROUPS, dtype=torch.int32, device=device)
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _COUNTERS[device]


def segment_sum_kernel(src, idx, rows, site="segment_sum"):
    """K9 on the card: `segment_sum_plain` of the CUDA tensors `src` (N, C)
    float32 or float64 and `idx` (N,) int32 or int64, the same bit for bit
    from launch to launch.  `site` names the caller in `LAUNCHES`
    ("take_rows": a lookup's backward; "segment_sum": a direct call).  One
    kernel launch and two allocations a call (the output, and the partials
    with their row ranges); the ctypes arguments are plain integers."""
    if not (src.is_cuda and idx.is_cuda and src.device == idx.device):
        raise ValueError(f"K9 takes CUDA tensors on one device, got {src.device} and {idx.device}")
    if src.dtype not in _DTYPES or idx.dtype not in _IDS:
        raise ValueError(f"K9 takes float32/float64 values and int32/int64 ids, got {src.dtype} "
                         f"and {idx.dtype}")
    if src.ndim != 2 or idx.ndim != 1 or src.shape[0] != idx.shape[0]:
        raise ValueError(f"K9 takes src (N, C) and idx (N,), got {tuple(src.shape)} and "
                         f"{tuple(idx.shape)}")
    n, cols = src.shape
    rows = int(rows)
    if n == 0 or cols == 0 or rows == 0:
        return torch.zeros(rows, cols, dtype=src.dtype, device=src.device)
    if cols >= 2**31 or rows * cols >= 2**62:
        raise ValueError(f"K9's table of {rows} x {cols} entries is too large")
    lib = _kernels.cuda_library()
    src, idx = src.contiguous(), idx.contiguous()
    counters = _counters(src.device)
    f64 = src.dtype == torch.float64
    plan = segment_plan(n, rows, cols, _SMS[src.device], 4 if f64 else 2)
    if plan["groups"] > MAX_GROUPS:
        raise ValueError(f"K9's plan takes {plan['groups']} groups, past {MAX_GROUPS}")
    out = torch.empty(rows, cols, dtype=src.dtype, device=src.device)
    # the float64 partials, then their row ranges (2 ints a CTA and a group)
    scratch = torch.empty(plan["scratch"] + plan["ctas"] + plan["groups"], dtype=torch.float64,
                          device=src.device)
    base = scratch.data_ptr()
    code = lib.segment_sum(src.data_ptr(), idx.data_ptr(), n, cols, rows, f64,
                           idx.dtype == torch.int64, *plan["args"], base,
                           base + 8 * plan["scratch"], counters.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream(src.device).cuda_stream)
    LAUNCHES["segment_sum", site, 0] += 1
    if code != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {code}")
    return out


def _segment_sum(src, idx, rows, site):
    """K9 for a CUDA tensor, its plain version for a CPU one; (N, ...) in,
    (rows, ...) out."""
    flat = src.reshape(src.shape[0], -1)
    if src.device.type == "cuda":
        out = segment_sum_kernel(flat, idx, rows, site)
    elif src.device.type == "cpu":
        out = segment_sum_plain(flat, idx, rows)
    else:
        raise ValueError(f"segment_sum runs on a CUDA card or the CPU, not {src.device}")
    return out.reshape((rows,) + tuple(src.shape[1:]))


class _TakeRows(torch.autograd.Function):
    """tab[i] for flat ids `i` in [0, rows); backward K9 at the same ids."""

    @staticmethod
    def forward(ctx, tab, i):
        ctx.save_for_backward(i)
        ctx.rows = tab.shape[0]
        return tab.index_select(0, i)

    @staticmethod
    def backward(ctx, g):
        (i,) = ctx.saved_tensors
        return _SegmentSum.apply(g, i, ctx.rows, True), None


class _SegmentSum(torch.autograd.Function):
    """K9 over flat ids; backward the gather at the same ids (zero where an
    id was dropped).  `in_range` marks ids known to lie in [0, rows) (a
    gather's backward), whose own backward needs no mask."""

    @staticmethod
    def forward(ctx, src, idx, rows, in_range):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.in_range = rows, in_range
        return _segment_sum(src, idx, rows, "take_rows" if in_range else "segment_sum")

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if ctx.in_range:
            return _TakeRows.apply(g, idx), None, None, None
        valid = (idx >= 0) & (idx < ctx.rows)
        got = _TakeRows.apply(g, idx.clamp(0, ctx.rows - 1))
        return got * valid.reshape((-1,) + (1,) * (g.ndim - 1)), None, None, None


def take_rows(tab, i):
    """tab[i] for an integer index tensor `i` of any shape (ids in [0,
    tab.shape[0])): i.shape + tab.shape[1:].  Its backward is K9 at the
    same ids, its trailing axes one channel each (a stacked-pair table of
    growth tables: 2 x 4 channels), so the table's gradient is the same bit
    for bit from run to run."""
    return _TakeRows.apply(tab, i.reshape(-1)).reshape(i.shape + tab.shape[1:])


def segment_sum(src, idx, rows):
    """out[r] = sum of src[q] over the q with idx[q] = r, for r < `rows`
    (ids outside [0, rows) dropped): `src` (N, ...) and `idx` (N,) in,
    (rows, ...) out.  K9 on the card, differentiable to any order (its
    backward is `take_rows`)."""
    return _SegmentSum.apply(src, idx.reshape(-1), int(rows), False)
