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

On the card `segment_sum` is K9 (`csrc/segment_sum.cu`): each thread sums
its runs of equal ids in float64 registers and adds each run once, as a
fixed-point integer, with integer atomics; so the result is the same bit
for bit from launch to launch (`index_add_`, the backward of
`index_select`, sums with float atomics in whatever order they land).  On
the CPU it is its plain version, `segment_sum_plain`, `index_add_` in
order.  The gather itself is `index_select` (`jnp.take` in the JAX package,
no Pallas kernel).

Parity: `montecosmo_tpu/metrics.py:104` (`jax.ops.segment_sum` with the
trash segment) and the VJP of `jnp.take` in `montecosmo_tpu/ops/interp.py:20`.
"""
import ctypes

import torch

from montecosmo_tpu_torch.ops._kernels import LAUNCHES

_DTYPES = (torch.float32, torch.float64)
_IDS = (torch.int32, torch.int64)


def segment_sum_plain(src, idx, rows):
    """K9's plain version: (rows, C) sums of the rows of `src` (N, C) by
    `idx` (N,), ids outside [0, rows) dropped; `index_add_` into a trash
    row, sequential on the CPU."""
    valid = (idx >= 0) & (idx < rows)
    out = torch.zeros((rows + 1,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    return out.index_add_(0, torch.where(valid, idx, rows), src)[:rows]


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def segment_sum_kernel(src, idx, rows, site="segment_sum"):
    """K9 on the card: `segment_sum_plain` of the CUDA tensors `src` (N, C)
    float32 or float64 and `idx` (N,) int32 or int64, the same bit for bit
    from launch to launch.  `site` names the caller in `LAUNCHES`
    ("take_rows": a lookup's backward; "segment_sum": a direct call)."""
    from montecosmo_tpu_torch.ops import _kernels

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
    f64 = src.dtype == torch.float64
    out = torch.empty(rows, cols, dtype=src.dtype, device=src.device)
    acc = torch.zeros(rows * cols * (2 if f64 else 1), dtype=torch.int64, device=src.device)
    maxbits = torch.zeros(1, dtype=torch.int64 if f64 else torch.int32, device=src.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(src.device).cuda_stream)
    code = lib.segment_sum(_ptr(src), _ptr(idx), ctypes.c_longlong(n), ctypes.c_int(cols),
                           ctypes.c_longlong(rows), ctypes.c_int(f64),
                           ctypes.c_int(idx.dtype == torch.int64), _ptr(maxbits), _ptr(acc),
                           _ptr(out), stream)
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
