"""K10 `bispectrum_sums`, the closed-triangle sums of the bispectrum.

`bispectrum_triples(F, U, triples)` returns, for every bin triple t = (i,
j, l), (S_F[t], S_U[t]) = (sum_x F_i F_j F_l, sum_x U_i U_j U_l) in
float64, from B shell-filtered fields F (B, N) and B unit-amplitude fields
U (B, N), float32.  `metrics.bispectrum` divides the one by the other.

On the card it is K10 (`csrc/bispectrum.cu`): for each l the sums are the
Gram matrix of the rows of F * F_l against the rows of F, so K10 takes them
in 16 x 8 blocks of (i, j) on the FP64 tensor cores (mma.sync m16n8k8), a
warp a strip of up to SLOTS l's of one block, over the cells of its CTA;
`bispectrum_plan` lays the blocks and strips out on the host.  Products
and sums are float64, added in an order the plan fixes, so the result is
the same bit for bit from launch to launch.  On the CPU it is its
plain version, `bispectrum_triples_plain`, which gathers the rows of a
chunk of triples and sums their products in float64.  The bispectrum is
never differentiated (neither is the JAX package's): asking for a gradient
raises.

Parity: the triple products of `montecosmo_tpu/metrics.py:179`
(`bispectrum`, `jnp.mean(fs[i] * fs[j] * fs[l])` and the same over the unit
fields).
"""
import ctypes
from functools import lru_cache

import numpy as np
import torch

from montecosmo_tpu_torch.ops._kernels import LAUNCHES

SLOTS = 6                  # csrc/bispectrum.cu kSlots: l's a warp's strip holds
BLOCK = (16, 8)            # a block's rows i and columns j (the MMA's m and n)
WARPS = 8                  # csrc/bispectrum.cu kWarps: strips a CTA
PAD = 4                    # csrc/bispectrum.cu kPad: a float64 tile row's padding
SMEM_LIMIT = 232448        # the shared memory one CTA may use on sm_90
MAX_BINS = 390             # the most fields a tile of 16 cells holds
TILES = (128, 64, 32, 16)  # cells a tile, the largest that fits first
WAVES = 4                  # the grid's waves of resident CTAs (one CTA an SM)
PLAIN_CHUNK_BYTES = 2**28  # float64 products the plain version holds at once


def _cdiv(a, b):
    return -(-a // b)


def padded_bins(bins):
    """B rounded up to the block's 16 rows (the float64 tile's rows)."""
    return BLOCK[0] * _cdiv(bins, BLOCK[0])


def tile_bytes(bins, tile):
    """Shared memory of a CTA at B fields and tiles of `tile` cells: the
    float64 tile of F and U (`padded_bins` rows, each tile + PAD doubles)
    and the two float32 stages of both."""
    return 2 * padded_bins(bins) * (tile + PAD) * 8 + 4 * bins * tile * 4


def _strips(triples):
    """The strips of the closed triples (T, 3), i <= j <= l: for each 16 x
    8 block (i // 16, j // 8) the range of l its triples take, cut into
    runs of at most SLOTS l's; (ib, jb, l0, nl) rows, the longest first (a
    CTA's warps then take strips of about one length).  Also each
    triple's strip, slot l - l0 and block entry 8 (i % 16) + j % 8."""
    i, j, l = (triples[:, c].astype(np.int64) for c in range(3))
    block = (i // BLOCK[0]) * 1_000_000 + j // BLOCK[1]
    rows, where = [], np.empty(len(triples), np.int64)
    for key in np.unique(block):
        sel = np.flatnonzero(block == key)
        lo, hi = int(l[sel].min()), int(l[sel].max())
        for l0 in range(lo, hi + 1, SLOTS):
            on = sel[(l[sel] >= l0) & (l[sel] < l0 + SLOTS)]
            where[on] = len(rows)
            rows.append((int(key // 1_000_000), int(key % 1_000_000), l0, min(SLOTS, hi - l0 + 1)))
    rows = np.asarray(rows, np.int64).reshape(-1, 4)
    order = np.argsort(-rows[:, 3], kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return (rows[order], rank[where], l - rows[order][rank[where], 2],
            BLOCK[1] * (i % BLOCK[0]) + j % BLOCK[1])


@lru_cache(maxsize=16)
def _plan(tri_bytes, n_triples, bins, n, sms, device):
    triples = np.frombuffer(tri_bytes, np.int32).reshape(n_triples, 3)
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"K10 takes 1 to {MAX_BINS} fields, got {bins}")
    if n_triples and not ((triples[:, 0] <= triples[:, 1]) & (triples[:, 1] <= triples[:, 2])
                          & (triples[:, 0] >= 0) & (triples[:, 2] < bins)).all():
        raise ValueError("K10 takes triples i <= j <= l of bins in [0, B)")
    rows, strip, slot, entry = _strips(triples)
    ny = max(1, _cdiv(len(rows), WARPS))
    strips = np.zeros((ny * WARPS, 4), np.int32)
    strips[:len(rows)] = rows
    entries = np.full((ny * WARPS, SLOTS, BLOCK[0] * BLOCK[1]), -1, np.int32)
    entries[strip, slot, entry] = np.arange(n_triples)
    tile = next(c for c in TILES if tile_bytes(bins, c) <= SMEM_LIMIT)
    nx = max(1, min(_cdiv(n, tile), _cdiv(WAVES * sms, ny)))
    per = _cdiv(_cdiv(n, nx), tile) * tile
    if device is not None:
        strips, entries = torch.as_tensor(strips, device=device), torch.as_tensor(entries,
                                                                                  device=device)
    return {"strips": strips, "entries": entries, "tile": tile, "ny": ny, "per": per,
            "nx": _cdiv(n, per), "rows": rows}


def bispectrum_plan(triples, bins, n, sms=132, device=None):
    """K10's plan for the closed triples (T, 3) (i <= j <= l), B fields of
    N cells, on a card of `sms` SMs, cached: `strips` (8 ny, 4) int32 (ib,
    jb, l0, nl; nl = 0 for the idle warps of the last CTA row) and
    `entries` (8 ny, SLOTS, 128) int32 (the triple at each strip's slot and
    16 x 8 block entry, -1 for none: every triple appears once), numpy
    arrays, or tensors on `device` when one is given; `ny` CTA rows of
    WARPS strips; `tile` cells, the largest of TILES whose stages fit a
    CTA; `nx` cell ranges of `per` cells (a multiple of the tile), about
    WAVES waves of CTAs."""
    tri = np.ascontiguousarray(np.asarray(triples, np.int32).reshape(-1, 3))
    return _plan(tri.tobytes(), tri.shape[0], int(bins), int(n), int(sms),
                 None if device is None else torch.device(device))


def bispectrum_triples_plain(F, U, triples, with_abs=False):
    """K10's plain version: (T, 2) float64 sums of F_i F_j F_l and U_i U_j
    U_l over the cells, the rows of a chunk of triples (PLAIN_CHUNK_BYTES of
    float64 products) gathered and their products summed in float64.  With `with_abs`, also the (T, 2) sums of
    the products' absolute values (the scale a comparison is held to)."""
    n = F.shape[1]
    tri = torch.as_tensor(triples, device=F.device).long().reshape(-1, 3)
    chunk = max(1, PLAIN_CHUNK_BYTES // (32 * n))
    out = torch.empty(tri.shape[0], 2, dtype=torch.float64, device=F.device)
    mag = torch.empty_like(out)
    for s in range(0, tri.shape[0], chunk):
        tr = tri[s:s + chunk]
        for col, X in enumerate((F, U)):
            p = X[tr[:, 0]].double() * X[tr[:, 1]].double() * X[tr[:, 2]].double()
            out[s:s + chunk, col] = p.sum(1)
            if with_abs:
                mag[s:s + chunk, col] = p.abs().sum(1)
    return (out, mag) if with_abs else out


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def bispectrum_triples_kernel(F, U, triples):
    """K10 on the card: `bispectrum_triples_plain` of the CUDA tensors F, U
    (B, N) float32 and triples (T, 3) int32 (i <= j <= l, as
    `metrics.bispectrum` lists them), the same bit for bit from launch to
    launch.  Two launches: the cell ranges' partial sums on the tensor
    cores, then their ordered sum.  The triples are read to the host for
    the plan (cached by their values)."""
    from montecosmo_tpu_torch.ops import _kernels

    if not (F.is_cuda and U.is_cuda and triples.is_cuda and F.device == U.device == triples.device):
        raise ValueError("K10 takes CUDA tensors on one device, got "
                         f"{F.device}, {U.device} and {triples.device}")
    if F.dtype != torch.float32 or U.dtype != torch.float32 or triples.dtype != torch.int32:
        raise ValueError(f"K10 takes float32 fields and int32 triples, got {F.dtype}, {U.dtype} "
                         f"and {triples.dtype}")
    if F.ndim != 2 or F.shape != U.shape or triples.ndim != 2 or triples.shape[1] != 3:
        raise ValueError(f"K10 takes F and U (B, N) and triples (T, 3), got {tuple(F.shape)}, "
                         f"{tuple(U.shape)} and {tuple(triples.shape)}")
    bins, n = F.shape
    t = triples.shape[0]
    if t == 0:
        return torch.zeros(0, 2, dtype=torch.float64, device=F.device)
    if n >= 2**40 or t >= 2**26:
        raise ValueError(f"K10's {n} cells or {t} triples are too many")
    sms = torch.cuda.get_device_properties(F.device).multi_processor_count
    plan = bispectrum_plan(triples.cpu().numpy(), bins, n, sms, F.device)
    lib = _kernels.cuda_library()
    F, U = F.contiguous(), U.contiguous()
    vec = n % 4 == 0 and F.data_ptr() % 16 == 0 and U.data_ptr() % 16 == 0
    partial = torch.empty(plan["nx"], t, 2, dtype=torch.float64, device=F.device)
    out = torch.empty(t, 2, dtype=torch.float64, device=F.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(F.device).cuda_stream)
    code = lib.bispectrum_sums(_ptr(F), _ptr(U), ctypes.c_longlong(n), ctypes.c_int(bins),
                               ctypes.c_int(padded_bins(bins)), ctypes.c_int(plan["tile"]),
                               ctypes.c_int(vec), _ptr(plan["strips"]), _ptr(plan["entries"]),
                               ctypes.c_int(plan["ny"]), ctypes.c_int(t),
                               ctypes.c_longlong(plan["per"]), ctypes.c_int(plan["nx"]),
                               _ptr(partial), _ptr(out), stream)
    LAUNCHES["bispectrum_sums", "partials", 0] += 1
    LAUNCHES["bispectrum_sums", "reduce", 0] += 1
    if code != 0:
        raise RuntimeError(f"bispectrum_sums launch failed: CUDA error {code}")
    return out


class _BispectrumTriples(torch.autograd.Function):
    """K10 (or its plain version on the CPU); no gradient."""

    @staticmethod
    def forward(ctx, F, U, triples):
        if F.device.type == "cuda":
            return bispectrum_triples_kernel(F, U, triples)
        if F.device.type == "cpu":
            return bispectrum_triples_plain(F, U, triples)
        raise ValueError(f"bispectrum_triples runs on a CUDA card or the CPU, not {F.device}")

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("the bispectrum's triple sums (K10) have no gradient")


def bispectrum_triples(F, U, triples):
    """(T, 2) float64 (sum_x F_i F_j F_l, sum_x U_i U_j U_l) for the rows
    (i, j, l) of `triples`: K10 on the card, its plain version on the CPU."""
    return _BispectrumTriples.apply(F, U, triples)
