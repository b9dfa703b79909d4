"""K10 `bispectrum_sums`, the closed-triangle sums of the bispectrum.

`bispectrum_triples(F, U, triples)` returns, for every bin triple t = (i,
j, l), (S_F[t], S_U[t]) = (sum_x F_i F_j F_l, sum_x U_i U_j U_l) in
float64, from B shell-filtered fields F (B, N) and B unit-amplitude fields
U (B, N), float32.  `metrics.bispectrum` divides the one by the other.

On the card it is K10 (`csrc/bispectrum.cu`): each field is read once, a
warp walks its triples with the pair products in registers, the products
are taken in float64 and the partial sums added in a fixed order, so the
result is the same bit for bit from launch to launch.  On the CPU it is its
plain version, `bispectrum_triples_plain`, which gathers the rows of a
chunk of triples and sums their products in float64.  The bispectrum is
never differentiated (neither is the JAX package's): asking for a gradient
raises.

Parity: the triple products of `montecosmo_tpu/metrics.py:179`
(`bispectrum`, `jnp.mean(fs[i] * fs[j] * fs[l])` and the same over the unit
fields).
"""
import ctypes

import torch

from montecosmo_tpu_torch.ops._kernels import LAUNCHES

TRIPLES_PER_CTA = 2048     # csrc/bispectrum.cu kTriples
SMEM_LIMIT = 232448        # the shared memory one CTA may use on sm_90
MAX_BINS = 390             # the most fields a tile of 32 cells holds (C = 32)
WAVES = 4                  # the grid's waves of resident CTAs
PLAIN_CHUNK_BYTES = 2**28  # float64 products the plain version holds at once
_THREADS = 256


def _cdiv(a, b):
    return -(-a // b)


def bispectrum_plan(n, bins, n_triples, sms=132):
    """K10's launch plan for N cells, B fields and T triples on a card of
    `sms` SMs: (M, cells a CTA, CTAs along the cells).  A tile is 32 M
    cells, M the largest of 8, 4, 2, 1 whose tile (2 B 32 M doubles) and
    accumulators fit a CTA's shared memory; the cells are cut into ranges
    so that the grid holds about WAVES waves of resident CTAs (four left
    fewer SMs idle in the last wave than two, at 128^3 and 256^3 on an
    H100)."""
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"K10 takes 1 to {MAX_BINS} fields, got {bins}")
    for m in (8, 4, 2, 1):
        smem = (2 * bins * 32 * m + 2 * TRIPLES_PER_CTA) * 8
        if smem <= SMEM_LIMIT:
            break
    tile = 32 * m
    resident = max(1, min(2048 // _THREADS, 233472 // (smem + 1024)))
    ny = _cdiv(n_triples, TRIPLES_PER_CTA)
    nx = max(1, min(_cdiv(n, tile), _cdiv(WAVES * sms * resident, ny)))
    per = _cdiv(_cdiv(n, nx), tile) * tile
    return m, per, _cdiv(n, per)


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
    (B, N) float32 and triples (T, 3) int32 (sorted by (i, j, l), as
    `metrics.bispectrum` lists them), the same bit for bit from launch to
    launch.  Two launches: the CTAs' partial sums, then their ordered sum."""
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
    m, per, nx = bispectrum_plan(n, bins, t, sms)
    lib = _kernels.cuda_library()
    F, U, triples = F.contiguous(), U.contiguous(), triples.contiguous()
    partial = torch.empty(nx, t, 2, dtype=torch.float64, device=F.device)
    out = torch.empty(t, 2, dtype=torch.float64, device=F.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(F.device).cuda_stream)
    code = lib.bispectrum_sums(_ptr(F), _ptr(U), ctypes.c_longlong(n), ctypes.c_int(bins),
                               _ptr(triples), ctypes.c_int(t), ctypes.c_int(m),
                               ctypes.c_longlong(per), ctypes.c_int(nx), _ptr(partial), _ptr(out),
                               stream)
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
