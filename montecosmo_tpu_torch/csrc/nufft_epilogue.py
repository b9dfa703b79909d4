"""NUFFT epilogue (K3), Triton: one fused elementwise pass over the rfft grid.

Forward, for the stacked rffts F_s (s = 0..n-1) of n interlaced paints:

    out = sum_s F_s exp(i s/n (kx + ky + kz)) / n * scale / bspline_hat(k, order)

Backward (torch's convention for complex tensors, grad = dL/d conj(z)):

    dF_s = g * exp(-i s/n (kx + ky + kz)) / n * scale / bspline_hat(k, order)

Replaces the phase sum of montecosmo_tpu/ops/paint.py::interlace (:192-195)
and the units jacobian and window deconvolution of ::nufft (:233-237), which
XLA fused on the TPU.  k is computed from the element index, so no kernel
mesh is read.  What bounds it on an H100: memory traffic, (n + 1) complex64
values per element (2 x 45 MB in, 45 MB out at the 224^3 paint mesh of the
128^3 flagship), no reuse; hence Triton and a plain blocked elementwise map.
Complex tensors are passed as `torch.view_as_real` float32 pairs.

Nothing here imports triton at module import: `build()` does, at the first
launch.
"""
import math

tl = None  # triton.language, bound by build()
_KERNEL = None


def build():
    """Import triton and define the kernel (once per process)."""
    global tl, _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as _tl

    tl = _tl

    @triton.jit
    def nufft_epilogue_kernel(src, dst, M, Y, ZC, X, Z, HX, HY, c0,
                              N_SHIFT: tl.constexpr, ORDER: tl.constexpr,
                              BACKWARD: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        e = pid * BLOCK + tl.arange(0, BLOCK)
        mask = e < M
        iz = e % ZC
        t = e // ZC
        iy = t % Y
        ix = t // Y
        fx = tl.where(ix < HX, ix, ix - X).to(tl.float32) / X
        fy = tl.where(iy < HY, iy, iy - Y).to(tl.float32) / Y
        fz = iz.to(tl.float32) / Z
        ksum = 6.283185307179586 * (fx + fy + fz)
        c = tl.zeros([BLOCK], dtype=tl.float32) + c0
        if ORDER > 0:
            # sinc(f) = sin(pi f) / (pi f), the B-spline window per axis
            ax = 3.141592653589793 * fx
            ay = 3.141592653589793 * fy
            az = 3.141592653589793 * fz
            sx = tl.where(fx == 0, 1.0, tl.sin(ax) / tl.where(fx == 0, 1.0, ax))
            sy = tl.where(fy == 0, 1.0, tl.sin(ay) / tl.where(fy == 0, 1.0, ay))
            sz = tl.where(fz == 0, 1.0, tl.sin(az) / tl.where(fz == 0, 1.0, az))
            wk = sx * sy * sz
            wo = wk
            for _ in tl.static_range(ORDER - 1):
                wo = wo * wk
            c = c / wo
        if BACKWARD:
            gr = tl.load(src + 2 * e, mask=mask, other=0.0)
            gi = tl.load(src + 2 * e + 1, mask=mask, other=0.0)
            for s in tl.static_range(N_SHIFT):
                th = ksum * (s / N_SHIFT)
                cs = tl.cos(th)
                sn = tl.sin(th)
                tl.store(dst + s * 2 * M + 2 * e, (gr * cs + gi * sn) * c, mask=mask)
                tl.store(dst + s * 2 * M + 2 * e + 1, (gi * cs - gr * sn) * c, mask=mask)
        else:
            accr = tl.zeros([BLOCK], dtype=tl.float32)
            acci = tl.zeros([BLOCK], dtype=tl.float32)
            for s in tl.static_range(N_SHIFT):
                fr = tl.load(src + s * 2 * M + 2 * e, mask=mask, other=0.0)
                fi = tl.load(src + s * 2 * M + 2 * e + 1, mask=mask, other=0.0)
                th = ksum * (s / N_SHIFT)
                cs = tl.cos(th)
                sn = tl.sin(th)
                accr += fr * cs - fi * sn
                acci += fr * sn + fi * cs
            tl.store(dst + 2 * e, accr * c, mask=mask)
            tl.store(dst + 2 * e + 1, acci * c, mask=mask)

    _KERNEL = nufft_epilogue_kernel
    return _KERNEL


BLOCK = 1024


def launch(src, dst, shape, n_shift, scale, order, backward):
    """Launch on the current stream.  src/dst: float32 (..., 2) views."""
    kernel = build()
    X, Y, Z = shape
    ZC = Z // 2 + 1
    M = X * Y * ZC
    grid = (math.ceil(M / BLOCK),)
    kernel[grid](src, dst, M, Y, ZC, X, Z, X // 2, Y // 2, float(scale) / n_shift,
                 N_SHIFT=n_shift, ORDER=order, BACKWARD=bool(backward), BLOCK=BLOCK,
                 num_warps=4)
