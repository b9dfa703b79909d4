"""NUFFT epilogue (K3), Triton: one fused elementwise pass over the rfft grid.

Forward, for the stacked rffts F_s (s = 0..n-1) of n interlaced paints:

    out = sum_s F_s exp(i s/n (kx + ky + kz)) / n * scale / W(k)

Backward (torch's convention for complex tensors, grad = dL/d conj(z)):

    dF_s = g * exp(-i s/n (kx + ky + kz)) / n * scale / W(k)

W is the paint window's Fourier transform: bspline_hat(k, order) (prod_i
sinc^order), or with `KB` the Kaiser-Bessel kaiser_bessel_hat(k, order,
kcut) (ops/fourier.py), per axis sinh(d)/d where |k order/2| <= beta and
sin(d)/d beyond, d = |beta^2 - (k order/2)^2|^1/2, beta = kcut order/2; its
norm (sinh(beta)/beta)^3 is folded into the constant factor on the host.
Triton has no sinh: below d = 0.5 both ratios are their Taylor series to
d^6 (the (e^d - e^-d)/2d form loses ~eps/d there), above it the
exponential form.  At the cutoffs the model uses (below pi: the JAX
package's factor final/paint < 1) sin(d)/d crosses zero inside the paint
grid, and 1/W(k) there amplifies any rounding of k and sin(d): so k is
computed as `ops/fourier.py::rfftk` computes it (the float64 frequency times
2 pi, rounded to float32) and the tail rounds k^2 and beta^2 - k^2 apart
(no fused multiply-add) and takes the IEEE square root and division and
libdevice's sin: the arithmetic of the plain version.

Replaces the phase sum of montecosmo_tpu/ops/paint.py::interlace (:192-195)
and the units jacobian and window deconvolution of ::nufft (:233-237, via
ops/fourier.py::window_hat at kernel_type 'rectangular' or 'kaiser_bessel'),
which XLA fused on the TPU.  k is computed from the element index, so no kernel
mesh is read.  What bounds it on an H100: memory traffic, (n + 1) complex64
values per element (2 x 45 MB in, 45 MB out at the 224^3 paint mesh of the
128^3 flagship), no reuse; hence Triton and a plain blocked elementwise map.
Complex tensors are passed as `torch.view_as_real` float32 pairs.

Nothing here imports triton at module import: `build()` does, at the first
launch.
"""
import math

tl = None  # triton.language, bound by build()
libdevice = None  # triton's CUDA libdevice bindings, bound by build()
kb_axis = None  # the Kaiser-Bessel factor of one axis, bound by build()
_KERNEL = None


def build():
    """Import triton and define the kernel (once per process)."""
    global tl, libdevice, kb_axis, _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as _tl
    from triton.language.extra import libdevice as _libdevice

    tl, libdevice = _tl, _libdevice

    @triton.jit
    def _kb_axis(i, n, beta, beta2, ORDER: tl.constexpr):
        """sinh(d)/d or sin(d)/d of one axis (i the signed frequency index of
        an axis of n cells), without the norm."""
        k = (i.to(tl.float64) * (1.0 / n.to(tl.float64)) * 6.283185307179586).to(tl.float32)
        k = k * ORDER * 0.5
        # rounded as torch rounds it: k^2, then the difference (no FMA)
        d = tl.sqrt_rn(tl.abs(libdevice.sub_rn(beta2, libdevice.mul_rn(k, k))))
        small = d < 0.5
        dd = d * d
        safe = tl.where(small, 1.0, d)
        e = tl.exp(safe)
        odd = dd * dd * dd / 5040.0
        sinh_d = tl.where(small, 1.0 + dd / 6.0 + dd * dd / 120.0 + odd,
                          (e - 1.0 / e) * 0.5 / safe)
        sin_d = tl.where(small, 1.0 - dd / 6.0 + dd * dd / 120.0 - odd,
                         tl.div_rn(libdevice.sin(safe), safe))
        return tl.where(tl.abs(k) <= beta, sinh_d, sin_d)

    kb_axis = _kb_axis

    @triton.jit
    def nufft_epilogue_kernel(src, dst, M, Y, ZC, X, Z, HX, HY, c0, beta, beta2,
                              N_SHIFT: tl.constexpr, ORDER: tl.constexpr, KB: tl.constexpr,
                              BACKWARD: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        e = pid * BLOCK + tl.arange(0, BLOCK)
        mask = e < M
        iz = e % ZC
        t = e // ZC
        iy = t % Y
        ix = t // Y
        jx = tl.where(ix < HX, ix, ix - X)
        jy = tl.where(iy < HY, iy, iy - Y)
        fx = jx.to(tl.float32) / X
        fy = jy.to(tl.float32) / Y
        fz = iz.to(tl.float32) / Z
        ksum = 6.283185307179586 * (fx + fy + fz)
        c = tl.zeros([BLOCK], dtype=tl.float32) + c0
        if KB:
            c = c / (kb_axis(jx, X, beta, beta2, ORDER) * kb_axis(jy, Y, beta, beta2, ORDER)
                     * kb_axis(iz, Z, beta, beta2, ORDER))
        elif ORDER > 0:
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


def launch(src, dst, shape, n_shift, scale, order, backward, kcut=None):
    """Launch on the current stream.  src/dst: float32 (..., 2) views;
    `kcut` the Kaiser-Bessel cutoff (None: the B-spline window)."""
    kernel = build()
    X, Y, Z = shape
    ZC = Z // 2 + 1
    M = X * Y * ZC
    grid = (math.ceil(M / BLOCK),)
    c0, beta = float(scale) / n_shift, 0.0
    kb = bool(order) and kcut is not None
    if kb:
        beta = kcut * order / 2
        c0 *= (math.sinh(beta) / beta) ** 3
    kernel[grid](src, dst, M, Y, ZC, X, Z, X // 2, Y // 2, c0, beta, beta**2,
                 N_SHIFT=n_shift, ORDER=order, KB=kb, BACKWARD=bool(backward), BLOCK=BLOCK,
                 num_warps=4)
