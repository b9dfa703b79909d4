"""Wavevectors, Fourier filter kernels and mass-assignment windows (the
B-splines and the Kaiser-Bessel window, and their Fourier transforms).

Kernel factories return broadcast-shaped float32 tensors ((N,1,1), (1,N,1),
(1,1,N/2+1)), so `sum(ki**2 for ki in kvec)` broadcasts to the rfft mesh.
The transforms are `torch.fft` (cuFFT on the card) with the "backward" norm.

Parity: `montecosmo_tpu/ops/fourier.py:48-275`.  `lazy_kvec` and the pencil
island are compiler and sharding workarounds of the JAX package and have no
counterpart here.
"""
from functools import lru_cache

import numpy as np
import torch

from montecosmo_tpu_torch.utils.safe import safe_div, safe_sqrt

_DIMS = (-3, -2, -1)


def rfftn(x):
    """3-D real FFT over the last three axes."""
    return torch.fft.rfftn(x, dim=_DIMS)


def irfftn(x):
    """Inverse of `rfftn` (even last extent)."""
    return torch.fft.irfftn(x, dim=_DIMS)


@lru_cache(maxsize=None)
def _rfftk_np(shape, box_size):
    dim = len(shape)
    scales = dim * (2 * np.pi,) if box_size is None else tuple(
        2 * np.pi * s / b for s, b in zip(shape, box_size))
    kvec = ()
    for ax, (s, sc) in enumerate(zip(shape, scales)):
        freq = np.fft.rfftfreq(s) if ax == dim - 1 else np.fft.fftfreq(s)
        bshape = [1] * dim
        bshape[ax] = -1
        kvec += ((freq * sc).astype(np.float32).reshape(bshape),)
    return kvec


@lru_cache(maxsize=None)
def _rfftk_cached(shape, box_size, device):
    return tuple(torch.as_tensor(k, device=device) for k in _rfftk_np(shape, box_size))


def rfftk(shape, box_size=None, device="cpu"):
    """Broadcast-shaped wavevectors for `rfftn`: cell units (k in [-pi, pi[)
    by default, physical units (h/Mpc) when `box_size` is given."""
    shape = tuple(int(s) for s in shape)
    box = None if box_size is None else tuple(float(b) for b in np.broadcast_to(
        box_size, (len(shape),)))
    return _rfftk_cached(shape, box, str(torch.device(device)))


def invlaplace_hat(kvec, fd_order=np.inf):
    """The inverse Laplacian, -1/k^2 (fd_order inf), or the inverse of the
    2nd- or 4th-order finite-difference Laplacian, whose eigenvalues are
    -sum_i 2 (1 - cos k_i) and -sum_i (cos 2k_i - 16 cos k_i + 15) / 6; the
    zero mode maps to zero.

    At fd_order 2 the JAX package takes kk = sum_i 2 (cos k_i - 1), the
    Laplacian's eigenvalue itself, so its -1/kk has the sign of +1/k^2
    (repulsive forces); here kk is minus the eigenvalue at every order
    (ROADMAP, the kept differences)."""
    if fd_order == 2:
        kk = sum(2 * (1 - torch.cos(ki)) for ki in kvec)
    elif fd_order == 4:
        kk = sum((torch.cos(2 * ki) - 16 * torch.cos(ki) + 15) / 6 for ki in kvec)
    elif fd_order == np.inf:
        kk = sum(ki**2 for ki in kvec)
    else:
        raise ValueError("fd_order must be 2, 4, or inf.")
    return -safe_div(torch.ones_like(kk), kk)


def gradient_hat(kvec, direction: int, fd_order=np.inf):
    """The spatial gradient along `direction`: i k (fd_order inf), or the
    2nd- or 4th-order central difference, i sin k or i (8 sin k - sin 2k) / 6."""
    ki = kvec[direction]
    if fd_order == 2:
        ki = torch.sin(ki)
    elif fd_order == 4:
        ki = (8 * torch.sin(ki) - torch.sin(2 * ki)) / 6
    elif fd_order != np.inf:
        raise ValueError("fd_order must be 2, 4, or inf.")
    return 1j * ki


def gaussian_hat(kvec, kcut=np.inf):
    """Gaussian low-pass filter with cutoff wavenumber `kcut`."""
    if kcut == np.inf:
        return 1.0
    kk = sum(ki**2 for ki in kvec)
    rcut = 2 * np.pi / kcut
    return torch.exp(-kk * rcut**2 / 2)


def top_hat(kvec, kcut=np.inf):
    """Isotropic boolean top-hat |k| < kcut."""
    if kcut == np.inf:
        return True
    kk = sum(ki**2 for ki in kvec)
    return kk < kcut**2


def bspline(s, order: int):
    """Real-space B-spline mass-assignment window (order 1: NGP, 2: CIC,
    3: TSC, 4: PCS); `s` is the signed distance to the cell in cell units."""
    s = s.abs()
    if order == 1:
        return torch.ones_like(s)
    if order == 2:
        return 1 - s
    if order == 3:
        return torch.where(s <= 0.5, 0.75 - s**2,
                           0.5 * torch.clamp(1.5 - s, min=0.0)**2)
    if order == 4:
        return torch.where(s <= 1.0, (4 - 6 * s**2 + 3 * s**3) / 6,
                           torch.clamp(2.0 - s, min=0.0)**3 / 6)
    raise ValueError("B-spline order must be in 1..4.")


def dbspline(s, order: int):
    """d/ds of `bspline` at signed distances `s`, as JAX differentiates it
    (zero at s = 0 and outside the support); the adjoints of the paint and
    the read use it."""
    a, sg = s.abs(), torch.sign(s)
    if order == 1:
        return torch.zeros_like(s)
    if order == 2:
        return -sg
    if order == 3:
        return sg * torch.where(a <= 0.5, -2 * a, -torch.clamp(1.5 - a, min=0.0))
    if order == 4:
        return sg * torch.where(a <= 1.0, (-12 * a + 9 * a**2) / 6,
                                -0.5 * torch.clamp(2.0 - a, min=0.0)**2)
    raise ValueError("B-spline order must be in 1..4.")


def bspline_hat(kvec, order: int = 2):
    """Fourier transform of the order-n B-spline window: prod_i sinc(k_i/2pi)^n."""
    out = 1.0
    for ki in kvec:
        out = out * torch.sinc(ki / (2 * np.pi))**order
    return out


def optim_kcut(oversamp, safety=0.98):
    """Near-optimal k-cutoff for PSWF-like (Kaiser-Bessel) kernels at a given
    oversampling factor (Barnett+2019 arXiv:1808.06736)."""
    return safety * np.pi * (2 - 1 / oversamp)


def kaiser_bessel_norm(order, kcut):
    """(beta, norm) of the Kaiser-Bessel window of support `order`:
    beta = kcut order / 2 and norm = order sinh(beta) / beta."""
    beta = kcut * order / 2
    return beta, order * np.sinh(beta) / beta


def kaiser_bessel(s, order, kcut):
    """Kaiser-Bessel window of support `order` cells (Barnett+2019) at signed
    distances `s`: i0(beta sqrt(1 - u^2)) / norm, u = 2 s / order.  The
    square root is `safe_sqrt`, so autograd gives a zero (not NaN) derivative
    where 1 - u^2 <= 0; `dkaiser_bessel` is the derivative itself."""
    u = s * 2 / order
    beta, norm = kaiser_bessel_norm(order, kcut)
    return torch.special.i0(beta * safe_sqrt(1 - u**2)) / np.float32(norm)


def dkaiser_bessel(s, order, kcut):
    """d/ds of `kaiser_bessel`: -(i1(z) / z) beta^2 u (2 / order) / norm with
    z = beta sqrt(1 - u^2), and i1(z) / z taken as its limit 1/2 at z = 0 (the
    support edge, where JAX's autodiff of the window gives NaN)."""
    u = s * 2 / order
    beta, norm = kaiser_bessel_norm(order, kcut)
    z = beta * safe_sqrt(1 - u**2)
    inside = z > 0
    ratio = torch.where(inside, torch.special.i1(z) / torch.where(inside, z, torch.ones_like(z)),
                        torch.full_like(z, 0.5))
    return -ratio * u * np.float32(beta**2 * 2 / order / norm)


def kaiser_bessel_hat(kvec, order, kcut):
    """Fourier transform of the Kaiser-Bessel window (Barnett+2019): per axis
    sinh(d)/d for |k| <= beta and sin(d)/d beyond, d = |beta^2 - k^2|^1/2
    (k scaled by order/2), over sinh(beta)/beta.  At d = 0 both are 1 (JAX's
    formula gives 0/0 there)."""
    beta = kcut * order / 2

    def kernel(k):
        k = k * order / 2
        dist = (beta**2 - k**2).abs() ** 0.5
        zero = dist == 0
        safe = torch.where(zero, torch.ones_like(dist), dist)
        out = torch.where(k.abs() <= beta, torch.sinh(safe) / safe, torch.sin(safe) / safe)
        out = torch.where(zero, torch.ones_like(out), out)
        return out / np.float32(np.sinh(beta) / beta)

    out = 1.0
    for ki in kvec:
        out = out * kernel(ki)
    return out


def window_hat(kvec, order: int, kernel_type="rectangular", oversamp=1.0):
    """Fourier transform of the selected paint window."""
    if kernel_type == "rectangular":
        return bspline_hat(kvec, order)
    if kernel_type == "kaiser_bessel":
        return kaiser_bessel_hat(kvec, order, optim_kcut(oversamp))
    raise ValueError(f"Unknown kernel type: {kernel_type}")


def deconv_paint(mesh, order: int = 2, kernel_type="rectangular", oversamp=1.0):
    """Deconvolve a painted mesh by its paint window: a real mesh through an
    rfftn/irfftn pair, an rfft mesh by one elementwise division."""
    from montecosmo_tpu_torch.ops.hermitian import ch2rshape

    if not mesh.is_complex():
        kvec = rfftk(mesh.shape, device=mesh.device)
        return irfftn(rfftn(mesh) / window_hat(kvec, order, kernel_type, oversamp))
    kvec = rfftk(ch2rshape(mesh.shape), device=mesh.device)
    return mesh / window_hat(kvec, order, kernel_type, oversamp)
