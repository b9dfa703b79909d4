"""Wavevectors, Fourier filter kernels and mass-assignment windows.

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

from montecosmo_tpu_torch.utils.safe import safe_div

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


def invlaplace_hat(kvec):
    """-1/k^2, with the zero mode mapped to zero."""
    kk = sum(ki**2 for ki in kvec)
    return -safe_div(torch.ones_like(kk), kk)


def gradient_hat(kvec, direction: int):
    """The spatial gradient along `direction`: i*k."""
    return 1j * kvec[direction]


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


def window_hat(kvec, order: int, kernel_type="rectangular", oversamp=1.0):
    """Fourier transform of the selected paint window."""
    if kernel_type == "rectangular":
        return bspline_hat(kvec, order)
    raise NotImplementedError(
        "kernel_type='kaiser_bessel' is not ported yet (ROADMAP Queue B, B1)")
