"""Truncated-normal transport: bijection between a standard normal variable
and a general truncated normal, stable in float32.

Body: CDF transport through the normal CDF/PPF (`ndtr` below /
`torch.special.ndtri`), evaluated on the numerically favorable side of 0; tails beyond
8 sigma: a softmin/softmax between the identity and the bound.  All branches
are evaluated on clipped inputs and combined with `torch.where`, so every
branch stays finite where it is not selected (double-where discipline).

Parity: `montecosmo_tpu/models/truncnorm.py:22-113`.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.safe import logaddexp

_TAIL_TEMP = 1 / 6.2842226 / 2
_LIM = 8.0
_EPS = float(np.finfo(np.float32).eps)

ndtri = torch.special.ndtri
_HALF_SQRT_2 = 0.5 * 2**0.5


def ndtr(x):
    """Standard normal CDF, accurate in both float32 tails: erfc away from 0
    (`torch.special.ndtr` uses 1 + erf and underflows to 0 below -5.4 sigma
    in float32), the same formulation as jax.scipy.special.ndtr."""
    w = x * _HALF_SQRT_2
    z = w.abs()
    y = torch.where(z < _HALF_SQRT_2, 1 + torch.erf(w),
                    torch.where(w > 0, 2 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _softmax_pair(a, b):
    return _TAIL_TEMP * logaddexp(a / _TAIL_TEMP, b / _TAIL_TEMP)


def _softmin_pair(a, b):
    return -_softmax_pair(-a, -b)


def _safe_ppf(p):
    return ndtri(torch.clamp(p, 1e-37, 1 - _EPS))


def _body(x, low, high):
    xc = torch.clamp(x, -_LIM, _LIM)
    cdf_low, cdf_high = ndtr(low), ndtr(high)
    y_low = _safe_ppf(cdf_low + (cdf_high - cdf_low) * ndtr(xc))
    cdf_nlow, cdf_nhigh = ndtr(-low), ndtr(-high)
    y_high = -_safe_ppf(cdf_nhigh - (cdf_nhigh - cdf_nlow) * ndtr(-xc))
    return torch.where(xc < 0, y_low, y_high)


def std2trunc(x, loc=0.0, scale=1.0, low=-np.inf, high=np.inf):
    """Transport a standard normal variable to a
    TruncNormal(loc, scale, low, high) variable."""
    loc, scale, low, high = (to_tensor(v, x.device) for v in (loc, scale, low, high))
    low = (low - loc) / scale
    high = (high - loc) / scale
    body = _body(x, low, high)
    lowtail = _softmax_pair(x, torch.broadcast_to(torch.clamp(low, min=-1e30), x.shape))
    hightail = _softmin_pair(x, torch.broadcast_to(torch.clamp(high, max=1e30), x.shape))
    out = torch.where((x < -_LIM) & (low < -_LIM), lowtail,
                      torch.where((_LIM < x) & (_LIM < high), hightail, body))
    return loc + scale * out


def _invbody(y, low, high):
    yc = torch.minimum(torch.maximum(y, torch.clamp(low, min=-_LIM)),
                       torch.clamp(high, max=_LIM))
    cdf_low, cdf_high = ndtr(low), ndtr(high)
    x_low = _safe_ppf((ndtr(yc) - cdf_low) / (cdf_high - cdf_low))
    cdf_nlow, cdf_nhigh = ndtr(-low), ndtr(-high)
    x_high = -_safe_ppf((cdf_nhigh - ndtr(-yc)) / (cdf_nhigh - cdf_nlow))
    return torch.where(yc < 0, x_low, x_high)


def _inv_lowtail(y, low):
    u = torch.clamp((low - y) / _TAIL_TEMP, max=-1e-12)
    return y + _TAIL_TEMP * torch.log(-torch.expm1(u))


def trunc2std(y, loc=0.0, scale=1.0, low=-np.inf, high=np.inf):
    """Inverse of `std2trunc`."""
    loc, scale, low, high = (to_tensor(v, y.device) for v in (loc, scale, low, high))
    y = (y - loc) / scale
    low = (low - loc) / scale
    high = (high - loc) / scale
    body = _invbody(y, low, high)
    lowf = torch.clamp(low, min=-1e30)
    highf = torch.clamp(high, max=1e30)
    lowtail = _inv_lowtail(y, torch.broadcast_to(lowf, y.shape))
    hightail = -_inv_lowtail(-y, torch.broadcast_to(-highf, y.shape))
    return torch.where((y < -_LIM) & (low < -_LIM), lowtail,
                       torch.where((_LIM < y) & (_LIM < high), hightail, body))
