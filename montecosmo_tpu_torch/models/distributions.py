"""Distributions of the field-level model's main path.

`Normal`, the detruncated priors `DetruncTruncNorm` / `DetruncUnif` (priors
in unconstrained sample space whose push-forward through `std2trunc` is a
TruncatedNormal / Uniform), and the `QuadGaussian` field likelihood.
`sample` takes a `torch.Generator`.

Parity: `montecosmo_tpu/models/distributions.py:65-95, 96-143, 179-257,
338-413`.
"""
import math

import numpy as np
import torch

from montecosmo_tpu_torch.models.truncnorm import std2trunc, trunc2std
from montecosmo_tpu_torch.utils import to_tensor

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _norm_logpdf(z):
    return -0.5 * z**2 - _HALF_LOG_2PI


def _shape(*xs):
    return torch.broadcast_shapes(*(tuple(np.shape(x)) if not torch.is_tensor(x)
                                    else tuple(x.shape) for x in xs))


def _device(*xs):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return None


def _randn(gen, shape, *like):
    device = _device(*like) or gen.device
    eps = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return eps.to(device)


def _rand(gen, shape, *like):
    device = _device(*like) or gen.device
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u.to(device)


def _grad_of_push(push, value):
    """Elementwise d push(value) / d value, itself differentiable (the
    log-Jacobian of the detruncated priors enters the log-density)."""
    with torch.enable_grad():
        v = value if value.requires_grad else value.detach().requires_grad_(True)
        y = push(v)
        (dy,) = torch.autograd.grad(y.sum(), v, create_graph=value.requires_grad)
    return y, dy


class Distribution:
    def sample(self, gen, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale)

    def sample(self, gen, sample_shape=()):
        eps = _randn(gen, tuple(sample_shape) + self.batch_shape, self.loc, self.scale)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        scale = to_tensor(self.scale, value.device)
        z = (value - self.loc) / scale
        return -0.5 * z**2 - torch.log(scale) - _HALF_LOG_2PI


class TruncatedNormal(Distribution):
    def __init__(self, loc=0.0, scale=1.0, low=-np.inf, high=np.inf):
        self.loc, self.scale, self.low, self.high = loc, scale, low, high

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale, self.low, self.high)

    def sample(self, gen, sample_shape=()):
        eps = _randn(gen, tuple(sample_shape) + self.batch_shape, self.loc)
        return std2trunc(eps, self.loc, self.scale, self.low, self.high)

    def log_prob(self, value):
        d = value.device
        loc, scale, low, high = (to_tensor(x, d) for x in (self.loc, self.scale, self.low, self.high))
        a, b = (low - loc) / scale, (high - loc) / scale
        z = (value - loc) / scale
        # log(Phi(b) - Phi(a)) on the half-line where log_ndtr is accurate
        flip = a + b > 0
        lo, hi = torch.where(flip, -b, a), torch.where(flip, -a, b)
        la, lb = torch.special.log_ndtr(lo), torch.special.log_ndtr(hi)
        log_norm = lb + torch.log(-torch.expm1(torch.clamp(la - lb, max=-1e-38)))
        lp = _norm_logpdf(z) - torch.log(scale) - log_norm
        inside = (low <= value) & (value <= high)
        return torch.where(inside, lp, torch.full_like(lp, -np.inf))


class Uniform(Distribution):
    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = low, high

    @property
    def batch_shape(self):
        return _shape(self.low, self.high)

    def sample(self, gen, sample_shape=()):
        u = _rand(gen, tuple(sample_shape) + self.batch_shape, self.low)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        low, high = to_tensor(self.low, value.device), to_tensor(self.high, value.device)
        inside = (low <= value) & (value <= high)
        lp = torch.broadcast_to(-torch.log(high - low), value.shape)
        return torch.where(inside, lp, torch.full_like(lp, -np.inf))


class DetruncTruncNorm(Distribution):
    """Prior in sample space whose push-forward through
    `std2trunc(., loc_fid, scale_fid, low, high)` is
    TruncatedNormal(loc, scale, low, high)."""

    def __init__(self, loc=0.0, scale=1.0, low=-np.inf, high=np.inf,
                 loc_fid=None, scale_fid=None):
        self.loc, self.scale, self.low, self.high = loc, scale, low, high
        self.loc_fid = loc if loc_fid is None else loc_fid
        self.scale_fid = scale if scale_fid is None else scale_fid

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale, self.low, self.high, self.loc_fid, self.scale_fid)

    def sample(self, gen, sample_shape=()):
        y = TruncatedNormal(self.loc, self.scale, self.low, self.high).sample(gen, sample_shape)
        return trunc2std(y, self.loc_fid, self.scale_fid, self.low, self.high)

    def log_prob(self, value):
        value = torch.broadcast_to(value, _shape(value, *(self.loc, self.scale, self.low,
                                                          self.high, self.loc_fid,
                                                          self.scale_fid)))
        push = lambda v: std2trunc(v, self.loc_fid, self.scale_fid, self.low, self.high)
        y, dy = _grad_of_push(push, value)
        # floor: far beyond the bounds the soft-tail slope underflows to 0
        ladj = torch.log(dy.abs() + 1e-30)
        return TruncatedNormal(self.loc, self.scale, self.low, self.high).log_prob(y) + ladj


class DetruncUnif(Distribution):
    """Prior in sample space whose push-forward through
    `std2trunc(., loc_fid, scale_fid, low, high)` is Uniform(low, high)."""

    def __init__(self, low=0.0, high=1.0, loc_fid=None, scale_fid=None):
        self.low, self.high = low, high
        self.loc_fid = (np.add(high, low)) / 2 if loc_fid is None else loc_fid
        self.scale_fid = np.subtract(high, low) / 12**0.5 if scale_fid is None else scale_fid

    @property
    def batch_shape(self):
        return _shape(self.low, self.high, self.loc_fid, self.scale_fid)

    def sample(self, gen, sample_shape=()):
        y = Uniform(self.low, self.high).sample(gen, sample_shape)
        return trunc2std(y, self.loc_fid, self.scale_fid, self.low, self.high)

    def log_prob(self, value):
        value = torch.broadcast_to(value, _shape(value, self.low, self.high, self.loc_fid,
                                                 self.scale_fid))
        push = lambda v: std2trunc(v, self.loc_fid, self.scale_fid, self.low, self.high)
        y, dy = _grad_of_push(push, value)
        ladj = torch.log(dy.abs() + 1e-30)
        low, high = to_tensor(self.low, value.device), to_tensor(self.high, value.device)
        y = torch.minimum(torch.maximum(y, low + 1e-30), high - 1e-30)
        return Uniform(self.low, self.high).log_prob(y) + ladj


class QuadGaussian(Distribution):
    """Quadratic-in-Gaussian noise, mean-subtracted:
        obs = loc + scale1 eps + scale2 (eps^2 - 1),  eps ~ N(0,1).
    Exact two-preimage density on its bounded support; Normal(loc, scale1)
    below |scale2| < LINEAR_TOL.  The guarded `root` keeps the
    `where(u > 0, lp, -inf)` NaN-free in reverse mode."""

    LINEAR_TOL = 1e-8

    def __init__(self, loc=0.0, scale1=1.0, scale2=0.0):
        self.loc, self.scale1, self.scale2 = loc, scale1, scale2

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale1, self.scale2)

    def sample(self, gen, sample_shape=()):
        eps = _randn(gen, tuple(sample_shape) + self.batch_shape, self.loc, self.scale1)
        return self.loc + self.scale1 * eps + self.scale2 * (eps**2 - 1.0)

    def _completed_square(self, value):
        s2 = to_tensor(self.scale2, value.device)
        curv = torch.where(s2.abs() < 1e-12, torch.ones_like(s2), s2)
        h = self.scale1 / (2.0 * curv)
        u = (value - self.loc) / curv + 1.0 + h**2
        root = torch.sqrt(torch.where(u > 0, u, torch.ones_like(u)))
        return curv, h, u, root

    def log_prob(self, value):
        curv, h, u, root = self._completed_square(value)
        two_phi = torch.logaddexp(_norm_logpdf(root - h), _norm_logpdf(root + h))
        lp = two_phi - torch.log(2.0 * curv.abs() * root)
        lp = torch.where(u > 0, lp, torch.full_like(lp, -np.inf))
        scale1 = to_tensor(self.scale1, value.device)
        lp_lin = _norm_logpdf((value - self.loc) / scale1) - torch.log(scale1)
        linear = to_tensor(self.scale2, value.device).abs() < self.LINEAR_TOL
        return torch.where(linear, lp_lin, lp)
