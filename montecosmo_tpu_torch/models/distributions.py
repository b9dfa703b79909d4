"""Distributions of the field-level model's paths.

`Normal`, the detruncated priors `DetruncTruncNorm` / `DetruncUnif` (priors
in unconstrained sample space whose push-forward through `std2trunc` is a
TruncatedNormal / Uniform), the field likelihoods `QuadGaussian`,
`Poisson`, `TwoQuadGaussian` and the moment-standardized `SinhArcsinh`, and
`BlockMultivariateNormal` (the powspec observable), and two noise models
on no model path: the moment-parametrized `SkewNormal` (with Owen's T for
its cdf and `match_quadratic_gaussian`) and the cubic-in-Gaussian
`CubGaussian`.  `sample` takes a `torch.Generator`; the likelihoods have
`cdf` and `log_cdf` (per-voxel cumulative densities, `Model.logdf_mesh`).

Parity: `montecosmo_tpu/models/distributions.py:35-95, 96-143, 144-175,
179-257, 258-338, 338-470, 474-650, 674-728`.
"""
import math

import numpy as np
import torch
from numpy.polynomial.hermite_e import hermegauss
from numpy.polynomial.legendre import leggauss

from montecosmo_tpu_torch.models.truncnorm import ndtr, std2trunc, trunc2std
from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.safe import logaddexp

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _norm_logpdf(z):
    return -0.5 * z**2 - _HALF_LOG_2PI


_log_ndtr = torch.special.log_ndtr


def _norm_logcdf_interval(lo, hi):
    """log(Phi(hi) - Phi(lo)) for hi >= lo, in log space: the interval
    reflected onto the half-line where log_ndtr is accurate, then
    log Phi(b) + log(-expm1(log Phi(a) - log Phi(b)))."""
    flip = lo + hi > 0
    a, b = torch.where(flip, -hi, lo), torch.where(flip, -lo, hi)
    la, lb = _log_ndtr(a), _log_ndtr(b)
    return lb + torch.log(-torch.expm1(torch.clamp(la - lb, max=-1e-38)))


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

    def cdf(self, value):
        return ndtr((value - self.loc) / self.scale)

    def log_cdf(self, value):
        return _log_ndtr((value - self.loc) / self.scale)


class Poisson(Distribution):
    """Poisson counts of rate `rate` (a tensor).  `log_cdf` is
    log Q(floor(v) + 1, rate), the regularized upper incomplete gamma,
    differentiable in the rate; floor(v) carries no derivative."""

    def __init__(self, rate):
        self.rate = rate

    @property
    def batch_shape(self):
        return tuple(self.rate.shape)

    def sample(self, gen, sample_shape=()):
        rate = torch.broadcast_to(self.rate, tuple(sample_shape) + self.batch_shape)
        return torch.poisson(rate.to(gen.device), generator=gen).to(self.rate.device)

    def log_prob(self, value):
        return torch.special.xlogy(value, self.rate) - self.rate - torch.lgamma(value + 1)

    def log_cdf(self, value):
        q = torch.special.gammaincc(torch.floor(value).detach() + 1, self.rate)
        return torch.log(torch.clamp(q, 1e-300, 1.0))

    def cdf(self, value):
        return torch.exp(self.log_cdf(value))


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
    below |scale2| < LINEAR_TOL.

    The JAX package completes the square: with h = scale1 / (2 scale2),
    u = (obs - loc) / scale2 + 1 + h^2 = (eps + h)^2 and r = sqrt(u), the
    density is [phi(r - h) + phi(r + h)] / (2 |scale2| r).  For small
    |scale2 / scale1|, r - h cancels two numbers of size |h|, and
    log(2 |scale2| r) the derivatives of log|scale2| and log r, each of size
    1 / scale2: in float32 the gradient in scale2 is lost (the witness in
    tests/test_torch_quadgauss.py records the JAX package's error).  Here
    the same density is written in c = 2 scale2 / scale1 = 1 / h and
    w = 2 (obs - loc) / scale1 + c, whose sizes do not grow as scale2 -> 0:
    q = 1 + c w = c^2 u,
    the preimage pair {r - h, r + h} = {sign(c) w / (1 + sqrt q),
    (1 + sqrt q) / |c|} (phi is even, so the order does not matter), and
    2 |scale2| r = |scale1| sqrt q.  The support is q > 0; the guarded
    `root` keeps the `where(q > 0, lp, -inf)` NaN-free in reverse mode."""

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
        """(c, w, q, root): c = 1 / h, w = c ((obs - loc) / curv + 1),
        q = c^2 u and root = sqrt(q), guarded on q <= 0 (outside the
        support); curv is scale2 guarded away from 0 (the linear branch
        takes over there)."""
        s2 = to_tensor(self.scale2, value.device)
        curv = torch.where(s2.abs() < 1e-12, torch.ones_like(s2), s2)
        c = 2.0 * curv / self.scale1
        w = 2.0 * (value - self.loc) / self.scale1 + c
        q = 1.0 + c * w
        root = torch.sqrt(torch.where(q > 0, q, torch.ones_like(q)))
        return c, w, q, root

    def log_prob(self, value):
        c, w, q, root = self._completed_square(value)
        near, far = torch.sign(c) * w / (1.0 + root), (1.0 + root) / c.abs()
        two_phi = logaddexp(_norm_logpdf(near), _norm_logpdf(far))
        lp = two_phi - torch.log(to_tensor(self.scale1, value.device).abs() * root)
        lp = torch.where(q > 0, lp, torch.full_like(lp, -np.inf))
        scale1 = to_tensor(self.scale1, value.device)
        lp_lin = _norm_logpdf((value - self.loc) / scale1) - torch.log(scale1)
        linear = to_tensor(self.scale2, value.device).abs() < self.LINEAR_TOL
        return torch.where(linear, lp_lin, lp)

    def log_cdf(self, value):
        """log P(obs <= value), in the JAX package's completed square:
        curv = scale2 (guarded), h = scale1 / (2 curv), u = (value - loc) /
        curv + 1 + h^2; {obs <= value} is eps in [-h - sqrt u, -h + sqrt u]
        when curv > 0 (empty for u <= 0), its complement when curv < 0."""
        s2 = to_tensor(self.scale2, value.device)
        curv = torch.where(s2.abs() < 1e-12, torch.ones_like(s2), s2)
        h = self.scale1 / (2.0 * curv)
        u = (value - self.loc) / curv + 1.0 + h**2
        root = torch.sqrt(torch.where(u > 0, u, torch.ones_like(u)))
        lo, hi = -h - root, -h + root
        ninf = torch.full_like(u, -np.inf)
        opens_up = torch.where(u > 0, _norm_logcdf_interval(lo, hi), ninf)
        opens_down = torch.where(u > 0, logaddexp(_log_ndtr(lo), _log_ndtr(-hi)),
                                 torch.zeros_like(u))
        lc = torch.where(curv > 0, opens_up, opens_down)
        lc_lin = _log_ndtr((value - self.loc) / self.scale1)
        return torch.where(s2.abs() < self.LINEAR_TOL, lc_lin, lc)

    def cdf(self, value):
        return torch.exp(self.log_cdf(value))

    @property
    def mean(self):
        return torch.broadcast_to(torch.as_tensor(self.loc), self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(torch.as_tensor(self.scale1**2 + 2 * self.scale2**2),
                                  self.batch_shape)

    @property
    def third_central_moment(self):
        # E[(s1 e + s2 (e^2 - 1))^3] with E e^4 = 3, E e^6 = 15
        return torch.broadcast_to(
            torch.as_tensor(6.0 * self.scale1**2 * self.scale2 + 8.0 * self.scale2**3),
            self.batch_shape)


def _std_normal_quadrature(deg, like):
    """(nodes, weights) with E_{N(0,1)}[f] ~ sum_i w_i f(z_i) (probabilists'
    Gauss-Hermite), in `like`'s dtype (float32 unless float64) and device."""
    z, w = hermegauss(deg)
    dtype = torch.float64 if like.dtype == torch.float64 else torch.float32
    return (torch.as_tensor(z, dtype=dtype, device=like.device),
            torch.as_tensor(w / np.sqrt(2 * np.pi), dtype=dtype, device=like.device))


class SinhArcsinh(Distribution):
    """Sinh-arcsinh of a normal, standardized so that loc and scale ARE the
    mean and the standard deviation: x = loc + scale (g(eps) - E g) / Std g,
    g(eps) = sinh(tailweight (arcsinh(eps) + skewness)), eps ~ N(0, 1); E g
    and Var g by a fixed Gauss-Hermite rule (QUAD_DEG nodes)."""

    QUAD_DEG = 20

    def __init__(self, mean=0.0, std=1.0, skewness=0.0, tailweight=1.0):
        self.loc, self.scale = mean, std
        self.skewness, self.tailweight = skewness, tailweight

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale, self.skewness, self.tailweight)

    def _like(self):
        return next(x for x in (self.loc, self.scale, self.skewness, self.tailweight)
                    if torch.is_tensor(x))

    def _g(self, eps):
        return torch.sinh(self.tailweight * (torch.asinh(eps) + self.skewness))

    def _g_mean_std(self):
        """E g and Std g, the quadrature axis trailing."""
        like = self._like()
        z, w = _std_normal_quadrature(self.QUAD_DEG, like)
        t = to_tensor(self.tailweight, like.device)[..., None]
        s = to_tensor(self.skewness, like.device)[..., None]
        gz = torch.sinh(t * (torch.asinh(z) + s))
        mean_g = (w * gz).sum(-1)
        var_g = (w * gz**2).sum(-1) - mean_g**2
        return mean_g, torch.sqrt(var_g)

    def sample(self, gen, sample_shape=()):
        mg, sg = self._g_mean_std()
        eps = _randn(gen, tuple(sample_shape) + self.batch_shape, self._like())
        return self.loc + self.scale * (self._g(eps) - mg) / sg

    def _pullback(self, value):
        """value -> eps, with the raw variate and Std g."""
        mg, sg = self._g_mean_std()
        raw = mg + sg * (value - self.loc) / self.scale
        eps = torch.sinh(torch.asinh(raw) / self.tailweight - self.skewness)
        return eps, raw, sg

    def log_prob(self, value):
        eps, raw, sg = self._pullback(value)
        # d value / d eps = (scale / sg) g'(eps), g'(eps) = tailweight
        # sqrt(1 + g^2) / sqrt(1 + eps^2)
        log_fwd = (torch.log(to_tensor(self.scale, value.device)) - torch.log(sg)
                   + torch.log(to_tensor(self.tailweight, value.device))
                   + 0.5 * (torch.log1p(raw**2) - torch.log1p(eps**2)))
        return _norm_logpdf(eps) - log_fwd

    def cdf(self, value):
        return ndtr(self._pullback(value)[0])

    def log_cdf(self, value):
        return _log_ndtr(self._pullback(value)[0])


class TwoQuadGaussian(Distribution):
    """Two-field quadratic-in-Gaussian noise, obs = loc + scale1 eps1 +
    scale2 (eps2^2 - 1) with eps1, eps2 independent: a finite normal
    mixture sum_i w_i N(loc + scale2 (z_i^2 - 1), scale1) over a
    Gauss-Hermite rule in eps2 (n_quad nodes), one logsumexp over the
    trailing component axis."""

    def __init__(self, loc=0.0, scale1=1.0, scale2=0.0, n_quad=64):
        self.loc, self.scale1, self.scale2 = loc, scale1, scale2
        self.n_quad = n_quad

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale1, self.scale2)

    def sample(self, gen, sample_shape=()):
        shp = tuple(sample_shape) + self.batch_shape
        e1 = _randn(gen, shp, self.loc, self.scale1)
        e2 = _randn(gen, shp, self.loc, self.scale1)
        return self.loc + self.scale1 * e1 + self.scale2 * (e2**2 - 1.0)

    def _mixture(self, value):
        """(component means, log weights, scale), the component axis
        trailing."""
        z, w = _std_normal_quadrature(self.n_quad, value)
        loc = to_tensor(self.loc, value.device)[..., None]
        means = loc + to_tensor(self.scale2, value.device)[..., None] * (z**2 - 1.0)
        return means, torch.log(w), to_tensor(self.scale1, value.device)[..., None]

    def log_prob(self, value):
        means, logw, scale = self._mixture(value)
        comp = logw + _norm_logpdf((value[..., None] - means) / scale) - torch.log(scale)
        return torch.logsumexp(comp, -1)

    def log_cdf(self, value):
        means, logw, scale = self._mixture(value)
        return torch.logsumexp(logw + _log_ndtr((value[..., None] - means) / scale), -1)

    def cdf(self, value):
        return torch.exp(self.log_cdf(value))


# E|N(0, 1)|: the standardized-mean unit of the skew normal's half-normal part
_HALF_NORMAL_MEAN = np.sqrt(2.0 / np.pi)
# |skewness| as delta -> 1 (the attainable supremum)
_SKEW_SUP = 0.5 * (4.0 - np.pi) * (2.0 / (np.pi - 2.0)) ** 1.5
_DELTA_CAP = 1.0 - 1e-7


def _cbrt(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def _like(x, value):
    """`x` as a tensor on `value`'s device, a number in `value`'s dtype."""
    if torch.is_tensor(x):
        return x.to(value.device)
    return torch.as_tensor(x, dtype=value.dtype, device=value.device)


def _owens_t_reduced(h, a, nodes, weights):
    """Owen's T for 0 <= a <= 1 from its definition T(h, a) = (1/2pi)
    int_0^a exp(-h^2 (1 + x^2) / 2) / (1 + x^2) dx, the Gauss-Legendre
    nodes mapped onto [0, a]."""
    x = a[..., None] * nodes
    integrand = torch.exp(-0.5 * h[..., None] ** 2 * (1.0 + x * x)) / (1.0 + x * x)
    return a * (weights * integrand).sum(-1) / (2.0 * np.pi)


def _owens_t(h, a, nodes, weights):
    """Owen's T(h, a) for any real a: odd in a, |a| > 1 folded to 1/|a|
    through T(h, a) = [Phi(h) + Phi(ah)] / 2 - Phi(h) Phi(ah) - T(ah, 1/a)."""
    aa = a.abs()
    fold = aa > 1.0
    inv = 1.0 / torch.clamp(aa, min=1.0)
    base = _owens_t_reduced(torch.where(fold, aa * h, h), torch.where(fold, inv, aa),
                            nodes, weights)
    ph, pah = ndtr(h), ndtr(aa * h)
    folded = 0.5 * (ph + pah) - ph * pah - base
    return torch.sign(a) * torch.where(fold, folded, base)


class SkewNormal(Distribution):
    """Azzalini skew normal parametrized by its own moments (mean, std,
    skew), so that location and scale decouple from the shape.  The skewness
    gamma = (4 - pi) / 2 m^3 / (1 - m^2)^(3/2) of the standardized mean
    m = E|N(0,1)| delta is inverted through r = cbrt(2 gamma / (4 - pi)) =
    m / sqrt(1 - m^2); |skew| is clipped just inside the supremum ~0.9953.
    `cdf` needs Owen's T (an `n_owen`-node Gauss-Legendre rule on a reduced
    domain)."""

    def __init__(self, mean=0.0, std=1.0, skew=0.0, max_skew=_SKEW_SUP * (1.0 - 1e-6),
                 n_owen=48):
        self.mean_, self.std, self.skew = mean, std, skew
        self.max_skew = float(min(max_skew, _SKEW_SUP * (1.0 - 1e-6)))
        x, w = leggauss(n_owen)  # nodes on [0, 1]
        self._nodes, self._weights = (x + 1.0) / 2.0, w / 2.0

    @property
    def batch_shape(self):
        return _shape(self.mean_, self.std, self.skew)

    def _delta(self, like):
        g = torch.clamp(_like(self.skew, like), -self.max_skew, self.max_skew)
        r = _cbrt(2.0 * g / (4.0 - np.pi))   # = m / sqrt(1 - m^2), odd in g
        m = r * torch.rsqrt(1.0 + r * r)      # the standardized mean
        return torch.clamp(m / _HALF_NORMAL_MEAN, -_DELTA_CAP, _DELTA_CAP)

    def _direct(self, like):
        """The direct parameters (xi, omega, alpha) from the moments."""
        d = self._delta(like)
        m = _HALF_NORMAL_MEAN * d
        omega = _like(self.std, like) * torch.rsqrt(1.0 - m * m)
        return _like(self.mean_, like) - omega * m, omega, d * torch.rsqrt(1.0 - d * d)

    def log_prob(self, value):
        xi, omega, alpha = self._direct(value)
        z = (value - xi) / omega
        return np.log(2.0) - torch.log(omega) + _norm_logpdf(z) + _log_ndtr(alpha * z)

    def sample(self, gen, sample_shape=()):
        shp = tuple(sample_shape) + self.batch_shape
        u = _randn(gen, (2,) + shp, self.mean_, self.std, self.skew)
        xi, omega, _ = self._direct(u)
        d = self._delta(u)
        return xi + omega * (d * u[0].abs() + torch.sqrt(1.0 - d * d) * u[1])

    def cdf(self, value):
        xi, omega, alpha = self._direct(value)
        z = (value - xi) / omega
        nodes, weights = (torch.as_tensor(x, dtype=value.dtype, device=value.device)
                          for x in (self._nodes, self._weights))
        t = _owens_t(z, torch.broadcast_to(alpha, z.shape), nodes, weights)
        return torch.clamp(ndtr(z) - 2.0 * t, 0.0, 1.0)

    def log_cdf(self, value):
        return torch.log(torch.clamp(self.cdf(value), 1e-300, 1.0))

    @property
    def mean(self):
        return torch.broadcast_to(torch.as_tensor(self.mean_), self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(torch.as_tensor(self.std**2), self.batch_shape)

    @property
    def skewness(self):
        return torch.broadcast_to(
            torch.clamp(torch.as_tensor(self.skew), -self.max_skew, self.max_skew),
            self.batch_shape)


def match_quadratic_gaussian(loc, scale1, scale2):
    """(mean, std, skew) of the SkewNormal whose first three central
    moments are those of QuadGaussian(loc, scale1, scale2)."""
    qd = QuadGaussian(loc, scale1, scale2)
    std = torch.sqrt(qd.variance)
    return qd.mean, std, qd.third_central_moment / std**3


class CubGaussian(Distribution):
    """Cubic-Hermite-in-Gaussian noise,
        obs = loc + s1 eps + s2 (eps^2 - 1) + s3 (eps^3 - 3 eps),
    its density summed over the real roots of the cubic (trigonometric and
    Cardano forms); QuadGaussian where |s3| < 1e-12."""

    def __init__(self, loc=0.0, scale1=1.0, scale2=0.0, scale3=0.0):
        self.loc, self.scale1, self.scale2, self.scale3 = loc, scale1, scale2, scale3

    @property
    def batch_shape(self):
        return _shape(self.loc, self.scale1, self.scale2, self.scale3)

    def sample(self, gen, sample_shape=()):
        eps = _randn(gen, tuple(sample_shape) + self.batch_shape, self.loc, self.scale1)
        return (self.loc + self.scale1 * eps + self.scale2 * (eps**2 - 1)
                + self.scale3 * (eps**3 - 3 * eps))

    def log_prob(self, value):
        """log of the sum over the real roots eps of s3 e^3 + s2 e^2 +
        (s1 - 3 s3) e - (v - loc + s2) = 0 of phi(eps) / |f'(eps)|; the
        roots by the trigonometric method on the depressed cubic (three
        real roots) or Cardano's formula (one)."""
        s1, s2, s3 = (_like(x, value) for x in (self.scale1, self.scale2, self.scale3))
        tiny = s3.abs() < 1e-12
        s3_safe = torch.where(tiny, torch.ones_like(s3), s3)

        # the depressed cubic t^3 + p t + q, e = t - s2 / (3 s3)
        a2 = s2 / s3_safe
        a1 = (s1 - 3 * s3) / s3_safe
        a0 = -(value - self.loc + s2) / s3_safe
        p = a1 - a2**2 / 3
        q = 2 * a2**3 / 27 - a2 * a1 / 3 + a0
        disc = -(4 * p**3 + 27 * q**2)

        def density_at(eps):
            fp = (s1 - 3 * s3 + 2 * s2 * eps + 3 * s3 * eps**2).abs()
            return torch.exp(_norm_logpdf(eps)) / torch.clamp(fp, min=1e-12)

        p_neg = torch.clamp(p, max=-1e-12)
        m = 2 * torch.sqrt(-p_neg / 3)
        theta = torch.arccos(torch.clamp(3 * q / (p_neg * m), -1.0, 1.0)) / 3
        dens3 = 0.0
        for k in range(3):
            dens3 = dens3 + density_at(m * torch.cos(theta - 2 * np.pi * k / 3) - a2 / 3)

        sq = torch.sqrt(torch.clamp(q**2 / 4 + p**3 / 27, min=1e-300))
        dens1 = density_at(_cbrt(-q / 2 + sq) + _cbrt(-q / 2 - sq) - a2 / 3)

        dens = torch.where(disc > 0, dens3, dens1)
        lp_cub = torch.log(torch.clamp(dens, min=1e-300))
        lp_quad = QuadGaussian(self.loc, s1, s2).log_prob(value)
        return torch.where(tiny, lp_quad, lp_cub)

    @property
    def mean(self):
        return torch.broadcast_to(torch.as_tensor(self.loc), self.batch_shape)

    @property
    def variance(self):
        """s1^2 + 2 s2^2 + 6 s3^2: the three Hermite terms are uncorrelated.
        The JAX package adds 6 s1 s3, which is no term of it (ROADMAP, the
        kept differences)."""
        s1, s2, s3 = self.scale1, self.scale2, self.scale3
        return torch.broadcast_to(torch.as_tensor(s1**2 + 2 * s2**2 + 6 * s3**2),
                                  self.batch_shape)


class BlockMultivariateNormal(Distribution):
    """Gaussian over D correlated components per independent block: `loc`
    (..., D, B) and per-block lower Cholesky factors `scale_tril` (B, D, D)
    (block b couples loc[..., :, b]: D multipoles by B k-bins).  `log_prob`
    gives per-element terms whose sum is the joint log-density: with z =
    L^-1 (x - loc), element (i, b) adds -z_ib^2 / 2 - log L_b[i, i] -
    log(2 pi) / 2."""

    def __init__(self, loc, scale_tril):
        self.loc, self.scale_tril = loc, scale_tril

    @property
    def batch_shape(self):
        D, B = self.scale_tril.shape[-2], self.scale_tril.shape[-3]
        return torch.broadcast_shapes(tuple(self.loc.shape), (D, B))

    def _solve(self, dev):
        """L^-1 dev per block: (..., D, B) -> (..., D, B)."""
        dev_b = dev.transpose(-1, -2)[..., None]              # (..., B, D, 1)
        z = torch.linalg.solve_triangular(self.scale_tril, dev_b, upper=False)
        return z[..., 0].transpose(-1, -2)

    def sample(self, gen, sample_shape=()):
        eps = _randn(gen, tuple(sample_shape) + self.batch_shape, self.loc)
        return self.loc + torch.einsum("bij,...jb->...ib", self.scale_tril, eps)

    def log_prob(self, value):
        z = self._solve(value - self.loc)
        logdiag = torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1))  # (B, D)
        return -0.5 * z**2 - logdiag.T - _HALF_LOG_2PI

    def log_cdf(self, value):
        """Componentwise cdf of the whitened residuals (a diagnostic)."""
        return _log_ndtr(self._solve(value - self.loc))

