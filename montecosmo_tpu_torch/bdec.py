"""Bayesian decision utilities: weighted quantiles and credible intervals and
sets of samples, on whatever device the samples lie.

Every estimator works on sorted (value, cdf, weight) knots with the sample
axis last; the JAX package lifts its 1-D routines to batches with `vmap`,
here the rows are a leading batch axis and every step broadcasts over them
(`torch.searchsorted` takes one sorted row per batch row).  The order-1
inverse CDF is `jnp.interp`'s linear interpolation; the order-2 one solves
the quadratic of a linear density within a segment in the Muller form.

Parity: `montecosmo_tpu/bdec.py` (cumulative_trapezoid :21, quantile :102,
argmedian :118, credint :125, qbci :138, qbcs :148, sci_noweights :164, sci
:180, scs :207).  `argmedian` stays host numpy, as in the JAX package.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.utils.io import to_np
from montecosmo_tpu_torch.utils.safe import safe_div

__all__ = ["cumulative_trapezoid", "quantile", "argmedian", "credint", "qbci", "qbcs", "sci",
           "sci_noweights", "scs"]


def _t(x, like=None):
    """A tensor of `x` (numpy keeps its dtype), on `like`'s device and in
    its dtype when given."""
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1, initial=None):
    """The cumulative composite-trapezoid integral of y(x) along `axis`;
    `x` 1-D (shared) or shaped like `y`; `initial` is prepended so that the
    output keeps y's length."""
    yy = torch.movedim(_t(y), axis, -1)
    mids = 0.5 * (yy[..., 1:] + yy[..., :-1])
    if x is None:
        steps = dx
    else:
        x = _t(x)
        steps = torch.diff(x if x.ndim == 1 else torch.movedim(x, axis, -1), dim=-1)
    out = torch.cumsum(steps * mids, dim=-1)
    if initial is not None:
        lead = torch.full((*out.shape[:-1], 1), initial, dtype=out.dtype, device=out.device)
        out = torch.cat([lead, out], -1)
    return torch.movedim(out, -1, axis)


# ------------------------------------------------------------------ CDF knots
def _sorted_knots(x, weights, axis):
    """Samples and weights sorted along `axis` (stable), as (rows, n) with
    the sample axis last, and the batch shape.  1-D weights index the
    sample axis."""
    x = torch.atleast_1d(_t(x))
    axis = axis % x.ndim
    if weights is None:
        w = torch.ones_like(x)
    else:
        w = _t(weights, x)
        if w.ndim == 1 and x.ndim > 1:
            w = w.reshape((-1,) + (1,) * (x.ndim - 1 - axis))
        w = torch.broadcast_to(w, x.shape)
    xs = torch.movedim(x, axis, -1)
    ws = torch.movedim(w, axis, -1)
    batch_shape, n = xs.shape[:-1], xs.shape[-1]
    xs, ws = xs.reshape(-1, n), ws.reshape(-1, n)
    order = torch.argsort(xs, dim=-1, stable=True)
    return xs.gather(-1, order), ws.gather(-1, order), batch_shape


def _cdf_knots(xs, ws, ord):
    """The normalised CDF at the sorted knots (last axis), and the weights
    normalised by the same total (the order-2 density)."""
    if ord == 1:
        raw = torch.cumsum(ws, dim=-1)
    elif ord == 2:
        raw = cumulative_trapezoid(ws, xs, axis=-1, initial=0.0)
    else:
        raise NotImplementedError("only CDF interpolation orders 1 and 2")
    total = raw[..., -1:]
    return safe_div(raw, total), safe_div(ws, total)


def _inv_cdf(p, xs, cdf, ws, ord):
    """The inverse CDF at probabilities p (rows, Q) of the knots (rows, n).

    ord 1: `jnp.interp(p, cdf, xs)` per row (clamped at the ends).  ord 2:
    the CDF is quadratic within a segment [x0, x1] (a linear density), and
    the offset u solves slope/2 u^2 + w0 u = dp, taken as u = 2 dp / (w0 +
    sqrt(w0^2 + 2 slope dp)), smooth through slope -> 0 and zero-width
    segments."""
    n = xs.shape[-1]
    p = p.contiguous()
    if ord == 1:
        i = torch.clamp(torch.searchsorted(cdf.contiguous(), p, right=True), 1, n - 1)
        f0, f1 = xs.gather(-1, i - 1), xs.gather(-1, i)
        c0, c1 = cdf.gather(-1, i - 1), cdf.gather(-1, i)
        dx = c1 - c0
        eps = torch.finfo(cdf.dtype).eps
        zero = dx.abs() <= eps * eps  # np.spacing(eps), eps a power of two
        f = torch.where(zero, f0, f0 + (p - c0) / torch.where(zero, torch.ones_like(dx), dx)
                        * (f1 - f0))
        f = torch.where(p < cdf[:, :1], xs[:, :1], f)
        return torch.where(p > cdf[:, -1:], xs[:, -1:], f)
    seg = torch.clamp(torch.searchsorted(cdf.contiguous(), p), 1, n - 1)
    x0, x1 = xs.gather(-1, seg - 1), xs.gather(-1, seg)
    w0 = ws.gather(-1, seg - 1)
    dp = p - cdf.gather(-1, seg - 1)
    slope = safe_div(ws.gather(-1, seg) - w0, x1 - x0)
    disc = torch.sqrt(torch.clamp(w0 * w0 + 2.0 * slope * dp, min=0.0))
    return torch.minimum(torch.maximum(x0 + safe_div(2.0 * dp, w0 + disc), x0), x1)


def quantile(x, p, axis=0, weights=None, ord=1):
    """The weighted quantile by CDF interpolation: ord 1 interpolates the
    cumulative weights linearly (sample quantiles), ord 2 the trapezoid
    integral of the density quadratically (samples that are grid points
    carrying pdf values).  Returns shape (*p.shape, *batch)."""
    xs, ws, batch_shape = _sorted_knots(x, weights, axis)
    p = _t(p, xs)
    cdf, wn = _cdf_knots(xs, ws, ord)
    q = _inv_cdf(p.reshape(1, -1).expand(xs.shape[0], -1), xs, cdf, wn, ord)
    return q.T.reshape(tuple(p.shape) + tuple(batch_shape))


def argmedian(a, axis=-1):
    """The indices of the median values along `axis` (the upper one for an
    even count); host numpy."""
    a = to_np(a)
    k = a.shape[axis] // 2
    return np.argpartition(a, k, axis).take(k, axis)


# ----------------------------------------------------------------- intervals
def credint(x, p=0.95, axis=0, weights=None, type="small", ord=1):
    """The p-credible interval: 'small' (the smallest, HDI), else the
    quantile-based 'low' / 'med' (equal-tail) / 'high'."""
    if type != "small":
        return qbci(x, p, axis, weights, type, ord)
    if weights is None:
        return sci_noweights(x, p, axis)
    return sci(x, p, axis, weights, ord)


_TAIL_FRACTION = {"low": 0.0, "med": 0.5, "high": 1.0}


def qbci(x, p=0.95, axis=0, weights=None, type="med", ord=1):
    """The quantile-based credible interval [q(t (1 - p)), q(t (1 - p) + p)],
    tail fraction t 0 ('low'), 1/2 ('med', equal-tail) or 1 ('high'), both
    ends from one quantile call: (*p.shape, *batch, 2)."""
    p = _t(p)
    lo = _TAIL_FRACTION[type] * (1.0 - p)
    ends = quantile(x, torch.stack([lo, lo + p]), axis, weights, ord)
    return torch.movedim(ends, 0, -1)


def qbcs(x, p=0.95, weights=None, type="med", norm=np.inf):
    """The quantile-based credible set: the `norm`-ball of probability p
    around the per-dimension low / median / high centres.  x (*batch,
    n_samples, n_dim); returns (center, radius)."""
    x = torch.atleast_2d(_t(x))
    n_dim = x.shape[-1]
    which = np.array([_TAIL_FRACTION[t] * 2 for t in np.broadcast_to(type, n_dim)], dtype=int)
    ends = quantile(x, [0.0, 0.5, 1.0], -2, weights)
    center = torch.movedim(ends, 0, -1)[..., torch.arange(n_dim), torch.as_tensor(which)]
    dists = torch.linalg.vector_norm(x - center[..., None, :], ord=norm, dim=-1)
    return center, quantile(dists, p, -1, weights)


def sci_noweights(x, p=0.95, axis=0):
    """The smallest credible interval (HDI) of unweighted samples: a window
    of round(p n) order statistics slid over the sorted samples, the
    narrowest kept (the first of equals): (*batch, 2)."""
    xs = torch.sort(torch.movedim(_t(x), axis, 0), dim=0).values
    n = xs.shape[0]
    k = min(int(np.rint(p * n)), n - 1)
    left = torch.argmin(xs[k:] - xs[:n - k], dim=0)
    lo = xs.gather(0, left[None])[0]
    hi = xs.gather(0, (left + k)[None])[0]
    return torch.stack([lo, hi], -1)


def sci(x, p=0.95, axis=0, weights=None, ord=1):
    """The smallest credible interval (HDI) of weighted samples, for every
    p at once: each sorted sample is a candidate left end, its right end
    the inverse CDF at cdf_left + p; candidates whose left tail already
    holds more than 1 - p get an infinite span.  (*p.shape, *batch, 2)."""
    xs, ws, batch_shape = _sorted_knots(x, weights, axis)
    p = _t(p, xs)
    cdf, wn = _cdf_knots(xs, ws, ord)
    rows, n = xs.shape
    pp = p.reshape(1, -1, 1)
    rights = _inv_cdf((cdf[:, None, :] + pp).reshape(rows, -1), xs, cdf, wn, ord).reshape(
        rows, -1, n)
    spans = torch.where(cdf[:, None, :] <= 1.0 - pp, rights - xs[:, None, :],
                        torch.full_like(rights, float("inf")))
    left = torch.argmin(spans, dim=-1, keepdim=True)
    out = torch.cat([xs[:, None, :].expand_as(rights).gather(-1, left), rights.gather(-1, left)],
                    -1)
    return torch.movedim(out, 0, -2).reshape(tuple(p.shape) + tuple(batch_shape) + (2,))


# ----------------------------------------------------------------- credible sets
def scs(x, p=0.95, weights=None, grid_size=64, bandwidth=None):
    """The p-smallest credible set (highest density region) in d <= 3
    dimensions: a Gaussian-product KDE of the weighted samples x (n, d)
    (Scott's bandwidth by default), its level the weighted (1 - p)-quantile
    of the KDE at the samples (Hyndman 1996).  Returns (per-dimension grid
    axes, the KDE on their tensor grid, the level)."""
    x = _t(x)
    if x.ndim == 1:
        x = x[:, None]
    n, d = x.shape
    assert d <= 3, "scs supports up to 3 dimensions"
    w = torch.full((n,), 1.0 / n, dtype=x.dtype, device=x.device) if weights is None else _t(
        weights, x) / _t(weights, x).sum()
    n_eff = 1.0 / (w**2).sum()
    mean = (w[:, None] * x).sum(0)
    sig = torch.sqrt((w[:, None] * (x - mean) ** 2).sum(0))
    if bandwidth is None:
        bandwidth = sig * n_eff ** (-1.0 / (d + 4))  # Scott's rule
    bw = torch.broadcast_to(_t(bandwidth, x), (d,))
    axes = [torch.linspace(float(x[:, k].min() - 3 * bw[k]), float(x[:, k].max() + 3 * bw[k]),
                           grid_size, dtype=x.dtype, device=x.device) for k in range(d)]

    def kern(grid_k, k):
        z = (grid_k[:, None] - x[None, :, k]) / bw[k]
        return torch.exp(-0.5 * z**2) / (bw[k] * np.sqrt(2 * np.pi))

    Ks = [kern(axes[k], k) for k in range(d)]
    if d == 1:
        mesh = Ks[0] @ w
    elif d == 2:
        mesh = torch.einsum("an,bn,n->ab", Ks[0], Ks[1], w)
    else:
        mesh = torch.einsum("an,bn,cn,n->abc", Ks[0], Ks[1], Ks[2], w)
    prod = kern(x[:, 0], 0)
    for k in range(1, d):
        prod = prod * kern(x[:, k], k)
    level = quantile(prod @ w, 1.0 - p, weights=w)
    return axes, mesh, level
