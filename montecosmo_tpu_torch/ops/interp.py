"""Linear interpolation on uniform grids (index arithmetic) and on general
sorted nodes (`interp`, the counterpart of `jnp.interp`).

Parity: `montecosmo_tpu/ops/interp.py:20-108` (with `is_uniform`,
`log_uniform_interp_fn`, the lookup of tabulated register spectra, and
`resample_uniform`); `interp` follows
`jnp.interp`'s semantics (clamp to the end values, differentiable in the
query, the nodes and the values).
"""
import numpy as np
import torch

from montecosmo_tpu_torch.ops.segment import take_rows

_TINY = float(np.finfo(np.float32).tiny)
_EPS = float(np.spacing(np.finfo(np.float32).eps))
_PAIRS = {}


def _node_pairs(xtab, device):
    """(n-1, 2) rows (x_i, 1/(x_{i+1}-x_i)) of concrete float32 nodes,
    cached per device."""
    xt = np.asarray(xtab, np.float32)
    key = (xt.tobytes(), str(device))
    if key not in _PAIRS:
        _PAIRS[key] = torch.as_tensor(np.stack([xt[:-1], 1.0 / np.diff(xt)], 1), device=device)
    return _PAIRS[key]


def uniform_interp(x, x0, dx, ytab, left=None, right=None, logx=False,
                   xtab=None):
    """Linear interpolation of `ytab` sampled at x0 + i*dx (i = 0..n-1).

    x     : query tensor (or Python float) of any shape; the bracket is found
            in log space if logx=True (x0/dx in log units; x <= 0 maps to
            `left`).
    ytab  : (n,) or (n, ...) with trailing channel dims; the output is then
            x.shape + ytab.shape[1:], every channel bracketed once.
    xtab  : optional concrete node positions in linear units; the lerp then
            runs linearly in x between them.
    left, right : values outside the grid (None clamps to the end values).

    One gather of the stacked (n-1, 2, ...) pairs (y_i, y_{i+1}) per call,
    as the JAX function takes them, so its backward is one segment sum
    (`take_rows`: K9 on the card).
    """
    n = ytab.shape[0]
    trail = (1,) * (ytab.ndim - 1)
    x = torch.as_tensor(x, dtype=ytab.dtype, device=ytab.device)
    xq = torch.log(torch.clamp(x, min=_TINY)) if logx else x
    t = (xq - x0) / dx
    i = torch.clamp(torch.floor(t).long(), 0, n - 2)
    pairs = torch.stack([ytab[:-1], ytab[1:]], 1)
    lo, hi = take_rows(pairs, i).unbind(i.ndim)
    if xtab is not None:
        x_lo, inv = take_rows(_node_pairs(xtab, x.device), i).unbind(i.ndim)
        frac = (x - x_lo) * inv
    else:
        frac = t - i
    y = lo + frac.reshape(frac.shape + trail) * (hi - lo)
    below = t < 0
    if logx:
        below = below | (x <= 0)
    above = t > (n - 1)
    ybelow = ytab[0] if left is None else torch.as_tensor(left, dtype=y.dtype, device=y.device)
    yabove = ytab[-1] if right is None else torch.as_tensor(right, dtype=y.dtype, device=y.device)
    y = torch.where(below.reshape(below.shape + trail), ybelow, y)
    return torch.where(above.reshape(above.shape + trail), yabove, y)


def interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` for increasing `xp` (1-D tensors)."""
    x = torch.as_tensor(x, dtype=fp.dtype, device=fp.device)
    i = torch.clamp(torch.searchsorted(xp.detach().contiguous(), x.detach(), right=True),
                    1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    zero = dx.abs() <= _EPS
    f = torch.where(zero, fp[i - 1],
                    fp[i - 1] + delta / torch.where(zero, torch.ones_like(dx), dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def is_uniform(x, logx=False, rtol=1e-6):
    """True if the concrete 1-D node array is uniformly spaced (in log x)."""
    x = np.asarray(x, float)
    if logx:
        if np.any(x <= 0):
            return False
        x = np.log(x)
    d = np.diff(x)
    return d.size > 0 and bool(np.all(np.abs(d - d[0]) <= rtol * np.abs(d[0])))


def log_uniform_interp_fn(ks, ys, left=0.0, right=0.0, n_min=256):
    """Interpolator x -> y of a table with concrete nodes `ks` (the values
    `ys` a tensor, differentiable): log-uniform nodes are used as they are;
    others are resampled once onto a log-uniform grid (`interp` over the
    table itself, not over the queries), then `uniform_interp`."""
    ks_np = np.asarray(ks, float)
    if is_uniform(ks_np, logx=True):
        logk0 = float(np.log(ks_np[0]))
        dlogk = float((np.log(ks_np[-1]) - logk0) / (ks_np.size - 1))
        tab, nodes = ys, ks_np
    else:
        t = np.log(ks_np)
        tu = np.linspace(t[0], t[-1], max(2 * ks_np.size, n_min))
        nodes = np.exp(tu)
        tab = interp(torch.as_tensor(nodes, dtype=ys.dtype, device=ys.device),
                     torch.as_tensor(ks_np, dtype=ys.dtype, device=ys.device), ys)
        logk0, dlogk = float(tu[0]), float(tu[1] - tu[0])
    return lambda x: uniform_interp(x, logk0, dlogk, tab, left=left, right=right, logx=True,
                                    xtab=nodes)


def resample_uniform(x, y, n=None, logx=False, device="cpu"):
    """Resample a concrete (x, y) table onto a uniform grid over the same
    range (in log x with `logx`): (x0, dx, ytab) for `uniform_interp`, the
    table float32 on `device`.  Host numpy: for fixed tables only."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if n is None:
        n = max(2 * x.size, 64)
    t = np.log(x) if logx else x
    tu = np.linspace(t[0], t[-1], n)
    yu = np.interp(tu, t, y)
    return float(tu[0]), float(tu[1] - tu[0]), torch.as_tensor(yu, dtype=torch.float32,
                                                                device=device)
