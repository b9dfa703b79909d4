"""Small numerics helpers shared across the port.

Parity: `montecosmo_tpu/utils/safe.py:40-62` (safe_sqrt, safe_div);
`logaddexp` is `jnp.logaddexp` with JAX's all-orders-stable derivatives.
"""
import numpy as np
import torch


def safe_sqrt(x):
    """sqrt with all-orders-clean derivatives at x <= 0 (double-where).

    A bare `torch.where(x > 0, x.sqrt(), 0)` still differentiates the sqrt
    at the exact zeros of a power mesh: its backward is inf * 0 = NaN, and
    re-linearizing it (Hessian-vector products) poisons whole Hessians.
    The inner where keeps the unselected branch at sqrt(1)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def safe_div(x, y):
    """Division where division by zero yields zero, with safe gradients.

    Double-where, so reverse mode never sees a 0/0.  numpy in, numpy out;
    a tensor on either side gives a tensor.
    """
    if not (torch.is_tensor(x) or torch.is_tensor(y)):
        x, y = np.asarray(x), np.asarray(y)
        denom = np.where(y == 0, 1, y)
        return np.where(y == 0, 0, x / denom)
    if not torch.is_tensor(y):
        real = {torch.complex64: torch.float32, torch.complex128: torch.float64}
        y = torch.as_tensor(y, dtype=real.get(x.dtype, x.dtype), device=x.device)
    denom = torch.where(y == 0, torch.ones_like(y), y)
    q = x / denom
    return torch.where(y == 0, torch.zeros_like(q), q)


def logaddexp(a, b):
    """log(e^a + e^b) as max(a, b) + log1p(e^-|a - b|), whose derivatives
    of every order stay finite for finite inputs.  torch.logaddexp's
    backward is grad / (1 + e^(b - a)): where b - a > 88 (float32) e^(b - a)
    overflows, and its derivative inf / inf is NaN -- a Hessian-vector
    product through a branch that `where` discards still multiplies that
    NaN by 0 (the quad-Gaussian likelihood's unused quadratic branch at
    s_e2 = 0).  jnp.logaddexp carries its own stable derivative rule."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
