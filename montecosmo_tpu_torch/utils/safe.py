"""Small numerics helpers shared across the port.

Parity: `montecosmo_tpu/utils/safe.py:40-62` (safe_sqrt, safe_div).
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
