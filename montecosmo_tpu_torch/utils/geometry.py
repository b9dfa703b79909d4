"""Sky <-> cartesian coordinates.

Parity: `montecosmo_tpu/utils/geometry.py:12-30` (radecrad2cart,
cart2radecrad).  Tensors in, tensors out; numpy inputs become float32
tensors on `device`, as the JAX package's float32 arrays.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.utils.safe import safe_div


def _as_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def radecrad2cart(ra, dec, radius, device="cpu"):
    """(RA, DEC) in degrees and a radius -> cartesian (..., 3)."""
    ra = torch.deg2rad(_as_tensor(ra, device))
    dec = torch.deg2rad(_as_tensor(dec, ra.device))
    radius = _as_tensor(radius, ra.device)
    cos_dec = torch.cos(dec)
    xyz = torch.stack((cos_dec * torch.cos(ra), cos_dec * torch.sin(ra), torch.sin(dec)))
    return torch.movedim(radius * xyz, 0, -1)


def cart2radecrad(cart, device="cpu"):
    """Cartesian (..., 3) -> (RA in [0, 360), DEC in [-90, 90], radius)."""
    cart = _as_tensor(cart, device)
    radius = torch.linalg.vector_norm(cart, dim=-1)
    x, y, z = torch.movedim(cart, -1, 0)
    ra = torch.remainder(torch.rad2deg(torch.atan2(y, x)), 360.0)
    dec = torch.rad2deg(torch.asin(safe_div(z, radius)))
    return ra, dec, radius
