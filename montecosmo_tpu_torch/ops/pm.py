"""Particle-mesh forces and 1/2LPT on the regular particle lattice.

The Fourier filters (-1/k^2, i k_i, Hessian products) are plain torch
elementwise ops around `torch.fft` (cuFFT on the card); fusing them into
kernels is ROADMAP Queue B, B4.

Parity: `montecosmo_tpu/ops/pm.py:32-134` (the `sites_shape` path: forces
read at the undisplaced lattice by strided slicing).  The painted-density
and off-lattice forms of `pm_forces` and the N-body integrators are ROADMAP
Queue A item 11.
"""
import torch

from montecosmo_tpu_torch.ops.background import Background
from montecosmo_tpu_torch.ops.fourier import gradient_hat, invlaplace_hat, irfftn, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import ch2rshape
from montecosmo_tpu_torch.ops.paint import read_sites


def _lattice_only(pos, sites_shape, read_order):
    if sites_shape is None or read_order > 2 or torch.is_tensor(pos) and pos.ndim != 2:
        raise NotImplementedError(
            "forces at off-lattice positions need `read` (ROADMAP Queue B, B3)")


def pm_forces(pos, mesh, read_order: int = 2, sites_shape=None):
    """Gravitational forces at the lattice sites from an rfft density mesh:
    Poisson solve, then the 3 gradient components read by strided slicing."""
    _lattice_only(pos, sites_shape, read_order)
    kvec = rfftk(ch2rshape(mesh.shape), device=mesh.device)
    pot = mesh * invlaplace_hat(kvec)
    grads = torch.stack([irfftn(-gradient_hat(kvec, i) * pot) for i in range(3)], -1)
    return read_sites(grads, sites_shape)


def delta2_source(mesh):
    """2LPT source delta2 = sum_i<j (h_ii h_jj - h_ij^2) of the potential
    Hessian h_ij = d_i d_j invlaplace(delta), with 6 FFTs."""
    kvec = rfftk(ch2rshape(mesh.shape), device=mesh.device)
    pot = mesh * invlaplace_hat(kvec)
    delta2 = 0.0
    diag_sum = 0.0
    for i in range(3):
        hess_ii = irfftn(gradient_hat(kvec, i) ** 2 * pot)
        delta2 = delta2 + hess_ii * diag_sum
        diag_sum = diag_sum + hess_ii
        for j in range(i + 1, 3):
            hess_ij = gradient_hat(kvec, i) * gradient_hat(kvec, j)
            delta2 = delta2 - irfftn(hess_ij * pot) ** 2
    return delta2


def pm_forces2(pos, mesh, read_order: int = 2, sites_shape=None):
    """2LPT source-term forces: Poisson forces of `delta2_source`."""
    return pm_forces(pos, rfftn(delta2_source(mesh)), read_order, sites_shape=sites_shape)


def lpt(bg: Background, init_mesh, pos, a, lpt_order: int = 2, read_order: int = 2,
        sites_shape=None):
    """1st/2nd-order LPT displacement and growth-time velocity at scale
    factor `a`; `init_mesh` is the linear density at a=1 (real or rfft)."""
    if not init_mesh.is_complex():
        init_mesh = rfftn(init_mesh)
    force1 = pm_forces(pos, init_mesh, read_order, sites_shape=sites_shape)
    dpos = bg.a2g(a) * force1
    vel = force1
    if lpt_order == 2:
        force2 = pm_forces2(pos, init_mesh, read_order, sites_shape=sites_shape)
        dpos = dpos - bg.a2g2(a) * force2
        vel = vel - bg.a2dg2dg(a) * force2
    elif lpt_order != 1:
        raise ValueError(f"lpt_order must be 1 or 2, got {lpt_order}")
    return dpos, vel
