"""Particle-mesh forces, 1/2LPT, and the BullFrog growth-time leapfrog.

The Fourier filters (-1/k^2, i k_i, Hessian products) are plain torch
elementwise ops around `torch.fft` (cuFFT on the card); fusing them into
kernels is ROADMAP Queue B, B4.  The particle work of a force evaluation is
K1 (paint) and K4/K5 (the force read) of `ops/paint.py`.

The N-body loop is a Python loop over steps; with `checkpoint=True` each
step runs under `torch.utils.checkpoint`, so the backward pass keeps only
(pos, vel) per step and recomputes the step's paint, FFTs and read.

Parity: `montecosmo_tpu/ops/pm.py:32-334` (pm_forces, delta2_source,
pm_forces2, lpt, alpha_bullfrog, alpha_fastpm, bullfrog_step, nbody_bf,
nbody_bf_lightcone).  `lpt_fpm`, `nbody_rk4` and `nbody_tsit5` are ROADMAP
Queue A item 11.
"""
import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from montecosmo_tpu_torch.ops.background import Background, Esqr
from montecosmo_tpu_torch.ops.fourier import (
    bspline_hat, gradient_hat, invlaplace_hat, irfftn, rfftk, rfftn,
)
from montecosmo_tpu_torch.ops.hermitian import ch2rshape
from montecosmo_tpu_torch.ops.paint import paint, read_multi, read_sites, read_window
from montecosmo_tpu_torch.utils.safe import safe_div


def pm_forces(pos, mesh, read_order: int = 2, paint_deconv: bool = False, lattice_shape=None,
              max_disp=8, sites_shape=None):
    """Gravitational forces at particle positions from a density mesh.

    mesh : a shape tuple -> paint the particles first (K1, clamped to their
           lattice sites when `lattice_shape` is given), then rfft;
           an rfft mesh -> the density itself.
    Poisson solve, the 3 gradient components stacked channel-last, then the
    read: strided slicing at the lattice sites (`sites_shape`, order <= 2),
    the clamped lattice read (`lattice_shape`), or the plain read.  Paint and
    read use the B-spline window of `read_order` (1-4).
    """
    if isinstance(mesh, tuple):
        mesh_shape = mesh
        mesh = rfftn(paint(pos, mesh_shape, order=read_order, lattice_shape=lattice_shape,
                           max_disp=max_disp, clip=True))
        if paint_deconv:
            # painted AND read at this order: deconvolve twice
            mesh = mesh / bspline_hat(rfftk(mesh_shape, device=mesh.device), read_order) ** 2

    kvec = rfftk(ch2rshape(mesh.shape), device=mesh.device)
    pot = mesh * invlaplace_hat(kvec)
    grads = torch.stack([irfftn(-gradient_hat(kvec, i) * pot) for i in range(3)], -1)
    if sites_shape is not None and read_order <= 2:
        return read_sites(grads, sites_shape)
    if lattice_shape is not None:
        return read_window(pos.reshape(-1, 3), grads, lattice_shape, read_order,
                           max_disp=max_disp, clip=True)
    return read_multi(pos, grads, read_order)


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
    if lpt_order not in (1, 2):
        raise ValueError(f"lpt_order must be 1 or 2, got {lpt_order}")
    force1 = pm_forces(pos, init_mesh, read_order, sites_shape=sites_shape)
    if lpt_order == 1:
        return bg.a2g(a) * force1, force1
    # D1, D2 and dD2/dD1 from one lookup of the stacked growth table
    g, g2, f, f2 = bg._growth(a)
    force2 = pm_forces2(pos, init_mesh, read_order, sites_shape=sites_shape)
    dpos = g * force1 - g2 * force2
    vel = force1 - safe_div(g2 * f2, g * f) * force2
    return dpos, vel


# ----------------------------------------------------------------- BullFrog
def alpha_bullfrog(bg: Background, g0, dg):
    """BullFrog kick coefficient (List & Hahn arXiv:2309.10865 eq. 2.3)."""
    g1 = g0 + dg / 2
    g2 = g0 + dg
    dg2dg0, dg2dg2 = bg.g2dg2dg(g0), bg.g2dg2dg(g2)
    # linearization of (D2 - D1^2)/D1 around g0, evaluated at midpoint g1
    lin_ratio = (bg.g2g2(g0) + dg2dg0 * dg / 2) / g1 - g1
    return (dg2dg2 - lin_ratio) / (dg2dg0 - lin_ratio)


def alpha_fastpm(bg: Background, g0, dg):
    """FastPM kick coefficient (List & Hahn arXiv:2309.10865 eq. 3.16)."""
    g2 = g0 + dg
    a0, a2 = bg.g2a(g0), bg.g2a(g2)
    c0 = torch.sqrt(Esqr(bg.cosmo, a0)) * g0 * bg.g2f(g0) * a0**2
    c2 = torch.sqrt(Esqr(bg.cosmo, a2)) * g2 * bg.g2f(g2) * a2**2
    return c0 / c2


def bullfrog_step(bg: Background, dg, mesh_shape: tuple, paint_order: int = 2,
                  paint_deconv=False, alpha_fn=alpha_bullfrog, lattice_shape=None, max_disp=8):
    """One drift-kick-drift BullFrog step in growth time, as a function
    (pos, vel, g0) -> (pos, vel), vel = dpos/dD1 and g0 the step's start."""
    mesh_shape = tuple(int(s) for s in mesh_shape)

    def step(pos, vel, g0):
        pos = pos + vel * (dg / 2)                                       # drift
        forces = pm_forces(pos, mesh_shape, paint_order, paint_deconv=paint_deconv,
                           lattice_shape=lattice_shape, max_disp=max_disp)  # kick
        alpha = alpha_fn(bg, g0, dg)
        g1 = g0 + dg / 2
        vel = alpha * vel + (1 - alpha) * forces / g1
        pos = pos + vel * (dg / 2)                                       # drift
        return pos, vel

    return step


def _bf_start(bg: Background, init_mesh, pos, a0, a1, n_steps, paint_order, lpt_order,
              paint_deconv, alpha_fn, lattice_shape, max_disp, sites_shape, init_read_order):
    """What `nbody_bf` and `nbody_bf_lightcone` share before their steps:
    (g0, g1, dg, LPT-initialized pos, vel, the BullFrog step function)."""
    g0 = bg.a2g(a0)
    g1 = bg.a2g(a1)
    dg = (g1 - g0) / int(n_steps)
    dpos, vel = lpt(bg, init_mesh, pos, a0, lpt_order, init_read_order, sites_shape)
    step = bullfrog_step(bg, dg, ch2rshape(init_mesh.shape), paint_order, paint_deconv,
                         alpha_fn, lattice_shape, max_disp)
    return g0, g1, dg, pos + dpos, vel, step


def _run_steps(body, state, g0, dg, n_steps, checkpoint):
    """Yield the state after each of `n_steps` calls state = body(*state, g_i),
    g_i = g0 + i dg; with `checkpoint` (and autograd on) each call runs under
    `torch.utils.checkpoint`."""
    for i in range(int(n_steps)):
        args = (*state, g0 + dg * i)
        if checkpoint and torch.is_grad_enabled():
            # O(1)-per-step reverse-mode memory; the recomputed paint sums
            # its atomics in another order than the forward's
            state = torch_checkpoint(body, *args, use_reentrant=False)
        else:
            state = body(*args)
        yield state


def nbody_bf(bg: Background, init_mesh, pos, a0=0.0, a1=1.0, n_steps=5, paint_order: int = 2,
             lpt_order: int = 2, paint_deconv=False, snapshots=None, alpha_fn=alpha_bullfrog,
             checkpoint=True, lattice_shape=None, max_disp=8, sites_shape=None,
             init_read_order: int = 1):
    """BullFrog N-body from `a0` to `a1`: LPT initialization, then `n_steps`
    growth-time DKD steps.

    snapshots : None -> the final state with a leading singleton axis;
                int k >= 2 -> k states growth-equispaced in [g0, g1], snapped
                to step ends; a list of scale factors -> the step ends
                nearest to them.
    init_read_order : window order of the LPT force reads (1: exact at the
                undisplaced integer lattice).
    Returns (pos, vel), each stacked over snapshots on the leading axis.
    """
    n_steps = int(n_steps)
    g0, _, dg, pos, vel, step = _bf_start(bg, init_mesh, pos, a0, a1, n_steps, paint_order,
                                          lpt_order, paint_deconv, alpha_fn, lattice_shape,
                                          max_disp, sites_shape, init_read_order)
    keep = not (snapshots is None or isinstance(snapshots, int) and snapshots <= 1)
    states = []
    for pos, vel in _run_steps(step, (pos, vel), g0, dg, n_steps, checkpoint):
        if keep:
            states.append((pos, vel))

    if not keep:
        return pos[None], vel[None]
    if isinstance(snapshots, int):
        ts = np.linspace(0.0, 1.0, snapshots)
        idx = np.unique(np.rint(ts * (n_steps - 1)).astype(int))
    else:
        g_req = bg.a2g(torch.as_tensor(np.asarray(snapshots, np.float32), device=pos.device))
        step_ends = g0 + dg * torch.arange(1, n_steps + 1, device=pos.device)
        idx = torch.argmin((step_ends[None, :] - g_req[:, None]).abs(), -1).tolist()
    return (torch.stack([states[i][0] for i in idx]), torch.stack([states[i][1] for i in idx]))


def nbody_bf_lightcone(bg: Background, init_mesh, pos, g_tgt, a0=0.0, a1=1.0, n_steps=5,
                       paint_order: int = 2, lpt_order: int = 2, paint_deconv=False,
                       alpha_fn=alpha_bullfrog, checkpoint=True, lattice_shape=None, max_disp=8,
                       sites_shape=None, init_read_order: int = 1):
    """BullFrog N-body seen on the light cone: each particle's (pos, vel)
    interpolated linearly in growth between the two step-boundary states
    that bracket its crossing growth `g_tgt` (broadcastable to pos[..., :1],
    clipped to [g0, g1]).

    The hat weights w_i = relu(1 - |g_tgt - g_i| / dg) over the uniform
    step boundaries g_i are a partition of unity, so the blend is summed
    inside the step loop (acc += w_i state_i): no stack of snapshots.  With
    `checkpoint`, each step and its share of the blend run under
    `torch.utils.checkpoint`, as in `nbody_bf`.
    Returns (pos, vel), without a snapshot axis.
    """
    g0, g1, dg, pos, vel, step = _bf_start(bg, init_mesh, pos, a0, a1, n_steps, paint_order,
                                           lpt_order, paint_deconv, alpha_fn, lattice_shape,
                                           max_disp, sites_shape, init_read_order)
    gt = torch.minimum(torch.maximum(g_tgt, g0), g1)  # jnp.clip

    def hat(gi):
        return torch.relu(1.0 - (gt - gi).abs() / dg)

    def step_and_blend(pos, vel, acc_pos, acc_vel, gi):
        pos, vel = step(pos, vel, gi)
        w = hat(gi + dg)
        return pos, vel, acc_pos + w * pos, acc_vel + w * vel

    w = hat(g0)
    state = (pos, vel, w * pos, w * vel)
    for state in _run_steps(step_and_blend, state, g0, dg, n_steps, checkpoint):
        pass
    return state[2], state[3]
