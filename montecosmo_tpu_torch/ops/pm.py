"""Particle-mesh forces, 1/2LPT, the BullFrog growth-time leapfrog, and the
scale-factor-time integrators (fixed-step RK4, adaptive Tsit5) that validate
it.

The Fourier filters (-1/k^2, i k_i, Hessian products) are plain torch
elementwise ops around `torch.fft` (cuFFT on the card); fusing them into
kernels is ROADMAP Queue B, B4.  The particle work of a force evaluation is
K1 (paint) and K4/K5 (the force read) of `ops/paint.py`.

The N-body loop is a Python loop over steps; with `checkpoint=True` each
step runs under `torch.utils.checkpoint`, so the backward pass keeps only
(pos, vel) per step and recomputes the step's paint, FFTs and read.
`nbody_rk4` and `nbody_tsit5` checkpoint each step (each Tsit5 attempt) too;
Tsit5 decides on the host whether an attempt is accepted, outside the
checkpointed stages, so that the recompute cannot take another branch.

Parity: `montecosmo_tpu/ops/pm.py:32-535` (pm_forces, delta2_source,
pm_forces2, lpt, lpt_fpm, alpha_bullfrog, alpha_fastpm, bullfrog_step,
nbody_bf, nbody_bf_lightcone, nbody_bf_scan, nbody_rk4, nbody_tsit5), with
the finite-difference filters of `ops/fourier.py`.
"""
import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from montecosmo_tpu_torch.ops.background import Background, Esqr
from montecosmo_tpu_torch.ops.fourier import (
    bspline_hat, gaussian_hat, gradient_hat, invlaplace_hat, irfftn, rfftk, rfftn,
)
from montecosmo_tpu_torch.ops.hermitian import ch2rshape
from montecosmo_tpu_torch.ops.paint import paint, read_multi, read_sites, read_window
from montecosmo_tpu_torch.utils.safe import safe_div


def pm_forces(pos, mesh, read_order: int = 2, paint_deconv: bool = False, grad_fd=np.inf,
              lap_fd=np.inf, kcut=np.inf, lattice_shape=None, max_disp=8, sites_shape=None):
    """Gravitational forces at particle positions from a density mesh.

    mesh : a shape tuple -> paint the particles first (K1, clamped to their
           lattice sites when `lattice_shape` is given), then rfft;
           an rfft mesh -> the density itself.
    Poisson solve (`lap_fd`: the Laplacian's finite-difference order, inf
    for the exact one), an optional Gaussian cut `kcut` of the potential,
    the 3 gradient components (`grad_fd`) stacked channel-last, then the
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
    pot = mesh * invlaplace_hat(kvec, lap_fd)
    if kcut != np.inf:
        pot = pot * gaussian_hat(kvec, kcut)
    grads = torch.stack([irfftn(-gradient_hat(kvec, i, grad_fd) * pot) for i in range(3)], -1)
    if sites_shape is not None and read_order <= 2:
        return read_sites(grads, sites_shape)
    if lattice_shape is not None:
        return read_window(pos.reshape(-1, 3), grads, lattice_shape, read_order,
                           max_disp=max_disp, clip=True)
    return read_multi(pos, grads, read_order)


def delta2_source(mesh, grad_fd=np.inf, lap_fd=np.inf):
    """2LPT source delta2 = sum_i<j (h_ii h_jj - h_ij^2) of the potential
    Hessian h_ij = d_i d_j invlaplace(delta), with 6 FFTs."""
    kvec = rfftk(ch2rshape(mesh.shape), device=mesh.device)
    pot = mesh * invlaplace_hat(kvec, lap_fd)
    delta2 = 0.0
    diag_sum = 0.0
    for i in range(3):
        hess_ii = irfftn(gradient_hat(kvec, i, grad_fd) ** 2 * pot)
        delta2 = delta2 + hess_ii * diag_sum
        diag_sum = diag_sum + hess_ii
        for j in range(i + 1, 3):
            hess_ij = gradient_hat(kvec, i, grad_fd) * gradient_hat(kvec, j, grad_fd)
            delta2 = delta2 - irfftn(hess_ij * pot) ** 2
    return delta2


def pm_forces2(pos, mesh, read_order: int = 2, grad_fd=np.inf, lap_fd=np.inf,
               sites_shape=None):
    """2LPT source-term forces: Poisson forces of `delta2_source`."""
    return pm_forces(pos, rfftn(delta2_source(mesh, grad_fd, lap_fd)), read_order,
                     grad_fd=grad_fd, lap_fd=lap_fd, sites_shape=sites_shape)


def lpt(bg: Background, init_mesh, pos, a, lpt_order: int = 2, read_order: int = 2,
        grad_fd=np.inf, lap_fd=np.inf, sites_shape=None):
    """1st/2nd-order LPT displacement and growth-time velocity at scale
    factor `a`; `init_mesh` is the linear density at a=1 (real or rfft)."""
    if not init_mesh.is_complex():
        init_mesh = rfftn(init_mesh)
    if lpt_order not in (1, 2):
        raise ValueError(f"lpt_order must be 1 or 2, got {lpt_order}")
    fd = dict(grad_fd=grad_fd, lap_fd=lap_fd, sites_shape=sites_shape)
    force1 = pm_forces(pos, init_mesh, read_order, **fd)
    if lpt_order == 1:
        return bg.a2g(a) * force1, force1
    # D1, D2 and dD2/dD1 from one lookup of the stacked growth table
    g, g2, f, f2 = bg._growth(a)
    force2 = pm_forces2(pos, init_mesh, read_order, **fd)
    dpos = g * force1 - g2 * force2
    vel = force1 - safe_div(g2 * f2, g * f) * force2
    return dpos, vel


def lpt_fpm(bg: Background, init_mesh, pos, a, lpt_order: int = 1, read_order: int = 2,
            grad_fd=np.inf, lap_fd=np.inf):
    """LPT in FastPM momentum conventions, p = a^2 f E dq/dD, each order
    with its own growth rate (for the integrators in scale-factor time).
    `a` is taken at least 1-D, as the JAX function takes it.  Returns
    (dpos, p)."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=bg.growth_tab.dtype, device=bg.growth_tab.device)
    a = torch.atleast_1d(a)
    E = torch.sqrt(Esqr(bg.cosmo, a))
    if lpt_order == 1:
        dpos, _ = lpt(bg, init_mesh, pos, a, 1, read_order, grad_fd, lap_fd)
        return dpos, a**2 * bg.a2f(a) * E * dpos
    if lpt_order != 2:
        raise ValueError(f"lpt_order must be 1 or 2, got {lpt_order}")
    if not init_mesh.is_complex():
        init_mesh = rfftn(init_mesh)
    # the split forces, once (the JAX function runs `lpt` first and then
    # computes them again: the same values)
    g, g2, f, f2 = bg._growth(a)
    dq1 = g * pm_forces(pos, init_mesh, read_order, grad_fd=grad_fd, lap_fd=lap_fd)
    dq2 = g2 * pm_forces2(pos, init_mesh, read_order, grad_fd=grad_fd, lap_fd=lap_fd)
    return dq1 - dq2, a**2 * E * (f * dq1 - f2 * dq2)


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
                  paint_deconv=False, grad_fd=np.inf, lap_fd=np.inf, alpha_fn=alpha_bullfrog,
                  lattice_shape=None, max_disp=8):
    """One drift-kick-drift BullFrog step in growth time, as a function
    (pos, vel, g0) -> (pos, vel), vel = dpos/dD1 and g0 the step's start."""
    mesh_shape = tuple(int(s) for s in mesh_shape)

    def step(pos, vel, g0):
        pos = pos + vel * (dg / 2)                                       # drift
        forces = pm_forces(pos, mesh_shape, paint_order, paint_deconv=paint_deconv,
                           grad_fd=grad_fd, lap_fd=lap_fd, lattice_shape=lattice_shape,
                           max_disp=max_disp)                            # kick
        alpha = alpha_fn(bg, g0, dg)
        g1 = g0 + dg / 2
        vel = alpha * vel + (1 - alpha) * forces / g1
        pos = pos + vel * (dg / 2)                                       # drift
        return pos, vel

    return step


def _bf_start(bg: Background, init_mesh, pos, a0, a1, n_steps, paint_order, lpt_order,
              paint_deconv, grad_fd, lap_fd, alpha_fn, lattice_shape, max_disp, sites_shape,
              init_read_order):
    """What `nbody_bf` and `nbody_bf_lightcone` share before their steps:
    (g0, g1, dg, LPT-initialized pos, vel, the BullFrog step function)."""
    g0 = bg.a2g(a0)
    g1 = bg.a2g(a1)
    dg = (g1 - g0) / int(n_steps)
    dpos, vel = lpt(bg, init_mesh, pos, a0, lpt_order, init_read_order, grad_fd, lap_fd,
                    sites_shape)
    step = bullfrog_step(bg, dg, ch2rshape(init_mesh.shape), paint_order, paint_deconv,
                         grad_fd, lap_fd, alpha_fn, lattice_shape, max_disp)
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
             lpt_order: int = 2, paint_deconv=False, grad_fd=np.inf, lap_fd=np.inf,
             snapshots=None, alpha_fn=alpha_bullfrog, checkpoint=True, lattice_shape=None,
             max_disp=8, sites_shape=None, init_read_order: int = 1):
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
                                          lpt_order, paint_deconv, grad_fd, lap_fd, alpha_fn,
                                          lattice_shape, max_disp, sites_shape, init_read_order)
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
                       grad_fd=np.inf, lap_fd=np.inf, alpha_fn=alpha_bullfrog, checkpoint=True,
                       lattice_shape=None, max_disp=8, sites_shape=None,
                       init_read_order: int = 1):
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
                                           lpt_order, paint_deconv, grad_fd, lap_fd, alpha_fn,
                                           lattice_shape, max_disp, sites_shape, init_read_order)
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


def nbody_bf_scan(bg: Background, init_mesh, pos, a, n_steps=5, paint_order: int = 2,
                  grad_fd=np.inf, lap_fd=np.inf):
    """Minimal BullFrog run: the velocity is the Zel'dovich force at g = 0
    (no LPT displacement), then `n_steps` plain steps from g = 0 to g(a).
    `init_mesh` is the rfft of the linear density at a = 1.  Returns (pos,
    vel) with a leading singleton axis."""
    if not init_mesh.is_complex():
        init_mesh = rfftn(init_mesh)
    dg = bg.a2g(a) / int(n_steps)
    vel = pm_forces(pos, init_mesh, paint_order, grad_fd=grad_fd, lap_fd=lap_fd)
    step = bullfrog_step(bg, dg, ch2rshape(init_mesh.shape), paint_order, grad_fd=grad_fd,
                         lap_fd=lap_fd)
    state = (pos, vel)
    for state in _run_steps(step, state, 0.0, dg, n_steps, checkpoint=False):
        pass
    return state[0][None], state[1][None]


# ------------------------------------------------------ scale-factor time
def _fpm_vector_field(bg: Background, mesh_shape, paint_order, grad_fd, lap_fd):
    """d(pos, vel)/da of the FastPM-convention ODE: (vel / (a^3 E),
    1.5 Omega_m F(pos) / (a^2 E)), F the PM forces of the particles'
    own (unclamped) paint."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    cosmo = bg.cosmo

    def vf(pos, vel, a):
        E = torch.sqrt(Esqr(cosmo, a))
        forces = pm_forces(pos, mesh_shape, paint_order, grad_fd=grad_fd,
                           lap_fd=lap_fd) * 1.5 * cosmo.Omega_m
        return vel / (a**3 * E), forces / (a**2 * E)

    return vf


def _scale_factor(a, like):
    """`a` as a float32 tensor on `like`'s device (the JAX functions hold the
    integrators' times in float32)."""
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def nbody_rk4(bg: Background, init_mesh, pos, a0, a1, n_steps=16, paint_order: int = 2,
              grad_fd=4, lap_fd=np.inf):
    """Fixed-step RK4 N-body in scale-factor time, FastPM momentum
    conventions, from the 1LPT state at `a0` (`lpt_fpm`); each step runs
    under `torch.utils.checkpoint` when autograd is on.  Returns (pos, p)
    with a leading singleton axis (the LPT state when a0 == a1)."""
    dpos, vel = lpt_fpm(bg, init_mesh, pos, a0, 1, paint_order, grad_fd, lap_fd)
    pos = pos + dpos
    if a0 == a1:
        return pos[None], vel[None]
    vf = _fpm_vector_field(bg, ch2rshape(init_mesh.shape), paint_order, grad_fd, lap_fd)
    da = (a1 - a0) / n_steps

    def step(pos, vel, a):
        k1 = vf(pos, vel, a)
        k2 = vf(pos + da / 2 * k1[0], vel + da / 2 * k1[1], a + da / 2)
        k3 = vf(pos + da / 2 * k2[0], vel + da / 2 * k2[1], a + da / 2)
        k4 = vf(pos + da * k3[0], vel + da * k3[1], a + da)
        return tuple(x + da / 6 * (d1 + 2 * d2 + 2 * d3 + d4)
                     for x, d1, d2, d3, d4 in zip((pos, vel), k1, k2, k3, k4))

    state = (pos, vel)
    for state in _run_steps(step, state, _scale_factor(a0, pos), _scale_factor(da, pos),
                            n_steps, checkpoint=True):
        pass
    return state[0][None], state[1][None]


# Tsitouras 5(4) embedded pair (Tsitouras 2011, the published tableau)
_TS_C = (0.161, 0.327, 0.9, 0.9800255409045097, 1.0)
_TS_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
     -0.028269050394068383),
)
_TS_B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774, 0.0)
_TS_BTILDE = (  # b - b_hat: the weights of the embedded 4th-order error estimate
    -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
    -0.1447110071732629, 0.5823571654525552, -0.45808210592918697, 1.0 / 66.0)


def _combine(y, ks, coefs, dt):
    """y + dt sum_i c_i k_i, leaf by leaf of the (pos, vel) state."""
    return tuple(yl + dt * sum(c * k for c, k in zip(coefs, kl)) for yl, *kl in zip(y, *ks))


def nbody_tsit5(bg: Background, init_mesh, pos, a0, a1, tol=1e-3, paint_order: int = 2,
                grad_fd=4, lap_fd=np.inf, snapshots=None, max_steps=100, safety=0.9,
                pcoeff=0.4, icoeff=1.0, stats=None):
    """Adaptive-step N-body in scale-factor time: the Tsit5 5(4) pair with
    the PI step-size controller (PIDController(0.4, 1, 0)), FSAL (stage 7
    of an accepted step is stage 1 of the next: 6 force evaluations an
    attempt), from the 1LPT state at `a0`; the FastPM-convention ODE of
    `nbody_rk4`.  A validation integrator: production runs use `nbody_bf`.

    snapshots : None -> the state at a1; int n >= 2 -> n states at
                linspace(a0, a1, n); a list -> the states at those scale
                factors.  Snapshot edges are chained segments that share
                the controller state; each segment makes at most
                `max_steps` attempts and stops where it is when they run
                out (as the JAX function does, without an error).
    stats : a dict, if given, receives the numbers of accepted and
            rejected attempts and of force evaluations.

    The stages run on the device; one host read an attempt decides accept
    or reject (and the end of a segment).  a, dt and the previous error
    stay tensors in the autograd graph, so the gradient flows through the
    controller as it does through the JAX function's masked scan (a where
    on the host's choice has the derivative of `jnp.where`); a and dt are
    float32, as in the JAX function.  Returns (pos, p) stacked over the
    snapshots on the leading axis."""
    dpos, vel = lpt_fpm(bg, init_mesh, pos, a0, 1, paint_order, grad_fd, lap_fd)
    pos = pos + dpos
    if a0 == a1:
        return pos[None], vel[None]
    vf = _fpm_vector_field(bg, ch2rshape(init_mesh.shape), paint_order, grad_fd, lap_fd)
    order = 5.0  # min(solver, embedded) + 1: the controller's exponent base
    counts = {"accepted": 0, "rejected": 0, "force_evaluations": 1}

    def attempt(pos, vel, k1_pos, k1_vel, a, dt_eff):
        """One Tsit5 attempt of size dt_eff from (pos, vel) at a: the new
        state, its stage 7 and the RMS of the embedded error over
        tol (1 + max(|y0|, |y1|))."""
        y, ks = (pos, vel), [(k1_pos, k1_vel)]
        for ci, ai in zip(_TS_C, _TS_A):
            ks.append(vf(*_combine(y, ks, ai, dt_eff), a + ci * dt_eff))
        y1 = _combine(y, ks, _TS_B[:6], dt_eff)  # b7 = 0
        k7 = vf(*y1, a + dt_eff)
        sq_sum, count = 0.0, 0
        for leaf0, leaf1, *kl in zip(y, y1, *(ks + [k7])):
            e = dt_eff * sum(c * k for c, k in zip(_TS_BTILDE, kl))
            scale = tol + tol * torch.maximum(leaf0.abs(), leaf1.abs())
            sq_sum = sq_sum + ((e / scale) ** 2).sum()
            count += leaf0.numel()
        return (*y1, *k7, torch.sqrt(sq_sum / count))

    def segment(y, k1, a_lo, a_hi, dt, err_prev):
        a = _scale_factor(a_lo, y[0])
        end = float(np.float32(a_hi - 1e-7 * (a_hi - a_lo)))  # done: a >= end, in float32
        for _ in range(max_steps):
            if a.item() >= end:
                break
            dt_eff = torch.minimum(dt, a_hi - a)  # clip the last step
            args = (*y, *k1, a, dt_eff)
            if torch.is_grad_enabled():
                out = torch_checkpoint(attempt, *args, use_reentrant=False)
            else:
                out = attempt(*args)
            y1, k7, err = out[:2], out[2:4], out[4]
            counts["force_evaluations"] += 6
            err = torch.where(torch.isfinite(err), err, torch.full_like(err, 2.0))
            accept = err.item() <= 1.0  # the attempt's one host read
            e_n = torch.clamp(err, min=1e-10)
            factor = (safety * e_n ** (-(icoeff + pcoeff) / order)
                      * torch.clamp(err_prev, min=1e-10) ** (pcoeff / order))
            dt_next = (dt * torch.clamp(factor, 0.2, 10.0)).float()
            if accept:
                y, k1, a, err_prev = y1, k7, a + dt_eff, e_n
                counts["accepted"] += 1
            else:
                counts["rejected"] += 1
            dt = dt_next
        return y, k1, dt, err_prev

    if snapshots is None or (isinstance(snapshots, int) and snapshots < 2):
        ts = np.asarray([a1], float)
    elif isinstance(snapshots, int):
        ts = np.linspace(a0, a1, snapshots)
    else:
        ts = np.asarray(snapshots, float)

    y = (pos, vel)
    k1 = vf(*y, _scale_factor(a0, pos))
    dt = _scale_factor((a1 - a0) / 20.0, pos)
    err_prev = _scale_factor(1.0, pos)
    saves, a_cur = [], float(a0)
    for t in ts:  # chained segments, shared controller state
        if t > a_cur:
            y, k1, dt, err_prev = segment(y, k1, a_cur, float(t), dt, err_prev)
            a_cur = float(t)
        saves.append(y)
    if stats is not None:
        stats.update(counts)
    return torch.stack([s[0] for s in saves]), torch.stack([s[1] for s in saves])
