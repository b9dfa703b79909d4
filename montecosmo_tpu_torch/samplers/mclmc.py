"""Microcanonical Langevin Monte Carlo (MCLMC) and its Metropolis-adjusted
variant (MAMS), with automatic L / step-size adaptation.

Parity: `montecosmo_tpu/samplers/mclmc.py` (same names, same arithmetic):

* isokinetic dynamics on the sphere: the exact ESH momentum bounce, its
  kinetic-energy change in the log1p/expm1 form;
* minimal-norm (McLachlan) 2nd-order splitting: 2 gradient evals / step;
* partial momentum refresh (OU on the sphere) with rate eps/L;
* warmup: stochastic step-size control toward a desired energy variance per
  dimension (with the float32 noise-floor clamp), then L and optionally a
  diagonal inverse mass matrix from streaming position moments;
* MAMS: full-refresh trajectories of random length ~ U(0, 2 L / eps) with an
  MH correction, step size tuned to a target acceptance rate.

Where the JAX package takes a key, the public functions take a
torch.Generator; the loops inside (`_warmup_chunk`, `_run_chunk`,
`mams_kernel`) take their normal draws as tensors, so that a chain can be
driven by the JAX package's own draws.  States hold detached tensors: each
value+grad builds its graph under `torch.enable_grad()`, takes
`torch.autograd.grad` and drops it; everything else runs under
`torch.no_grad()`.  A MAMS trajectory is a loop of exactly its `n_steps`
McLachlan steps (the JAX scan runs `max_steps` and masks the rest, which
leaves the state as the loop does).  Chains run one after another.
"""
from functools import partial
from typing import Any, NamedTuple

import numpy as np
import torch


class IntegratorState(NamedTuple):
    position: Any          # dict of tensors
    momentum: Any          # flat unit vector (d,)
    logdensity: Any        # 0-d tensor
    logdensity_grad: Any   # dict of tensors, the keys of position


class MCLMCAdaptationState(NamedTuple):
    L: Any
    step_size: Any
    inverse_mass_matrix: Any  # flat (d,) or scalar 1.0


_MCLACHLAN_B1 = 0.1931833275037836
# normal draws of one warmup or run chunk: at most this many values (1 GiB)
_CHUNK_VALUES = 2**28


def _ravel(tree):
    """(flat, unravel) of a dict of tensors in the layout of
    jax.flatten_util.ravel_pytree: sorted keys, each leaf in C order."""
    keys = sorted(tree)
    shapes = [tuple(torch.as_tensor(tree[k]).shape) for k in keys]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.cat([torch.as_tensor(tree[k]).reshape(-1) for k in keys])

    def unravel(x):
        return {k: v.reshape(s) for k, v, s in zip(keys, torch.split(x, sizes), shapes)}

    return flat, unravel


def _value_and_grad(logdensity_fn, position):
    """(logdensity, gradient dict) at `position`, both detached: the graph
    lives only inside this call."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in position.items()}
    with torch.enable_grad():
        lp = logdensity_fn(leaves)
        grads = torch.autograd.grad(lp, list(leaves.values()), allow_unused=True)
    grad = {k: torch.zeros_like(v) if g is None else g.detach()
            for (k, v), g in zip(leaves.items(), grads)}
    return lp.detach(), grad


def _normal(rng, shape, like):
    """Standard normal draw of `shape`: `rng` itself when it is a tensor
    (the caller's draw), else from the torch.Generator `rng`."""
    if torch.is_tensor(rng):
        assert tuple(rng.shape) == tuple(shape), (rng.shape, shape)
        return rng.to(like.device, like.dtype)
    return torch.randn(shape, generator=rng, device=like.device, dtype=like.dtype)


def _uniform(rng, like):
    if torch.is_tensor(rng):
        return rng.to(like.device, like.dtype)
    return torch.rand((), generator=rng, device=like.device, dtype=like.dtype)


def _scalar(x, like):
    """Adaptation scalar (or vector) as a tensor on `like`'s device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def mclmc_init(position, logdensity_fn, rng):
    """Initial state: random unit momentum + logdensity and gradient.  `rng`
    is a torch.Generator or the (d,) normal draw of the momentum."""
    position = {k: torch.as_tensor(v) for k, v in position.items()}
    flat, _ = _ravel(position)
    with torch.no_grad():
        u = _normal(rng, flat.shape, flat)
        u = u / torch.linalg.vector_norm(u)
    logdensity, grad = _value_and_grad(logdensity_fn, position)
    position = {k: v.detach() for k, v in position.items()}
    return IntegratorState(position, u, logdensity, grad)


def _momentum_update(u, grad_flat, sqrt_invmm, step_size):
    """Exact isokinetic (ESH) momentum bounce; returns (u', dKE)."""
    d = u.shape[0]
    g = grad_flat * sqrt_invmm
    gnorm = torch.clamp(torch.linalg.vector_norm(g), min=1e-30)
    e = g / gnorm
    delta = step_size * gnorm / (d - 1)
    c = u @ e
    z = torch.exp(-delta)
    u_new = e * (1 - z) * (1 + z + c * (1 - z)) + 2 * z * u
    u_new = u_new / torch.linalg.vector_norm(u_new)
    # dKE = (d-1)(delta - log 2 + log(1 + c + (1-c) z^2)), rewritten via
    # 1 + c + (1-c) z^2 = 2 (1 + (1-c)(z^2-1)/2) so that the log is a log1p
    # of an O(delta) quantity: the naive form's float32 rounding of a log of
    # ~2, times (d-1), is ~0.1 of pure noise per update at d ~ 1e6
    z2m1 = torch.expm1(-2.0 * delta)  # z^2 - 1, no cancellation for small delta
    dKE = (d - 1) * (delta + torch.log1p(0.5 * (1 - c) * z2m1))
    return u_new, dKE


def _mclachlan_step(state: IntegratorState, logdensity_fn, step_size, sqrt_invmm):
    """One minimal-norm 2nd-order isokinetic step (2 gradient evals)."""
    x_flat, unravel = _ravel(state.position)
    g_flat, _ = _ravel(state.logdensity_grad)
    u = state.momentum
    b1 = _MCLACHLAN_B1

    u, dk1 = _momentum_update(u, g_flat, sqrt_invmm, b1 * step_size)
    x_flat = x_flat + 0.5 * step_size * sqrt_invmm * u
    logdensity, grad = _value_and_grad(logdensity_fn, unravel(x_flat))
    g_flat, _ = _ravel(grad)
    u, dk2 = _momentum_update(u, g_flat, sqrt_invmm, (1 - 2 * b1) * step_size)
    x_flat = x_flat + 0.5 * step_size * sqrt_invmm * u
    logdensity, grad = _value_and_grad(logdensity_fn, unravel(x_flat))
    g_flat, _ = _ravel(grad)
    u, dk3 = _momentum_update(u, g_flat, sqrt_invmm, b1 * step_size)

    new = IntegratorState(unravel(x_flat), u, logdensity, grad)
    return new, dk1 + dk2 + dk3


def _partial_refresh(u, noise, step_size, L):
    """OU momentum refresh on the sphere with rate eps/L; `noise` is the
    (d,) standard normal draw."""
    d = u.shape[0]
    nu = torch.sqrt((torch.exp(2 * _scalar(step_size, u) / L) - 1.0) / d)
    un = u + nu * noise
    return un / torch.linalg.vector_norm(un)


def mclmc_kernel(logdensity_fn, inverse_mass_matrix=1.0):
    """Unadjusted MCLMC transition: McLachlan step + partial refresh.

    kernel(rng, state, L, step_size) -> (new_state, info), info =
    dict(energy_change, logdensity); `rng` is a torch.Generator or the (d,)
    normal draw of the refresh."""

    def kernel(rng, state: IntegratorState, L, step_size):
        with torch.no_grad():
            sqrt_invmm = torch.sqrt(_scalar(inverse_mass_matrix, state.momentum))
            new, dKE = _mclachlan_step(state, logdensity_fn, step_size, sqrt_invmm)
            energy_change = dKE - new.logdensity + state.logdensity
            noise = _normal(rng, new.momentum.shape, new.momentum)
            u = _partial_refresh(new.momentum, noise, step_size, L)
        new = new._replace(momentum=u)
        return new, dict(energy_change=energy_change, logdensity=new.logdensity)

    return kernel


def _select(ok, new, old):
    """`new` where the 0-d boolean `ok`, else `old`, leaf by leaf."""
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*(_select(ok, n, o) for n, o in zip(new, old)))
    return torch.where(ok, new, old)


# --------------------------------------------------------------------- adaptation
def _nan_guard(prev_state, next_state, step_size_max, energy_change, step_size):
    """Reject non-finite transitions and shrink the step-size cap."""
    flat, _ = _ravel(next_state.position)
    ok = (torch.isfinite(energy_change)
          & torch.all(torch.isfinite(flat))
          & torch.isfinite(next_state.logdensity))
    state = _select(ok, next_state, prev_state)
    step_size_max = torch.where(ok, step_size_max, step_size * 0.8)
    energy_change = torch.where(ok, energy_change, torch.full_like(energy_change, np.inf))
    return ok, state, step_size_max, energy_change


def _chunk_sizes(n_steps, d):
    """Steps per chunk of noise, each chunk at most _CHUNK_VALUES draws."""
    per = max(1, _CHUNK_VALUES // max(d, 1))
    return [min(per, n_steps - i) for i in range(0, n_steps, per)]


def _adaptation_state(config, d, like):
    """MCLMCAdaptationState of tensors from a state, a dict or None."""
    if isinstance(config, dict):
        config = MCLMCAdaptationState(
            L=config["L"], step_size=config["step_size"],
            inverse_mass_matrix=config.get("inverse_mass_matrix", torch.ones(d)))
    return MCLMCAdaptationState(*(_scalar(x, like) for x in config))


def mclmc_warmup(gen, init_pos, logdf, n_steps=0, config=None,
                 desired_energy_var=5e-4, diagonal_preconditioning=False,
                 num_effective_samples=256, trust_in_estimate=1.5):
    """Tune (L, step_size[, diag inverse mass]) for MCLMC.

    tune1 (first half): stochastic step-size control (per step the squared
    energy error xi = E^2/(d sigma*^2) updates a forgetting average of
    log(xi / eps^6), whose -1/6 power is the new step size).  tune2 (second
    half): the same, plus streaming position moments giving L = sqrt(sum
    Var[x]) and optionally the diagonal inverse mass matrix.  `gen` is a
    torch.Generator on the positions' device.

    Returns (state, MCLMCAdaptationState)."""
    state = mclmc_init(init_pos, logdf, gen)
    flat, _ = _ravel(state.position)
    d = flat.shape[0]

    if config is None:
        config = MCLMCAdaptationState(
            torch.tensor(d**0.5, dtype=flat.dtype, device=flat.device),
            torch.tensor(d**0.5 / 1e4, dtype=flat.dtype, device=flat.device),
            inverse_mass_matrix=torch.ones(d, dtype=flat.dtype, device=flat.device))
    config = _adaptation_state(config, d, flat)

    if n_steps == 0:
        return state, config

    steps1 = n_steps // 2
    steps2 = n_steps - steps1

    carry = _warmup_carry0(state, config, flat.dtype, d)
    for steps, stream in ((steps1, False), (steps2, True)):
        for n in _chunk_sizes(steps, d):
            noise = torch.randn((n, d), generator=gen, device=flat.device, dtype=flat.dtype)
            carry = _warmup_chunk(carry, noise, stream, logdf, desired_energy_var,
                                  num_effective_samples, trust_in_estimate)
    return _warmup_finalize(carry, diagonal_preconditioning)


def _warmup_carry0(state, config, dtype, d):
    """Initial adaptation carry (see mclmc_warmup)."""
    dev = state.momentum.device
    zero = lambda: torch.zeros((), dtype=dtype, device=dev)
    cap0 = torch.tensor(np.inf, dtype=dtype, device=dev)
    mom0 = (zero(), torch.zeros(d, dtype=dtype, device=dev),
            torch.zeros(d, dtype=dtype, device=dev))
    return (state, config, (zero(), zero(), cap0, (zero(), zero())), mom0)


def _warmup_chunk(carry, noise, stream_moments, logdf, desired_energy_var=5e-4,
                  num_effective_samples=256, trust_in_estimate=1.5):
    """Run a chunk of warmup steps, one per row of `noise` (n_steps, d), the
    refresh draws; returns the carry.  Threading the carry through chunks
    gives the adaptation trajectory of one long chunk."""
    d = _ravel(carry[0].position)[0].shape[0]
    gamma = (num_effective_samples - 1.0) / (num_effective_samples + 1.0)
    state, params, (F, W, step_size_max, xi_avg), (w_sum, x_sum, x2_sum) = carry
    with torch.no_grad():
        for row in noise:
            kernel = mclmc_kernel(logdf, params.inverse_mass_matrix)
            next_state, info = kernel(row, state, params.L, params.step_size)
            ok, state, step_size_max, energy_change = _nan_guard(
                state, next_state, step_size_max, info["energy_change"], params.step_size)

            # float32 energy-measurement noise floor: energy_change subtracts
            # two logdensities of magnitude |L| whose float32 rounding (ulp <=
            # 2 eps |L|) puts ~ulp^2/6 of variance into every measurement.
            # Chasing a desired_energy_var below that floor collapses the step
            # size toward zero, so the per-dim target is clamped to keep the
            # true signal >~5x the noise RMS; in float64 the clamp is a no-op
            eps_mach = torch.finfo(energy_change.dtype).eps
            noise_var = (2.0 * eps_mach * state.logdensity.abs()) ** 2 / 6.0
            dev_eff = torch.clamp(25.0 * noise_var / d, min=desired_energy_var)
            xi = energy_change**2 / (d * dev_eff) + 1e-8
            log_xi = torch.log(xi)
            valid = torch.isfinite(log_xi)  # guarded bad steps carry xi = inf
            log_xi = torch.where(valid, log_xi, torch.zeros_like(log_xi))
            w = torch.where(valid, torch.exp(-0.5 * (log_xi / (6.0 * trust_in_estimate))**2),
                            torch.zeros_like(log_xi))
            # per-step estimate of the optimal step size (squared energy
            # error ~ eps^6), averaged in log space with forgetting
            log_eps_hat = torch.log(params.step_size) - log_xi / 6.0
            F = gamma * F + w * log_eps_hat
            W = gamma * W + w
            step_size = torch.exp(F / torch.clamp(W, min=1e-12))
            step_size = torch.minimum(step_size, step_size_max)
            params = params._replace(step_size=step_size)
            # arithmetic mean of xi at the current eps (for the final
            # rescale); guarded steps count as the cap
            xi_avg = (gamma * xi_avg[0] + torch.where(valid, torch.clamp(xi, max=1e3),
                                                      torch.full_like(xi, 1e3)),
                      gamma * xi_avg[1] + 1.0)

            if stream_moments:
                x, _ = _ravel(state.position)
                wgt = ok.to(x.dtype)
                w_sum = w_sum + wgt
                x_sum = x_sum + wgt * x
                x2_sum = x2_sum + wgt * x**2
    return (state, params, (F, W, step_size_max, xi_avg), (w_sum, x_sum, x2_sum))


def _moment_variances(w_sum, x_sum, x2_sum):
    x_avg = x_sum / torch.clamp(w_sum, min=1)
    return torch.clamp(x2_sum / torch.clamp(w_sum, min=1) - x_avg**2, min=1e-12)


def _warmup_finalize(carry, diagonal_preconditioning):
    """Final (state, MCLMCAdaptationState) from the adaptation carry."""
    state, params, (_, _, _, (xi_num, xi_den)), (w_sum, x_sum, x2_sum) = carry
    flat, _ = _ravel(state.position)
    d = flat.shape[0]

    with torch.no_grad():
        # rescale so that the arithmetic mean of xi is ~1 (log averaging
        # targets the geometric mean, which undershoots for heavy tails)
        xi_arith = xi_num / torch.clamp(xi_den, min=1e-12)
        correction = torch.clamp(xi_arith, 1.0, 1e3) ** (-1.0 / 6.0)
        params = params._replace(step_size=params.step_size * correction)

        variances = _moment_variances(w_sum, x_sum, x2_sum)
        if diagonal_preconditioning:
            invmm = variances
            # the effective step lives in whitened coordinates: rescale eps
            # so that the typical per-coordinate move is preserved
            old = torch.sqrt(_scalar(params.inverse_mass_matrix, flat))
            new = torch.sqrt(invmm)
            scale = torch.exp(torch.mean(torch.log(old / new)))
            params = params._replace(inverse_mass_matrix=invmm,
                                     step_size=params.step_size * scale,
                                     L=torch.sqrt(_scalar(float(d), flat)))
        else:
            params = params._replace(L=torch.sqrt(torch.sum(variances)))
    return state, params


def _stack(records):
    """List of dicts -> dict of tensors stacked along a new leading axis."""
    return {k: torch.stack([r[k] for r in records]) for k in records[0]}


def _run_chunk(state, noise, kernel, L, step_size):
    """`noise.shape[0]` MCLMC transitions, one per row of `noise`, the
    refresh draws: (state, RMS of the energy changes)."""
    de = []
    for row in noise:
        state, info = kernel(row, state, L, step_size)
        de.append(info["energy_change"])
    return state, torch.sqrt(torch.mean(torch.stack(de)**2))


def mclmc_run(gen, state, config, logdf, n_samples, transform=None,
              thinning=1, progress_bar=False):
    """Run MCLMC for `n_samples` thinned samples (thinning inner steps each).

    Per kept sample records (position, logdensity, mse_per_dim = RMS^2 of
    the energy changes / d) and n_evals (2 grad evals per McLachlan step).
    `gen` is a torch.Generator, or the (n_samples, thinning, d) refresh
    draws."""
    if isinstance(config, dict):
        L, step_size = config["L"], config["step_size"]
        invmm = config.get("inverse_mass_matrix", 1.0)
    else:
        L, step_size, invmm = config.L, config.step_size, config.inverse_mass_matrix

    kernel = mclmc_kernel(logdf, invmm)
    flat, _ = _ravel(state.position)
    d = flat.shape[0]
    L, step_size = _scalar(L, flat), _scalar(step_size, flat)

    if transform is None:
        transform = lambda state, info: (
            state.position,
            {"logdensity": state.logdensity,
             "mse_per_dim": info["energy_change"] ** 2 / d})

    samples, infos = [], []
    for i in range(n_samples):
        noise = _normal(gen[i] if torch.is_tensor(gen) else gen, (thinning, d), flat)
        state, de = _run_chunk(state, noise, kernel, L, step_size)
        sample, info = transform(state, {"energy_change": de})
        samples.append(sample)
        infos.append(info)
    out = {**_stack(samples), **_stack(infos)}
    out["n_evals"] = 2 * thinning * torch.ones(n_samples, device=flat.device)
    return state, out


def get_mclmc_warmup(logdf, n_steps=None, config=None, desired_energy_var=5e-4,
                     diagonal_preconditioning=False):
    return partial(mclmc_warmup, logdf=logdf, n_steps=n_steps, config=config,
                   desired_energy_var=desired_energy_var,
                   diagonal_preconditioning=diagonal_preconditioning)


def get_mclmc_run(logdf, n_samples, transform=None, thinning=1, progress_bar=False):
    return partial(mclmc_run, logdf=logdf, n_samples=n_samples,
                   transform=transform, thinning=thinning,
                   progress_bar=progress_bar)


# ======================================================================= MAMS
def _trajectory(state, logdensity_fn, step_size, sqrt_invmm, n_steps):
    """Integrate exactly `n_steps` McLachlan steps, accumulating the energy
    change for the MH correction."""
    dE = torch.zeros((), dtype=state.momentum.dtype, device=state.momentum.device)
    for _ in range(n_steps):
        new, dKE = _mclachlan_step(state, logdensity_fn, step_size, sqrt_invmm)
        dE = dE + dKE - new.logdensity + state.logdensity
        state = new
    return state, dE


def mams_kernel(logdensity_fn, inverse_mass_matrix, step_size, avg_steps, max_steps,
                L_proposal_factor=np.inf):
    """Metropolis-adjusted MCLMC: full momentum refresh, trajectory length
    n_steps = clip(ceil(U(0,1) * 2 * avg_steps), 1, max_steps), MH accept
    on the energy error.

    kernel(rng, state) -> (new_state, info); `rng` is a torch.Generator or
    the draws (momentum (d,), U of the length, U of the accept)."""

    def kernel(rng, state: IntegratorState):
        with torch.no_grad():
            like = state.momentum
            if isinstance(rng, torch.Generator):
                rng = (rng, rng, rng)
            mom, u_len, u_acc = rng
            sqrt_invmm = torch.sqrt(_scalar(inverse_mass_matrix, like))
            u = _normal(mom, like.shape, like)
            u = u / torch.linalg.vector_norm(u)
            state = state._replace(momentum=u)

            n_steps = torch.ceil(_uniform(u_len, like) * 2 * _scalar(avg_steps, like))
            n_steps = int(torch.clamp(n_steps, 1, max_steps))
            prop, dE = _trajectory(state, logdensity_fn, _scalar(step_size, like),
                                   sqrt_invmm, n_steps)

            p_acc = torch.clamp(torch.exp(-dE), max=1.0)
            p_acc = torch.where(torch.isfinite(dE), p_acc, torch.zeros_like(p_acc))
            accept = _uniform(u_acc, like) < p_acc
            new = _select(accept, prop, state)
        info = dict(acceptance_rate=p_acc, num_integration_steps=n_steps,
                    is_accepted=accept)
        return new, info

    return kernel


def mams_warmup(gen, init_pos, logdf, n_steps=0, config=None,
                diagonal_preconditioning=False, target_acc_rate=0.65,
                max_steps=128, random_trajectory_length=True,
                L_proposal_factor=np.inf):
    """Tune MAMS: Robbins-Monro step-size control toward `target_acc_rate`,
    L from streaming position variances.  Returns (state,
    MCLMCAdaptationState)."""
    state = mclmc_init(init_pos, logdf, gen)
    flat, _ = _ravel(state.position)
    d = flat.shape[0]

    if config is None:
        config = MCLMCAdaptationState(
            torch.tensor(d**0.5, dtype=flat.dtype, device=flat.device),
            torch.tensor(d**0.5 / 64, dtype=flat.dtype, device=flat.device),
            inverse_mass_matrix=torch.ones(d, dtype=flat.dtype, device=flat.device))
    config = _adaptation_state(config, d, flat)

    if n_steps == 0:
        return state, config

    carry = _mams_carry0(state, config, flat.dtype, d)
    xs = [(i, gen) for i in range(n_steps)]
    carry = _mams_chunk(carry, xs, logdf, target_acc_rate, max_steps, L_proposal_factor)
    return _mams_finalize(carry, diagonal_preconditioning)


def _mams_carry0(state, config, dtype, d):
    """Initial MAMS adaptation carry: (state, params, position moments)."""
    dev = state.momentum.device
    mom0 = (torch.zeros((), dtype=dtype, device=dev), torch.zeros(d, dtype=dtype, device=dev),
            torch.zeros(d, dtype=dtype, device=dev))
    return (state, config, mom0)


def _mams_chunk(carry, xs, logdf, target_acc_rate=0.65, max_steps=128,
                L_proposal_factor=np.inf):
    """Run a chunk of MAMS warmup steps; xs = [(global step index, draws)],
    the draws a torch.Generator or a step's (momentum, U, U).  The
    Robbins-Monro rate depends on the global index, so chunks thread into
    the trajectory of one long chunk."""
    state, params, (w_sum, x_sum, x2_sum) = carry
    with torch.no_grad():
        for i, rng in xs:
            avg_steps = torch.clamp(params.L / params.step_size, min=1.0)
            kernel = mams_kernel(logdf, params.inverse_mass_matrix, params.step_size,
                                 avg_steps, max_steps, L_proposal_factor)
            state, info = kernel(rng, state)

            # Robbins-Monro on log step size toward the target acceptance
            lr = 0.5 / np.sqrt(1.0 + i)
            log_eps = torch.log(params.step_size) \
                + lr * (info["acceptance_rate"] - target_acc_rate)
            params = params._replace(step_size=torch.exp(log_eps))

            x, _ = _ravel(state.position)
            w_sum = w_sum + 1.0
            x_sum = x_sum + x
            x2_sum = x2_sum + x**2
    return (state, params, (w_sum, x_sum, x2_sum))


def _mams_finalize(carry, diagonal_preconditioning):
    """Final (state, MCLMCAdaptationState) from the MAMS adaptation carry."""
    state, params, (w_sum, x_sum, x2_sum) = carry
    flat, _ = _ravel(state.position)
    d = flat.shape[0]
    with torch.no_grad():
        variances = _moment_variances(w_sum, x_sum, x2_sum)
        if diagonal_preconditioning:
            params = params._replace(inverse_mass_matrix=variances,
                                     L=torch.sqrt(_scalar(float(d), flat)))
        else:
            params = params._replace(L=torch.sqrt(torch.sum(variances)))
    return state, params


def mams_run(gen, state, config, logdf, n_samples, transform=None, thinning=1,
             progress_bar=False, max_steps=256, L_proposal_factor=np.inf):
    """Run MAMS; records (position, logdensity, acceptance_rate, n_evals)."""
    if isinstance(config, dict):
        L, step_size = config["L"], config["step_size"]
        invmm = config.get("inverse_mass_matrix", 1.0)
    else:
        L, step_size, invmm = config.L, config.step_size, config.inverse_mass_matrix

    like = state.momentum
    avg_steps = torch.clamp(_scalar(L, like) / _scalar(step_size, like), min=1.0)
    kernel = mams_kernel(logdf, invmm, step_size, avg_steps, max_steps, L_proposal_factor)

    if transform is None:
        transform = lambda state, info: (
            state.position,
            {"logdensity": state.logdensity,
             "acceptance_rate": info["acceptance_rate"],
             "n_evals": info["num_integration_steps"] * 2})

    samples, infos = [], []
    for _ in range(n_samples):
        acc, n_int = [], 0
        for _ in range(thinning):
            state, info = kernel(gen, state)
            acc.append(info["acceptance_rate"])
            n_int += info["num_integration_steps"]
        info = dict(acceptance_rate=torch.mean(torch.stack(acc)),
                    num_integration_steps=torch.tensor(n_int, device=like.device))
        sample, info = transform(state, info)
        samples.append(sample)
        infos.append(info)
    return state, {**_stack(samples), **_stack(infos)}


def get_mams_warmup(logdf, n_steps=None, config=None, diagonal_preconditioning=False):
    return partial(mams_warmup, logdf=logdf, n_steps=n_steps, config=config,
                   diagonal_preconditioning=diagonal_preconditioning)


def get_mams_run(logdf, n_samples, transform=None, thinning=1, progress_bar=False):
    return partial(mams_run, logdf=logdf, n_samples=n_samples,
                   transform=transform, thinning=thinning,
                   progress_bar=progress_bar)
