"""HMC and iterative NUTS with Stan-style window adaptation, and the
Metropolis-within-Gibbs combinators of the blocked field/parameter updates.

Parity: `montecosmo_tpu/samplers/hmc.py` (same names, same arithmetic):

* leapfrog and the fixed-length HMC kernel, on a diagonal or dense metric;
* dynamic NUTS: iterative progressive sampling (multinomial within a
  subtree, biased progressive between them), the generalized U-turn
  criterion with the checkpoint scheme for the subtrees' internal checks,
  the divergence threshold;
* dual-averaging step size and the Welford (diagonal or dense) mass in
  fast/slow/fast windows; Stan's step-size bracketing;
* `mwg_*`: blocked Gibbs over a dict of per-block kernels and states.

The loops are plain Python loops over exactly the leaves and doublings a
transition builds (the JAX `while_loop`s stop at the same places), each
leapfrog one value+grad (`mclmc._value_and_grad`).  Where the JAX package
takes a key, a transition takes a `Draws`: a torch.Generator wrapped, or
any object with the same methods, so that a test can replay the JAX
package's own draws.  States hold detached tensors.  Chains run one after
another.  Not ported: `nuts_host_transition` and the
`MONTECOSMO_NUTS_MAX_DOUBLINGS` variable (TPU program-length workarounds);
`max_num_doublings` is an argument.
"""
from functools import partial
from typing import Any, NamedTuple

import numpy as np
import torch

from montecosmo_tpu_torch.samplers.mclmc import _ravel, _stack, _value_and_grad


class HMCState(NamedTuple):
    position: Any          # dict of tensors
    logdensity: Any        # 0-d tensor
    logdensity_grad: Any   # dict of tensors, the keys of position


class Draws:
    """The random draws of a transition, in the order the kernels ask for
    them, from a torch.Generator: `momentum` (the normal xi of r = L^-T xi),
    then per doubling `direction` (+1 or -1, each with probability 1/2),
    `leaf` (one uniform a leaf, its progressive-sampling draw) and `take`
    (the uniform of the merge); HMC's `accept`.  A test replays the JAX
    package's draws through an object with the same methods."""

    def __init__(self, gen):
        self.gen = gen

    def _uniform(self, like):
        return torch.rand((), generator=self.gen, device=self.gen.device,
                          dtype=like.dtype).to(like.device)

    def momentum(self, like):
        return torch.randn(like.shape, generator=self.gen, device=self.gen.device,
                           dtype=like.dtype).to(like.device)

    def direction(self, like):
        return 1.0 if bool(self._uniform(like) < 0.5) else -1.0

    leaf = take = accept = _uniform


def _draws(rng):
    """`rng` as a Draws: a torch.Generator is wrapped, anything else is
    taken as it is."""
    return Draws(rng) if isinstance(rng, torch.Generator) else rng


def _tensor(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def hmc_init(position, logdensity_fn):
    logdensity, grad = _value_and_grad(logdensity_fn, position)
    return HMCState({k: torch.as_tensor(v).detach() for k, v in position.items()},
                    logdensity, grad)


def _vel(invmm, r):
    """Velocity invmm r: a diagonal metric elementwise, a dense (d, d) one
    as a matvec."""
    return invmm @ r if invmm.ndim == 2 else invmm * r


def _bcast_invmm(inverse_mass_matrix, x0):
    """An inverse-mass argument against the flat position: scalars and (d,)
    vectors broadcast to a diagonal metric, (d, d) stays dense."""
    invmm = _tensor(inverse_mass_matrix, x0)
    return invmm if invmm.ndim == 2 else torch.broadcast_to(invmm, x0.shape)


def _momentum(xi, invmm):
    """r ~ N(0, M), M = invmm^-1, from the standard normal draw `xi`.  Dense:
    invmm = L L^T gives r = L^-T xi (covariance L^-T L^-1 = invmm^-1)."""
    if invmm.ndim == 2:
        chol = torch.linalg.cholesky(invmm)
        return torch.linalg.solve_triangular(chol.T, xi[:, None], upper=True)[:, 0]
    return xi / torch.sqrt(invmm)


def _leapfrog(x, r, g, logdensity_fn, unravel, step_size, invmm):
    """One velocity-Verlet step on the flat phase space; g = grad logp."""
    r = r + 0.5 * step_size * g
    x = x + step_size * _vel(invmm, r)
    logdensity, grad = _value_and_grad(logdensity_fn, unravel(x))
    g = _ravel(grad)[0]
    r = r + 0.5 * step_size * g
    return x, r, g, logdensity


def _kinetic(r, invmm):
    return 0.5 * torch.dot(r, _vel(invmm, r))


# ======================================================================= HMC
def hmc_kernel(logdensity_fn, step_size, num_integration_steps, inverse_mass_matrix=1.0):
    """Fixed-trajectory HMC with MH correction: kernel(rng, state) ->
    (state, info), `rng` a torch.Generator or a Draws."""

    def kernel(rng, state: HMCState):
        draws = _draws(rng)
        with torch.no_grad():
            x0, unravel = _ravel(state.position)
            g0 = _ravel(state.logdensity_grad)[0]
            invmm = _bcast_invmm(inverse_mass_matrix, x0)
            r0 = _momentum(draws.momentum(x0), invmm)
            H0 = -state.logdensity + _kinetic(r0, invmm)
            x, r, g, ld = x0, r0, g0, state.logdensity
            for _ in range(int(num_integration_steps)):
                x, r, g, ld = _leapfrog(x, r, g, logdensity_fn, unravel, step_size, invmm)
            H1 = -ld + _kinetic(r, invmm)
            dH = H1 - H0
            p_acc = torch.where(torch.isfinite(dH), torch.clamp(torch.exp(-dH), max=1.0),
                                torch.zeros_like(dH))
            accept = bool(draws.accept(x0) < p_acc)
        new = HMCState(unravel(x), ld, unravel(g)) if accept else state
        info = dict(acceptance_rate=p_acc, is_accepted=accept,
                    num_integration_steps=int(num_integration_steps), energy=H1)
        return new, info

    return kernel


# ======================================================================= NUTS
class _Tree(NamedTuple):
    """A (sub)trajectory: edge states, multinomial sample, weights, stats."""
    x_left: Any
    r_left: Any
    g_left: Any
    ld_left: Any
    x_right: Any
    r_right: Any
    g_right: Any
    ld_right: Any
    x_prop: Any            # multinomial sample from the trajectory
    ld_prop: Any
    g_prop: Any
    logw: Any              # logsumexp of -H over the trajectory
    r_sum: Any             # momentum sum over the trajectory
    turning: bool
    diverging: bool
    sum_acc: Any           # sum of per-leaf min(1, e^{H0-H}) for adaptation
    n_leaves: int


def _is_turning(r_left, r_right, r_sum, invmm):
    v = _vel(invmm, r_sum)
    return (torch.dot(v, r_left) <= 0) | (torch.dot(v, r_right) <= 0)


def _popcount(i):
    """Number of set bits of a non-negative int."""
    return bin(int(i)).count("1")


def _subtree_carry0(tree: _Tree, direction, max_depth):
    """Leaf-loop carry at the start of a subtree build from `tree`'s edge."""
    if direction > 0:
        x, r, g, ld = tree.x_right, tree.r_right, tree.g_right, tree.ld_right
    else:
        x, r, g, ld = tree.x_left, tree.r_left, tree.g_left, tree.ld_left
    return dict(
        i=0, x=x, r=r, g=g, ld=ld, x_prop=x, ld_prop=ld, g_prop=g,
        logw=_tensor(-np.inf, ld), r_sum=torch.zeros_like(r), sum_acc=torch.zeros_like(ld),
        turning=False, diverging=False,
        r_ckpts=[None] * (max_depth + 1), rsum_ckpts=[None] * (max_depth + 1),
        x_first=x, r_first=r, g_first=g, ld_first=ld)


def _leaf_body(s, u_leaf, *, logdensity_fn, unravel, step_size, invmm, H0, direction,
               divergence_threshold):
    """One leapfrog leaf of a subtree build (progressive multinomial +
    checkpoint-scheme internal turning checks); `u_leaf` is its uniform."""
    x, r, g, ld = _leapfrog(s["x"], s["r"], s["g"], logdensity_fn, unravel,
                            direction * step_size, invmm)
    H = -ld + _kinetic(r, invmm)
    dH = H - H0
    logw_leaf = torch.where(torch.isfinite(H), -H, torch.full_like(H, -np.inf))
    sum_acc = s["sum_acc"] + torch.where(torch.isfinite(dH), torch.clamp(torch.exp(-dH), max=1.0),
                                         torch.zeros_like(dH))

    # progressive multinomial within the subtree
    logw = torch.logaddexp(s["logw"], logw_leaf)
    take = u_leaf < torch.exp(logw_leaf - logw)
    x_prop = torch.where(take, x, s["x_prop"])
    ld_prop = torch.where(take, ld, s["ld_prop"])
    g_prop = torch.where(take, g, s["g_prop"])

    r_sum = s["r_sum"] + r
    i = s["i"]
    # checkpoint at even leaves: slot = popcount(i)
    r_ckpts, rsum_ckpts = list(s["r_ckpts"]), list(s["rsum_ckpts"])
    if i % 2 == 0:
        r_ckpts[_popcount(i)] = r
        rsum_ckpts[_popcount(i)] = r_sum
    # turning checks for the subtrees ending at odd leaf i: slots
    # [popcount(i+1)-1, popcount(i)-1]
    turns = [_is_turning(r_ckpts[k], r, r_sum - rsum_ckpts[k] + r_ckpts[k], invmm)
             for k in range(_popcount(i + 1) - 1, _popcount(i)) if i % 2 == 1]
    # one host read for both flags
    flags = torch.stack([~torch.isfinite(dH) | (dH > divergence_threshold),
                         torch.stack(turns).any() if turns else torch.zeros_like(take)]).tolist()

    first = i == 0
    return dict(
        i=i + 1, x=x, r=r, g=g, ld=ld, x_prop=x_prop, ld_prop=ld_prop, g_prop=g_prop,
        logw=logw, r_sum=r_sum, sum_acc=sum_acc, turning=flags[1], diverging=flags[0],
        r_ckpts=r_ckpts, rsum_ckpts=rsum_ckpts,
        x_first=x if first else s["x_first"], r_first=r if first else s["r_first"],
        g_first=g if first else s["g_first"], ld_first=ld if first else s["ld_first"])


def _subtree_final(s, direction) -> _Tree:
    """Orient a finished leaf-loop carry along the global left/right axes."""
    first = (s["x_first"], s["r_first"], s["g_first"], s["ld_first"])
    last = (s["x"], s["r"], s["g"], s["ld"])
    left, right = (first, last) if direction > 0 else (last, first)
    return _Tree(*left, *right, s["x_prop"], s["ld_prop"], s["g_prop"], s["logw"], s["r_sum"],
                 s["turning"], s["diverging"], s["sum_acc"], s["i"])


def _double_merge(tree: _Tree, sub: _Tree, direction, u_take, invmm) -> _Tree:
    """Biased progressive merge of a new subtree into the trajectory;
    `u_take` is the merge's uniform."""
    invalid = sub.turning or sub.diverging
    if invalid:
        return tree._replace(turning=tree.turning or sub.turning,
                             diverging=tree.diverging or sub.diverging,
                             sum_acc=tree.sum_acc + sub.sum_acc,
                             n_leaves=tree.n_leaves + sub.n_leaves)
    p_take = torch.clamp(torch.exp(sub.logw - tree.logw), max=1.0)
    take = u_take < p_take
    x_prop = torch.where(take, sub.x_prop, tree.x_prop)
    ld_prop = torch.where(take, sub.ld_prop, tree.ld_prop)
    g_prop = torch.where(take, sub.g_prop, tree.g_prop)
    outer, inner = (tree, sub) if direction > 0 else (sub, tree)
    rl, rr = outer.r_left, inner.r_right
    r_sum = tree.r_sum + sub.r_sum
    return _Tree(outer.x_left, rl, outer.g_left, outer.ld_left,
                 inner.x_right, rr, inner.g_right, inner.ld_right,
                 x_prop, ld_prop, g_prop, torch.logaddexp(tree.logw, sub.logw), r_sum,
                 bool(_is_turning(rl, rr, r_sum, invmm)), sub.diverging,
                 tree.sum_acc + sub.sum_acc, tree.n_leaves + sub.n_leaves)


def nuts_kernel(logdensity_fn, step_size, inverse_mass_matrix=1.0, max_num_doublings=10,
                divergence_threshold=1000.0):
    """Dynamic NUTS transition (iterative, multinomial, biased progressive):
    kernel(rng, state) -> (state, info), `rng` a torch.Generator or a Draws.

    Sub-tree U-turn checks use the checkpoint scheme: while integrating leaf i
    of a subtree, the left-edge momenta of the perfect subtrees ending at i
    live in slots [popcount(i+1)-1, popcount(i)-1] of a max_depth-sized
    buffer, written at even leaves into slot popcount(leaf).  A doubling of
    depth k builds at most 2^k leaves, stopping at a U-turn or divergence."""
    max_depth = int(max_num_doublings)

    def kernel(rng, state: HMCState):
        draws = _draws(rng)
        with torch.no_grad():
            x0, unravel = _ravel(state.position)
            g0 = _ravel(state.logdensity_grad)[0]
            ld0 = state.logdensity
            invmm = _bcast_invmm(inverse_mass_matrix, x0)
            r0 = _momentum(draws.momentum(x0), invmm)
            H0 = -ld0 + _kinetic(r0, invmm)
            eps = _tensor(step_size, x0)
            tree = _Tree(x0, r0, g0, ld0, x0, r0, g0, ld0, x0, ld0, g0, -H0, r0, False, False,
                         torch.zeros_like(ld0), 1)
            body = partial(_leaf_body, logdensity_fn=logdensity_fn, unravel=unravel,
                           step_size=eps, invmm=invmm, H0=H0,
                           divergence_threshold=divergence_threshold)
            depth = 0
            while depth < max_depth and not tree.turning and not tree.diverging:
                direction = draws.direction(x0)
                s = _subtree_carry0(tree, direction, max_depth)
                while s["i"] < 2**depth and not s["turning"] and not s["diverging"]:
                    s = body(s, draws.leaf(x0), direction=direction)
                tree = _double_merge(tree, _subtree_final(s, direction), direction,
                                     draws.take(x0), invmm)
                depth += 1
        new = HMCState(unravel(tree.x_prop), tree.ld_prop, unravel(tree.g_prop))
        n_int = tree.n_leaves - 1
        info = dict(acceptance_rate=tree.sum_acc / max(n_int, 1), num_integration_steps=n_int,
                    is_divergent=tree.diverging, depth=depth, energy=-tree.ld_prop)
        return new, info

    return kernel


# ======================================================================= adaptation
class _DualAveragingState(NamedTuple):
    log_eps: Any
    log_eps_avg: Any
    grad_avg: Any
    t: Any
    mu: Any


def _da_init(step_size):
    log_eps = torch.log(step_size)
    zero = torch.zeros_like(log_eps)
    return _DualAveragingState(log_eps, zero, zero, zero, np.log(10.0) + log_eps)


def _da_update(state: _DualAveragingState, acc_prob, target=0.65, gamma=0.05, t0=10.0,
               kappa=0.75):
    t = state.t + 1
    grad_avg = (1 - 1 / (t + t0)) * state.grad_avg + (target - acc_prob) / (t + t0)
    log_eps = state.mu - torch.sqrt(t) / gamma * grad_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state.log_eps_avg
    return _DualAveragingState(log_eps, log_eps_avg, grad_avg, t, state.mu)


def _adaptation_schedule(num_steps, init_buffer=75, term_buffer=50, window=25):
    """Stan-style fast/slow/fast schedule: per-step (update_mass_now,
    is_in_slow_window) flags, mass matrix refreshed at slow-window ends."""
    if num_steps < 20:
        return np.zeros(num_steps, bool), np.zeros(num_steps, bool)
    init_buffer = min(init_buffer, num_steps // 4)
    term_buffer = min(term_buffer, num_steps // 4)
    slow = np.zeros(num_steps, bool)
    update = np.zeros(num_steps, bool)
    start = init_buffer
    w = window
    while start < num_steps - term_buffer:
        end = min(start + w, num_steps - term_buffer)
        if num_steps - term_buffer - end < w:  # absorb the remainder
            end = num_steps - term_buffer
        slow[start:end] = True
        update[end - 1] = True
        start = end
        w *= 2
    return update, slow


def _per_step(rng, num_steps):
    """Per-step draws of an adaptation: one Draws of a torch.Generator for
    every step, or the sequence of per-step draws given."""
    if isinstance(rng, torch.Generator):
        return [Draws(rng)] * num_steps
    return list(rng)


def window_adaptation(kernel_factory, logdensity_fn, num_steps, initial_position,
                      target_acceptance_rate=0.65, initial_step_size=1e-3, rng=None,
                      initial_inverse_mass_matrix=None, **kernel_kwargs):
    """Warm up step size (dual averaging) and inverse mass (Welford over
    slow windows) for an HMC/NUTS kernel factory
    `kernel_factory(logdensity_fn, step_size, inverse_mass_matrix, **kw)`.
    `rng` is a torch.Generator or the per-step draws.

    Returns ((last_state, params), hist) with params = dict(step_size,
    inverse_mass_matrix)."""
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    carry = _wa_carry0(logdensity_fn, initial_position, initial_step_size,
                       initial_inverse_mass_matrix)
    update_now, in_slow = _adaptation_schedule(num_steps)
    carry, hist = _wa_chunk(carry, (_per_step(rng, num_steps), update_now, in_slow),
                            kernel_factory, logdensity_fn, target_acceptance_rate,
                            **kernel_kwargs)
    return _wa_finalize(carry), hist


def _wa_carry0(logdensity_fn, initial_position, initial_step_size=1e-3,
               initial_inverse_mass_matrix=None):
    """Initial window-adaptation carry: (state, dual-avg, invmm, Welford).

    `initial_inverse_mass_matrix` seeds the mass before the first
    slow-window refresh (a Laplace approximation, a chain spread); its shape
    selects the metric for the whole warmup: scalar/(d,) adapts a diagonal
    mass, (d, d) a dense one (full Welford covariance in slow windows)."""
    state = hmc_init(initial_position, logdensity_fn)
    x0 = _ravel(state.position)[0]
    d = x0.shape[0]
    da = _da_init(_tensor(initial_step_size, x0))
    if initial_inverse_mass_matrix is None:
        invmm = torch.ones_like(x0)
    else:
        im = _tensor(initial_inverse_mass_matrix, x0)
        invmm = im if im.ndim == 2 else torch.broadcast_to(im, (d,)).clone()
    m2 = x0.new_zeros((d, d) if invmm.ndim == 2 else (d,))
    welford = (x0.new_zeros(()), torch.zeros_like(x0), m2)
    return (state, da, invmm, welford)


def bracket_init(logdensity_fn, position, rng, inverse_mass_matrix=1.0, initial_step_size=1.0):
    """First leg of Stan's step-size bracketing: the carry dict that
    `bracket_iter` steps while `carry['more']`, read by `bracket_final`.
    `rng` is a torch.Generator or the momentum's normal draw (a tensor)."""
    state = hmc_init(position, logdensity_fn)
    x0, unravel = _ravel(state.position)
    g0 = _ravel(state.logdensity_grad)[0]
    with torch.no_grad():
        invmm = _bcast_invmm(inverse_mass_matrix, x0)
        xi = rng if torch.is_tensor(rng) else Draws(rng).momentum(x0)
        r0 = _momentum(xi.to(x0), invmm)
        H0 = -state.logdensity + _kinetic(r0, invmm)
        eps0 = _tensor(initial_step_size, x0)
        carry = dict(x0=x0, r0=r0, g0=g0, H0=H0, invmm=invmm, eps=eps0,
                     dlog=torch.zeros_like(eps0), d0=torch.ones_like(eps0))
        dlog0 = _bracket_logacc(logdensity_fn, unravel, carry, eps0)
        log_half = np.log(0.5)
        d0 = torch.where(dlog0 > log_half, 1.0, -1.0).to(x0.dtype)
        return {**carry, "dlog": dlog0, "d0": d0, "more": d0 * dlog0 > d0 * log_half}


def _bracket_logacc(logdensity_fn, unravel, carry, eps):
    x, r, g, ld = _leapfrog(carry["x0"], carry["r0"], carry["g0"], logdensity_fn, unravel, eps,
                            carry["invmm"])
    dlog = carry["H0"] - (-ld + _kinetic(r, carry["invmm"]))
    return torch.where(torch.isfinite(dlog), dlog, torch.full_like(dlog, -np.inf))


def bracket_iter(logdensity_fn, position_like, carry):
    """One doubling/halving step of the bracket search (one gradient eval
    while `carry['more']`).  `position_like` supplies the dict layout."""
    if not bool(carry["more"]):
        return carry
    unravel = _ravel(position_like)[1]
    with torch.no_grad():
        eps = carry["eps"] * torch.exp2(carry["d0"])
        dlog = _bracket_logacc(logdensity_fn, unravel, carry, eps)
        more = carry["d0"] * dlog > carry["d0"] * np.log(0.5)
    return {**carry, "eps": eps, "dlog": dlog, "more": more}


def bracket_final(carry):
    # the search stops one step PAST the 50% crossing; when doubling upward
    # the final eps can sit beyond the leapfrog stability limit: back off to
    # the last passing eps
    eps = torch.where(carry["d0"] > 0, 0.5 * carry["eps"], carry["eps"])
    return torch.clamp(eps, 1e-8, 1e3)


def find_reasonable_step_size(logdensity_fn, position, rng, inverse_mass_matrix=1.0,
                              initial_step_size=1.0, max_iters=30):
    """Stan's bracketing initializer (Hoffman & Gelman 2014, alg. 4): from
    `initial_step_size`, double/halve until a single leapfrog step crosses
    50% acceptance; O(log eps*) gradient evals (2 + the iterations).  `rng`
    as in `bracket_init`."""
    carry = bracket_init(logdensity_fn, position, rng, inverse_mass_matrix, initial_step_size)
    for _ in range(max_iters):
        if not bool(carry["more"]):
            break
        carry = bracket_iter(logdensity_fn, position, carry)
    return bracket_final(carry)


def _wa_post(carry, info, upd, slow, target_acceptance_rate=0.65):
    """Post-kernel window-adaptation update for ONE step: dual averaging,
    Welford within slow windows, mass refresh at slow-window ends."""
    state, da, invmm, welford = carry
    x = _ravel(state.position)[0]
    d = x.shape[0]
    da = _da_update(da, info["acceptance_rate"], target=target_acceptance_rate)

    # Welford within slow windows (m2's ndim selects diagonal or dense)
    n, mean, m2 = welford
    slow = float(slow)
    n1 = n + slow
    delta = x - mean
    mean = mean + slow * delta / torch.clamp(n1, min=1)
    dense = m2.ndim == 2
    m2 = m2 + slow * (torch.outer(delta, x - mean) if dense else delta * (x - mean))
    welford = (n1, mean, m2)

    # refresh the mass at slow-window ends, reset Welford and dual averaging
    if upd:
        n, mean, m2 = welford
        var = m2 / torch.clamp(n - 1, min=1)
        reg = 1e-3 * (5.0 / (n + 5.0))  # Stan shrinkage toward (a small) I
        reg = reg * torch.eye(d, dtype=x.dtype, device=x.device) if dense else reg
        invmm = torch.where(n > 1, var * (n / (n + 5.0)) + reg, invmm)
        da = _da_init(torch.exp(da.log_eps))
        welford = (torch.zeros_like(n), torch.zeros_like(mean), torch.zeros_like(m2))
    return (state, da, invmm, welford)


def _wa_chunk(carry, xs, kernel_factory, logdensity_fn, target_acceptance_rate=0.65,
              **kernel_kwargs):
    """A chunk of window-adaptation steps; xs = (per-step draws, update,
    slow), slices of the precomputed schedule.  Chunks thread into the
    trajectory of one long chunk."""
    hist = []
    for rng, upd, slow in zip(*xs):
        state, da, invmm, welford = carry
        kernel = kernel_factory(logdensity_fn, torch.exp(da.log_eps), invmm, **kernel_kwargs)
        state, info = kernel(rng, state)
        carry = _wa_post((state, da, invmm, welford), info, bool(upd), slow,
                         target_acceptance_rate)
        n_int = info.get("num_integration_steps", 0)
        hist.append(dict(acceptance_rate=info["acceptance_rate"],
                         num_integration_steps=_tensor(n_int, state.logdensity),
                         position=state.position))
    if not hist:
        return carry, {}
    return carry, {"acceptance_rate": torch.stack([h["acceptance_rate"] for h in hist]),
                   "num_integration_steps": torch.stack(
                       [h["num_integration_steps"] for h in hist]),
                   "position": _stack([h["position"] for h in hist])}


def _wa_finalize(carry):
    """Final (state, params) from the window-adaptation carry."""
    state, da, invmm, _ = carry
    return state, dict(step_size=torch.exp(da.log_eps_avg), inverse_mass_matrix=invmm)


# ======================================================================= within-Gibbs
def _per_block(rng, names):
    """Per-block draws: a torch.Generator shared by the blocks, or a dict of
    block name -> rng."""
    return rng if isinstance(rng, dict) else {k: rng for k in names}


def _position_of(state):
    return state.position if isinstance(state, HMCState) else state


def _union(state):
    union = {}
    for st in state.values():
        union |= _position_of(st)
    return union


def mwg_warmup(rng, state, logdf, config, n_samples=0, progress_bar=False):
    """Per-block NUTS window adaptation: each block is warmed conditioned on
    the current values of all the others.

    state : dict of block name -> HMCState (or dict position).
    config : dict of block name -> kwargs for window_adaptation.
    Returns ((state, params), (positions, infos))."""
    rngs = _per_block(rng, state.keys())
    state = dict(state)
    infos = {"n_evals": 0}
    params, positions = {}, {}
    for k in state.keys():
        union = _union(state)

        def logdf_k(value, _union=dict(union)):
            return logdf({**_union, **value})

        conf = dict(config.get(k, {}))
        conf.pop("num_integration_steps", None)
        (state[k], params[k]), hist = window_adaptation(
            nuts_kernel, logdf_k, num_steps=n_samples, initial_position=_position_of(state[k]),
            target_acceptance_rate=conf.pop("target_acceptance_rate", 0.65),
            initial_step_size=conf.pop("initial_step_size", 1e-3), rng=rngs[k], **conf)
        if hist:
            n_evals = hist["num_integration_steps"]
            infos["infos_" + k] = {"acceptance_rate": hist["acceptance_rate"],
                                   "num_integration_steps": n_evals}
            infos["n_evals"] += torch.sum(n_evals)
            positions |= hist["position"]
    return (state, params), (positions, infos)


def mwg_kernel_general(rng, state, logdf, step_fn, init_fn, config):
    """One Metropolis-within-Gibbs sweep: update each block with its own MCMC
    kernel, conditioned on the current values of all the other blocks."""
    rngs = _per_block(rng, state.keys())
    state = dict(state)
    infos = {"n_evals": 0}
    for k in state.keys():
        union = _union(state)

        def logdf_k(value, _union=dict(union)):
            return logdf({**_union, **value})

        state[k] = init_fn[k](position=_position_of(state[k]), logdensity_fn=logdf_k)
        state[k], info = step_fn[k](rng=rngs[k], state=state[k], logdensity_fn=logdf_k,
                                    **config[k])
        infos["infos_" + k] = {"acceptance_rate": info["acceptance_rate"],
                               "num_integration_steps": info["num_integration_steps"]}
        infos["n_evals"] += info["num_integration_steps"]
    # the last-updated block's logdensity is the joint at the final union
    infos["logdensity"] = state[k].logdensity
    return state, infos


def sampling_loop_general(rng, initial_state, logdf, step_fn, init_fn, config, n_samples,
                          progress_bar=False):
    """The MWG kernel for n_samples sweeps: (last state, (unified positions,
    infos)), each stacked over the sweeps.  `rng` is a torch.Generator, or
    the per-sweep rngs."""
    rngs = [rng] * n_samples if isinstance(rng, torch.Generator) else list(rng)
    state, unions, infos = initial_state, [], []
    for r in rngs:
        state, info = mwg_kernel_general(r, state, logdf, step_fn, init_fn, config)
        unions.append(_union(state))
        infos.append(info)
    return state, (_stack(unions), _stack_infos(infos))


def _stack_infos(infos, device=None):
    """A list of (nested) info dicts -> the same with the leaves stacked
    (Python numbers as tensors on the logdensity's device)."""
    device = device or infos[0]["logdensity"].device
    return {k: _stack_infos([i[k] for i in infos], device) if isinstance(v, dict)
            else torch.stack([torch.as_tensor(i[k], device=device) for i in infos])
            for k, v in infos[0].items()}


def nutswg_init(logdf, kernel="NUTS", blocks=None, max_num_doublings=10):
    """Build (step_fn, init_fn, config, init_state_fn) for blocked NUTS/HMC.

    blocks : dict of block name -> list of site names; default a 'mesh_'
    block (field) and a 'rest_' block (scalars)."""
    init_ss = 1e-3
    target = 0.65

    def init_fn(position, logdensity_fn):
        return hmc_init(position, logdensity_fn)

    def make_step(name):
        if kernel == "HMC":
            n_int = 256 if name == "mesh_" else 64

            def step_fn(rng, state, logdensity_fn, step_size=init_ss, inverse_mass_matrix=1.0,
                        **kw):
                return hmc_kernel(logdensity_fn, step_size, n_int,
                                  inverse_mass_matrix)(rng, state)
        else:
            def step_fn(rng, state, logdensity_fn, step_size=init_ss, inverse_mass_matrix=1.0,
                        **kw):
                return nuts_kernel(logdensity_fn, step_size, inverse_mass_matrix,
                                   max_num_doublings)(rng, state)
        return step_fn

    names = ["mesh_", "rest_"]
    step_fn = {k: make_step(k) for k in names}
    init_fns = {k: init_fn for k in names}
    config = {k: {"target_acceptance_rate": target, "initial_step_size": init_ss}
              for k in names}

    def init_state_fn(init_pos):
        return get_init_state(init_pos, logdf, init_fns, blocks)

    return step_fn, init_fns, config, init_state_fn


def get_init_state(init_pos, logdf, init_fn, blocks=None):
    """Split a flat position dict into per-block HMCStates."""
    if blocks is None:
        mesh_keys = [k for k in init_pos if k.endswith("mesh_")]
        rest_keys = [k for k in init_pos if k not in mesh_keys]
        blocks = {"mesh_": mesh_keys, "rest_": rest_keys}
    state = {}
    for name, keys in blocks.items():
        pos = {k: init_pos[k] for k in keys}
        others = {k: init_pos[k] for k in init_pos if k not in keys}
        state[name] = init_fn[name](position=pos,
                                    logdensity_fn=lambda x, _o=others: logdf({**x, **_o}))
    return state


def nutswg_run(rng, init_state, config, logdf, step_fn, init_fn, n_samples,
               progress_bar=False):
    last_state, (samples, infos) = sampling_loop_general(
        rng, init_state, logdf, step_fn, init_fn, config, n_samples, progress_bar)
    return samples, infos, last_state


def get_nutswg_run(logdf, step_fn, init_fn, n_samples, progress_bar=False):
    return partial(nutswg_run, logdf=logdf, step_fn=step_fn, init_fn=init_fn,
                   n_samples=n_samples, progress_bar=progress_bar)


def nutswg_warm(rng, init_state, logdf, config, n_samples, progress_bar=False):
    (last_state, config), (samples, infos) = mwg_warmup(
        rng, init_state, logdf, config, n_samples, progress_bar=progress_bar)
    return samples, infos, last_state, config


def get_nutswg_warm(logdf, config, n_samples, progress_bar=False):
    return partial(nutswg_warm, logdf=logdf, config=config, n_samples=n_samples,
                   progress_bar=progress_bar)
