"""The NUTS pieces of the inference campaign: the blocked NUTS warmup, its
Laplace-seeded scalar mass, and the NUTS branch of the full warmup.

Parity: `montecosmo_tpu/script.py:257` (`_nuts_blocks`), `:270`
(`_segmented_nuts_warmup`), `:617` (`_laplace_seed`) and `:694-770` (the
NUTS branch of `full_warmup`).  Functions on a log-density (or a `Model`)
and a state; the 3-phase campaign with its file I/O is ROADMAP Queue A item
6.  Not ported: host chunking, h5 checkpoint resume and the `MONTECOSMO_*`
environment variables (TPU program-length workarounds); the dense-mass
cap is the argument `dense_max`.  Chains run one after another; a chain
position's leaves carry a leading chain axis, as the JAX package's.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.samplers import hmc as H
from montecosmo_tpu_torch.samplers.mclmc import _ravel


def _nuts_blocks(names):
    """Default NUTS-within-Gibbs block split: field vs scalars, empty blocks
    dropped (a fully observed field leaves plain NUTS on the scalars)."""
    mesh_keys = [k for k in names if k.endswith("mesh_")]
    rest_keys = [k for k in names if k not in mesh_keys]
    blocks = {}
    if mesh_keys:
        blocks["mesh_"] = mesh_keys
    if rest_keys:
        blocks["rest_"] = rest_keys
    return blocks


def _chain(tree, c):
    return {k: v[c] for k, v in tree.items()}


def _stack_chains(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _initial_invmm(invmm0, n_chains, d, use_dense, like):
    """Per-chain initial inverse masses, (C, d, d) dense or (C, d) / (C,)
    diagonal, from a seed as `_segmented_nuts_warmup` accepts it."""
    if invmm0 is None:
        if use_dense:
            return torch.eye(d, dtype=like.dtype, device=like.device).expand(n_chains, d, d)
        return torch.ones(n_chains, dtype=like.dtype, device=like.device)
    invmm0 = torch.as_tensor(invmm0, dtype=like.dtype, device=like.device)
    if invmm0.ndim == 2 and invmm0.shape == (d, d) and d != n_chains:
        # a shared dense seed (a Laplace inverse Hessian)
        shared = invmm0 if use_dense else torch.diagonal(invmm0)
        return shared.expand(n_chains, *shared.shape)
    if invmm0.ndim <= 1:  # scalar or shared (d,) diagonal
        if use_dense:
            return torch.diag(torch.broadcast_to(invmm0, (d,))).expand(n_chains, d, d)
        return invmm0.expand(n_chains, *invmm0.shape)
    if invmm0.ndim == 2 and use_dense:  # per-chain (C, d) diagonal
        return torch.stack([torch.diag(v) for v in invmm0])
    return invmm0


def _segmented_nuts_warmup(logpdf, n_steps, n_chains, gen, pos, initial_step_size=None,
                           target=0.8, initial_inverse_mass_matrix=None, max_num_doublings=10,
                           dense_max=64, log=print):
    """Blocked NUTS window adaptation (Stan fast/slow/fast schedule), one
    block after the other, each conditioned on the others' current values.

    `initial_step_size=None` brackets a per-chain starting step size
    (`find_reasonable_step_size`: 2 + its iterations value+grads) instead of
    starting dual averaging blind at 1e-3.  A non-mesh block of at most
    `dense_max` dimensions adapts a dense mass; mesh blocks stay diagonal.
    `initial_inverse_mass_matrix` optionally seeds per-block masses (dict
    block name -> scalar, (d,), (C, d) or (d, d)).  `gen` is a
    torch.Generator; `pos` a dict of (n_chains, ...) tensors.

    Returns (state: {block: HMCState of (n_chains, ...) leaves},
             config: {block: {step_size (C,), inverse_mass_matrix}},
             n_evals: the integration steps and bracket evaluations, as the
             JAX package counts them)."""
    blocks = _nuts_blocks(list(pos))
    update_now, in_slow = H._adaptation_schedule(n_steps)
    state, config = {}, {}
    others = dict(pos)  # running per-chain values of the not-yet-warmed blocks
    n_evals = 0
    for name, keys in blocks.items():
        p_block = {k: others[k] for k in keys}
        rest = {k: v for k, v in others.items() if k not in keys}
        like = next(iter(p_block.values()))
        d_block = int(sum(np.prod(v.shape[1:]) for v in p_block.values()))
        use_dense = not name.startswith("mesh") and 0 < d_block <= dense_max
        invmm0 = _initial_invmm((initial_inverse_mass_matrix or {}).get(name), n_chains,
                                d_block, use_dense, like)
        states, steps, invmms = [], [], []
        for c in range(n_chains):
            p_c, rest_c = _chain(p_block, c), _chain(rest, c)

            def logdf(v, _rest=rest_c):
                return logpdf({**_rest, **v})

            if initial_step_size is None:
                carry = H.bracket_init(logdf, p_c, gen, inverse_mass_matrix=invmm0[c])
                n_evals += 2  # the init and the first probe
                for _ in range(30):  # max_iters
                    if not bool(carry["more"]):
                        break
                    carry = H.bracket_iter(logdf, p_c, carry)
                    n_evals += 1
                eps0 = H.bracket_final(carry)
            else:
                eps0 = torch.as_tensor(initial_step_size, dtype=like.dtype, device=like.device)
            log(f"  nuts warmup [{name}] chain {c}: bracketed step size {float(eps0):.5g}")
            carry = H._wa_carry0(logdf, p_c, eps0, invmm0[c])
            carry, hist = H._wa_chunk(carry, ([H.Draws(gen)] * n_steps, update_now, in_slow),
                                      H.nuts_kernel, logdf, target_acceptance_rate=target,
                                      max_num_doublings=max_num_doublings)
            if hist:
                n_evals += int(hist["num_integration_steps"].sum())
            st, params = H._wa_finalize(carry)
            states.append(st)
            steps.append(params["step_size"])
            invmms.append(params["inverse_mass_matrix"])
        state[name] = H.HMCState(_stack_chains([s.position for s in states]),
                                 torch.stack([s.logdensity for s in states]),
                                 _stack_chains([s.logdensity_grad for s in states]))
        config[name] = {"step_size": torch.stack(steps),
                        "inverse_mass_matrix": torch.stack(invmms)}
        others = {**others, **state[name].position}
    return state, config, n_evals


def block_hessian(logpdf, p_block, others):
    """The (d, d) Hessian of logpdf in the raveled `p_block` (sorted keys),
    `others` held fixed: one gradient with its graph, then one backward of
    it a column (reverse over reverse)."""
    flat0, unravel = _ravel({k: torch.as_tensor(v).detach() for k, v in p_block.items()})
    d = flat0.shape[0]
    x = flat0.clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(logpdf({**others, **unravel(x)}), x, create_graph=True)
        return torch.stack([torch.autograd.grad(g[i], x, retain_graph=i < d - 1)[0]
                            for i in range(d)], 1)


def _laplace_seed(logpdf, p_block, others):
    """Dense inverse-mass seed for a small parameter block: the inverse of
    the (PSD-ified) conditional Hessian of -logpdf at the current point
    (`block_hessian`).  Saddle directions are handled with the |eigenvalue|
    trick; the spectrum is floored at 1e-6 of the largest curvature
    (condition cap 1e6).  Returns (cov (d, d) in the block's dtype, the
    floored curvatures (d,) as numpy)."""
    hess_t = block_hessian(logpdf, p_block, others).detach()
    hess = -hess_t.cpu().numpy().astype(np.float64)
    hess = 0.5 * (hess + hess.T)
    if not np.all(np.isfinite(hess)):
        raise FloatingPointError("non-finite Hessian at warm start")
    as_t = lambda a: torch.as_tensor(0.5 * (a + a.T), dtype=hess_t.dtype, device=hess_t.device)
    try:
        w, v = np.linalg.eigh(hess)
    except np.linalg.LinAlgError:
        # LAPACK non-convergence on extreme-conditioned Hessians: equilibrate
        # to unit diagonal and retry -- with H = S A S, S = diag(sqrt|diag H|),
        # the PSD-ified inverse of H is S^-1 (v |w|^-1 v^T) S^-1
        s = np.sqrt(np.maximum(np.abs(np.diag(hess)), 1e-30))
        w, v = np.linalg.eigh(hess / np.outer(s, s))
        wa = np.maximum(np.abs(w), 1e-6 * max(np.abs(w).max(), 1e-30))
        cov = ((v / wa) @ v.T) / np.outer(s, s)
        return as_t(cov), wa * float(np.median(s)) ** 2
    w = np.abs(w)
    w = np.maximum(w, 1e-6 * max(w.max(), 1e-30))
    return as_t((v / w) @ v.T), w


def _median0(x):
    """Median over the leading (chain) axis, the mean of the two middle
    values for an even count (numpy's and jnp.median's)."""
    s = torch.sort(x, 0).values
    n = x.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def full_warmup(model, obs, state_field, n_steps, n_chains, gen, max_num_doublings=10,
                log=print):
    """The NUTS branch of the full warmup: condition `model` on `obs`, start
    every chain at `model.kaiser_post` (the field from the field warmup's
    `state_field` when the field is not observed), seed the mesh block's
    mass from the field warmup's chain spread (more than one chain) and the
    `rest_` block's from the Laplace approximation (at most 64 dimensions),
    warm up block by block, and collapse each block's (step_size, inverse
    mass) to the chains' median (a dense median symmetrised and floored
    PSD).  `state_field.position`'s leaves carry a leading chain axis.

    Returns (state, config, n_evals)."""
    model.reset()
    model.substitute(obs | model.obs_data(), from_base=True)
    model.block()
    params_warm = _stack_chains([model.kaiser_post(gen) for _ in range(n_chains)])
    if "white_mesh" not in model.data and state_field is not None:
        params_warm |= state_field.position

    # the mesh block's mass from the field warmup's cross-chain spread,
    # with Stan-style shrinkage for few chains
    seed_invmm = {}
    if state_field is not None and "white_mesh" not in model.data and n_chains > 1:
        mesh_keys = sorted(k for k in state_field.position if k.endswith("mesh_"))
        if mesh_keys:
            x = torch.stack([_ravel(_chain({k: state_field.position[k] for k in mesh_keys},
                                           c))[0] for c in range(n_chains)])
            nc = float(n_chains)
            seed_invmm["mesh_"] = x.var(0, unbiased=False) * nc / (nc + 5.0) + 1e-3 * 5.0 / (
                nc + 5.0)
    # the Laplace seed of the scalar block: its conditional Hessian at the
    # warm start, with the Omega_m/sigma8/b1 correlations a diagonal misses
    rest_keys = [k for k in params_warm if not k.endswith("mesh_")]
    d_rest = int(sum(np.prod(params_warm[k].shape[1:]) for k in rest_keys))
    if rest_keys and 0 < d_rest <= 64:
        p0 = {k: params_warm[k][0] for k in rest_keys}
        o0 = {k: v[0] for k, v in params_warm.items() if k not in rest_keys}
        try:
            cov, w = _laplace_seed(model.logpdf, p0, o0)
            seed_invmm["rest_"] = cov
            log(f"  nuts warmup [rest_] Laplace-seeded mass ({d_rest} dims, curvature "
                f"{w.min():.3g}..{w.max():.3g})")
        except (np.linalg.LinAlgError, FloatingPointError) as exc:
            # window adaptation re-estimates the mass anyway
            log(f"  nuts warmup [rest_] Laplace seed failed ({exc}); unit mass")
    else:
        log(f"  nuts warmup [rest_] no Laplace seed ({d_rest} dims > 64): diagonal mass")

    state, config, n_evals = _segmented_nuts_warmup(
        model.logpdf, n_steps, n_chains, gen, params_warm, initial_inverse_mass_matrix=seed_invmm,
        max_num_doublings=max_num_doublings, log=log)
    log(f"NUTS warmup n_evals: {n_evals}")
    for name, conf in config.items():
        ss = _median0(conf["step_size"])
        invmm = _median0(conf["inverse_mass_matrix"])
        if invmm.ndim == 2:
            # an elementwise median of PSD matrices need not be PSD:
            # symmetrise and floor the spectrum before sharing it out
            m = invmm.detach().cpu().double().numpy()
            w, v = np.linalg.eigh(0.5 * (m + m.T))
            w = np.maximum(w, 1e-8 * max(w.max(), 1e-30))
            invmm = torch.as_tensor((v * w) @ v.T, dtype=invmm.dtype, device=invmm.device)
        config[name] = {"step_size": ss.expand(n_chains),
                        "inverse_mass_matrix": invmm.expand(n_chains, *invmm.shape)}
        log(f"block {name}: ss {float(ss):.3e}, invmm mean {float(invmm.mean()):.3e}")
    return state, config, n_evals
