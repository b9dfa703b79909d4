"""The inference campaign: the three phases of `run/infer.py` with
file-based idempotent resume, and the chains' post-processing.

Phase 1 `field_warmup` : sample only the initial field (every other latent
                         at the fiducial), chains started from the Kaiser
                         posterior, MCLMC tuned per chain.
Phase 2 `full_warmup`  : tune every latent, the field seeded from phase 1;
                         MCLMC or MAMS (configs collapsed to the chains'
                         median) or blocked NUTS (`_nuts_full_warmup`).
Phase 3 `full_run`     : n_runs x n_samples thinned samples, each run saved
                         as run_{i}.npz with the last state, resumed from
                         the last state with fresh randomness per run.
`make_chains`          : load the runs, reparametrise, the transfer and
                         coherence of the white mesh, save chains.npz and
                         chains_.npz, print the summary.

Every phase looks for its output files and loads them instead of
recomputing.  Files are the port's own (`utils.io.npsave`: `.npz` trees of
numpy arrays), never HDF5.  Chains run one after another; a state's leaves
carry a leading chain axis, as the JAX package's.

Parity: `montecosmo_tpu/script.py:257` (`_nuts_blocks`), `:270`
(`_segmented_nuts_warmup`), `:534` (field_warmup), `:617`
(`_laplace_seed`), `:665` (full_warmup), `:818` (full_run) and `:1070`
(make_chains, without its figures).  Not ported: the TPU chunking of long
loops (`_segmented_warmup`, `MAX_STEPS_PER_CALL`, mid-run checkpoints),
the host-driven NUTS transition and the `MONTECOSMO_*` environment
variables; the dense-mass cap is the argument `dense_max`.  Not ported yet:
`make_logdf_mesh`, `compare_chains` and the figures (ROADMAP Queue A item
6).
"""
import os
from functools import partial
from pathlib import Path

import numpy as np
import torch

from montecosmo_tpu_torch.chains import Chains
from montecosmo_tpu_torch.samplers import hmc as H
from montecosmo_tpu_torch.samplers.mclmc import (
    IntegratorState, MCLMCAdaptationState, _ravel, mams_run, mams_warmup, mclmc_run,
    mclmc_warmup,
)
from montecosmo_tpu_torch.utils.io import npload, npsave


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


def _nuts_full_warmup(model, obs, state_field, n_steps, n_chains, gen, max_num_doublings=10,
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


# ---------------------------------------------------------------------------
# The campaign
# ---------------------------------------------------------------------------
def _device(model):
    return getattr(model, "device", torch.device("cpu"))


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _host(tree):
    """A state or config (NamedTuple / dict tree of tensors) -> numpy."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_asdict"):
        return {k: _host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _on(tree, device):
    """A loaded tree of numpy leaves -> tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), device=device)


def _save(path, tree):
    """`npsave` through a temporary file and an atomic replace: a run killed
    mid-write leaves the previous file whole."""
    tmp = Path(path).with_suffix(".tmp.npz")
    npsave(tmp, _host(tree))
    os.replace(tmp, path)


def _load_state(path, device, sampler="mclmc"):
    """A saved integrator state: an MCLMC/MAMS `IntegratorState`, or for
    NUTS a dict of block name -> `HMCState`."""
    tree = _on(npload(path), device)
    if sampler == "nuts":
        return {name: H.HMCState(**fields) for name, fields in tree.items()}
    return IntegratorState(**tree)


def _load_config(path, device, sampler="mclmc"):
    tree = _on(npload(path), device)
    return tree if sampler == "nuts" else MCLMCAdaptationState(**tree)


def _stack_states(states):
    """Per-chain states or configs (NamedTuples of tensors and dicts of
    tensors) -> one with a leading chain axis."""
    first = states[0]
    out = []
    for i, leaf in enumerate(first):
        vals = [s[i] for s in states]
        out.append(_stack_chains(vals) if isinstance(leaf, dict) else torch.stack(
            [torch.as_tensor(v) for v in vals]))
    return type(first)(*out)


def _chain_state(state, c):
    """Chain c of a state or config with a leading chain axis."""
    return type(state)(*(_chain(v, c) if isinstance(v, dict) else v[c] for v in state))


def _warmup_chains(logpdf, n_steps, desired_energy_var, tune_mass, n_chains, gen, pos,
                   sampler="mclmc"):
    """MCLMC (or MAMS) warmup of each chain from its row of `pos`, one
    chain after another: (state, config) with a leading chain axis."""
    states, configs = [], []
    for c in range(n_chains):
        if sampler == "mams":
            st, cf = mams_warmup(gen, _chain(pos, c), logpdf, n_steps,
                                 diagonal_preconditioning=tune_mass)
        else:
            st, cf = mclmc_warmup(gen, _chain(pos, c), logpdf, n_steps,
                                  desired_energy_var=desired_energy_var,
                                  diagonal_preconditioning=tune_mass)
        states.append(st)
        configs.append(cf)
    return _stack_states(states), _stack_states(configs)


def _kaiser_starts(model, n_chains, seed=45, **kwargs):
    """Each chain's start, a draw of the Kaiser posterior (sample space)."""
    gen = _generator(seed, _device(model))
    return _stack_chains([model.kaiser_post(gen, **kwargs) for _ in range(n_chains)])


def field_warmup(model, chains_dir, n_steps, desired_energy_var, n_chains, scale_field=7 / 8,
                 seed=43, overwrite=False, log=print):
    """Field-only warmup: every latent but the field fixed at the fiducial,
    the model conditioned on its observation, MCLMC tuned on the initial
    field (no mass tuning) from `kaiser_post(scale_field)`.  Loads
    field_warm_{state,conf}.npz from `chains_dir` when they exist.

    Returns (state, config, params_start); the model is left conditioned."""
    chains_dir = Path(chains_dir)
    chains_dir.mkdir(parents=True, exist_ok=True)
    state_path = chains_dir / "field_warm_state.npz"
    conf_path = chains_dir / "field_warm_conf.npz"

    model.reset()
    model.substitute(model.fiduc | model.obs_data(), from_base=True)
    model.block()
    params_start = _kaiser_starts(model, n_chains, scale_field=scale_field)
    log("\nField warmup params:", list(params_start))

    if not state_path.exists() or overwrite:
        log("Field warmup...")
        state, config = _warmup_chains(model.logpdf, n_steps, desired_energy_var, False,
                                       n_chains, _generator(seed, _device(model)), params_start)
        _save(state_path, state)
        _save(conf_path, config)
    else:
        log("Loading field warmup...")
        state = _load_state(state_path, _device(model))
        config = _load_config(conf_path, _device(model))
    return state, config, params_start


def full_warmup(model, obs, state_field, chains_dir, n_steps, desired_energy_var, n_chains,
                tune_mass, eval_per_ess=1e3, seed=43, overwrite=False, sampler="mclmc",
                log=print):
    """Full warmup: condition on `obs`, tune every other latent, the field
    from the field warmup's state.  Loads full_warm_{state,conf}.npz from
    `chains_dir` when they exist.

    sampler='mclmc': the energy-variance tuner; the chains' configs collapse
      to their median with L = 0.4 (eval_per_ess / 2) step_size.
    sampler='mams': the acceptance tuner (target 0.65); median of (L,
      step_size, inverse mass).
    sampler='nuts': blocked window adaptation (`_nuts_full_warmup`); median
      of each block's (step_size, inverse mass)."""
    chains_dir = Path(chains_dir)
    chains_dir.mkdir(parents=True, exist_ok=True)
    state_path = chains_dir / "full_warm_state.npz"
    conf_path = chains_dir / "full_warm_conf.npz"
    device = _device(model)

    if state_path.exists() and not overwrite:
        log("\nLoading full warmup...")
        model.reset()
        model.substitute(obs | model.obs_data(), from_base=True)
        model.block()
        return (_load_state(state_path, device, sampler),
                _load_config(conf_path, device, sampler))

    log("\nFull warmup...")
    gen = _generator(seed, device)
    if sampler == "nuts":
        state, config, n_evals = _nuts_full_warmup(model, obs, state_field, n_steps, n_chains,
                                                   gen, log=log)
    else:
        model.reset()
        model.substitute(obs | model.obs_data(), from_base=True)
        model.block()
        params_warm = _kaiser_starts(model, n_chains)
        if "white_mesh" not in model.data and state_field is not None:
            params_warm |= state_field.position
        log("Full warmup params:", list(params_warm))
        state, config = _warmup_chains(model.logpdf, n_steps, desired_energy_var, tune_mass,
                                       n_chains, gen, params_warm, sampler)
        print_mclmc_config(config, log)
        ss = _median0(config.step_size)
        invmm = _median0(config.inverse_mass_matrix)
        L = _median0(config.L) if sampler == "mams" else 0.4 * eval_per_ess / 2 * ss
        config = MCLMCAdaptationState(*(x.expand(n_chains, *x.shape) for x in (L, ss, invmm)))
        print_mclmc_config(config, log)
    _save(state_path, state)
    _save(conf_path, config)
    return state, config


def print_mclmc_config(config, log=print):
    invmm = config.inverse_mass_matrix
    log("\nss: ", config.step_size.cpu().numpy())
    log("L: ", config.L.cpu().numpy())
    log("invmm mean:", invmm.mean(tuple(range(1, invmm.ndim))).cpu().numpy()
        if invmm.ndim > 1 else float(invmm.mean()))


def _run_chains(model, state, config, n_samples, n_chains, thinning, gen, sampler):
    """One run of every chain: (last state, samples) with leading (chain,
    sample) axes on the samples, as the JAX package's runs."""
    step_fn, init_fn, _, _ = H.nutswg_init(model.logpdf)
    runs, last = [], []
    for c in range(n_chains):
        if sampler == "nuts":
            st_c = {k: _chain_state(st, c) for k, st in state.items()}
            cf_c = {k: {kk: v[c] for kk, v in cf.items()} for k, cf in config.items()}
            st_c, (union, infos) = H.sampling_loop_general(gen, st_c, model.logpdf, step_fn,
                                                           init_fn, cf_c, n_samples)
            out = {**union, "logdensity": infos["logdensity"], "n_evals": infos["n_evals"]}
        else:
            run = mams_run if sampler == "mams" else mclmc_run
            st_c, out = run(gen, _chain_state(state, c), _chain_state(config, c),
                            model.logpdf, n_samples, thinning=thinning)
        last.append(st_c)
        runs.append(out)
    state = ({k: _stack_states([s[k] for s in last]) for k in last[0]} if sampler == "nuts"
             else _stack_states(last))
    samples = {k: torch.stack([torch.as_tensor(r[k]) for r in runs]) for k in runs[0]}
    return state, samples


def full_run(model, state, config, chains_dir, n_samples, n_runs, n_chains, thinning=64, seed=42,
             overwrite=False, sampler="mclmc", log=print):
    """Sampling runs 1..n_runs, each saved as run_{i}.npz (the samples
    with leading (chain, sample) axes, logdensity, n_evals and the sampler's
    info) with the last state in run_last_state.npz.  A campaign started
    again resumes from the last state at the first missing run; run i
    draws from its own generator (`seed`, i), so resumed runs take fresh
    randomness.  'nuts' runs NUTS-within-Gibbs sweeps (thinning ignored:
    every sweep is kept).  Returns the last state."""
    chains_dir = Path(chains_dir)
    chains_dir.mkdir(parents=True, exist_ok=True)
    last_path = chains_dir / "run_last_state.npz"
    device = _device(model)

    start = 1
    if last_path.exists() and not overwrite:
        state = _load_state(last_path, device, sampler)
        while (chains_dir / f"run_{start}.npz").exists() and start <= n_runs:
            start += 1
        log(f"Resuming at run {start}...")
    log("Running...")
    for i_run in range(start, n_runs + 1):
        log(f"run {i_run}/{n_runs}")
        gen = _generator(seed * 100_003 + i_run, device)
        state, samples = _run_chains(model, state, config, n_samples, n_chains, thinning, gen,
                                     sampler)
        if "mse_per_dim" in samples:
            log("MSE per dim:", samples["mse_per_dim"].mean(1).cpu().numpy(), "\n")
        elif "acceptance_rate" in samples:
            log("acceptance:", samples["acceptance_rate"].mean(1).cpu().numpy(), "\n")
        _save(chains_dir / f"run_{i_run}.npz", samples)
        _save(last_path, state)
    return state


# ---------------------------------------------------------------------------
# Chains post-processing
# ---------------------------------------------------------------------------
def make_chains(save_dir, start=1, end=100, thinning=1, prefix="", device="cuda", log=print):
    """Load the runs of `save_dir`/chains, reparametrise them to base space,
    add the transfer and coherence of the white mesh against the
    register's or the self-data campaign's truth.npz (when the field is
    inferred), keep 10 values of each field,
    and save `{prefix}chains.npz`; the same in sample space as
    `{prefix}chains_.npz`, whose summary is printed.  The model comes from
    `save_dir`/model.yaml, the observed sites from obs.npz.  Returns the
    sample-space chains."""
    from montecosmo_tpu_torch.models.model import FieldLevelModel

    save_dir = Path(save_dir)
    chains_dir = save_dir / "chains"
    model = FieldLevelModel.load(save_dir / "model.yaml", device=device)
    obs = npload(save_dir / "obs.npz")
    white_mesh = model.white_mesh
    if white_mesh is None and (save_dir / "truth.npz").exists():
        white_mesh = npload(save_dir / "truth.npz")["white_mesh"]
    infer_init = "white_mesh" not in obs and white_mesh is not None
    model.substitute(obs, from_base=True)

    thin = partial(Chains.thin, thinning=thinning)
    pick = partial(Chains.choice, n=10, names=["init", "init_"])
    transforms = [thin, model.reparam_chains,
                  partial(model.powtranscoh_chains, names=["white_mesh"] if infer_init else [],
                          mesh0=white_mesh), pick]
    chains = model.load_runs(chains_dir, start, end, transforms=transforms, batch_ndim=2)
    chains.save(chains_dir / f"{prefix}chains.npz")
    log({k: v for k, v in chains.shape.items()}, "\n")

    chains = model.load_runs(chains_dir, start, end, transforms=[thin, pick], batch_ndim=2)
    chains.save(chains_dir / f"{prefix}chains_.npz")
    log({k: v for k, v in chains.shape.items()}, "\n")
    chains.print_summary()
    return chains
