"""Chunked run-and-save runner: warmup + runs saved as `.npz`, with the last
state pickled as numpy for resume (on any device).

Parity: `montecosmo_tpu/samplers/runner.py:14-61` (same `.npz` layout and
`{path}_last_state.p` resume).
"""
import os
import pickle

import numpy as np
import torch


def _to_numpy(tree):
    """Tensors of a (named) tuple / list / dict tree -> numpy arrays."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree, device):
    """numpy arrays of a tree -> tensors on `device` (dtype kept)."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_torch(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v, device) for v in tree)
    return tree


def _device_of(tree):
    """The device of the first tensor in `tree` (the CPU if none)."""
    if torch.is_tensor(tree):
        return tree.device
    leaves = tree.values() if isinstance(tree, dict) else tree if isinstance(
        tree, (tuple, list)) else ()
    for leaf in leaves:
        dev = _device_of(leaf)
        if dev is not None:
            return dev
    return None


def save_run(samples, infos, last_state, i_run: int, path: str,
             group_by_chain: bool = True):
    """Save one run's samples (+ infos) as `{path}_{i_run}.npz` and the last
    state as a pickle of numpy arrays (`{path}_last_state.p`, overwritten
    per run for resume)."""
    out = {}
    for k, v in {**samples, **(infos or {})}.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}/{kk}"] = np.asarray(_to_numpy(vv))
        else:
            out[k] = np.asarray(_to_numpy(v))
    if "num_integration_steps" in out and "n_evals" not in out:
        out["n_evals"] = out.pop("num_integration_steps")
    np.savez(f"{path}_{i_run}.npz", **out)
    with open(f"{path}_last_state.p", "wb") as f:
        pickle.dump(_to_numpy(last_state), f, protocol=pickle.HIGHEST_PROTOCOL)


def sample_and_save(run_fn, init_state, path: str, start: int = 0, end: int = 1,
                    warmup_fn=None, seed=42, resume: bool = True):
    """Warmup (if `warmup_fn`) then chunked runs, each saved via `save_run`.

    run_fn(gen, state) -> (samples, infos, last_state)
    warmup_fn(gen, state) -> (samples, infos, last_state[, config...])
    `seed` is an int or a torch.Generator; every call draws from the one
    generator.  Resumes from `{path}_last_state.p` when it exists, its
    state moved to the device of `init_state`."""
    device = _device_of(init_state) or torch.device("cpu")
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(
        device=device).manual_seed(int(seed))
    state = init_state

    if resume and os.path.exists(f"{path}_last_state.p"):
        with open(f"{path}_last_state.p", "rb") as f:
            state = _to_torch(pickle.load(f), device)
        while os.path.exists(f"{path}_{start}.npz") and start <= end:
            start += 1
        print(f"Resuming at run {start}")
    elif warmup_fn is not None:
        print(f"run {start}/{end} (warmup)")
        out = warmup_fn(gen, state)
        samples, infos, state = out[0], out[1], out[2]
        save_run(samples, infos, state, start, path)
        start += 1

    for i_run in range(start, end + 1):
        print(f"run {i_run}/{end}")
        samples, infos, state = run_fn(gen, state)
        save_run(samples, infos, state, i_run, path)
    return state
