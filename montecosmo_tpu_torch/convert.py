"""State carried from the JAX package to the port.

The model has no trained weights: its state is the sample-space parameter
dict (`model.reparam(model.fiduc, inv=True)` plus `white_mesh_`, optionally
the observed `count_mesh`) and the config dict, which the port's
`FieldLevelModel(**conf, device=...)` takes unchanged.  An observation
crosses in the JAX package's own layout: the count mesh, the real packing
of its rfft for lik_type='fourier_gauss' (`cgh2rg(rfftn(counts))`), or the
(n_ell, n_k) multipoles `powspec` for observable='powspec'.  The N-body
evolution (`evolution='nbody'`) adds no parameter and no state: its latents
are the 2LPT model's, and `tests/test_torch_nbody.py` holds the gradient of
every one of them against the JAX package.

A sampler's state crosses as numpy: the JAX `IntegratorState` and
`MCLMCAdaptationState` with numpy leaves (`jax.tree.map(np.asarray, state)`)
become the port's, so that a chain warmed in one package continues in the
other.  Both packages flatten a position dict alike (sorted keys, C order),
so the momentum and the inverse mass matrix keep their layout.  A NUTS
state (`HMCState`, or a dict of block name -> HMCState, the blocked warmup's)
and a per-block NUTS config (step size and inverse mass matrix, diagonal or
dense) cross the same way.
"""
from typing import Mapping

import numpy as np
import torch

from montecosmo_tpu_torch.samplers.hmc import HMCState
from montecosmo_tpu_torch.samplers.mclmc import IntegratorState, MCLMCAdaptationState
from montecosmo_tpu_torch.utils import to_tensor


def params_from_numpy(params: Mapping[str, np.ndarray], device) -> dict:
    """Parameter dict of numpy arrays, scalars or tensors -> dict of float32
    / complex64 tensors on `device`, same keys."""
    return {k: to_tensor(v, device) for k, v in params.items()}


def _array(x, device):
    """numpy array or scalar -> tensor on `device`, dtype kept (a Python
    float as float32)."""
    return torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, float) else np.asarray(x),
                           device=device)


def mclmc_state_from_numpy(state, device) -> IntegratorState:
    """An MCLMC/MAMS integrator state with numpy leaves (position and
    gradient dicts, flat momentum, logdensity) -> the port's, on `device`."""
    return IntegratorState(
        position={k: _array(v, device) for k, v in state.position.items()},
        momentum=_array(state.momentum, device),
        logdensity=_array(state.logdensity, device),
        logdensity_grad={k: _array(v, device) for k, v in state.logdensity_grad.items()})


def mclmc_config_from_numpy(config, device) -> MCLMCAdaptationState:
    """An MCLMC adaptation state (L, step_size, inverse_mass_matrix) with
    numpy leaves, or the same as a dict -> the port's, on `device`."""
    if isinstance(config, Mapping):
        config = MCLMCAdaptationState(config["L"], config["step_size"],
                                      config.get("inverse_mass_matrix", 1.0))
    return MCLMCAdaptationState(*(_array(x, device) for x in (
        config.L, config.step_size, config.inverse_mass_matrix)))


def hmc_state_from_numpy(state, device):
    """An HMC/NUTS state with numpy leaves (position and gradient dicts,
    logdensity), or a dict of block name -> such states -> the port's, on
    `device`."""
    if isinstance(state, Mapping):
        return {k: hmc_state_from_numpy(v, device) for k, v in state.items()}
    return HMCState(position={k: _array(v, device) for k, v in state.position.items()},
                    logdensity=_array(state.logdensity, device),
                    logdensity_grad={k: _array(v, device)
                                     for k, v in state.logdensity_grad.items()})


def nuts_config_from_numpy(config, device):
    """A per-block NUTS config, block name -> {step_size, inverse_mass_matrix}
    with numpy leaves (a scalar, (d,) or (d, d) mass; a leading chain axis
    kept) -> the same of tensors on `device`."""
    return {name: {k: _array(conf[k], device) for k in ("step_size", "inverse_mass_matrix")}
            for name, conf in config.items()}
