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
every one of them against the JAX package.  The `png` latents (fNL_,
fNL_bp_, ...) and the `ap` latents (alpha_iso_, alpha_ap_) cross as every
latent does; the AP path's other state is the fiducial cosmology
(`bg_fid`, which ap_auto=True reads), which the port derives from the
latents' `loc_fid` as the JAX package does: `config_from_numpy` carries a
JAX model's config (`dataclasses.asdict(model)`, a register's fiducial
already in its latents) into the port's keyword arguments.

A register crosses as a file: `register_from_h5` reads one of the JAX
package's `.h5` registers (where h5py is installed) into the tree that
`utils.io.npsave` writes as the port's `.npz`, which
`FieldLevelModel(register=...)` loads on a machine without h5py.

A sampler's state crosses as numpy: the JAX `IntegratorState` and
`MCLMCAdaptationState` with numpy leaves (`jax.tree.map(np.asarray, state)`)
become the port's, so that a chain warmed in one package continues in the
other.  Both packages flatten a position dict alike (sorted keys, C order),
so the momentum and the inverse mass matrix keep their layout.  A NUTS
state (`HMCState`, or a dict of block name -> HMCState, the blocked warmup's)
and a per-block NUTS config (step size and inverse mass matrix, diagonal or
dense) cross the same way.
"""
from dataclasses import fields
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


def _plain(v):
    """A numpy (or array-like) scalar -> a Python number; an array -> a
    float64 numpy array; anything else (str, None, tuple) unchanged."""
    if isinstance(v, (str, bool, int, float, tuple, type(None))):
        return v
    v = np.asarray(v)
    return v.item() if v.ndim == 0 else v.astype(np.float64)


def config_from_numpy(conf: Mapping, device="cuda") -> dict:
    """A JAX `FieldLevelModel`'s config with numpy leaves (its
    `dataclasses.asdict`, or a config dict) -> the keyword arguments of the
    port's `FieldLevelModel` on `device`: the keys the port takes, numpy
    scalars as Python numbers, and every latent (the `png` and `ap` groups
    with the rest) with its fiducial `loc_fid`/`scale_fid`, which set the
    port's fiducial cosmology (`cosmo_fid`, `bg_fid`) as they set the JAX
    package's."""
    from montecosmo_tpu_torch.models.model import FieldLevelModel

    names = {f.name for f in fields(FieldLevelModel)}
    out = {k: _plain(v) for k, v in conf.items() if k in names and k != "latents"}
    out["latents"] = {name: {k: _plain(v) for k, v in latent.items()}
                      for name, latent in conf["latents"].items()}
    return out | {"device": device}


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


def register_from_h5(path) -> dict:
    """A JAX package register (`.h5`, read through h5py) -> the register
    dict of numpy arrays and Python scalars that `utils.io.npsave` writes
    as the port's `.npz`."""
    from montecosmo_tpu_torch.utils.io import h5load

    return h5load(path)
