"""State carried from the JAX package to the port.

The model has no trained weights: its state is the sample-space parameter
dict (`model.reparam(model.fiduc, inv=True)` plus `white_mesh_`, optionally
the observed `count_mesh`) and the config dict, which the port's
`FieldLevelModel(**conf, device=...)` takes unchanged.  The N-body
evolution (`evolution='nbody'`) adds no parameter and no state: its latents
are the 2LPT model's, and `tests/test_torch_nbody.py` holds the gradient of
every one of them against the JAX package.
"""
from typing import Mapping

import numpy as np

from montecosmo_tpu_torch.utils import to_tensor


def params_from_numpy(params: Mapping[str, np.ndarray], device) -> dict:
    """Parameter dict of numpy arrays, scalars or tensors -> dict of float32
    / complex64 tensors on `device`, same keys."""
    return {k: to_tensor(v, device) for k, v in params.items()}
