"""State carried from the JAX package to the port.

The model has no trained weights: its state is the sample-space parameter
dict (`model.reparam(model.fiduc, inv=True)` plus `white_mesh_`, optionally
the observed `count_mesh`) and the config dict, which the port's
`FieldLevelModel(**conf, device=...)` takes unchanged.
"""
from typing import Mapping

import numpy as np

from montecosmo_tpu_torch.utils import to_tensor


def params_from_numpy(params: Mapping[str, np.ndarray], device) -> dict:
    """Parameter dict of numpy arrays, scalars or tensors -> dict of float32
    / complex64 tensors on `device`, same keys."""
    return {k: to_tensor(v, device) for k, v in params.items()}
