"""The port's model of the JAX package's registered mock
(registered/register_synthetic_z1.000_b32_p0.h5: a 32^3 full-sky box at a_obs
0.5 with its tabulated spectrum, white mesh and counts) against the JAX
package's on the CPU: the `.h5` through `convert.register_from_h5` and
`npsave` to the port's `.npz`, `FieldLevelModel(register=...)` from it,
the Kaiser evolution (the register's spectrum through `white2lin` and the
Kaiser field), logpdf value and gradient against the JAX model of the same
`.h5` (`test_torch_register.registered_parity`).  One test in a file of its
own: xdist's file queue runs it beside the JAX package's long one-test
files instead of ahead of them."""
from pathlib import Path

import torch

from montecosmo_tpu_torch.convert import register_from_h5
from montecosmo_tpu_torch.utils.io import npsave

from test_torch_register import registered_parity

torch.set_num_threads(1)

REGISTER = Path(__file__).resolve().parent.parent / "registered" / \
    "register_synthetic_z1.000_b32_p0.h5"


def test_registered_mock_model_matches_jax(tmp_path):
    npsave(tmp_path / "register.npz", register_from_h5(REGISTER))
    tm = registered_parity(REGISTER, tmp_path / "register.npz", evolution="kaiser")
    assert tm.lin_kpow is not None and tm.white_mesh.dtype == torch.complex64
    assert tm.final_shape == (32, 32, 32) and tm.init_shape == (48, 48, 48)
