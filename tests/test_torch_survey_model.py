"""The port's masked cut-sky model against the JAX package's on the CPU: a
register painted by the port's `register_catalog` (held against the JAX
package's in test_torch_register.py) from the catalogs of
test_torch_register.py (12^3 budget: an (8, 18, 12) final mesh, the
footprint ~89% of it, the selection at the (14, 32, 20) paint shape), saved
as the port's `.npz` and, for the JAX package, as `.h5`; the 2LPT
curved-sky light cone with the selection mesh, the footprint mask and the
radial counts in the quad-Gaussian likelihood: logpdf value and gradient
against the JAX model of the `.h5` (`test_torch_register.registered_parity`); the
Fourier likelihood refuses the masked register.  One test in a file of its own: xdist's file queue runs it beside the JAX
package's long one-test files instead of ahead of them."""
import numpy as np
import pytest
import torch

from montecosmo_tpu_torch import FieldLevelModel, default_config
from montecosmo_tpu_torch.ops.background import get_cosmology
from montecosmo_tpu_torch.utils.io import h5save, npsave

from test_torch_register import catalog, registered_parity, OMEGA_M, SIGMA8

torch.set_num_threads(1)


def test_cut_sky_masked_model_matches_jax(tmp_path):
    reg = FieldLevelModel.register_catalog(
        12**3, get_cosmology(Omega_m=OMEGA_M, sigma8=SIGMA8), catalog(20_000, 1),
        catalog(50_000, 2), device="cpu")
    npsave(tmp_path / "register.npz", reg)
    h5save(tmp_path / "register.h5", reg)
    tm = registered_parity(tmp_path / "register.h5", tmp_path / "register.npz", evolution="lpt")
    assert tm.curved_sky and tm.a_obs is None and tm.final_shape == (8, 18, 12)
    assert tm.paint_shape == (14, 32, 20) and tm._selec_paint.shape == (14, 32, 20)
    assert 0.8 < float(tm.mask_mesh.float().mean()) < 0.95
    assert tm.count_mesh.ndim == 1 and tm.count_mesh.numel() == int(tm.mask_mesh.sum())
    # the Fourier likelihood needs the whole box, as the JAX package asserts
    fm = FieldLevelModel(**{**default_config, "register": str(tmp_path / "register.npz"),
                            "lik_type": "fourier_gauss"}, device="cpu")
    p = fm.reparam({k: np.asarray(v) for k, v in fm.fiduc.items()}, inv=True)
    p["white_mesh_"] = torch.zeros(fm.init_shape)
    with pytest.raises(ValueError, match="full box"):
        fm.logpdf(p | fm.obs_data())
