"""The port's 8^3 Eulerian-bias model with png_type='bias' on the
curved-sky light cone against the JAX package in float64 on the CPU
(`test_torch_likelihoods.model_parity` and its tolerances).  One test in a
file of its own: xdist's file queue runs it beside the JAX package's long
one-test files instead of ahead of them."""
import torch

from test_torch_likelihoods import model_parity

torch.set_num_threads(1)


def test_eulerian_png_model_matches_jax():
    """The logpdf value and gradient of the 8^3 model with Eulerian bias
    and png_type='bias' on the curved-sky light cone: phi read at the
    particles (strided slices), advected with them (K1/K3, K2 in the
    backward), its Eulerian PNG terms, the fNL-shifted initial field
    (`add_png` and the chreshape round trip) and phi in the likelihood's
    s_ep term."""
    tm, _, _ = model_parity(evolution="lpt", bias_type="eulerian", png_type="bias", a_obs=None,
                            curved_sky=True)
    assert (tm.bias_type, tm.png_type) == ("eulerian", "bias")
