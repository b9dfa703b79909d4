"""Eulerian bias in the port against the JAX package on the CPU:
`eulerian_bias` on shared meshes, and the Eulerian model (2LPT at
lpt_order 1: the matter advected by K1/K3's paint, in paint-mesh units)
logpdf value and gradient at 8^3 (`model_parity`, its tolerances in
test_torch_likelihoods.py).

Tolerances of `eulerian_bias` (float32 FFTs in another order): the
weights within 1e-5 of the largest, the VJP in the field within 1e-4 of
the largest entry, in the bias scalars rtol 1e-4.
"""
import numpy as np
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.models import bricks as tbr
from test_torch_likelihoods import model_parity

torch.set_num_threads(1)
NAMES = ("b1", "b2", "bs2", "bn2")


def test_eulerian_bias_matches_jax():
    """Weights of a 16^3 advected matter field (box 128 Mpc/h, nonzero mean
    that the operator drops) at Lagrangian biases; VJP of a random
    cotangent in the real field and each bias."""
    rng = np.random.default_rng(0)
    x = (1.0 + 0.3 * rng.standard_normal((16, 16, 16))).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    bias = dict(zip(NAMES, np.array([0.8, -0.3, 0.2, 4.0], np.float32)))
    box = np.array([128.0] * 3)

    xt = torch.tensor(x, requires_grad=True)
    bt = {k: torch.tensor(v, requires_grad=True) for k, v in bias.items()}
    out = tbr.eulerian_bias(torch.fft.rfftn(xt), box, bt)
    grads = torch.autograd.grad(out, [xt, *bt.values()], torch.tensor(ct))

    png = {"fNL": 0.0, "fNL_bp": 0.0, "fNL_bpd": 0.0}

    def fj(y, *b):
        m = jnp.fft.rfftn(y)
        return jbr.eulerian_bias(m, m, box, dict(zip(NAMES, b)), png)[0]

    oj, vjp = jax.vjp(fj, jnp.asarray(x), *map(jnp.asarray, bias.values()))
    gj = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(oj)).max())
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gj[0]), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(gj[0])).max())
    for name, a, b in zip(NAMES, grads[1:], gj[1:]):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-4, err_msg=name)


def test_bias_conversions_match_jax():
    """b1, b2 and b_phi_delta between Lagrangian and Eulerian, both ways."""
    b, c = np.float32(0.7), np.float32(-0.4)
    for name, args in (("b1_L2E", (b,)), ("b1_E2L", (b,)), ("b2_L2E", (b, c)),
                       ("b2_E2L", (b, c)), ("bpd_L2E", (b, c)), ("bpd_E2L", (b, c))):
        got = getattr(tbr, name)(*map(torch.tensor, args))
        np.testing.assert_allclose(got.item(), float(getattr(jbr, name)(*args)), rtol=1e-7,
                                   err_msg=name)


def test_eulerian_model_logpdf_and_grad_match_jax():
    """bias_type='eulerian' with 2LPT at lpt_order 1 (tests/test_model_variants.py's
    Eulerian case), at 8^3."""
    tm, _, _ = model_parity(evolution="lpt", bias_type="eulerian", lpt_order=1)
    assert tm.bias_type == "eulerian"
