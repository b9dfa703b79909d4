"""The gradient through the port's adaptive Tsit5 against `jax.grad` of the
JAX package's, on the CPU.  One test in a file of its own: its JAX program
(reverse mode through the masked adaptive scan) is the heaviest compile of
the N-body remainder's tests, and xdist's file queue runs a one-test file
beside the JAX package's long one-test files instead of ahead of them.

The loss is tests/test_pm.py::test_tsit5_grad_flows's, sum(sin(pos)) of
the final state at tol 1e-2 and max_steps 24, from a = 0.2 to 1, on a
strong 16^3 field (4 Mpc/h cells), differentiated in the linear field and
Omega_m.  Float32 on both sides (the JAX function does not run in float64:
test_torch_integrators.py).  The gradient reaches the states through the
step sizes too (dt from the error, a from dt, the vector field from a):
with dt detached in the port the field's gradient is off by 3.0e-2 and
Omega_m's by 3.4e-3 (measured), so the tolerances, 5e-3 of the largest
field gradient and 1e-3 relative in Omega_m (measured 1.2e-3 and 2.7e-4
of that), hold the gradient through the controller.
"""
import numpy as np
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg, pm as jpm
from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.ops import background as tbg, fourier as tfo, pm as tpm
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_ops import T, _lin_field

torch.set_num_threads(1)


def test_tsit5_gradient_matches_jax():
    shape, box = (16, 16, 16), (64.0,) * 3
    lin = np.fft.irfftn(_lin_field(shape, box, 25), shape, axes=(0, 1, 2)).astype(np.float32)
    kw = dict(tol=1e-2, max_steps=24)

    def jloss(m, om):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=0.8))
        pos, _ = jpm.nbody_tsit5(bg, jnp.fft.rfftn(m), jbr.regular_pos(shape), 0.2, 1.0, **kw)
        return jnp.sum(jnp.sin(pos[-1]))

    lj, (gmj, goj) = jax.jit(jax.value_and_grad(jloss, (0, 1)))(jnp.asarray(lin),
                                                                jnp.float32(0.31))
    mt, omt = T(lin, True), T(np.float32(0.31), True)
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=omt, sigma8=torch.tensor(0.8)))
    stats = {}
    pos, _ = tpm.nbody_tsit5(bg, tfo.rfftn(mt), tbr.regular_pos(shape), 0.2, 1.0, stats=stats,
                             **kw)
    loss = torch.sin(pos[-1]).sum()
    loss.backward()
    print(stats)
    assert stats["accepted"] >= 3
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    gmj = np.asarray(gmj)
    assert np.isfinite(mt.grad.numpy()).all() and np.abs(gmj).max() > 0
    np.testing.assert_allclose(mt.grad.numpy(), gmj, rtol=0, atol=5e-3 * np.abs(gmj).max())
    np.testing.assert_allclose(omt.grad.item(), float(goj), rtol=1e-3)
