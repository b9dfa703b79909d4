"""The port's N-body model against the JAX package on the CPU: the 16^3
BullFrog light cone at TSC, its logpdf value and gradient (the tolerances
of `test_torch_model.logpdf_and_grad_16`).  One test in a file of its own:
xdist's file queue runs it beside the JAX package's long one-test files
instead of ahead of them."""
import torch

from test_torch_model import logpdf_and_grad_16

torch.set_num_threads(1)


def test_logpdf_and_grad_nbody_match_jax_16():
    """The N-body model at 16^3 on the light cone (a_obs=None) at TSC
    (paint_order=3): force paints and reads, and the render, at order 3.  The
    fixed-a_obs CIC N-body stays covered by the golden 32^3 forward and the
    nbody_bf gradient tests."""
    logpdf_and_grad_16("nbody", a_obs=None, paint_order=3)
