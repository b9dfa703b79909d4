"""The port's full-sky `register_catalog` (a periodic box with catalog
RSD) against the JAX package's on the CPU, at test_torch_register.py's
tolerances.  One test in a file of its own: xdist's file queue runs it
beside the JAX package's long one-test files instead of ahead of them."""
import numpy as np
import pytest
import torch

from test_torch_register import _hold_register, _register_both

torch.set_num_threads(1)


def test_full_sky_register_matches_jax():
    """A 16^3-budget full-sky periodic box from two chunks of cartesian
    particles with velocities (catalog RSD at a_obs along the line of
    sight): the counts against JAX's, their sum the tracers'
    (`fullsky2count`'s conservation assert holds), the box centre on the
    line of sight at chi(a_obs)."""
    rng = np.random.default_rng(3)
    box = np.array([640.0, 640.0, 640.0])
    chunks = [{"pos": rng.uniform(-320, 320, (5000, 3)) + [0.0, 0.0, 2000.0],
               "vel": rng.normal(0, 300.0, (5000, 3))} for _ in range(2)]
    los = np.array([0.0, 0.0, 1.0])
    rt, rj = _register_both(cell_budget=16**3, data=chunks, box_size=box,
                            box_center=(0.0, 0.0, 2000.0), a_obs=0.5, los=los)
    _hold_register(rt, rj)
    assert rt["count_mesh"].shape == (16, 16, 16)
    np.testing.assert_allclose(rt["count_mesh"].sum(), 10_000, rtol=1e-5)
    assert rt["n_tracers"] == pytest.approx(10_000, rel=1e-5)
