"""The port's cut-sky `register_catalog` against the JAX package's on the
CPU, at test_torch_register.py's tolerances (masks equal cell for cell,
counts 1e-5 and the selection 2e-5 of their largest value); the port's on
the CPU runs K1's and K3's plain versions.  One test in a file of its own:
xdist's file queue runs it beside the JAX package's long one-test files
instead of ahead of them."""
import numpy as np
import torch

from test_torch_register import _close, _hold_register, _register_both, catalog

torch.set_num_threads(1)


def test_cut_sky_register_matches_jax():
    """A 16^3-budget cut-sky register from 20,000 data and 50,000 randoms:
    the box, the counts, the selection (at the paint shape) and the
    footprint mask (some cells outside it) against JAX's; the counts sum to
    the data's weight."""
    data, rand = catalog(20_000, 1), catalog(50_000, 2)
    rt, rj = _register_both(cell_budget=16**3, data=data, random=rand)
    _hold_register(rt, rj)
    np.testing.assert_array_equal(rt["mask_mesh"], np.asarray(rj["mask_mesh"]))
    assert 0.5 < rt["mask_mesh"].mean() < 0.95
    _close(rt["selec_mesh"], rj["selec_mesh"], 2e-5)
    assert rt["selec_mesh"].shape == tuple(
        2 * np.rint(np.multiply(rt["count_mesh"].shape, 7 / 4) / 2).astype(int))
    np.testing.assert_allclose(rt["count_mesh"].sum(), 20_000, rtol=1e-5)
