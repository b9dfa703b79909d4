"""The chains' diagnostics of the port (`metrics.effective_sample_size`,
`gelman_rubin`, `multi_ess`, `multi_gr`) and `powtranscoh` against the JAX
package's `metrics` on the CPU (float32 in both: 1e-4 relative; the
spectra 1e-5 of their largest value).  One test in a file of its own:
xdist's file queue runs it beside the JAX package's long one-test files
instead of ahead of them."""
import numpy as np
import torch
from jax import numpy as jnp

from montecosmo_tpu import metrics as jmetrics

from montecosmo_tpu_torch import metrics as tmetrics

torch.set_num_threads(1)


def ar1(shape, rho, seed):
    """AR(1) draws (n_chains, n_samples, ...), float32, chains offset."""
    rng = np.random.default_rng(seed)
    x = np.zeros(shape)
    eps = rng.standard_normal(shape)
    x[:, 0] = eps[:, 0]
    for t in range(1, shape[1]):
        x[:, t] = rho * x[:, t - 1] + eps[:, t]
    return (x + 0.1 * np.arange(shape[0]).reshape(-1, *[1] * (len(shape) - 1))).astype(
        np.float32)


def test_chain_diagnostics_match_jax():
    """ESS, r-hat and their multivariate means on AR(1) chains (4 chains
    of 200 draws of 6 parameters, rho 0.3 for three of them and 0.9 for the
    others), and powtranscoh of two 8^3 meshes."""
    x = np.concatenate([ar1((4, 200, 3), 0.3, 0), ar1((4, 200, 3), 0.9, 1)], -1)
    for name in ("effective_sample_size", "multi_ess", "gelman_rubin", "multi_gr"):
        np.testing.assert_allclose(getattr(tmetrics, name)(x).numpy(),
                                   np.asarray(getattr(jmetrics, name)(jnp.asarray(x))),
                                   rtol=1e-4, err_msg=name)
    rng = np.random.default_rng(1)
    m0 = rng.standard_normal((8, 8, 8)).astype(np.float32)
    m1 = (m0 + 0.5 * rng.standard_normal((8, 8, 8))).astype(np.float32)
    box = np.array([320.0, 320.0, 320.0])
    out_t = tmetrics.powtranscoh(torch.tensor(m0), torch.tensor(m1), box)
    out_j = jmetrics.powtranscoh(jnp.asarray(m0), jnp.asarray(m1), box)
    for t, j in zip(out_t, out_j):
        t, j = np.asarray(t), np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.nanmax(np.abs(j)))
