"""The port's Laplace approximation (montecosmo_tpu_torch.lapprox), Laplace
mass seed (script._laplace_seed), Adam MAP optimisation and ADVI against
the JAX package's, on the CPU.

* `hessian_diag`, `hessian_diag_stochastic` and `marginal_covariance`
  (exact and Hutchinson) on an analytic potential, a quadratic with a
  quartic field term and a cubic coupling, in float64 (`jax.enable_x64`)
  at 1e-10: the port's reverse over reverse against JAX's forward over
  reverse; the Hutchinson probes are JAX's own Rademacher draws, passed in.
* `_laplace_seed` on a correlated quadratic with a saddle direction, and on
  the 8^3 2LPT model's {Omega_m_, b1_, sigma8_} block (float32: rtol 2e-3,
  the model Hessian's tolerance in test_torch_hessian.py).
* `optimize` (Adam under lr0 / sqrt(1 + t)) on test_samplers.py's potential
  and `advi` fed JAX's normal draws: float32, rtol 1e-5 (the same updates in
  another order of float32 operations; the potentials along the Adam path
  1e-4: optax rounds its bias correction to float32).
"""
import numpy as np
import pytest
import torch

import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu import lapprox as JL
from montecosmo_tpu.samplers import optimize as jax_optimize, advi as jax_advi
from montecosmo_tpu.script import _laplace_seed as jax_laplace_seed
from montecosmo_tpu_torch import lapprox as TL
from montecosmo_tpu_torch.samplers import optimize, advi
from montecosmo_tpu_torch.script import _laplace_seed

torch.set_num_threads(1)

M, N = 3, 24
TIGHT = dict(rtol=1e-10, atol=1e-10)


def _coefs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, M))
    return dict(A=a @ a.T + M * np.eye(M), B=0.3 * rng.standard_normal((M, N)),
                d=rng.uniform(1.0, 3.0, N), x=0.2 * rng.standard_normal(M),
                y=0.5 * rng.standard_normal(N))


def potential(lib):
    c = _coefs()
    arr = jnp.asarray if lib is jnp else torch.as_tensor

    def pot(x, y):
        A, B, d = arr(c["A"]), arr(c["B"]), arr(c["d"])
        return (0.5 * x @ A @ x + 0.5 * (d * y**2).sum() + x @ B @ y + 0.1 * (y**4).sum()
                + 0.05 * (x**3).sum() * (y**2).sum())
    return pot


def probes(n):
    """JAX's Rademacher probes of `hessian_diag_stochastic` with its key."""
    return np.stack([np.asarray(jr.rademacher(k, (N,), dtype=jnp.float64))
                     for k in jr.split(jr.key(0), n)])


def test_hessian_diags_match_jax():
    c = _coefs()
    with jax.enable_x64(True):
        fj = lambda y: potential(jnp)(jnp.asarray(c["x"]), y)
        ft = lambda y: potential(torch)(torch.as_tensor(c["x"]), y)
        yj, yt = jnp.asarray(c["y"]), torch.as_tensor(c["y"])
        np.testing.assert_allclose(TL.hessian_diag(ft, yt).numpy(),
                                   np.asarray(JL.hessian_diag(fj, yj, chunk=5)), **TIGHT)
        np.testing.assert_allclose(
            TL.hessian_diag_stochastic(ft, yt, 6, torch.as_tensor(probes(6))).numpy(),
            np.asarray(JL.hessian_diag_stochastic(fj, yj, 6)), **TIGHT)


@pytest.mark.parametrize("method,chunk", [("exact", None), ("hutchinson", 8)])
def test_marginal_covariance_matches_jax(method, chunk):
    c = _coefs()
    with jax.enable_x64(True):
        cov_j, schur_j = JL.marginal_covariance(potential(jnp), jnp.asarray(c["x"]),
                                                jnp.asarray(c["y"]), method, chunk)
        key = None if method == "exact" else torch.as_tensor(probes(chunk))
        cov_t, schur_t = TL.marginal_covariance(potential(torch), torch.as_tensor(c["x"]),
                                                torch.as_tensor(c["y"]), method, chunk, key=key)
        cov_a, _ = TL.cov_x_from_pot_x_y(potential(torch), torch.as_tensor(c["x"]),
                                         torch.as_tensor(c["y"]), "exact")
    np.testing.assert_allclose(schur_t.numpy(), np.asarray(schur_j), **TIGHT)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), **TIGHT)
    assert cov_a.shape == (M, M)


def test_laplace_seed_matches_jax_quadratic():
    """A correlated Gaussian and a negative-curvature direction (folded
    positive), as test_samplers.py holds the JAX seed."""
    C = np.array([[2.0, 0.6], [0.6, 0.5]])
    Ci = np.linalg.inv(C)

    def logdf(lib):
        arr = jnp.asarray if lib is jnp else torch.as_tensor
        stack = jnp.stack if lib is jnp else torch.stack

        def f(p):
            x = stack([p["a"], p["b"]])
            return -0.5 * x @ arr(Ci) @ x + 10.0 * p["c"] ** 2
        return f

    p = {"a": 0.1, "b": -0.2, "c": 0.05}
    with jax.enable_x64(True):
        cov_j, w_j = jax_laplace_seed(logdf(jnp), {k: jnp.asarray(v) for k, v in p.items()}, {})
        cov_t, w_t = _laplace_seed(logdf(torch), {k: torch.tensor(v, dtype=torch.float64)
                                                 for k, v in p.items()}, {})
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), **TIGHT)
    np.testing.assert_allclose(w_t, w_j, **TIGHT)
    np.testing.assert_allclose(cov_t.numpy()[:2, :2], C, rtol=1e-10)
    assert abs(cov_t[2, 2].item() - 1 / 20.0) < 1e-10


def test_optimize_matches_jax():
    x0 = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    w = np.arange(1, 9, dtype=np.float32)
    pj, vj = jax_optimize(lambda p: jnp.sum((p["x"] - 3.0) ** 2 * w), {"x": jnp.asarray(x0)},
                          lr0=0.3, n_epochs=60)
    pt, vt = optimize(lambda p: torch.sum((p["x"] - 3.0) ** 2 * torch.as_tensor(w)),
                      {"x": torch.as_tensor(x0)}, lr0=0.3, n_epochs=60)
    np.testing.assert_allclose(pt["x"].numpy(), np.asarray(pj["x"]), rtol=1e-5, atol=1e-5)
    # optax forms the bias correction 1 - 0.999^t in float32 (1.3e-5 off at
    # t = 1), torch in float64: the potentials drift apart by ~5e-5
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-4)
    _, vl = optimize(lambda p: (p["x"] ** 2).sum(), {"x": torch.ones(2)}, n_epochs=3, scan=False)
    assert isinstance(vl, list) and len(vl) == 3


def test_advi_matches_jax():
    """30 ADVI steps on an 8-dim Gaussian with JAX's own draws of eps (the
    port loops over the n_mc samples JAX vmaps)."""
    scales = np.geomspace(0.5, 3.0, 8).astype(np.float32)
    start = {"x": np.zeros(8, np.float32)}
    n_steps, n_mc, seed = 30, 4, 3
    post_j, elbo_j = jax_advi(lambda p: -0.5 * jnp.sum((p["x"] / scales) ** 2),
                              {"x": jnp.asarray(start["x"])}, n_steps, n_mc, lr0=0.05, seed=seed)
    eps = np.stack([np.asarray(jr.normal(k, (n_mc, 8), jnp.float32))
                    for k in jr.split(jr.key(seed), n_steps)])
    post_t, elbo_t = advi(lambda p: -0.5 * torch.sum((p["x"] / torch.as_tensor(scales)) ** 2),
                          {"x": torch.as_tensor(start["x"])}, n_steps, n_mc, lr0=0.05,
                          seed=torch.as_tensor(eps))
    np.testing.assert_allclose(post_t.mu.numpy(), np.asarray(post_j.mu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(post_t.sigma.numpy(), np.asarray(post_j.sigma), rtol=1e-5)
    np.testing.assert_allclose(elbo_t.numpy(), np.asarray(elbo_j), rtol=1e-5, atol=1e-5)
    x = {"x": torch.full((8,), 0.3)}
    np.testing.assert_allclose(post_t.log_prob(x).item(),
                               float(post_j.log_prob({"x": jnp.full(8, 0.3)})), rtol=1e-5)
    draws = post_t.sample(torch.Generator().manual_seed(0), 5)
    assert draws["x"].shape == (5, 8) and post_t.mean["x"].shape == (8,)
