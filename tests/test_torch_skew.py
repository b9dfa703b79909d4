"""The port's SkewNormal (with Owen's T and match_quadratic_gaussian) and
CubGaussian against the JAX package on the same numpy inputs, on the CPU
(the JAX SkewNormal values from one jitted program, `jax_skew`).

Tolerances, float32: log-densities 2e-6 of their largest magnitude (a few
ulps of the special functions), cdfs 1e-6 absolute (log-cdfs 1e-5
relative where the cdf is at least 1e-2), the moment
parameters 1e-6 relative; the gradients of SkewNormal.log_prob in its
value and parameters 1e-4 relative with an atol of 1e-5 of the largest
(log_ndtr's derivative in the far tail, where the two packages' float32
formulations differ by up to 2.3e-5 relative; cube roots and rsqrt in
another order), at |skew| <= 0.9: at 0.99 (alpha ~ 1e2) many values
put alpha z far into that tail, where the derivatives differ by up to
0.5% (measured), so there the values alone are held.
CubGaussian.variance: the JAX
package adds 6 s1 s3, which is not a term of Var[s1 e + s2 (e^2 - 1) +
s3 (e^3 - 3 e)] = s1^2 + 2 s2^2 + 6 s3^2 (E[e (e^3 - 3 e)] = 0); the port
returns the exact variance (ROADMAP, the kept differences), held against a
Gauss-Hermite quadrature of the polynomial, which is exact.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.models import distributions as jdi
from montecosmo_tpu_torch.models import distributions as tdi

torch.set_num_threads(1)

VALUES = np.random.default_rng(60).normal(0.2, 2.0, 2000).astype(np.float32)


def _close(t, j, rtol=0.0, atol_rel=2e-6):
    t, j = np.asarray(t), np.asarray(j)
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    np.testing.assert_array_equal(t[~fin], j[~fin])
    np.testing.assert_allclose(t[fin], j[fin], rtol=rtol,
                               atol=atol_rel * max(np.abs(j[fin]).max(), 1e-30))


# the largest |skew| held is 0.99: at the clipped supremum (skew >= 0.9953,
# delta = 1 - 1e-7) 1 - delta^2 = 2.4e-7 has lost its digits in float32, and
# the JAX package's own eager and jitted log_probs differ by 33% there
SKEW = [(0.3, 1.2, 0.5), (0.0, 1.0, -0.9), (1.0, 0.5, 0.99), (-0.2, 2.0, 0.0)]


@pytest.fixture(scope="module")
def jax_skew():
    """Every JAX value the SkewNormal test compares, one jitted program:
    per parameter set, (log_prob, cdf, log_cdf, mean, variance, skewness,
    the gradients of the summed log_prob in the values and parameters)."""
    def one(v, mean, std, skew):
        d = jdi.SkewNormal(mean, std, skew)
        grads = jax.grad(lambda vv, *p: jdi.SkewNormal(*p).log_prob(vv).sum(), (0, 1, 2, 3))(
            v, mean, std, skew)
        return d.log_prob(v), d.cdf(v), d.log_cdf(v), d.mean, d.variance, d.skewness, grads

    program = jax.jit(lambda v: [one(v, *map(jnp.float32, p)) for p in SKEW])
    return dict(zip(SKEW, jax.tree_util.tree_map(np.asarray, program(jnp.asarray(VALUES)))))


@pytest.mark.parametrize("mean,std,skew", SKEW)
def test_skew_normal_matches_jax(jax_skew, mean, std, skew):
    """log_prob, cdf (Owen's T, both sides of |alpha| = 1) and log_cdf on
    2000 values, the moments, and at |skew| <= 0.9 the gradients of the
    summed log_prob in the values and (away from skew 0, where the cube
    root's derivative is infinite in both) in mean, std and skew."""
    lp, cdf, log_cdf, *moments, grads = jax_skew[mean, std, skew]
    vt = torch.tensor(VALUES)
    t = tdi.SkewNormal(mean, std, skew)
    _close(t.log_prob(vt), lp)
    _close(t.cdf(vt), cdf, 0.0, 1e-6)
    # log_cdf where the cdf is >= 1e-2: below, ndtr(z) - 2 T(z, alpha)
    # cancels and 1e-7 of absolute rounding is 1e-7 / cdf in the log
    body = cdf >= 1e-2
    _close(t.log_cdf(vt).numpy()[body], log_cdf[body], 1e-5, 1e-6)
    for name, mj in zip(("mean", "variance", "skewness"), moments):
        np.testing.assert_allclose(float(getattr(t, name)), float(mj), rtol=1e-6)
    if abs(skew) > 0.95:
        return  # alpha ~ 1e2: log_ndtr(alpha z) deep in its tail (see above)
    params = [torch.tensor(np.float32(x), requires_grad=True) for x in (mean, std, skew)]
    vg = torch.tensor(VALUES, requires_grad=True)
    tdi.SkewNormal(*params).log_prob(vg).sum().backward()
    for g, x in list(zip(grads, [vg] + params))[:4 if skew != 0.0 else 1]:
        _close(x.grad.numpy(), g, 1e-4, 1e-5)


def test_match_quadratic_gaussian_and_cub_gaussian_match_jax():
    """match_quadratic_gaussian (the QuadGaussian's mean, std and skewness)
    and the QuadGaussian moments; CubGaussian.log_prob on three- and
    one-root values, s3 of both signs, and its QuadGaussian branch at s3 =
    0; mean and variance (the exact variance: the module's docstring),
    and draws from a torch.Generator with the exact moments."""
    for loc, s1, s2 in ((0.1, 1.0, 0.2), (-0.5, 2.0, -0.3)):
        t = tdi.match_quadratic_gaussian(loc, s1, s2)
        j = jdi.match_quadratic_gaussian(loc, s1, s2)
        np.testing.assert_allclose([float(x) for x in t], [float(x) for x in j], rtol=1e-6)
        q, qj = tdi.QuadGaussian(loc, s1, s2), jdi.QuadGaussian(loc, s1, s2)
        for name in ("mean", "variance", "third_central_moment"):
            np.testing.assert_allclose(float(getattr(q, name)), float(getattr(qj, name)),
                                       rtol=1e-6)
    z, w = np.polynomial.hermite_e.hermegauss(8)
    w = w / np.sqrt(2 * np.pi)
    gen = torch.Generator().manual_seed(0)
    for loc, s1, s2, s3 in ((0.0, 1.0, 0.2, 0.1), (0.5, 1.0, -0.3, 0.05), (0.0, 1.0, 0.1, -0.4),
                            (0.0, 1.0, 0.2, 0.0)):
        t, j = tdi.CubGaussian(loc, s1, s2, s3), jdi.CubGaussian(loc, s1, s2, s3)
        _close(t.log_prob(torch.tensor(VALUES)), jax.jit(j.log_prob)(jnp.asarray(VALUES)), 0.0,
               1e-5)
        assert float(t.mean) == float(j.mean) == loc
        x = s1 * z + s2 * (z**2 - 1) + s3 * (z**3 - 3 * z)
        exact = float(w @ x**2)
        np.testing.assert_allclose(float(t.variance), exact, rtol=1e-6)
        np.testing.assert_allclose(float(j.variance) - 6 * s1 * s3, exact, rtol=1e-6)
        draws = t.sample(gen, (400_000,)).double()
        assert abs(float(draws.mean()) - loc) < 5 * exact**0.5 / 400_000**0.5
        np.testing.assert_allclose(float(draws.var()), exact, rtol=0.02)
