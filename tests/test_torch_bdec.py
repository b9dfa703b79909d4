"""The port's `bdec` against the JAX package on the CPU: every function,
unweighted and weighted, at CDF orders 1 and 2, on the same seeded float32
samples (3 parameters x 40 draws, sample axis first; weights in [0.1, 1]).

Tolerance: 2e-6 absolute (the samples are O(1)): both packages interpolate
the same float32 knots, the port's cumulative sums and trapezoids in
another order (measured <= 1.8e-6, `sci` at order 1).  `argmedian` and
`sci_noweights` pick order statistics and are held equal.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import montecosmo_tpu.bdec as J

import montecosmo_tpu_torch.bdec as T

ATOL = 2e-6
RNG = np.random.default_rng(11)
X = RNG.normal(size=(40, 3)).astype(np.float32)
W = RNG.uniform(0.1, 1.0, 40).astype(np.float32)
P = [0.68, 0.95]


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


KINDS = ["low", "med", "high"]


def _jax_outputs(x, w, ord):
    """Every traceable JAX result of a case, in one program."""
    out = {"q": J.quantile(x, jnp.asarray(P), 0, w, ord),
           "q1": J.quantile(x[:, 0], 0.3, weights=w, ord=ord),
           "qT": J.quantile(x.T, jnp.asarray(P), -1, w, ord),
           "qbci": J.qbci(x, jnp.asarray(P), 0, w, "med", ord),
           "qbcs": J.qbcs(x, 0.9, w, "med"), "qbcs3": J.qbcs(x, 0.9, w, KINDS),
           "scs": J.scs(x[:, :2], 0.9, w, grid_size=16)}
    for kind in KINDS + ([] if w is None else ["small"]):
        out[kind] = J.credint(x, 0.9, 0, w, kind, ord)
    if w is not None:
        out["sci"] = J.sci(x, jnp.asarray(P), 0, w, ord)
    y = x if ord == 1 else jnp.abs(x)
    out["ct"] = J.cumulative_trapezoid(y, x[:, 0], axis=0, initial=0.0)
    out["ct_dx"] = J.cumulative_trapezoid(y.T, dx=0.5)
    return out


JAX_OUTPUTS = jax.jit(_jax_outputs, static_argnums=2)


@pytest.mark.parametrize("ord", [1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_bdec_matches_jax(ord, weighted):
    """quantile (scalar and array p, axis 0 and -1), credint of every type,
    qbci, qbcs (each tail type), sci (weighted; sci_noweights otherwise),
    cumulative_trapezoid and scs; the JAX side in one jitted program a
    case (sci_noweights is host numpy there)."""
    w = W if weighted else None
    want = JAX_OUTPUTS(jnp.asarray(X), None if w is None else jnp.asarray(w), ord)
    _close(T.quantile(X, P, 0, w, ord), want["q"])
    _close(T.quantile(X[:, 0], 0.3, weights=w, ord=ord), want["q1"])
    _close(T.quantile(X.T, P, -1, w, ord), want["qT"])
    for kind in KINDS:
        _close(T.credint(X, 0.9, 0, w, kind, ord), want[kind])
    if weighted:
        _close(T.credint(X, 0.9, 0, w, "small", ord), want["small"])
        _close(T.sci(X, P, 0, w, ord), want["sci"])
    else:
        small = J.sci_noweights(X, 0.9, 0)
        _close(T.credint(X, 0.9, 0, None, "small", ord), small, atol=0)
        _close(T.sci_noweights(X, 0.9, 0), small, atol=0)
    _close(T.qbci(X, P, 0, w, "med", ord), want["qbci"])
    for kind, key in (("med", "qbcs"), (KINDS, "qbcs3")):
        for got, ref in zip(T.qbcs(X, 0.9, w, kind), want[key]):
            _close(got, ref)
    y = X if ord == 1 else np.abs(X)
    _close(T.cumulative_trapezoid(y, X[:, 0], axis=0, initial=0.0), want["ct"])
    _close(T.cumulative_trapezoid(y.T, dx=0.5), want["ct_dx"])
    axes_t, mesh_t, level_t = T.scs(X[:, :2], 0.9, w, grid_size=16)
    axes_j, mesh_j, level_j = want["scs"]
    for a_t, a_j in zip(axes_t, axes_j):
        _close(a_t, a_j)
    _close(mesh_t, mesh_j, atol=1e-6 * float(np.abs(mesh_j).max()))
    _close(level_t, level_j, atol=1e-6 * float(np.abs(mesh_j).max()))


def test_argmedian_scs_dimensions_and_float64():
    """argmedian equals the JAX package's; scs in 1 and 3 dimensions (2 in
    the test above); a float64 input stays float64 and its order-1 quantile
    is the linear interpolation of the cumulative weights i / n."""
    np.testing.assert_array_equal(T.argmedian(torch.as_tensor(X), 0), J.argmedian(X, 0))
    for d, w in ((1, None), (3, W)):
        axes_t, mesh_t, level_t = T.scs(X[:, :d], 0.9, w, grid_size=8)
        axes_j, mesh_j, level_j = jax.jit(J.scs, static_argnames="grid_size")(
            jnp.asarray(X[:, :d]), 0.9, w, grid_size=8)
        for a_t, a_j in zip(axes_t, axes_j):
            _close(a_t, a_j)
        _close(mesh_t, mesh_j, atol=1e-6 * float(np.abs(mesh_j).max()))
        _close(level_t, level_j, atol=1e-6 * float(np.abs(mesh_j).max()))
    x64 = X.astype(np.float64)
    q = T.quantile(x64, [0.25, 0.5], 0)
    assert q.dtype == torch.float64
    xs = np.sort(x64, 0)
    cdf = np.arange(1, 41) / 40
    want = np.stack([[np.interp(p, cdf, xs[:, j]) for j in range(3)] for p in (0.25, 0.5)])
    np.testing.assert_allclose(q.numpy(), want, rtol=0, atol=1e-12)


def _witness(draws, span, sets=256, seed=11):
    """A seeded subset of the card-against-CPU witness: `sets` columns of
    `draws` normal draws, weights exp(-span u) with u uniform (1e-35..1 at
    span 80, as a campaign's density weights spread)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((draws, sets))
    return x, np.exp(-span * rng.uniform(size=(draws, sets)))


_WITNESS_FNS = {"qbci": jax.jit(J.qbci, static_argnums=2), "sci": jax.jit(J.sci, static_argnums=2)}


def test_float32_witness_against_jax_and_float64():
    """qbci and sci at the 68% and 95% levels on the witness subsets (16
    and 64 draws, spans 10, 37, 80): the port's float32 against the JAX
    package's float32 within 1e-4 (both interpolate float32 CDF knots
    that differ by ulps, the JAX package's summed in float32, the port's
    in float64; measured <= 3.8e-5), and nearer float64: over all cases
    the port's float32 is off its float64 result by more than 1e-6 in no
    more sets than the JAX package's float32 is (measured 31 against 65
    of 3,072)."""
    off = {"port": 0, "jax": 0}
    for draws in (16, 64):
        for span in (10.0, 37.0, 80.0):
            x, w = _witness(draws, span)
            x32, w32 = x.astype(np.float32), w.astype(np.float32)
            for name, jfn in _WITNESS_FNS.items():
                fn = getattr(T, name)
                t64 = fn(torch.as_tensor(x), P, 0, torch.as_tensor(w)).numpy()
                t32 = fn(torch.as_tensor(x32), P, 0, torch.as_tensor(w32))
                assert t32.dtype == torch.float32
                j32 = np.asarray(jfn(jnp.asarray(x32), jnp.asarray(P), 0, jnp.asarray(w32)))
                _close(t32, j32, atol=1e-4)
                for key, got in (("port", t32.numpy()), ("jax", j32)):
                    d = np.abs(got.astype(np.float64) - t64).reshape(2, -1, 2).max((0, 2))
                    off[key] += int((d > 1e-6).sum())
    assert off["port"] <= off["jax"], off
