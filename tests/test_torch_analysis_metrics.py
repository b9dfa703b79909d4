"""The rest of the port's `metrics` (the value binning, the binned MSEs and
distributions, the error bars, the Kaiser multipoles, the curved-sky mu^2
operators, the Wigner coefficients) and the small leftovers of the ops
(`fftk`, `boxreshape`, `resample_uniform`, `Planck15`, `Background.k2ell`
and `ell2k`) against the JAX package on the CPU, on the same seeded numpy
inputs.

Tolerances: the host-numpy functions (binning, distributions, error bars,
`real_sph_harm`, `wigner3j_square`, `resample_uniform`'s nodes) are the
same numpy arithmetic and are held equal; float32 device arithmetic
(`mse_wave`, `naive_mu2_delta`, `kaiser_formula`, the Limber conversions)
is held at 1e-5 relative to its largest entry, the FFTs and the
background tables summing in another order (measured <= 6.0e-7, ell2k);
`boxreshape` and `fftk` are held equal.
"""
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import montecosmo_tpu.metrics as jm
from montecosmo_tpu.ops import background as jbg
from montecosmo_tpu.ops.fourier import fftk as jax_fftk
from montecosmo_tpu.ops.hermitian import boxreshape as jax_boxreshape
from montecosmo_tpu.ops.interp import resample_uniform as jax_resample_uniform

import montecosmo_tpu_torch.metrics as tm
from montecosmo_tpu_torch.ops import background as tbg
from montecosmo_tpu_torch.ops.fourier import fftk
from montecosmo_tpu_torch.ops.hermitian import boxreshape
from montecosmo_tpu_torch.ops.interp import resample_uniform

RNG = np.random.default_rng(5)
N = 16
MESH0 = RNG.normal(size=(N,) * 3).astype(np.float32)
MESH1 = (MESH0 + 0.3 * RNG.normal(size=(N,) * 3)).astype(np.float32)
POS = np.stack(np.meshgrid(*[np.arange(N) - N / 2 + 0.5] * 3, indexing="ij"), -1) * 10.0
RMESH = np.sqrt((POS**2).sum(-1))


def _equal(got, want):
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _equal(g, w)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_binning_and_distributions_match_jax():
    """bin_and_aggregate (a count, a width, quantile edges, an aggregate
    function), mse_radius, mse_value, distr_radial and distr_angular (sum
    and aggregate function), from tensors on the port's side."""
    t0, t1 = torch.as_tensor(MESH0), torch.as_tensor(MESH1)
    for args, kw in [((MESH1, MESH0, 7), {}), ((MESH1, MESH0, 0.5), {}),
                     ((MESH1, MESH0, [0.1, 0.5, 0.9]), {"min_count": None}),
                     ((MESH1, MESH0, 5), {"aggr_fn": np.median})]:
        _equal(tm.bin_and_aggregate(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                      for a in args), **kw),
               jm.bin_and_aggregate(*args, **kw))
    _equal(tm.mse_radius(t0, t1, RMESH, 10.0), jm.mse_radius(MESH0, MESH1, RMESH, 10.0))
    _equal(tm.mse_radius(t0, t1, RMESH, 10.0, redges=8, aggr_fn=np.max),
           jm.mse_radius(MESH0, MESH1, RMESH, 10.0, redges=8, aggr_fn=np.max))
    _equal(tm.mse_value(t0, t1, 10.0, [0.2, 0.5, 0.8]),
           jm.mse_value(MESH0, MESH1, 10.0, [0.2, 0.5, 0.8]))
    _equal(tm.distr_radial(t1, RMESH, 10.0), jm.distr_radial(MESH1, RMESH, 10.0))
    _equal(tm.distr_angular(t1, POS), jm.distr_angular(MESH1, POS))
    _equal(tm.distr_angular(t1, POS, 4, 6, min_count=50, aggr_fn=np.mean),
           jm.distr_angular(MESH1, POS, 4, 6, min_count=50, aggr_fn=np.mean))


def test_mse_wave_errorbars_sph_harm_wigner_match_jax():
    """mse_wave (the spectrum of the difference, K9's plain version), the
    mean and variance error bars (Student t / chi^2 and Gaussian),
    real_sph_harm for every m at l 0-3, and wigner3j_square with and
    without its prefactor."""
    got = tm.mse_wave(torch.as_tensor(MESH0), torch.as_tensor(MESH1), (160.0,) * 3, kedges=6)
    want = jm.mse_wave(jnp.asarray(MESH0), jnp.asarray(MESH1), (160.0,) * 3, kedges=6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[2], want[2])
    count, std = np.array([5, 10, 40]), np.array([0.5, 1.0, 2.0])
    for approx in (False, True):
        np.testing.assert_allclose(tm.mean_errorbar(count, torch.as_tensor(std), 0.9, approx),
                                   np.asarray(jm.mean_errorbar(count, std, 0.9, approx)),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm.var_errorbar(count, std**2, 0.68, approx),
                                   np.asarray(jm.var_errorbar(count, std**2, 0.68, approx)),
                                   rtol=1e-6)
    theta, phi = np.linspace(0.1, 3.0, 7), np.linspace(-3.0, 3.0, 7)
    for l in range(4):
        for m in range(-l, l + 1):
            np.testing.assert_array_equal(tm.real_sph_harm(l, m, theta, phi),
                                          jm.real_sph_harm(l, m, theta, phi))
    for lo, li in [(0, 0), (2, 2), (4, 2), (2, 4), (3, 1)]:
        for pre in (True, False):
            assert tm.wigner3j_square(lo, li, pre) == jm.wigner3j_square(lo, li, pre)
    assert tm._wigner3j_zero_sq(1, 1, 1) == jm._wigner3j_zero_sq(1, 1, 1) == 0


def test_mu2_operators_and_kaiser_formula_match_jax():
    """naive_mu2_delta against the JAX package (a line of sight per cell);
    the Kaiser multipoles 0, 2, 4 on each package's Planck15 background, and
    an ell outside them refused; k2ell and ell2k."""
    mesh = torch.fft.rfftn(torch.as_tensor(MESH1))
    los = torch.as_tensor((POS / RMESH[..., None]).astype(np.float32))
    got = tm.naive_mu2_delta(mesh, los)
    _close(got, jm.naive_mu2_delta(jnp.asarray(mesh.numpy()), jnp.asarray(los.numpy())))

    cosmo_t, cosmo_j = tbg.Planck15(), jbg.Planck15()
    assert cosmo_t._asdict() == cosmo_j._asdict()
    bg_t = tbg.Background.create(cosmo_t, device="cpu")
    bg_j = jbg.Background.create(cosmo_j)
    k = np.logspace(-2, 0, 12).astype(np.float32)
    pk = (1e4 * k / (1 + (k / 0.02) ** 2)).astype(np.float32)
    for a, ells in ((0.5, 0), (0.8, [0, 2, 4])):
        kt, pt = tm.kaiser_formula(bg_t, a, (k, pk), 1.5, ells)
        kj, pj = jm.kaiser_formula(bg_j, a, (jnp.asarray(k), jnp.asarray(pk)), 1.5, ells)
        np.testing.assert_array_equal(kt, np.asarray(kj))
        _close(pt, pj)
    with pytest.raises(NotImplementedError):
        tm.kaiser_formula(bg_t, 0.5, (k, pk), 1.5, 1)
    a = np.array([0.4, 0.7], np.float32)
    _close(bg_t.k2ell(torch.as_tensor(a), torch.as_tensor(k[:2])), bg_j.k2ell(a, k[:2]))
    _close(bg_t.ell2k(torch.as_tensor(a), 100.0), bg_j.ell2k(a, 100.0))


def test_fftk_boxreshape_resample_uniform_match_jax():
    """fftk in cell and physical units, boxreshape cropping, padding and
    both, resample_uniform on a linear and a log grid."""
    for box in (None, (100.0, 200.0, 300.0)):
        for got, want in zip(fftk((6, 4, 8), box), jax_fftk((6, 4, 8), box)):
            np.testing.assert_array_equal(got.numpy(), want)
    for shape in [(8, 8, 8), (20, 20, 20), (8, 20, 16)]:
        np.testing.assert_array_equal(boxreshape(torch.as_tensor(MESH0), shape).numpy(),
                                      np.asarray(jax_boxreshape(jnp.asarray(MESH0), shape)))
    x = np.logspace(-3, 1, 37)
    y = np.sin(x)
    for logx, n in ((False, None), (True, 100)):
        got, want = resample_uniform(x, y, n, logx), jax_resample_uniform(x, y, n, logx)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
