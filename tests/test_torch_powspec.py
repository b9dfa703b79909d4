"""The power-spectrum observable of the port against the JAX package on
the CPU: `spectrum_plan` (equal), the auto and cross multipole `spectrum`
and the auto spectrum's gradient (K9's plain forward and its gather
backward), `BlockMultivariateNormal`, and the `observable='powspec'`
model's value and gradient with tests/test_powspec.py's configuration
(16^3 2LPT, poles 0 and 2, scatter paint; latents unbounded, as in
`model_parity`, whose tolerances hold).

Tolerances: spectra within 1e-5 of the largest multipole (float32 mode
powers summed in another order), their gradients within 1e-4; the
distribution's values and gradients rtol 1e-5 / 1e-4 (float32 triangular
solves); the static covariance's Cholesky factors within 1e-4 (the port's
fiducial spectrum is its own float32 `lin_power`).
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu import metrics as jmet
from montecosmo_tpu.models import distributions as jd

from montecosmo_tpu_torch import metrics as tmet
from montecosmo_tpu_torch.models import distributions as td
from test_torch_likelihoods import model_parity

torch.set_num_threads(1)
BOX = (128.0, 128.0, 128.0)
OBLIQUE = tuple(np.array([0.3, -0.4, 0.866]) / np.linalg.norm([0.3, -0.4, 0.866]))


@pytest.mark.parametrize("shape, kedges, ells, corners, los", [
    ((16, 16, 16), None, (0, 2), False, (0.0, 0.0, 1.0)),
    ((16, 16, 24), 7, (0, 2, 4), True, OBLIQUE),
    ((32, 32, 32), 0.05, (0,), False, (0.0, 0.0, 0.0)),
])
def test_spectrum_plan_equals_jax(shape, kedges, ells, corners, los):
    a = jmet.spectrum_plan(shape, BOX, kedges, ells, corners, los)
    b = tmet.spectrum_plan(shape, BOX, kedges, ells, corners, los)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


@pytest.mark.parametrize("los", [(0.0, 0.0, 1.0), OBLIQUE])
def test_auto_and_cross_spectrum_match_jax(los):
    """Auto and cross multipoles (0, 2, 4) of 16^3 fields, and the VJP of
    the auto multipoles with respect to the field."""
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((16, 16, 16)).astype(np.float32) for _ in range(2))
    kw = dict(box_size=BOX, ells=(0, 2, 4), include_corners=False, los=los)
    xt = torch.tensor(x, requires_grad=True)
    k_t, p_t = tmet.spectrum(xt, **kw)
    k_j, p_j = jmet.spectrum(jnp.asarray(x), **kw)
    np.testing.assert_allclose(k_t, np.asarray(k_j), rtol=1e-12)
    for ell in (0, 2, 4):
        ref = np.asarray(p_j[ell])
        np.testing.assert_allclose(p_t[ell].detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(p_j[0])).max())
    _, c_t = tmet.spectrum(torch.tensor(x), torch.tensor(y), **kw)
    _, c_j = jmet.spectrum(jnp.asarray(x), jnp.asarray(y), **kw)
    for ell in (0, 2, 4):
        np.testing.assert_allclose(c_t[ell].numpy(), np.asarray(c_j[ell]), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(c_j[0])).max())

    ct = rng.standard_normal((3, len(k_t))).astype(np.float32)
    (g,) = torch.autograd.grad(torch.stack([p_t[e] for e in (0, 2, 4)]), xt, torch.tensor(ct))
    _, vjp = jax.vjp(lambda z: jnp.stack([jmet.spectrum(z, **kw)[1][e] for e in (0, 2, 4)]),
                     jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(gj)).max())


def test_block_multivariate_normal_matches_jax():
    """log_prob and log_cdf (per element) of stacked (D, B) multipoles with
    per-block lower triangular factors, their gradients in the value, the
    mean and the factors; and sample moments (the covariance L L^T of each
    block within 5% over 2e4 draws)."""
    rng = np.random.default_rng(1)
    D, B = 3, 6
    tril = np.tril(0.3 * rng.standard_normal((B, D, D)))
    tril += np.eye(D) * (1.0 + 0.2 * np.arange(B)[:, None, None])
    tril = tril.astype(np.float32)
    loc, value = (rng.standard_normal((D, B)).astype(np.float32) for _ in range(2))
    for name in ("log_prob", "log_cdf"):
        args_t = [torch.tensor(a, requires_grad=True) for a in (value, loc, tril)]
        out = getattr(td.BlockMultivariateNormal(args_t[1], args_t[2]), name)(args_t[0])
        gt = torch.autograd.grad(out.sum(), args_t)
        fj = lambda v, m, L: getattr(jd.BlockMultivariateNormal(m, L), name)(v)
        oj = fj(*map(jnp.asarray, (value, loc, tril)))
        gj = jax.jit(jax.grad(lambda *a: fj(*a).sum(), argnums=(0, 1, 2)))(
            *map(jnp.asarray, (value, loc, tril)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(oj), rtol=1e-5, atol=1e-6)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4 * np.abs(np.asarray(b)).max())
    gen = torch.Generator().manual_seed(0)
    d = td.BlockMultivariateNormal(torch.tensor(loc), torch.tensor(tril))
    x = torch.stack([d.sample(gen) for _ in range(20000)]).double()
    dev = x - x.mean(0)
    cov = torch.einsum("nib,njb->bij", dev, dev) / (x.shape[0] - 1)
    want = torch.tensor(tril, dtype=torch.float64) @ torch.tensor(tril, dtype=torch.float64).mT
    assert float((cov - want).abs().max() / want.abs().max()) < 0.05


POWSPEC = dict(final_shape=(16, 16, 16), cell_length=8.0, box_center=(0.0, 0.0, 500.0),
               evolution="lpt", observable="powspec", poles=(0, 2), a_obs=0.5,
               curved_sky=False, paint_method="scatter", n_rbins=None)


def test_powspec_model_matches_jax():
    """The powspec model: the static binning equal to the JAX model's and
    its covariance factors within 1e-4, the logpdf value and gradient
    (`model_parity`, the observation the port's predicted draw), and
    `powspec_obs` / `obs_data` on a count mesh."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default
    from test_torch_likelihoods import BASE

    tm, p, obs = model_parity(site="powspec", **POWSPEC)
    jm = JaxModel(**{**jax_default, **BASE, **POWSPEC})
    st_t, st_j = tm._powspec_static(), jm._powspec_static()
    np.testing.assert_array_equal(st_t["kedges"], st_j["kedges"])
    np.testing.assert_array_equal(st_t["kmean"], st_j["kmean"])
    np.testing.assert_allclose(st_t["tril"].numpy(), st_j["tril"], rtol=1e-4,
                               atol=1e-4 * np.abs(st_j["tril"]).max())
    assert obs.shape == (2, len(st_t["kmean"]))

    counts = np.random.default_rng(2).poisson(3.0, tm.final_shape).astype(np.float32)
    tm.count_mesh = torch.tensor(counts)
    got = tm.obs_data()["powspec"]
    ref = np.asarray(jm.powspec_obs(jnp.asarray(counts)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    tm.powspec_data = obs
    assert tm.obs_data()["powspec"] is obs
