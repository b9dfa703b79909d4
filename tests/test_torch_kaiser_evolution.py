"""The Kaiser evolution of the port against the JAX package on the CPU:
the curved-sky mu^2 operator `optim_mu2_delta`, `kaiser_model` in its
three regimes (flat sky at one scale factor, the flat-sky light cone, the
curved sky), and `FieldLevelModel(evolution='kaiser')`'s logpdf value and
gradient in each regime at 8^3 (`model_parity`, its tolerances in
test_torch_likelihoods.py).

Tolerances of the operator tests (float32 FFTs in another order): values
within 1e-5 of the largest entry, gradients (the VJP of a random
cotangent) within 1e-4 of the largest.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu import metrics as jmet
from montecosmo_tpu.models import bricks as jbr
from montecosmo_tpu.ops import background as jbg

from montecosmo_tpu_torch import FieldLevelModel, default_config, metrics as tmet
from montecosmo_tpu_torch.models import bricks as tbr
from montecosmo_tpu_torch.ops import background as tbg
from test_torch_likelihoods import BASE, model_parity

torch.set_num_threads(1)
SHAPE = (16, 16, 16)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _los_field(curved, rng):
    """A per-cell unit line of sight (16^3, 3): one direction everywhere
    (flat) or each cell's direction from an observer outside the box."""
    if not curved:
        u = np.broadcast_to(np.array([0.3, -0.4, 0.866], np.float32), SHAPE + (3,))
        return (u / np.linalg.norm(u, axis=-1, keepdims=True)).astype(np.float32)
    pos = np.stack(np.meshgrid(*[np.arange(16.0)] * 3, indexing="ij"), -1) - 8.0
    pos = pos + np.array([3.0, -2.0, 40.0]) + 0.1 * rng.standard_normal(pos.shape)
    return (pos / np.linalg.norm(pos, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("curved", [False, True])
def test_optim_mu2_delta_matches_jax(curved):
    """(delta, mu2_delta) of a 16^3 rfft mesh against JAX's
    optim_mu2_delta, and its VJP with respect to the real field (through
    rfftn); on the flat line of sight also against JAX's naive_mu2_delta
    (two mu-projections, 8 FFTs), the same operator there off the kz = 0
    and Nyquist planes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    los = _los_field(curved, rng)
    ct = rng.standard_normal((2,) + SHAPE).astype(np.float32)

    xt = torch.tensor(x, requires_grad=True)
    out = torch.stack(tmet.optim_mu2_delta(torch.fft.rfftn(xt), torch.tensor(los)))
    (gt,) = torch.autograd.grad(out, xt, torch.tensor(ct))
    fj = lambda y: jnp.stack(jmet.optim_mu2_delta(jnp.fft.rfftn(y), jnp.asarray(los)))
    oj, vjp = jax.vjp(fj, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(ct))
    _close(out.detach(), oj, 1e-5)
    _close(gt, gj, 1e-4)
    if not curved:
        # the naive projections' irffts of k_i / |k| delta (odd in k, no
        # factor i) lose their parts on the kz = 0 and Nyquist planes, which
        # the Y_2m products (even in k) keep: compare off those planes
        mesh = np.fft.rfftn(x)
        mesh[8], mesh[:, 8], mesh[..., 8], mesh[..., 0] = 0, 0, 0, 0
        naive = jmet.naive_mu2_delta(jnp.asarray(mesh.astype(np.complex64)),
                                     jnp.asarray(los[0, 0, 0]))
        mu2 = tmet.optim_mu2_delta(torch.tensor(mesh.astype(np.complex64)), torch.tensor(los))[1]
        _close(mu2, naive, 1e-5)


REGIMES = {"flat": dict(a_obs=0.5, curved_sky=False),
           "flat light cone": dict(a_obs=None, curved_sky=False),
           "curved": dict(a_obs=None, curved_sky=True)}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_kaiser_model_matches_jax(regime):
    """kaiser_model on a 16^3 linear field (box 1000 Mpc/h) against JAX's:
    one scale factor and direction (flat), a per-cell scale factor in [0.4,
    0.7] (flat light cone), or per-cell scale factors and lines of sight
    (curved); values, and the VJP with respect to the real linear field
    and b1E."""
    rng = np.random.default_rng(1)
    box = np.array([1000.0] * 3)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    if regime == "flat":
        a, los = 0.5, np.array([0.0, 0.0, 1.0])
    else:
        a = rng.uniform(0.4, 0.7, SHAPE).astype(np.float32)
        los = np.array([0.0, 0.0, 1.0]) if regime == "flat light cone" else _los_field(True, rng)
    ct = rng.standard_normal(SHAPE).astype(np.float32)
    cosmo_t = tbg.get_cosmology(Omega_m=0.31, sigma8=0.81)
    cosmo_j = jbg.get_cosmology(Omega_m=0.31, sigma8=0.81)
    bg_t, bg_j = tbg.Background.create(cosmo_t), jbg.Background.create(cosmo_j)

    xt, bt = torch.tensor(x, requires_grad=True), torch.tensor(1.7, requires_grad=True)
    at = a if np.ndim(a) == 0 else torch.tensor(a)
    lt = torch.tensor(los, dtype=torch.float32) if np.ndim(los) == 4 else los
    out = tbr.kaiser_model(cosmo_t, at, torch.fft.rfftn(xt), box, bt, los=lt, bg=bg_t)
    gx, gb = torch.autograd.grad(out, (xt, bt), torch.tensor(ct))

    def fj(y, b):
        return jbr.kaiser_model(cosmo_j, jnp.asarray(a), jnp.fft.rfftn(y), box, b,
                                los=jnp.asarray(los, jnp.float32), bg=bg_j)

    oj, vjp = jax.vjp(fj, jnp.asarray(x), jnp.float32(1.7))
    gxj, gbj = vjp(jnp.asarray(ct))
    _close(out.detach(), oj, 1e-5)
    _close(gx, gxj, 1e-4)
    np.testing.assert_allclose(gb.item(), float(gbj), rtol=1e-4)


def test_kaiser_png_and_ap_are_refused():
    """The PNG term of kaiser_model and the Kaiser evolution's AP
    re-sampling raise, naming their ROADMAP items."""
    cosmo = tbg.get_cosmology(Omega_m=0.31, sigma8=0.81)
    with pytest.raises(NotImplementedError, match="Queue A item 4 \\(PNG\\)"):
        tbr.kaiser_model(cosmo, 0.5, torch.zeros(8, 8, 5, dtype=torch.complex64), (100.0,) * 3,
                         2.0, png_type="fNL")
    with pytest.raises(NotImplementedError, match="Queue A item 4 \\(AP\\)"):
        FieldLevelModel(**{**default_config, **BASE, "ap_auto": True}, device="cpu")


@pytest.mark.parametrize("regime", list(REGIMES))
def test_kaiser_evolution_logpdf_and_grad_match_jax(regime):
    """FieldLevelModel(evolution='kaiser') at 8^3 in each regime (the curved
    sky with the observer at the box center, as the JAX package's default
    sky)."""
    updates = dict(REGIMES[regime])
    if regime == "curved":
        updates["box_center"] = (0.0, 0.0, 0.0)
    tm, _, _ = model_parity(**updates)
    assert tm.evolution == "kaiser"
