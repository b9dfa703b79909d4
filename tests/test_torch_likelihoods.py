"""The port's field likelihoods against the JAX package on the CPU: the
distributions (`Poisson`, `SinhArcsinh`, `TwoQuadGaussian`, and the cdfs
of `Normal` and `QuadGaussian`) with their gradients, each `lik_type`'s
model logpdf value and gradient at 8^3, and `Model.logdf_mesh`.

`model_parity` is shared with the other model tests of the slice
(test_torch_kaiser_evolution.py, test_torch_powspec.py,
test_torch_eulerian.py).  It takes tests/test_model_variants.py's `BASE`
(8^3, cell 40 Mpc/h, Kaiser evolution at a_obs 0.5, flat sky, Kaiser
preconditioning, one radial bin) with every latent unbounded (no
low/high): the truncated-normal transports of the bounded priors cost ~25
s of each JAX compile here and are held against JAX with their bounds in
test_torch_model.py.  The JAX side is the package's model built and run in
float64 (jax.enable_x64), one compile a case: it is what the JAX package's
float32 approximates (where the AP remap reads the fiducial distances its
float32 gradient is off its own float64 one by up to 30%, test_torch_ap.py),
and it was already the reference of ngbars_.  Tolerances, the port's
float32 against it:
* logpdf: 1e-5 relative (a float32 sum over the mesh in another order);
* white_mesh_: rtol 1e-3, atol 1e-3 of its largest entry (measured
  <= 1e-4);
* each scalar latent: atol 1e-2 of its largest gradient in the port run in
  float64, rtol 1e-3: a scalar's gradient is a sum over the mesh that can
  cancel, and both float32 packages sit up to 3.5e-3 (port) and 6.5e-3
  (JAX) of it off float64 (measured, Eulerian bias);
* ngbars_ (scale_fid 1e-7: its gradient cancels to ~1e-4 of its terms):
  the port run in float64 against JAX's float64 at 3e-2 of its value (measured: 1.4e-2 on the curved sky, 1.3e-3 at a_obs
  0.5, <= 1.5e-5 for the other lik_types; the JAX model keeps some float32
  constants), and the port's float32 run against its float64 run at 5e-2
  (measured: port 2.2e-2, JAX's float32 4.0e-2 on the curved sky).
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp
from jax.scipy.special import gammaincc as jgammaincc

from montecosmo_tpu.models import distributions as jd

from montecosmo_tpu_torch import FieldLevelModel, default_config
from montecosmo_tpu_torch.convert import params_from_numpy
from montecosmo_tpu_torch.models import distributions as td

torch.set_num_threads(1)

UNBOUNDED = {k: {kk: vv for kk, vv in v.items() if kk not in ("low", "high")}
             for k, v in default_config["latents"].items()}
# tests/test_model_variants.py's BASE, every latent unbounded
BASE = dict(final_shape=(8, 8, 8), cell_length=40.0, evolution="kaiser", a_obs=0.5,
            curved_sky=False, box_center=(0.0, 0.0, 1000.0), precond="kaiser",
            init_oversamp=1.0, evol_oversamp=1.0, ptcl_oversamp=1.0, paint_oversamp=1.0,
            n_rbins=1, latents=UNBOUNDED)


def parity_inputs(conf, move_s_e2, x64=False):
    """Both models of `conf` (the JAX one built under jax.enable_x64 with
    `x64`: its fiducial tables in float64), the sample-space latents
    (fiducial + 0.3 sigma, s_e2_ left at 0 unless `move_s_e2`) and a white
    mesh, float32 numpy."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default

    with jax.enable_x64(x64):
        jm = JaxModel(**{**jax_default, **conf})
    tm = FieldLevelModel(**{**default_config, **conf}, device="cpu")
    rng = np.random.default_rng(0)
    p = {k: np.asarray(v, np.float32) for k, v in jm.reparam(dict(jm.fiduc), inv=True).items()}
    for k in p:
        if k != "s_e2_" or move_s_e2:
            p[k] = (p[k] + 0.3 * rng.standard_normal(np.shape(p[k]))).astype(np.float32)
    p["white_mesh_"] = rng.standard_normal(jm.init_shape).astype(np.float32)
    return jm, tm, p


# the JAX package's float64 value_and_grad of each model case, compiled once
# per process: the latents and the observation are its arguments
JAX_PROGRAMS = {}


def jax_logpdf_program(jm, key):
    """(jm, the jitted float64 `value_and_grad` of `jm.logpdf` (latents q,
    observation o); call it under jax.enable_x64), cached under `key`."""
    if key not in JAX_PROGRAMS:
        JAX_PROGRAMS[key] = (jm, jax.jit(jax.value_and_grad(lambda q, o: jm.logpdf({**q, **o}))))
    return JAX_PROGRAMS[key]


def model_parity(site="count_mesh", move_s_e2=False, **updates):
    """The logpdf value and gradient of BASE with `updates`: the port's
    float32 run against the JAX package's model built and run in float64
    (jax.enable_x64; one compile a case), on the same numpy latents and the
    same observation (drawn by the port's `predict`), at the module's
    tolerances.  Returns the port's model, the latents and the
    observation."""
    key = (site, move_s_e2, repr(sorted(updates.items())))
    jm, tm, p = parity_inputs({**BASE, **updates}, move_s_e2, x64=True)
    jm, vg64 = jax_logpdf_program(jm, key)
    obs = tm.predict(seed=1, samples=params_from_numpy(p, "cpu"), hide_samp=False)[site]
    assert torch.isfinite(obs).all()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tp = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in p.items()}
        lp = tm.logpdf({**tp, site: obs.to(dtype)})
        lp.backward()
        grads[dtype] = (lp.item(), {k: v.grad.numpy() for k, v in tp.items()})
    with jax.enable_x64(True):
        lj, gj = vg64({k: jnp.asarray(v, jnp.float64) for k, v in p.items()},
                      {site: jnp.asarray(obs.numpy(), jnp.float64)})
        lj, gj = float(lj), {k: np.asarray(v) for k, v in gj.items()}
    lt, g32 = grads[torch.float32]
    hold_value_and_grad(lt, g32, grads[torch.float64][1], lj, gj)
    return tm, p, obs


def hold_value_and_grad(lt, g32, g64, lj, gj):
    """The port's float32 logpdf `lt` and gradient `g32` (its float64 run's
    `g64`) against the JAX package's float64 `lj`, `gj`, at the module's
    tolerances."""
    assert np.isfinite(lt) and abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
    assert set(gj) == set(g32)
    for k, gk in gj.items():
        scale = max(np.abs(g64[k]).max(), 1e-30)
        if k == "white_mesh_":
            np.testing.assert_allclose(g32[k], gk, rtol=1e-3, atol=1e-3 * scale, err_msg=k)
        elif k == "ngbars_":
            np.testing.assert_allclose(g64[k], gk, rtol=3e-2, atol=0, err_msg=k)
            np.testing.assert_allclose(g32[k], g64[k], rtol=5e-2, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g32[k], gk, rtol=1e-3, atol=1e-2 * scale, err_msg=k)


# ======================================================================= distributions
def _both(fn_t, fn_j, args, wrt):
    """fn(*args) and the gradient of its sum with respect to args[wrt] in
    both packages (float32)."""
    targs = [torch.tensor(a, requires_grad=i in wrt) for i, a in enumerate(args)]
    out_t = fn_t(*targs)
    grads_t = torch.autograd.grad(out_t.sum(), [targs[i] for i in wrt])
    jargs = [jnp.asarray(a) for a in args]
    out_j = fn_j(*jargs)
    grads_j = jax.grad(lambda *a: fn_j(*a).sum(), argnums=tuple(wrt))(*jargs)
    return out_t.detach().numpy(), np.asarray(out_j), [g.numpy() for g in grads_t], [
        np.asarray(g) for g in grads_j]


def _close(a, b, rtol):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_poisson_matches_jax():
    """log_prob, cdf and log_cdf of counts around their rates, and their
    gradients in the rate (log_cdf through Q(floor(v) + 1, rate)): rtol
    1e-5 (float32 lgamma, xlogy, gammaincc)."""
    rng = np.random.default_rng(0)
    rate = rng.uniform(0.5, 20.0, 200).astype(np.float32)
    value = rng.poisson(rate).astype(np.float32)
    for name in ("log_prob", "cdf", "log_cdf"):
        ot, oj, gt, gj = _both(lambda v, r: getattr(td.Poisson(r), name)(v),
                               lambda v, r: getattr(jd.Poisson(r), name)(v), (value, rate), (1,))
        _close(ot, oj, 1e-5)
        _close(gt[0], gj[0], 1e-4)
    q = td.Poisson(torch.tensor(rate)).cdf(torch.tensor(value))
    np.testing.assert_allclose(q.numpy(), np.asarray(jgammaincc(value + 1, rate)), rtol=1e-5)


def test_normal_and_quad_gaussian_cdfs_match_jax():
    """Normal's cdf/log_cdf and QuadGaussian's (the JAX package's completed
    square), its curvature of either sign and the linear branch, values
    and gradients in value, loc and the scales: rtol 1e-4."""
    rng = np.random.default_rng(1)
    loc = rng.normal(size=300).astype(np.float32)
    s1 = rng.uniform(0.5, 2.0, 300).astype(np.float32)
    value = (loc + s1 * rng.normal(size=300)).astype(np.float32)
    for name in ("cdf", "log_cdf"):
        ot, oj, gt, gj = _both(lambda v, m, s: getattr(td.Normal(m, s), name)(v),
                               lambda v, m, s: getattr(jd.Normal(m, s), name)(v),
                               (value, loc, s1), (0, 1, 2))
        _close(ot, oj, 1e-5)
        for a, b in zip(gt, gj):
            _close(a, b, 1e-4)
    for s2 in (0.3, -0.2, 0.0):
        s2s = np.full(300, s2, np.float32)
        for name in ("cdf", "log_cdf"):
            ot, oj, gt, gj = _both(
                lambda v, m, a, b: getattr(td.QuadGaussian(m, a, b), name)(v),
                lambda v, m, a, b: getattr(jd.QuadGaussian(m, a, b), name)(v),
                (value, loc, s1, s2s), (0, 1, 2, 3))
            finite = np.isfinite(oj)
            np.testing.assert_array_equal(np.isfinite(ot), finite)
            _close(ot[finite], oj[finite], 1e-5)
            for a, b in zip(gt, gj):
                _close(a, b, 1e-4)


@pytest.mark.parametrize("cls", ["SinhArcsinh", "TwoQuadGaussian"])
def test_shash_and_two_quad_gaussian_match_jax(cls):
    """log_prob, cdf and log_cdf, and their gradients in the value and
    every parameter: rtol 1e-4 (float32 quadratures of 20 and 64 nodes)."""
    rng = np.random.default_rng(2)
    n = 200
    loc = rng.normal(size=n).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    value = (loc + scale * rng.normal(size=n)).astype(np.float32)
    if cls == "SinhArcsinh":
        third = rng.uniform(-0.5, 0.5, n).astype(np.float32)       # skewness
        fourth = rng.uniform(0.8, 1.3, n).astype(np.float32)       # tailweight
        args = (value, loc, scale, third, fourth)
    else:
        third = rng.uniform(-0.5, 0.5, n).astype(np.float32)       # scale2
        args = (value, loc, scale, third)
    for name in ("log_prob", "cdf", "log_cdf"):
        ot, oj, gt, gj = _both(lambda v, *a: getattr(getattr(td, cls)(*a), name)(v),
                               lambda v, *a: getattr(getattr(jd, cls)(*a), name)(v),
                               args, tuple(range(len(args))))
        _close(ot, oj, 1e-5)
        for a, b in zip(gt, gj):
            _close(a, b, 1e-4)


@pytest.mark.parametrize("cls", ["Poisson", "SinhArcsinh", "TwoQuadGaussian"])
def test_samples_have_the_distribution_moments(cls):
    """`sample` with an explicit torch.Generator: the batch shape, the mean
    within 5 standard errors of 4e5 draws and the variance within 5% (its
    standard error is below 1% at these kurtoses); Poisson: the rate, the
    others: loc and std^2 (scale1^2 + 2 scale2^2)."""
    gen = torch.Generator().manual_seed(0)
    n = 400_000
    if cls == "Poisson":
        d, mean, var = td.Poisson(torch.full((n,), 3.5)), 3.5, 3.5
    elif cls == "SinhArcsinh":
        d = td.SinhArcsinh(torch.full((n,), 1.0), torch.tensor(2.0), torch.tensor(0.3),
                           torch.tensor(1.1))
        mean, var = 1.0, 4.0
    else:
        d, mean, var = td.TwoQuadGaussian(torch.full((n,), 1.0), 2.0, 0.5), 1.0, 4.5
    x = d.sample(gen).double()
    assert x.shape == (n,)
    se = (var / n) ** 0.5
    assert abs(x.mean().item() - mean) < 5 * se
    assert abs(x.var().item() - var) < 0.05 * var


# ======================================================================= model
@pytest.mark.parametrize("lik", ["poisson", "fourier_gauss", "two_quad_gauss", "shash"])
def test_lik_type_logpdf_and_grad_match_jax(lik):
    """Each lik_type's 8^3 logpdf value and gradient (two_quad_gauss and
    shash with s_e2 moved off 0, so that their own shapes count; BASE's own
    quad_gauss is test_torch_kaiser_evolution.py's flat-sky case)."""
    model_parity(lik_type=lik, move_s_e2=lik in ("two_quad_gauss", "shash"))


@pytest.mark.parametrize("lik", ["poisson", "fourier_gauss", "two_quad_gauss", "shash"])
def test_logdf_mesh_matches_jax(lik):
    """Model.logdf_mesh: the per-voxel log-pdf and log-cdf of the count
    mesh at the same latents and observation, rtol 1e-4 of the largest
    entry (quad_gauss's log-cdf is held in the distribution test above)."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default

    conf = {**BASE, "lik_type": lik}
    jm, tm, p = parity_inputs(conf, lik in ("two_quad_gauss", "shash"))
    obs = tm.predict(seed=1, samples=params_from_numpy(p, "cpu"), hide_samp=False)["count_mesh"]
    lpdf, lcdf = tm.logdf_mesh({**p, "count_mesh": obs.numpy()})
    ref = jax.jit(jm.logdf_mesh)({**{k: jnp.asarray(v) for k, v in p.items()},
                                  "count_mesh": jnp.asarray(obs.numpy())})
    for got, want in zip((lpdf, lcdf), ref):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_fourier_gauss_count2delta_and_kaiser_start():
    """The fourier_gauss counts are the real packing of their rfft:
    count2delta unpacks them (irfftn(rg2cgh)) to the overdensity of the
    count mesh, and the Kaiser start is finite."""
    from montecosmo_tpu_torch.ops.fourier import rfftn
    from montecosmo_tpu_torch.ops.hermitian import cgh2rg

    tm = FieldLevelModel(**{**default_config, **BASE, "lik_type": "fourier_gauss"}, device="cpu")
    counts = torch.tensor(np.random.default_rng(3).uniform(0.5, 1.5, (8, 8, 8)),
                          dtype=torch.float32)
    ref = FieldLevelModel(**{**default_config, **BASE}, device="cpu").count2delta(counts)
    torch.testing.assert_close(tm.count2delta(cgh2rg(rfftn(counts))), ref, rtol=1e-5,
                               atol=1e-5)
    tm.count_mesh = cgh2rg(rfftn(counts))
    start = tm.kaiser_post(0)
    assert torch.isfinite(start["white_mesh_"]).all()
