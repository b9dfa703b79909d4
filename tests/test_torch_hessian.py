"""Second derivatives of the port (the double backward through K1-K5, with
K6 `paint_cic_grad` and K7 `read_cic_hess`) against the JAX package, on the
CPU.

* Hessian-vector products of a scalar functional (a linear plus a
  quadratic term, so that the cotangent meshes depend on the inputs too) of
  `paint` (the scatter) and the clamped lattice paint
  (`paint_window(clip=True)` in JAX), of `read_multi` and the clamped
  `read_window`, and of `nufft` (clamped, interlaced, deconvolved), at
  B-spline orders 1-4, against `jax.jvp(jax.grad(...))` of the JAX
  functions on the same numpy inputs; particles off ties and off |d| = H
  (outliers well past it).  float32: rtol 1e-4 with atol 1e-5 of the
  largest entry (sums of up to 2 x 64 corner terms, three kernels deep).
* The autograd Function chain (`_PaintCIC` -> `_PaintCICAdjoint` -> K6/K7,
  `_ReadCIC` -> `_ReadCICAdjoint`, `_NufftEpilogue` ->
  `_NufftEpilogueAdjoint`) against autograd twice through the plain
  versions, in float64 at 1e-10; Kaiser-Bessel windows refuse a double
  backward, naming their ROADMAP item.
* The port's counterpart of tests/test_hessian_finite.py: the 3x3 Hessian
  (`script.block_hessian`) of the 8^3 model's logpdf in {Omega_m_,
  sigma8_, b1_} for `lpt` and `nbody` is finite, nonzero and within rtol
  2e-3 (atol 1e-3 of the largest entry: the port's float32 value+grads of
  ~10^3 terms, differentiated once more) of the JAX package's, central
  differences of its float64 gradient (within 4.3e-4 of its float32
  forward-over-reverse one, which takes 4x longer to compile; measured);
  the port's `_laplace_seed` of
  the block on the model against the JAX package's on the quadratic of
  JAX's Hessian (its curvatures at 2e-3, the inverse at 5e-3: an inverse
  amplifies the Hessian's float32 error by its condition number); for lpt,
  the port's Hutchinson `marginal_covariance` of the block given
  white_mesh_ on the model against the same Schur complement formed from
  JAX's own HVPs with the same 4 Rademacher probes (5e-3 of the largest
  entry, its inverse 2e-2: measured 2.6e-6 and 1.6e-5).
"""
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu.ops.paint import nufft as jnufft, paint as jpaint, read_multi as jread_multi
from montecosmo_tpu.ops.paint_window import paint_window as jpaint_window, read_window as jread_window

from montecosmo_tpu_torch.convert import params_from_numpy
from montecosmo_tpu_torch.ops import hermitian as the, paint as tpa
from montecosmo_tpu_torch.script import _laplace_seed, block_hessian

from test_torch_card import _lattice_particles

torch.set_num_threads(1)

ORDERS = (1, 2, 3, 4)
LATTICE, STRIDE, H, SHAPE = (8, 8, 8), (2, 2, 2), 3, (16, 16, 16)
SCATTER_SHAPE, FINAL = (12, 10, 8), (12, 12, 12)
NAMES = ("paint", "paint_window", "read_multi", "read_window", "nufft")


def _inputs():
    rng = np.random.default_rng(50)
    pos, w = _lattice_particles(LATTICE, STRIDE, H, 51)
    n = len(pos)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        pos=pos, w=w, spos=rng.uniform(-3, 15, (n, 3)).astype(np.float32), sw=w,
        g=f(*SHAPE), d=f(*SHAPE), sg=f(*SCATTER_SHAPE), sd=f(*SCATTER_SHAPE),
        mesh=f(*SHAPE, 3), smesh=f(*SCATTER_SHAPE, 3), ct=f(n, 3), e=f(n, 3),
        cre=f(*the.r2chshape(FINAL)), cim=f(*the.r2chshape(FINAL)), dk=f(*the.r2chshape(FINAL)),
        vpos=f(n, 3), vw=f(n), vmesh=f(*SHAPE, 3), vsmesh=f(*SCATTER_SHAPE, 3))


def _quad(out, lin, sq):
    return (out * lin).sum() + 0.5 * (sq * out * out).sum()


def _functionals(lib, x, order):
    """name -> (scalar functional of two arguments, its inputs, the
    direction), with `lib` the JAX package's functions or the port's."""
    if lib == "jax":
        paint_s = lambda p, w: jpaint(p, SCATTER_SHAPE, w, order)
        paint_w = lambda p, w: jpaint_window(p, SHAPE, LATTICE, w, order, max_disp=H, clip=True)
        read_m = lambda p, m: jread_multi(p, [m[..., c] for c in range(3)], order)
        read_w = lambda p, m: jread_window(p, m, LATTICE, order, max_disp=H, clip=True)
        nufft = lambda p, w: jnufft(p, FINAL, SHAPE, w, paint_order=order,
                                    lattice_shape=LATTICE, max_disp=H, clip=True)
    else:
        paint_s = lambda p, w: tpa.paint(p, SCATTER_SHAPE, w, order)
        paint_w = lambda p, w: tpa.paint(p, SHAPE, w, order, lattice_shape=LATTICE, max_disp=H,
                                         clip=True)
        read_m = lambda p, m: tpa.read_multi(p, m, order)
        read_w = lambda p, m: tpa.read_window(p, m, LATTICE, order, max_disp=H, clip=True)
        nufft = lambda p, w: tpa.nufft(p, FINAL, SHAPE, w, paint_order=order,
                                       lattice_shape=LATTICE, max_disp=H, clip=True)
    s = np.float32(12 / 16)

    def nufft_loss(p, w):
        out = nufft(p, w)
        return (out.real * x["cre"] + out.imag * x["cim"]).sum() + 0.5 * (
            x["dk"] * (out.real**2 + out.imag**2)).sum()

    return {
        "paint": (lambda p, w: _quad(paint_s(p, w), x["sg"], x["sd"]), (x["spos"], x["sw"]),
                  (x["vpos"], x["vw"])),
        "paint_window": (lambda p, w: _quad(paint_w(p, w), x["g"], x["d"]), (x["pos"], x["w"]),
                         (x["vpos"], x["vw"])),
        "read_multi": (lambda p, m: _quad(read_m(p, m), x["ct"], x["e"]),
                       (x["spos"], x["smesh"]), (x["vpos"], x["vsmesh"])),
        "read_window": (lambda p, m: _quad(read_w(p, m), x["ct"], x["e"]), (x["pos"], x["mesh"]),
                        (x["vpos"], x["vmesh"])),
        "nufft": (nufft_loss, (x["pos"] * s, x["w"]), (x["vpos"], x["vw"]))}


@lru_cache(maxsize=None)
def _jax_hvps(order):
    """jvp(grad(f)) of the five JAX functionals at `order`, one compile."""
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}

    def run(x):
        out = {}
        for name, (f, args, vs) in _functionals("jax", x, order).items():
            out[name] = jax.jvp(jax.grad(f, (0, 1)), args, vs)[1]
        return out

    return jax.tree.map(np.asarray, jax.jit(run)(x))


def _torch_hvp(f, args, vs):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    grads = torch.autograd.grad(f(*leaves), leaves, create_graph=True, allow_unused=True)
    dot = sum((g * v).sum().real for g, v in zip(grads, vs) if g is not None)
    out = torch.autograd.grad(dot, leaves, allow_unused=True)
    return [torch.zeros_like(a) if o is None else o for a, o in zip(leaves, out)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", NAMES)
def test_hvp_matches_jax(name, order):
    x = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    f, args, vs = _functionals("torch", x, order)[name]
    got = _torch_hvp(f, args, vs)
    ref = _jax_hvps(order)[name]
    for g, r, what in zip(got, ref, ("positions", "second input")):
        r = np.asarray(r)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-30),
                                   err_msg=f"{name} order {order}: {what}")
    if order > 1:  # a second derivative, not zeros
        assert np.abs(got[0].numpy()).max() > 0


def _f64(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("clip", [True, False])
def test_function_chain_double_backward_matches_plain_autograd(order, clip):
    """HVPs through the Functions (the CPU wrappers: K2's, K5's, K6's and
    K7's plain versions) against autograd twice of paint_cic_plain /
    read_cic_plain, float64, for 2 interlace shifts and C = 3 channels."""
    x = _inputs()
    pos, w, vpos, vw = _f64(x["pos"], x["w"], x["vpos"], x["vw"])
    pos[:5] += 4.0  # past the clamp bound on every axis
    g2, d2 = _f64(np.stack([x["g"], x["d"]]), np.stack([x["d"], x["g"]]))
    mesh, ct, e, vmesh = _f64(x["mesh"], x["ct"], x["e"], x["vmesh"])
    lat = LATTICE if clip else None
    gp = tpa.cic_geometry(SHAPE, 2, lat, H, clip, order)
    gr = tpa.cic_geometry(SHAPE, 1, lat, H, clip, order)
    cases = (
        ((pos, w), (vpos, vw), lambda p, ww: _quad(tpa._PaintCIC.apply(p, ww, gp), g2, d2),
         lambda p, ww: _quad(tpa.paint_cic_plain(p, ww, gp), g2, d2)),
        ((pos, mesh), (vpos, vmesh), lambda p, m: _quad(tpa._ReadCIC.apply(p, m, gr), ct, e),
         lambda p, m: _quad(tpa.read_cic_plain(p, m, gr), ct, e)))
    for args, vs, chain, plain in cases:
        for a, b in zip(_torch_hvp(chain, args, vs), _torch_hvp(plain, args, vs)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10 * max(b.abs().max().item(), 1e-30))


def test_nufft_epilogue_double_backward():
    """K3 is linear: its backward's backward is itself.  An HVP of a real
    functional through the Functions against autograd twice of its plain
    arithmetic."""
    rng = np.random.default_rng(3)
    eg = tpa.EpilogueGeometry((8, 8, 8), 2, 1.3, 2, None)
    shape = (2,) + the.r2chshape((8, 8, 8))
    cplx = lambda *s: torch.complex(*(torch.as_tensor(rng.standard_normal(s)) for _ in range(2)))
    fk, v, c = cplx(*shape), cplx(*shape), cplx(*shape[1:])
    dk = torch.as_tensor(rng.standard_normal(shape[1:]))

    def loss(epi):
        return lambda z: (epi(z) * c.conj()).real.sum() + 0.5 * (dk * epi(z).abs() ** 2).sum()

    got = _torch_hvp(loss(lambda z: tpa._NufftEpilogue.apply(z, eg)), (fk,), (v,))[0]
    ref = _torch_hvp(loss(lambda z: tpa._epilogue_math(z, eg, False)), (fk,), (v,))[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_kaiser_bessel_double_backward_is_not_ported():
    x = _inputs()
    pos, w = (torch.as_tensor(x[k]).requires_grad_(True) for k in ("pos", "w"))
    m = tpa.paint(pos, SHAPE, w, 3, "kaiser_bessel", lattice_shape=LATTICE, max_disp=H, clip=True)
    (gp,) = torch.autograd.grad((m * m).sum(), pos, create_graph=True)
    with pytest.raises(NotImplementedError, match="Queue B item 10"):
        torch.autograd.grad(gp.sum(), pos)


# ------------------------------------------------- model Hessian (8^3)
HESS_KEYS = ("Omega_m_", "b1_", "sigma8_")  # sorted: the ravel order of both packages
N_PROBES = 4


MODEL_CONF = dict(final_shape=3 * (8,), cell_length=40.0, lpt_order=2, a_obs=0.5,
                  curved_sky=False, box_center=(0.0, 0.0, 1000.0), lik_type="quad_gauss",
                  precond="kaiser", init_oversamp=1.0, evol_oversamp=1.0, ptcl_oversamp=1.0,
                  paint_oversamp=1.0)


FD_STEP = 1e-3  # the central differences' step along each tangent (sample-space units)


def _lower_jax_gradient(evolution):
    """One evolution's case: the port's model, the counts it predicts at the
    fiducial point and a seeded white mesh, the tangents (the 3 scalar
    columns and, for lpt, over (scalars, white_mesh_) the field's
    Hutchinson probes too), and the JAX package's gradient of the same
    logpdf in float64 (jax.enable_x64), lowered with the point and the
    observation as its arguments."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    conf = dict(MODEL_CONF, evolution=evolution)
    jm = JaxModel(**{**jax_default, **conf})
    tm = FieldLevelModel(**{**default_config, **conf}, device="cpu")
    rng = np.random.default_rng(7)
    truth = {k: np.asarray(v, np.float32) for k, v in jm.reparam(dict(jm.fiduc), inv=True).items()}
    truth["white_mesh_"] = rng.standard_normal(jm.init_shape).astype(np.float32)
    count = tm.predict(seed=8, samples=params_from_numpy(truth, "cpu"), hide_base=False,
                       hide_det=False, hide_samp=False)["count_mesh"].numpy()
    # every other latent at the fiducial (the JAX test leaves them out)
    obs = {"count_mesh": count, **{k: v for k, v in truth.items() if k not in HESS_KEYS}}
    m, wm = len(HESS_KEYS), truth["white_mesh_"]
    n_y = wm.size if evolution == "lpt" else 0

    def grad_j(flat, o):
        def lp(f):
            field = {"white_mesh_": f[m:].reshape(wm.shape)} if n_y else {}
            return jm.logpdf({**o, **field, **{k: f[i] for i, k in enumerate(HESS_KEYS)}})
        return jax.grad(lp)(flat)

    probes = np.stack([np.asarray(jr.rademacher(k, (n_y,), dtype=jnp.float32))
                       for k in jr.split(jr.key(0), N_PROBES)]) if n_y else np.zeros((0, 0))
    tangents = np.eye(m, m + n_y, dtype=np.float32)
    if n_y:
        tangents = np.concatenate([tangents, np.pad(probes, ((0, 0), (m, 0)))])
    with jax.enable_x64(True):
        flat0 = jnp.concatenate([jnp.zeros(m), jnp.asarray(wm.reshape(-1), jnp.float64)[:n_y]])
        o64 = {k: jnp.asarray(v, jnp.float64) for k, v in obs.items()
               if not (n_y and k == "white_mesh_")}
        lowered = jax.jit(grad_j).lower(flat0, o64)
    return dict(tm=tm, obs=obs, probes=probes, wm=wm, n_y=n_y, tangents=tangents,
                flat0=flat0, o64=o64), lowered


@lru_cache(maxsize=None)
def _jax_model_hvps():
    """Both evolutions' cases with the JAX package's Hessian-vector product
    columns (`cols`): central differences, step FD_STEP, of its float64
    gradient along each tangent.  They match the JAX package's float32
    forward-over-reverse columns (`jax.vmap(jax.jvp(jax.grad))`, which this
    test compared with before) within 2.8e-6 (lpt) and 4.3e-4 (nbody: that
    program's own float32 error) of the largest entry, and compile in ~40
    s where those took ~170 s each (measured, one CPU core).  The gradients
    are lowered one after the other (tracing is not thread-safe) and
    compiled side by side in two threads."""
    cases, lowered = {}, {}
    for evolution in ("lpt", "nbody"):
        cases[evolution], lowered[evolution] = _lower_jax_gradient(evolution)
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    with jax.enable_x64(True):
        for evolution, case in cases.items():
            grad_j, x0, o = compiled[evolution], case["flat0"], case["o64"]
            case["cols"] = np.stack([
                (np.asarray(grad_j(x0 + FD_STEP * v, o)) - np.asarray(grad_j(x0 - FD_STEP * v, o)))
                / (2 * FD_STEP) for v in jnp.asarray(case["tangents"], jnp.float64)])
    return cases


@pytest.mark.parametrize("evolution", ["lpt", "nbody"])
def test_scalar_hessian_matches_jax(evolution):
    """tests/test_hessian_finite.py's configuration (8^3, Kaiser
    preconditioning, quad-Gaussian) and block, the N-body one with its
    default 10 BullFrog steps: the port's reverse-over-reverse 3x3 Hessian
    at the fiducial point against the JAX package's (central differences
    of its float64 gradient, `_jax_model_hvps`), on the same white mesh,
    counts and other latents."""
    case = _jax_model_hvps()[evolution]
    tm, obs, probes, wm, n_y, cols = (case[k] for k in ("tm", "obs", "probes", "wm", "n_y",
                                                         "cols"))
    m = len(HESS_KEYS)
    hess_j = cols[:m, :m]

    obs_t = params_from_numpy(obs, "cpu")
    hess_t = block_hessian(tm.logpdf, {k: torch.zeros(()) for k in HESS_KEYS}, obs_t).numpy()
    assert np.isfinite(hess_t).all(), hess_t
    assert np.abs(hess_t).max() > 1e-3, hess_t
    np.testing.assert_allclose(hess_t, hess_j, rtol=2e-3, atol=1e-3 * np.abs(hess_j).max())

    # the Laplace mass seed of the block: the port's `_laplace_seed` on the
    # model against the JAX package's on the quadratic with JAX's Hessian
    from montecosmo_tpu.script import _laplace_seed as jax_laplace_seed

    hq = jnp.asarray(0.5 * (hess_j + hess_j.T))
    cov_j, w_j = jax_laplace_seed(
        lambda p: 0.5 * jnp.stack([p[k] for k in HESS_KEYS]) @ hq @ jnp.stack(
            [p[k] for k in HESS_KEYS]), {k: jnp.zeros(()) for k in HESS_KEYS}, {})
    cov_t, w_t = _laplace_seed(tm.logpdf, {k: torch.zeros(()) for k in HESS_KEYS}, obs_t)
    np.testing.assert_allclose(w_t, w_j, rtol=2e-3)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=5e-3,
                               atol=2e-3 * np.abs(np.asarray(cov_j)).max())
    if not n_y:
        return

    # the Hutchinson marginal covariance of the block given white_mesh_: the
    # port's on the model against the same formula on JAX's own HVPs with
    # the same probes (U = -logpdf: A = -H_xx, C = -H_yx, d = mean r (-H r))
    from montecosmo_tpu_torch.lapprox import marginal_covariance

    C = -cols[:m, m:].T
    d = np.mean(probes * -cols[m:, m:], 0)
    schur_j = -hess_j - C.T @ (C / (d + 1e-9)[:, None])
    schur_j = 0.5 * (schur_j + schur_j.T)
    rest = {k: v for k, v in obs_t.items() if k != "white_mesh_"}

    def pot(x, y):
        return -tm.logpdf({**rest, "white_mesh_": y.reshape(wm.shape),
                           **{k: x[i] for i, k in enumerate(HESS_KEYS)}})

    cov_h, schur_t = marginal_covariance(pot, torch.zeros(m), torch.as_tensor(wm.reshape(-1)),
                                         "hutchinson", N_PROBES, key=torch.as_tensor(probes))
    np.testing.assert_allclose(schur_t.numpy(), schur_j, rtol=5e-3,
                               atol=2e-3 * np.abs(schur_j).max())
    np.testing.assert_allclose(cov_h.numpy(), np.linalg.inv(schur_j), rtol=2e-2,
                               atol=1e-2 * np.abs(np.linalg.inv(schur_j)).max())


def test_logaddexp_and_quad_gaussian_hessians_finite():
    """The port's `utils.safe.logaddexp` keeps every derivative finite where
    torch.logaddexp's second derivative is NaN (its backward
    grad / (1 + e^(b - a)) overflows past b - a = 88 in float32): the
    witness behind the quad-Gaussian likelihood's full Hessian, NaN at
    s_e2 = 0 through its discarded quadratic branch before (found at 16^3
    in the rest_ block; scale1 = 20 here puts the branch's two terms ~200
    apart).  Its second derivative in loc is the linear branch's
    -1 / scale1^2."""
    from montecosmo_tpu_torch.models.distributions import QuadGaussian
    from montecosmo_tpu_torch.utils.safe import logaddexp

    def hessian(f, x):
        x = torch.tensor(x, requires_grad=True)
        (g,) = torch.autograd.grad(f(x), x, create_graph=True)
        return torch.stack([torch.autograd.grad(g[i], x, retain_graph=True)[0]
                            for i in range(len(x))])

    pair = [0.0, -300.0]
    assert torch.isnan(hessian(lambda x: torch.logaddexp(x[0], x[1]), pair)).any()
    got = hessian(lambda x: logaddexp(x[0], x[1]), pair)
    assert torch.isfinite(got).all() and float(got.abs().max()) < 1e-30
    got = hessian(lambda x: logaddexp(x[0], x[1]), [0.3, -0.4])
    s = 1 / (1 + np.exp(-0.7))  # d/da; the Hessian is s (1 - s) [[1, -1], [-1, 1]]
    np.testing.assert_allclose(got.numpy(), s * (1 - s) * np.array([[1, -1], [-1, 1]]),
                               rtol=1e-6)
    value = torch.tensor([3.0, -45.0, 80.0])
    h = hessian(lambda x: QuadGaussian(x[0], 20.0, 0.0).log_prob(value).sum(), [1.0])
    assert torch.isfinite(h).all()
    np.testing.assert_allclose(h.item(), -3 / 400, rtol=1e-6)
