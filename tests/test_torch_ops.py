"""Parity of the PyTorch port's ops (montecosmo_tpu_torch.ops) with the JAX
package on the same numpy inputs, on the CPU.

Every input is drawn with numpy and handed to both packages.  Tolerances are
float32 ones: the two frameworks round elementwise chains and FFT sums
differently, so values agree to ~1e-6 relative and sums of many terms to
~1e-5.  Gradients are compared only w.r.t. real inputs (JAX and torch
differ in their convention for complex ones).
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg, fourier as jfo, hermitian as jhe
from montecosmo_tpu.ops import interp as jin, pm as jpm, power as jpo
from montecosmo_tpu.ops.paint import nufft as jnufft, paint as jpaint
from montecosmo_tpu.ops.paint_window import paint_window as jpaint_window
from montecosmo_tpu.models import bricks as jbr, distributions as jdi, truncnorm as jtn
from montecosmo_tpu.utils import safe as jsa

from montecosmo_tpu_torch.ops import background as tbg, fourier as tfo, hermitian as the
from montecosmo_tpu_torch.ops import interp as tin, paint as tpa, pm as tpm, power as tpo
from montecosmo_tpu_torch.models import bricks as tbr, distributions as tdi, truncnorm as ttn
from montecosmo_tpu_torch.utils import safe as tsa

from test_torch_card import _lattice_particles, _with_ties

torch.set_num_threads(1)

# float32 elementwise chains: a few ulps; sums over a mesh: ~1e-5 relative
RTOL, ATOL_REL = 1e-5, 1e-5


def close(t, j, rtol=RTOL, atol_rel=ATOL_REL):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_rel * max(np.abs(j).max(), 1e-30))


def T(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def test_safe_ops_values_and_grads_at_zero():
    x = np.array([0.0, -1.0, 0.25, 4.0], np.float32)
    for tf, jf in ((tsa.safe_sqrt, jsa.safe_sqrt), (lambda v: tsa.safe_div(v, v * 2 - 0.5),
                                                    lambda v: jsa.safe_div(v, v * 2 - 0.5))):
        xt = T(x, True)
        tf(xt).sum().backward()
        close(tf(T(x)), jf(jnp.asarray(x)))
        close(xt.grad, jax.grad(lambda v: jf(v).sum())(jnp.asarray(x)))
        assert np.isfinite(xt.grad.numpy()).all()


def test_fourier_kernels():
    shape, box = (8, 6, 10), (40.0, 30.0, 50.0)
    kt, kj = tfo.rfftk(shape, box), jfo.rfftk(shape, box)
    for a, b in zip(kt, kj):
        close(a, b, 0, 0)
    close(tfo.invlaplace_hat(kt), jfo.invlaplace_hat(kj))
    close(tfo.bspline_hat(kt, 2), jfo.bspline_hat(kj, 2))
    close(tfo.window_hat(kt, 3), jfo.window_hat(kj, 3))
    close(tfo.gradient_hat(kt, 1).imag, np.imag(jfo.gradient_hat(kj, 1)))
    close(tfo.gaussian_hat(kt, 0.5), jfo.gaussian_hat(kj, 0.5))
    np.testing.assert_array_equal(tfo.top_hat(kt, 0.4).numpy(), jfo.top_hat(kj, 0.4))
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    close(torch.view_as_real(tfo.rfftn(T(x))), np.stack([np.fft.rfftn(x).real,
                                                         np.fft.rfftn(x).imag], -1), 1e-4, 1e-5)
    close(tfo.irfftn(tfo.rfftn(T(x))), x, 1e-5, 1e-6)
    s = np.random.default_rng(1).uniform(-2.5, 2.5, 50).astype(np.float32)
    for order in (2, 3, 4):
        close(tfo.bspline(T(s), order).clamp(min=0) if order == 2 else tfo.bspline(T(s), order),
              np.maximum(jfo.bspline(jnp.asarray(s), order), 0) if order == 2
              else jfo.bspline(jnp.asarray(s), order))


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward", "amp"])
def test_hermitian_repack(norm):
    x = np.random.default_rng(2).standard_normal((8, 6, 10)).astype(np.float32)
    ct, cj = the.rg2cgh(T(x), norm), jhe.rg2cgh(jnp.asarray(x), norm)
    if norm == "amp":
        close(ct, cj)
        close(the.cgh2rg(ct, norm), jhe.cgh2rg(cj.astype(jnp.complex64), norm))
        return
    close(ct.real, np.real(cj))
    close(ct.imag, np.imag(cj))
    close(the.cgh2rg(ct, norm), jhe.cgh2rg(cj, norm))
    close(the.cgh2rg(ct, norm), x)


@pytest.mark.parametrize("shapes", [((12, 12, 7), (8, 8, 5)), ((8, 8, 5), (12, 10, 7))],
                         ids=["down", "up"])
def test_chreshape(shapes):
    src, dst = shapes
    x = np.random.default_rng(3).standard_normal(the.ch2rshape(src)).astype(np.float32)
    kt, kj = tfo.rfftn(T(x)), jnp.fft.rfftn(jnp.asarray(x))
    ot, oj = the.chreshape(kt, dst), jhe.chreshape(kj, dst)
    close(ot.real, np.real(oj))
    close(ot.imag, np.imag(oj))


def test_background_tables_and_omega_grad():
    a = np.array([0.2, 0.5, 0.77, 1.0], np.float32)
    chi = np.array([100.0, 1500.0, 3000.0], np.float32)

    def scal_t(om):
        bg = tbg.Background.create(tbg.get_cosmology(Omega_m=om, sigma8=torch.tensor(0.8)))
        A = torch.tensor(a)
        return bg, (bg.a2g(A).sum() + bg.a2g2(A).sum() + bg.a2f(A).sum()
                    + bg.a2dg2dg(A).sum() + bg.chi2a(torch.tensor(chi)).sum() * 10
                    + bg.g2a(torch.tensor([0.3, 0.6])).sum())

    def scal_j(om):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=0.8))
        return bg, (bg.a2g(a).sum() + bg.a2g2(a).sum() + bg.a2f(a).sum()
                    + bg.a2dg2dg(a).sum() + bg.chi2a(chi).sum() * 10
                    + bg.g2a(jnp.asarray([0.3, 0.6])).sum())

    om = T(np.float32(0.31), True)
    bt, st = scal_t(om)
    st.backward()
    (sj, bj), gj = jax.jit(jax.value_and_grad(lambda o: scal_j(o)[::-1], has_aux=True))(
        jnp.float32(0.31))
    for name in ("g_tab", "g2_tab", "f_tab", "f2_tab", "chi_tab", "a_chi_tab"):
        close(getattr(bt, name), getattr(bj, name), 1e-5, 1e-6)
    close(st, sj)
    # dD/dOmega_m etc. through the RK4 tables: f32 steps, ~1e-4
    close(om.grad, gj, 1e-4, 0)


def test_uniform_interp_and_interp():
    rng = np.random.default_rng(4)
    ytab = rng.standard_normal(32).astype(np.float32)
    x = rng.uniform(-0.5, 35.0, 200).astype(np.float32)
    close(tin.uniform_interp(T(x), 0.0, 1.0, T(ytab), left=0.0),
          jin.uniform_interp(jnp.asarray(x), 0.0, 1.0, jnp.asarray(ytab), left=0.0))
    nodes = np.logspace(-2, 1, 32)
    xq = np.exp(rng.uniform(np.log(5e-3), np.log(20.0), 200)).astype(np.float32)
    x0, dx = float(np.log(nodes[0])), float(np.log(nodes[1] / nodes[0]))
    close(tin.uniform_interp(T(xq), x0, dx, T(ytab), logx=True, xtab=nodes),
          jin.uniform_interp(jnp.asarray(xq), x0, dx, jnp.asarray(ytab), logx=True, xtab=nodes))
    xp = np.sort(rng.uniform(0, 1, 20)).astype(np.float32)
    q = rng.uniform(-0.2, 1.2, 100).astype(np.float32)
    close(tin.interp(T(q), T(xp), T(ytab[:20])), jnp.interp(q, xp, ytab[:20]))


def test_lin_power_mesh_and_grad():
    shape, box = (12, 12, 12), (240.0,) * 3

    def pt(om, s8):
        return tpo.lin_power_mesh(tbg.get_cosmology(Omega_m=om, sigma8=s8), shape, box)

    def pj(om, s8):
        return jpo.lin_power_mesh(jbg.get_cosmology(Omega_m=om, sigma8=s8), shape, box)

    om, s8 = T(np.float32(0.3), True), T(np.float32(0.8), True)
    mt = pt(om, s8)
    mt.sum().backward()
    close(mt, jax.jit(pj)(jnp.float32(0.3), jnp.float32(0.8)), 1e-4, 1e-6)
    gj = jax.jit(jax.grad(lambda o, s: pj(o, s).sum(), (0, 1)))(jnp.float32(0.3), jnp.float32(0.8))
    close(om.grad, gj[0], 1e-4, 0)
    close(s8.grad, gj[1], 1e-4, 0)
    # white2lin / lin2white: x sqrt(P) and its safe inverse (0 where P = 0)
    white = np.random.default_rng(16).standard_normal(the.r2chshape(shape)).astype(np.complex64)
    cos_t, cos_j = tbg.Planck18(), jbg.Planck18()
    lt = tbr.white2lin(cos_t, torch.tensor(white), shape, box)
    lj = jbr.white2lin(cos_j, jnp.asarray(white), shape, box)
    close(torch.view_as_real(lt), np.stack([np.real(lj), np.imag(lj)], -1), 1e-4, 1e-6)
    wj = jbr.lin2white(cos_j, lj, shape, box)
    close(torch.view_as_real(tbr.lin2white(cos_t, lt, shape, box)),
          np.stack([np.real(wj), np.imag(wj)], -1), 1e-4, 1e-6)


def _lin_field(shape, box, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    pm = np.asarray(jpo.lin_power_mesh(jbg.Planck18(), shape, box))
    k = np.fft.rfftn(x) * np.sqrt(pm) * np.prod(np.divide(shape, box)) ** 0.5
    return k.astype(np.complex64)


def test_lpt_2nd_order_16():
    shape, box, a = (16, 16, 16), (256.0,) * 3, 0.5
    lin = _lin_field(shape, box, 5)
    bt, bj = tbg.Background.create(tbg.Planck18()), jbg.Background.create(jbg.Planck18())
    post, posj = tbr.regular_pos(shape), jbr.regular_pos(shape)
    dt, vt = tpm.lpt(bt, torch.tensor(lin), post, a, 2, read_order=1, sites_shape=shape)
    dj, vj = jax.jit(lambda m: jpm.lpt(bj, m, posj, a, 2, read_order=1, sites_shape=shape))(
        jnp.asarray(lin))
    close(dt, dj, 1e-4, 1e-5)
    close(vt, vj, 1e-4, 1e-5)


def test_lagrangian_bias_16():
    shape, box, a = (16, 16, 16), (256.0,) * 3, 0.5
    lin = _lin_field(shape, box, 6)
    bias = {"b1": 0.5, "b2": 0.3, "bs2": -0.2, "b3": 0.1, "bds2": 0.1, "bs3": -0.05,
            "bn2": 0.05, "bnpar": 0.2}
    png = {k: 0.0 for k in ("fNL", "fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2", "fNL_bn2p")}
    bt, bj = tbg.Background.create(tbg.Planck18()), jbg.Background.create(jbg.Planck18())
    wt, dvt, _ = tbr.lagrangian_bias(tbr.regular_pos(shape), a, box, torch.tensor(lin),
                                     {k: torch.tensor(v) for k, v in bias.items()}, bt, shape)
    wj, dvj, _ = jax.jit(lambda m: jbr.lagrangian_bias(
        jbg.Planck18(), jbr.regular_pos(shape), a, box, m, bias, png, read_order=1, bg=bj,
        sites_shape=shape))(jnp.asarray(lin))
    close(wt, wj, 1e-4, 1e-5)
    close(dvt, dvj, 1e-4, 1e-5)


def _vjp_both(tfun, jfun, pos, w, g):
    pt, wt = T(pos, True), T(w, True)
    tfun(pt, wt).backward(torch.tensor(g))
    gp, gw = jax.jit(lambda p, ww, gg: jax.vjp(jfun, p, ww)[1](gg))(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(g))
    return (pt.grad, gp), (wt.grad, gw)


def test_paint_clamped_matches_paint_window_with_outliers():
    """The port's lattice paint (clamp to sites) against paint_window(clip=True):
    values and the gradients w.r.t. weights and positions, outliers included."""
    lattice, stride, H, shape = (8, 8, 8), (2, 2, 2), 3, (16, 16, 16)
    pos, w = _lattice_particles(lattice, stride, H, 7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    tf = lambda p, ww: tpa.paint(p, shape, ww, 2, lattice_shape=lattice, max_disp=H, clip=True)
    jf = lambda p, ww: jpaint_window(p, shape, lattice, ww, 2, max_disp=H, clip=True)
    close(tf(T(pos), T(w)), jf(jnp.asarray(pos), jnp.asarray(w)))
    (dpt, dpj), (dwt, dwj) = _vjp_both(tf, jf, pos, w, g)
    close(dwt, dwj)
    close(dpt, dpj)
    assert np.abs(dpj).max() > 0


def test_paint_unclamped_matches_scatter_paint():
    """lattice_shape=None: the plain periodic scatter of ops.paint.paint."""
    shape = (12, 10, 8)
    rng = np.random.default_rng(9)
    pos = rng.uniform(-3, 15, (500, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 500).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    tf = lambda p, ww: tpa.paint(p, shape, ww, 2)
    jf = lambda p, ww: jpaint(p, shape, ww, 2)
    with pytest.raises(NotImplementedError, match="Kaiser-Bessel"):
        tpa.paint(T(pos), shape, T(w), 5, "kaiser_bessel")
    close(tf(T(pos), T(w)), jf(jnp.asarray(pos), jnp.asarray(w)))
    (dpt, dpj), (dwt, dwj) = _vjp_both(tf, jf, pos, w, g)
    close(dwt, dwj)
    close(dpt, dpj)


def test_nufft_interlaced_clamp_after_shift():
    """Interlaced NUFFT with outliers: each shift is clamped after it is added
    (paint.py:186 + paint_window.py:289).  Values and gradients of a real
    functional of the complex output."""
    lattice, H = (8, 8, 8), 3
    final, paint_shape = (12, 12, 12), (16, 16, 16)
    pos, w = _lattice_particles(lattice, (2, 2, 2), H, 10)
    pos = pos * np.float32(12 / 16)  # final-mesh units
    rng = np.random.default_rng(11)
    cre, cim = (rng.standard_normal(the.r2chshape(final)).astype(np.float32) for _ in range(2))

    def tf(p, ww):
        out = tpa.nufft(p, final, paint_shape, ww, lattice_shape=lattice, max_disp=H, clip=True)
        return (out.real * torch.tensor(cre) + out.imag * torch.tensor(cim)).sum()

    def jf(p, ww):
        out = jnufft(p, final, paint_shape, ww, lattice_shape=lattice, max_disp=H, clip=True)
        return (out.real * cre + out.imag * cim).sum()

    pt, wt = T(pos, True), T(w, True)
    vt = tf(pt, wt)
    vt.backward()
    vj, (gp, gw) = jax.jit(jax.value_and_grad(jf, (0, 1)))(jnp.asarray(pos), jnp.asarray(w))
    close(vt, vj, 1e-4)
    close(wt.grad, gw, 1e-4)
    close(pt.grad, gp, 1e-4)


def test_nufft_epilogue_backward_convention():
    """The epilogue's hand-written backward (conjugated phase) equals torch
    autograd through the plain complex formula."""
    shape = (8, 6, 10)
    rng = np.random.default_rng(12)
    cs = (2,) + the.r2chshape(shape)
    fk = torch.complex(T(rng.standard_normal(cs).astype(np.float32)),
                       T(rng.standard_normal(cs).astype(np.float32)))
    g = torch.complex(*(T(rng.standard_normal(cs[1:]).astype(np.float32)) for _ in range(2)))
    geom = tpa.EpilogueGeometry(shape, 2, 1.3, 2)
    a, b = fk.clone().requires_grad_(True), fk.clone().requires_grad_(True)
    out_f = tpa.nufft_epilogue(a, shape, 1.3, 2)
    out_p = tpa.nufft_epilogue_plain(b, geom)
    close(torch.view_as_real(out_f), torch.view_as_real(out_p).detach().numpy())
    (ga,) = torch.autograd.grad(out_f, a, g)
    (gb,) = torch.autograd.grad(out_p, b, g)
    close(torch.view_as_real(ga), torch.view_as_real(gb).numpy())


def test_truncnorm_transport():
    x = np.linspace(-10, 10, 41).astype(np.float32)
    args = (0.3, 0.1, 0.05, 1.0)
    yt = ttn.std2trunc(T(x), *args)
    close(yt, jax.jit(jtn.std2trunc)(jnp.asarray(x), *args), 1e-5, 1e-6)
    y = np.linspace(0.06, 0.99, 30).astype(np.float32)
    close(ttn.trunc2std(T(y), *args), jax.jit(jtn.trunc2std)(jnp.asarray(y), *args), 1e-4, 1e-5)


def _value_and_grad_jax(f, x):
    """(f(x), grad of sum f) of an elementwise JAX function, one compile."""
    (_, v), g = jax.jit(jax.value_and_grad(lambda u: (f(u).sum(), f(u)), has_aux=True))(
        jnp.asarray(x))
    return v, g


def test_distributions_log_prob_and_grads():
    rng = np.random.default_rng(13)
    loc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    val = (loc + 0.4 * rng.standard_normal(64)).astype(np.float32)
    for s2 in (0.0, 0.08):
        s1 = T(np.float32(0.7), True)
        lt = tdi.QuadGaussian(T(loc), s1, s2).log_prob(T(val)).sum()
        lt.backward()
        fj = lambda s: jdi.QuadGaussian(jnp.asarray(loc), s, s2).log_prob(jnp.asarray(val)).sum()
        close(lt, fj(jnp.float32(0.7)))
        close(s1.grad, jax.jit(jax.grad(fj))(jnp.float32(0.7)), 1e-4)
    # DetruncTruncNorm (the bounded latents) is held against JAX through the
    # model's logpdf gradient in test_torch_model.py
    x = np.array([-3.0, -0.5, 0.0, 0.4, 2.0], np.float32)
    lt = tdi.Normal(0.2, 1.5).log_prob(T(x))
    close(lt, jdi.Normal(0.2, 1.5).log_prob(jnp.asarray(x)))
    xt = T(x, True)
    conf = (0.0, 2.0, 0.8, 0.4)
    lt = tdi.DetruncUnif(*conf).log_prob(xt)
    lt.sum().backward()
    vj, gj = _value_and_grad_jax(lambda v: jdi.DetruncUnif(*conf).log_prob(v), x)
    close(lt, vj, 1e-5, 1e-6)
    close(xt.grad, gj, 1e-4, 1e-5)


def test_set_radial_count_bins():
    """The radial-bin lookup and the <= 4-bin select chain, against the JAX
    package on the same radius mesh (bin indices must agree exactly)."""
    box_center, shape, box = (0.0, 0.0, 1000.0), (16, 16, 16), (128.0,) * 3
    rot_t, rot_j = tbr.Rotation((0, 0, 0)), jax.scipy.spatial.transform.Rotation.from_rotvec(
        jnp.zeros(3))
    rt = tbr.radius_mesh(box_center, rot_t, box, shape, curved_sky=False)
    rj = jbr.radius_mesh(box_center, rot_j, box, shape, curved_sky=False)
    close(rt, rj, 0, 0)
    mesh = np.random.default_rng(14).uniform(0.5, 1.5, shape).astype(np.float32)
    for n in (3, 9):
        r = np.asarray(rj)
        redges = np.linspace(r.min() - 0.01, r.max() + 0.01, n + 1)
        counts = np.linspace(0.5, 2.0, n).astype(np.float32)
        close(tbr.set_radial_count(T(mesh), rt, redges, T(counts)),
              jbr.set_radial_count(jnp.asarray(mesh), rj, redges, jnp.asarray(counts)), 0, 0)
