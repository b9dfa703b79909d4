"""The PyTorch port's Kaiser-Bessel windows against the JAX package on the
same numpy inputs, on the CPU; the curved sky is test_torch_curved.py.

* `paint`, `paint_window`, `read`, `read_multi`, `read_window`, `interlace`
  and `nufft` at kernel_type='kaiser_bessel' and supports 1-4: values
  against the JAX function on the same path (the window path clamps to the
  lattice sites, outliers included; at support 1 it paints the one-hot NGP
  whatever the kernel type, the scatter path the Kaiser-Bessel weight).
  Gradients are held against the JAX scatter path, with the particles inside
  the clamp, because the JAX window path's Kaiser-Bessel position gradient
  is NaN (`test_jax_window_path_witnesses` pins that); at support 1 the
  window path's one-hot has a finite gradient and is its own yardstick.
* the plain adjoints (K2's and K5's CPU versions, which write the window's
  derivative out) against autograd of the plain paint and read;
* `kaiser_bessel_hat` / `window_hat` / `deconv_paint` on rfft grids on both
  sides of the bulk/tail switch |k| = beta.

No input sits on a tie: the JAX scatter path's Kaiser-Bessel gradient is NaN
at the support edge too.  Tolerances as test_paint_window.py:48 (rtol and
atol 2e-5) for the values; gradients 1e-4 (sums of up to 64 terms whose
derivative carries a Bessel ratio).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import fourier as jfo
from montecosmo_tpu.ops.paint import (
    interlace as jinterlace, nufft as jnufft, paint as jpaint, read as jread,
    read_multi as jread_multi,
)
from montecosmo_tpu.ops.paint_window import paint_window as jpaint_window, read_window as jread_window

from montecosmo_tpu_torch.ops import fourier as tfo, hermitian as the
from montecosmo_tpu_torch.ops import paint as tpa
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_ops import T, _lattice_particles, close

torch.set_num_threads(1)

KB = "kaiser_bessel"
ORDERS = (1, 2, 3, 4)
OVERSAMP = 1.5  # the window's cutoff optim_kcut(1.5) in the direct calls
LATTICE, STRIDE, H, SHAPE = (8, 8, 8), (2, 2, 2), 3, (16, 16, 16)
SCATTER_SHAPE, FINAL = (12, 10, 8), (12, 12, 12)
VTOL = 2e-5   # values: test_paint_window.py:48
GTOL = 1e-4   # gradients


def _inputs():
    rng = np.random.default_rng(60)
    pos, w = _lattice_particles(LATTICE, STRIDE, H, 61)
    # inside the clamp: displacements N(0, 1.2 cells) cut at H - 0.7 (off
    # the integers and half-integers, with and without the interlace shift)
    pin, _ = _lattice_particles(LATTICE, STRIDE, H, 62, n_out=0)
    sites = tbr.regular_pos(SHAPE, LATTICE).numpy()
    pin = sites + np.clip(pin - sites, 0.7 - H, H - 0.7)
    return dict(
        pos=pos, pin=pin, w=w, g=rng.standard_normal(SHAPE).astype(np.float32),
        mesh=rng.standard_normal(SHAPE + (3,)).astype(np.float32),
        ct=rng.standard_normal((len(pos), 3)).astype(np.float32),
        spos=rng.uniform(-3, 15, (500, 3)).astype(np.float32),
        sw=rng.uniform(0.5, 1.5, 500).astype(np.float32),
        sg=rng.standard_normal(SCATTER_SHAPE).astype(np.float32),
        smeshes=rng.standard_normal((3,) + SCATTER_SHAPE).astype(np.float32),
        sct=rng.standard_normal((500, 3)).astype(np.float32),
        cre=rng.standard_normal(the.r2chshape(FINAL)).astype(np.float32),
        cim=rng.standard_normal(the.r2chshape(FINAL)).astype(np.float32),
        ire=rng.standard_normal(the.r2chshape(SHAPE)).astype(np.float32),
        iim=rng.standard_normal(the.r2chshape(SHAPE)).astype(np.float32))


def _vjp(f, args, ct):
    out, pull = jax.vjp(f, *args)
    return out, pull(ct)


@lru_cache(maxsize=None)
def _jax_results():
    """Values (and VJPs where the yardstick is that path) of the JAX
    functions at Kaiser-Bessel supports 1-4, in one compile."""
    x = _inputs()

    def run(x):
        return {f"support {order}": _jax_run(x, order) for order in ORDERS}

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)({k: jnp.asarray(v)
                                                            for k, v in x.items()}))


def _jax_run(x, order):
    """The JAX functions at support `order` (inside `_jax_results`'s jit)."""
    # the gradient yardstick of the window path: itself at support 1 (the
    # one-hot NGP), the scatter path at 2-4 (the window path's is NaN)
    grad_lattice = LATTICE if order == 1 else None
    res = {}
    res["paint"] = _vjp(lambda p, w: jpaint(p, SCATTER_SHAPE, w, order, KB, OVERSAMP),
                        (x["spos"], x["sw"]), x["sg"])
    res["paint_window"] = (
        jpaint_window(x["pos"], SHAPE, LATTICE, x["w"], order, KB, OVERSAMP, max_disp=H,
                      clip=True),
        _vjp(lambda p, w: jpaint(p, SHAPE, w, order, KB, OVERSAMP, grad_lattice, H, True),
             (x["pin"], x["w"]), x["g"])[1])
    res["read"] = _vjp(lambda p, m: jread(p, m, order, KB, OVERSAMP),
                       (x["spos"], x["smeshes"][0]), x["sct"][:, 0])
    res["read_multi"] = _vjp(lambda p, m: jread_multi(p, list(m), order, KB, OVERSAMP),
                             (x["spos"], x["smeshes"]), x["sct"])

    def jread_in(p, m):
        if order == 1:
            return jread_window(p, m, LATTICE, order, KB, OVERSAMP, max_disp=H, clip=True)
        return jread_multi(p, m, order, KB, OVERSAMP)

    res["read_window"] = (
        jread_window(x["pos"], x["mesh"], LATTICE, order, KB, OVERSAMP, max_disp=H,
                     clip=True),
        _vjp(jread_in, (x["pin"], x["mesh"]), x["ct"])[1])

    def loss(out, re, im):
        return (out.real * re + out.imag * im).sum()

    def interlace_loss(p, w):
        return loss(jinterlace(p, SHAPE, w, order, 2, KB, OVERSAMP), x["ire"], x["iim"])

    res["interlace"] = jax.value_and_grad(interlace_loss, (0, 1))(x["spos"], x["sw"])

    def nufft_loss(p, w, lattice):
        out = jnufft(p, FINAL, SHAPE, w, paint_order=order, kernel_type=KB,
                     lattice_shape=lattice, max_disp=H, clip=True)
        return loss(out, x["cre"], x["cim"])

    f = np.float32(12 / 16)
    res["nufft"] = (nufft_loss(x["pos"] * f, x["w"], LATTICE),
                    jax.grad(nufft_loss, (0, 1))(x["pin"] * f, x["w"], grad_lattice))
    return res


def _torch_vjp(f, args, ct):
    leaves = [T(a, True) for a in args]
    out = f(*leaves)
    out.backward(torch.tensor(ct))
    return out, [leaf.grad for leaf in leaves]


def _torch_results(name, order):
    """(value, gradients) of the port's counterpart of `name`; for the window
    path the value at the positions with outliers and the gradients at the
    positions inside the clamp."""
    x = _inputs()
    if name == "paint":
        return _torch_vjp(lambda p, w: tpa.paint(p, SCATTER_SHAPE, w, order, KB, OVERSAMP),
                          (x["spos"], x["sw"]), x["sg"])
    if name == "read":
        return _torch_vjp(lambda p, m: tpa.read(p, m, order, KB, OVERSAMP),
                          (x["spos"], x["smeshes"][0]), x["sct"][:, 0])
    if name == "read_multi":
        return _torch_vjp(lambda p, m: tpa.read_multi(p, list(m), order, KB, OVERSAMP),
                          (x["spos"], x["smeshes"]), x["sct"])
    if name == "paint_window":
        f = lambda p, w: tpa.paint(p, SHAPE, w, order, KB, OVERSAMP, lattice_shape=LATTICE,
                                   max_disp=H, clip=True)
        return f(T(x["pos"]), T(x["w"])), _torch_vjp(f, (x["pin"], x["w"]), x["g"])[1]
    if name == "read_window":
        f = lambda p, m: tpa.read_window(p, m, LATTICE, order, KB, OVERSAMP, max_disp=H,
                                         clip=True)
        return f(T(x["pos"]), T(x["mesh"])), _torch_vjp(f, (x["pin"], x["mesh"]), x["ct"])[1]

    def loss(out, re, im):
        return (out.real * T(re) + out.imag * T(im)).sum()

    if name == "interlace":
        p, w = T(x["spos"], True), T(x["sw"], True)
        val = loss(tpa.interlace(p, SHAPE, w, order, 2, KB, OVERSAMP), x["ire"], x["iim"])
        val.backward()
        return val, [p.grad, w.grad]
    f = np.float32(12 / 16)

    def nufft_loss(p, w):
        out = tpa.nufft(p, FINAL, SHAPE, w, paint_order=order, kernel_type=KB,
                        lattice_shape=LATTICE, max_disp=H, clip=True)
        return loss(out, x["cre"], x["cim"])

    p, w = T(x["pin"] * f, True), T(x["w"], True)
    nufft_loss(p, w).backward()
    return nufft_loss(T(x["pos"] * f), T(x["w"])), [p.grad, w.grad]


@pytest.mark.parametrize("name", ["paint", "paint_window", "read", "read_multi",
                                  "read_window", "interlace", "nufft"])
@pytest.mark.parametrize("order", ORDERS)
def test_kaiser_bessel_paint_and_read_match_jax(order, name):
    """Values on the JAX function's own path; gradients in positions and
    weights (or meshes) against its finite yardstick, all finite."""
    vt, gt = _torch_results(name, order)
    vj, gj = _jax_results()[f"support {order}"][name]
    sums = name in ("interlace", "nufft")  # a real functional: a sum over the rfft grid
    close(vt, vj, 1e-4 if sums else VTOL, 1e-5 if sums else VTOL)
    for a, b in zip(gt, gj):
        assert torch.isfinite(a).all() and np.isfinite(b).all()
        close(a, b, GTOL, 1e-5)
    clamped_ngp = order == 1 and name in ("paint_window", "read_window", "nufft")
    assert (np.abs(gj[0]).max() == 0) == clamped_ngp  # the one-hot NGP has no position gradient


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", ["paint", "read"])
def test_kaiser_bessel_plain_adjoints_equal_autograd(kind, order):
    """K2's and K5's plain versions (the CPU backward passes, with the
    window's derivative written out) against autograd of K1's and K4's plain
    versions (NaN-free through `safe_sqrt`), clamped (with two interlace
    shifts for the paint) and unclamped, no particle on a tie."""
    pos, w = _lattice_particles(LATTICE, STRIDE, H, 63, n_out=10)
    rng = np.random.default_rng(64)
    for clip in (True, False):
        n_shift = 2 if kind == "paint" else 1
        geom = tpa.cic_geometry(SHAPE, n_shift, LATTICE, H, clip, order, KB, OVERSAMP)
        assert geom.window == "kb"
        pt, wt = T(pos, True), T(w, True)
        if kind == "paint":
            g = T(rng.standard_normal((2,) + SHAPE).astype(np.float32))
            dp, dw = torch.autograd.grad((tpa.paint_cic_plain(pt, wt, geom) * g).sum(), (pt, wt),
                                         allow_unused=True, materialize_grads=True)
            ap, aw = tpa.paint_cic_adjoint_plain(T(pos), T(w), g, geom)
            close(aw, dw.numpy())
        else:
            mesh = T(rng.standard_normal(SHAPE + (3,)).astype(np.float32))
            ct = T(rng.standard_normal((len(pos), 3)).astype(np.float32))
            mt = mesh.clone().requires_grad_(True)
            dp, dm = torch.autograd.grad((tpa.read_cic_plain(pt, mt, geom) * ct).sum(), (pt, mt),
                                         allow_unused=True, materialize_grads=True)
            ap, am = tpa.read_cic_adjoint_plain(T(pos), mesh, ct, geom)
            close(am, dm.numpy())
        close(ap, dp.numpy(), 1e-5, 1e-6)
        assert (np.abs(dp.numpy()).max() > 0) == (order > 1 or not clip)


def test_kaiser_bessel_derivative_is_finite_at_the_support_edge():
    """At |u| = 1 (a clamped particle on an integer cell, even support) the
    written-out derivative is the finite limit (i1(z)/z -> 1/2), equal to a
    float64 central difference of the window; JAX's autodiff of the same
    window is NaN there."""
    kcut = tfo.optim_kcut(OVERSAMP)
    h = 1e-6
    for order in (2, 4):
        s = torch.tensor([order / 2, -order / 2, 0.3, -0.7], dtype=torch.float64)
        d = tfo.dkaiser_bessel(s, order, kcut)
        # one-sided into the support at the edges, central inside
        lo = s - torch.tensor([h, 0.0, h, h], dtype=torch.float64)
        hi = s + torch.tensor([0.0, h, h, h], dtype=torch.float64)
        fd = (tfo.kaiser_bessel(hi, order, kcut) - tfo.kaiser_bessel(lo, order, kcut)) / (hi - lo)
        assert torch.isfinite(d).all()
        np.testing.assert_allclose(d.numpy(), fd.numpy(), rtol=1e-4)
        dj = jax.vmap(jax.grad(lambda v: jfo.kaiser_bessel(v, order, kcut)))(
            jnp.asarray(s.numpy(), jnp.float32))
        assert np.isnan(np.asarray(dj)[:2]).all() and np.isfinite(np.asarray(dj)[2:]).all()


def test_jax_window_path_witnesses():
    """What the JAX package does at kernel_type='kaiser_bessel', which the
    port does not copy (ROADMAP Queue C): (1) the window path's position
    gradient is NaN for every particle at supports 2-4 (the scatter path's
    is finite); (2) at support 1 the window path paints the one-hot NGP and
    the scatter path the Kaiser-Bessel weight, so their meshes and totals
    differ; (3) at an exact half-integer the window path spreads an odd
    support over P + 1 cells, the scatter path over P."""
    pos, w = _lattice_particles(LATTICE, STRIDE, H, 65, n_out=0)
    g = np.random.default_rng(66).standard_normal(SHAPE).astype(np.float32)
    tie = np.array([[4.5, 6.2, 5.3]], np.float32)

    def run(p, ww, gg, t):
        out = {}
        for order in (1, 2):
            win = lambda q: jpaint_window(q, SHAPE, LATTICE, ww, order, KB, OVERSAMP,
                                          max_disp=H, clip=True)
            sca = lambda q: jpaint(q, SHAPE, ww, order, KB, OVERSAMP)
            out[f"support {order}"] = (win(p), sca(p), jax.vjp(win, p)[1](gg)[0],
                                       jax.vjp(sca, p)[1](gg)[0])
        tie_lat = (1, 1, 1)
        out["tie"] = (jpaint_window(t, SHAPE, tie_lat, 1.0, 3, KB, OVERSAMP, max_disp=8),
                      jpaint(t, SHAPE, 1.0, 3, KB, OVERSAMP))
        return out

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(pos, w, g, tie))
    win1, sca1, gwin1, _ = out["support 1"]
    assert np.abs(win1 - sca1).max() > 0.1 and abs(win1.sum() - w.sum()) < 1e-2 * w.sum()
    assert abs(sca1.sum() - win1.sum()) > 1e-3 * w.sum()
    assert np.isfinite(gwin1).all() and not np.abs(gwin1).max()
    _, _, gwin2, gsca2 = out["support 2"]
    assert np.isnan(gwin2).all() and np.isfinite(gsca2).all()
    win_tie, sca_tie = out["tie"]
    assert (np.abs(win_tie) > 0).any(1).any(1).sum() == 4   # cells along x: P + 1
    assert (np.abs(sca_tie) > 0).any(1).any(1).sum() == 3   # P
    # the port paints P cells at the tie, as the scatter path
    close(tpa.paint(T(tie), SHAPE, 1.0, 3, KB, OVERSAMP), sca_tie, VTOL, VTOL)


def test_kaiser_bessel_paint_jumps_at_the_stencil_switch():
    """The Kaiser-Bessel window is 1/norm, not 0, at its support edge, so a
    particle crossing the point where its stencil switches (a half-integer
    at odd support, an integer at even) moves 1/norm of its weight by P
    cells; the B-spline paint is continuous there."""
    eps = np.float32(1e-5)
    for order, x0 in ((3, 4.5), (4, 5.0)):
        pos = T(np.array([[x0 - eps, 5.2, 6.7], [x0 + eps, 5.2, 6.7]], np.float32))
        _, norm = tfo.kaiser_bessel_norm(order, tfo.optim_kcut(OVERSAMP))
        for kernel, jump in (("rectangular", 0.0), (KB, 1 / norm)):
            a, b = (tpa.paint(pos[i:i + 1], SHAPE, 1.0, order, kernel, OVERSAMP).sum((1, 2))
                    for i in (0, 1))
            np.testing.assert_allclose(float((a - b).abs().max()), jump, atol=1e-4)


@pytest.mark.parametrize("oversamp", [192 / 224, OVERSAMP, 7 / 4])
def test_kaiser_bessel_hat_and_deconv_match_jax(oversamp):
    """kaiser_bessel_hat through window_hat on rfft grids and deconv_paint of
    a real and an rfft mesh.  Below an oversampling factor of ~1.04 the
    cutoff drops under pi and the grid straddles the bulk/tail switch |k| =
    kcut (the model's case: a paint mesh finer than the final one gives a
    factor below 1); above it every mode is in the bulk."""
    shape = (16, 12, 20)
    kt, kj = tfo.rfftk(shape), jfo.rfftk(shape)
    kcut = tfo.optim_kcut(oversamp)
    np.testing.assert_allclose(kcut, float(jfo.optim_kcut(oversamp)), rtol=1e-15)
    x = np.random.default_rng(67).standard_normal(shape).astype(np.float32)
    for order in ORDERS:
        kk = np.abs(np.asarray(kj[0]).ravel()) * order / 2
        beta = kcut * order / 2
        assert (kk <= beta).any() and (kk > beta).any() == (oversamp < 1)
        close(tfo.window_hat(kt, order, KB, oversamp), jfo.window_hat(kj, order, KB, oversamp),
              VTOL, VTOL)
        close(tfo.deconv_paint(T(x), order, KB, oversamp),
              jfo.deconv_paint(jnp.asarray(x), order, KB, oversamp), 1e-4, 1e-5)
        fk = np.fft.rfftn(x).astype(np.complex64)
        dt = tfo.deconv_paint(torch.tensor(fk), order, KB, oversamp)
        dj = np.asarray(jfo.deconv_paint(jnp.asarray(fk), order, KB, oversamp))
        close(torch.view_as_real(dt), np.stack([dj.real, dj.imag], -1), 1e-4, 1e-5)
