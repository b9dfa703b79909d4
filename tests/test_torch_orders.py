"""The PyTorch port's B-spline orders 1 (NGP), 3 (TSC) and 4 (PCS) and the
N-body light cone against the JAX package on the same numpy inputs, on the
CPU: `paint` (scatter), `paint_window(clip=True)`, `read`, `read_multi`,
`read_window(clip=True)` and `nufft` (values and gradients in weights,
meshes and positions); the plain adjoints against autograd; and
`nbody_bf_lightcone` (states, and gradients in the linear field and Omega_m).
The 16^3 model-level light cone at TSC is `test_logpdf_and_grad_nbody_match_jax_16`
in test_torch_nbody.py.

Inputs include positions on exact half-integers, where the odd orders round
half to even; in the clamped window paint the JAX package rounds NGP
positions relative to their lattice group's window base, whose parity the
geometry below makes odd.  Tolerances are float32 ones, as in
test_torch_ops.py: ~1e-5 relative for sums of up to 64 terms per particle;
N-body states 1e-4 and their gradients 1e-3, as in test_torch_nbody.py.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg, pm as jpm
from montecosmo_tpu.ops.paint import (
    nufft as jnufft, paint as jpaint, read as jread, read_multi as jread_multi,
)
from montecosmo_tpu.ops.paint_window import paint_window as jpaint_window, read_window as jread_window
from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.ops import background as tbg, fourier as tfo, hermitian as the
from montecosmo_tpu_torch.ops import paint as tpa, pm as tpm
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_ops import T, _lattice_particles, _with_ties, close

torch.set_num_threads(1)

ORDERS = (1, 3, 4)
# clamped window geometry: lattice 8^3 at stride 2, max_disp 3; the NGP
# window margin is 3 + 2 = 5 and the group span 16, so every window base is odd
LATTICE, STRIDE, H, SHAPE = (8, 8, 8), (2, 2, 2), 3, (16, 16, 16)
SCATTER_SHAPE, FINAL = (12, 10, 8), (12, 12, 12)


def _inputs():
    rng = np.random.default_rng(40)
    pos, w = _lattice_particles(LATTICE, STRIDE, H, 41)
    pos = _with_ties(pos, LATTICE, STRIDE, rng)
    spos = rng.uniform(-3, 15, (500, 3)).astype(np.float32)
    spos[:100] = np.floor(spos[:100]) + 0.5
    sw = rng.uniform(0.5, 1.5, 500).astype(np.float32)
    return dict(
        pos=pos, w=w, g=rng.standard_normal(SHAPE).astype(np.float32),
        mesh=rng.standard_normal(SHAPE + (3,)).astype(np.float32),
        ct=rng.standard_normal((len(pos), 3)).astype(np.float32),
        spos=spos, sw=sw, sg=rng.standard_normal(SCATTER_SHAPE).astype(np.float32),
        smeshes=rng.standard_normal((3,) + SCATTER_SHAPE).astype(np.float32),
        sct=rng.standard_normal((500, 3)).astype(np.float32),
        cre=rng.standard_normal(the.r2chshape(FINAL)).astype(np.float32),
        cim=rng.standard_normal(the.r2chshape(FINAL)).astype(np.float32))


def _vjp(f, args, ct):
    out, pull = jax.vjp(f, *args)
    return out, pull(ct)


@lru_cache(maxsize=None)
def _jax_results(order):
    """Values and VJPs of the six JAX functions at `order`, in one compile."""
    x = _inputs()

    def run(x):
        res = {}
        res["paint"] = _vjp(lambda p, w: jpaint(p, SCATTER_SHAPE, w, order),
                            (x["spos"], x["sw"]), x["sg"])
        res["paint_window"] = _vjp(
            lambda p, w: jpaint_window(p, SHAPE, LATTICE, w, order, max_disp=H, clip=True),
            (x["pos"], x["w"]), x["g"])
        res["read"] = _vjp(lambda p, m: jread(p, m, order), (x["spos"], x["smeshes"][0]),
                           x["sct"][:, 0])
        res["read_multi"] = _vjp(lambda p, m: jread_multi(p, list(m), order),
                                 (x["spos"], x["smeshes"]), x["sct"])
        res["read_window"] = _vjp(
            lambda p, m: jread_window(p, m, LATTICE, order, max_disp=H, clip=True),
            (x["pos"], x["mesh"]), x["ct"])

        def nufft_loss(p, w):
            out = jnufft(p, FINAL, SHAPE, w, paint_order=order, lattice_shape=LATTICE,
                         max_disp=H, clip=True)
            return (out.real * x["cre"] + out.imag * x["cim"]).sum()

        res["nufft"] = jax.value_and_grad(nufft_loss, (0, 1))(x["pos"] * np.float32(12 / 16),
                                                             x["w"])
        return res

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)({k: jnp.asarray(v)
                                                            for k, v in x.items()}))


def _torch_vjp(f, args, ct):
    leaves = [T(a, True) for a in args]
    out = f(*leaves)
    out.backward(torch.tensor(ct))
    return out, [leaf.grad for leaf in leaves]


def _torch_results(name, order):
    x = _inputs()
    if name == "paint":
        return _torch_vjp(lambda p, w: tpa.paint(p, SCATTER_SHAPE, w, order),
                          (x["spos"], x["sw"]), x["sg"])
    if name == "paint_window":
        return _torch_vjp(lambda p, w: tpa.paint(p, SHAPE, w, order, lattice_shape=LATTICE,
                                                 max_disp=H, clip=True),
                          (x["pos"], x["w"]), x["g"])
    if name == "read":
        return _torch_vjp(lambda p, m: tpa.read(p, m, order), (x["spos"], x["smeshes"][0]),
                          x["sct"][:, 0])
    if name == "read_multi":
        return _torch_vjp(lambda p, m: tpa.read_multi(p, list(m), order),
                          (x["spos"], x["smeshes"]), x["sct"])
    if name == "read_window":
        return _torch_vjp(lambda p, m: tpa.read_window(p, m, LATTICE, order, max_disp=H,
                                                       clip=True),
                          (x["pos"], x["mesh"]), x["ct"])
    p, w = T(x["pos"] * np.float32(12 / 16), True), T(x["w"], True)
    out = tpa.nufft(p, FINAL, SHAPE, w, paint_order=order, lattice_shape=LATTICE, max_disp=H,
                    clip=True)
    loss = (out.real * T(x["cre"]) + out.imag * T(x["cim"])).sum()
    loss.backward()
    return loss, [p.grad, w.grad]


@pytest.mark.parametrize("name", ["paint", "paint_window", "read", "read_multi",
                                  "read_window", "nufft"])
@pytest.mark.parametrize("order", ORDERS)
def test_paint_and_read_orders_match_jax(order, name):
    """Values and the VJP in positions and weights (or meshes) at `order`.
    NGP has a zero position gradient in both packages."""
    vt, gt = _torch_results(name, order)
    vj, gj = _jax_results(order)[name]
    tol = 1e-4 if name == "nufft" else 1e-5  # a sum over the rfft grid
    close(vt, vj, tol)
    for a, b in zip(gt, gj):
        close(a, b, tol)
    if order == 1:
        assert not gt[0].abs().max() and not np.abs(gj[0]).max()
    else:
        assert np.abs(gj[0]).max() > 0


@pytest.mark.parametrize("order", (3, 4))
@pytest.mark.parametrize("kind", ["paint", "read"])
def test_plain_adjoints_equal_autograd(kind, order):
    """K2's and K5's plain versions (the CPU backward passes) equal autograd of
    K1's and K4's plain versions, clamped (with two interlace shifts for the
    paint) and unclamped."""
    pos, w = _lattice_particles(LATTICE, STRIDE, H, 42, n_out=10)
    rng = np.random.default_rng(43)
    for clip in (True, False):
        if kind == "paint":
            geom = tpa.cic_geometry(SHAPE, 2, LATTICE, H, clip, order)
            g = T(rng.standard_normal((2,) + SHAPE).astype(np.float32))
            pt, wt = T(pos, True), T(w, True)
            dp, dw = torch.autograd.grad((tpa.paint_cic_plain(pt, wt, geom) * g).sum(), (pt, wt))
            ap, aw = tpa.paint_cic_adjoint_plain(T(pos), T(w), g, geom)
            close(aw, dw.numpy())
        else:
            geom = tpa.cic_geometry(SHAPE, 1, LATTICE, H, clip, order)
            mesh, ct = T(rng.standard_normal(SHAPE + (3,)).astype(np.float32)), \
                T(rng.standard_normal((len(pos), 3)).astype(np.float32))
            pt, mt = T(pos, True), mesh.clone().requires_grad_(True)
            dp, dm = torch.autograd.grad((tpa.read_cic_plain(pt, mt, geom) * ct).sum(), (pt, mt))
            ap, am = tpa.read_cic_adjoint_plain(T(pos), mesh, ct, geom)
            close(am, dm.numpy())
        close(ap, dp.numpy())


@pytest.mark.parametrize("paint_order", [2, 3])
def test_nbody_bf_lightcone_matches_jax(paint_order):
    """nbody_bf_lightcone at 16^3, 2 steps, the model's lattice and sites and
    a bound max_disp=1 that the clamp crosses; each particle's target growth
    from a scale factor in [0.3, 0.9], the evolution run to the latest, as
    the model does.  States, and the gradient of a random linear functional
    of them in the linear field and Omega_m."""
    from test_torch_nbody import _nbody_inputs

    shape, _, lin = _nbody_inputs()
    lin = np.fft.irfftn(lin, shape, axes=(0, 1, 2)).astype(np.float32)
    rng = np.random.default_rng(44)
    n = int(np.prod(shape))
    a_tgt = rng.uniform(0.3, 0.9, (n, 1)).astype(np.float32)
    rp, rv = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(2))
    kw = dict(a0=0.0, n_steps=2, paint_order=paint_order, lattice_shape=shape, max_disp=1,
              sites_shape=shape)

    def jfun(m, om):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=0.8))
        g_tgt = bg.a2g(a_tgt)
        pos, vel = jpm.nbody_bf_lightcone(bg, jnp.fft.rfftn(m), jbr.regular_pos(shape), g_tgt,
                                          a1=bg.g2a(g_tgt.max()), **kw)
        return (pos * rp).sum() + (vel * rv).sum(), (pos, vel)

    (_, (pj, vj)), (gmj, goj) = jax.jit(jax.value_and_grad(jfun, (0, 1), has_aux=True))(
        jnp.asarray(lin), jnp.float32(0.31))

    mt, omt = T(lin, True), T(np.float32(0.31), True)
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=omt, sigma8=torch.tensor(0.8)))
    g_tgt = bg.a2g(T(a_tgt))
    pt, vt = tpm.nbody_bf_lightcone(bg, tfo.rfftn(mt), tbr.regular_pos(shape), g_tgt,
                                    a1=bg.g2a(g_tgt.max()), **kw)
    ((pt * T(rp)).sum() + (vt * T(rv)).sum()).backward()

    close(pt, pj, 1e-4, 1e-5)
    close(vt, vj, 1e-4, 1e-5)
    disp = np.abs(np.asarray(pj) - np.asarray(jbr.regular_pos(shape)))
    assert (disp > 1).any(), "no particle crossed the clamp bound"
    close(mt.grad, gmj, 1e-3, 1e-4)
    close(omt.grad, goj, 1e-3)
