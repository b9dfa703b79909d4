"""The PyTorch port's N-body slice (BullFrog, `evolution='nbody'`) against the
JAX package on the same numpy inputs, on the CPU: the force read and its
gradients, the growth-time lookups and kick coefficients, `nbody_bf` and the
golden 32^3 N-body product (the 16^3 N-body logpdf value and gradient are in
test_torch_nbody_model.py).

Tolerances are float32 ones, as in test_torch_ops.py: a few ulps for
elementwise chains, ~1e-5 relative for sums over a mesh; N-body states
carry the FFT and read rounding of every step (1e-4).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg, pm as jpm
from montecosmo_tpu.ops.paint import read as jread, read_multi as jread_multi
from montecosmo_tpu.ops.paint_window import read_window as jread_window
from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.ops import background as tbg, fourier as tfo, paint as tpa, pm as tpm
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_model import golden_forward_32
from test_torch_ops import T, _lattice_particles, close

torch.set_num_threads(1)


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("stride,C", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_read_window_clamped_matches_jax(stride, C):
    """The clamped lattice read (K4/K5's plain versions) against
    read_window(clip=True): values, and the VJP w.r.t. positions and meshes,
    with 20 particles displaced past the bound H."""
    lattice, H = (16, 16, 16), 3
    shape = tuple(l * stride for l in lattice)
    pos, _ = _lattice_particles(lattice, (stride,) * 3, H, 20 + stride)
    rng = np.random.default_rng(21 + C)
    mesh = rng.standard_normal(shape + ((C,) if C > 1 else ())).astype(np.float32)
    ct = rng.standard_normal((len(pos),) + ((C,) if C > 1 else ())).astype(np.float32)

    pt, mt = T(pos, True), T(mesh, True)
    vt = tpa.read_window(pt, mt, lattice, 2, max_disp=H, clip=True)
    vt.backward(torch.tensor(ct))
    vj, (gp, gm) = jax.jit(lambda p, m, g: (lambda v, f: (v, f(g)))(*jax.vjp(
        lambda pp, mm: jread_window(pp, mm, lattice, 2, max_disp=H, clip=True), p, m)))(
        jnp.asarray(pos), jnp.asarray(mesh), jnp.asarray(ct))
    close(vt, vj)
    close(mt.grad, gm)
    close(pt.grad, gp)
    # the clamp acted: some particle has a zeroed position gradient
    assert (pt.grad == 0).any() and np.abs(gp).max() > 0


def test_read_adjoint_plain_equals_autograd():
    """K5's plain version (the CPU backward of the read) equals autograd of
    K4's plain version, clamped and unclamped."""
    lattice, H = (8, 8, 8), 2
    pos, _ = _lattice_particles(lattice, (2, 2, 2), H, 22, n_out=10)
    rng = np.random.default_rng(23)
    mesh = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    ct = rng.standard_normal((len(pos), 3)).astype(np.float32)
    for geom in (tpa.cic_geometry((16,) * 3, 1, lattice, H, True),
                 tpa.cic_geometry((16,) * 3, 1)):
        pt, mt = T(pos, True), T(mesh, True)
        dp, dm = torch.autograd.grad((tpa.read_cic_plain(pt, mt, geom) * T(ct)).sum(), (pt, mt))
        ap, am = tpa.read_cic_adjoint_plain(T(pos), T(mesh), T(ct), geom)
        close(ap, dp.numpy())
        close(am, dm.numpy())


# ------------------------------------------------------------------- (b)
def test_read_multi_and_read_unclamped_match_jax():
    """read_multi / read: the periodic, unclamped CIC read at arbitrary
    positions, values and gradients."""
    shape = (12, 10, 8)
    rng = np.random.default_rng(24)
    pos = rng.uniform(-3, 15, (7, 9, 3)).astype(np.float32)
    meshes = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    ct = rng.standard_normal((7, 9, 3)).astype(np.float32)

    pt, mts = T(pos, True), [T(m, True) for m in meshes]
    vt = tpa.read_multi(pt, mts)
    vt.backward(torch.tensor(ct))
    vj, (gp, gm) = jax.jit(lambda p, m, g: (lambda v, f: (v, f(g)))(*jax.vjp(jread_multi, p, m)))(
        jnp.asarray(pos), [jnp.asarray(m) for m in meshes], jnp.asarray(ct))
    close(vt, vj)
    close(pt.grad, gp)
    for a, b in zip(mts, gm):
        close(a.grad, b)

    close(tpa.read(T(pos), T(meshes[0])), jread(jnp.asarray(pos), jnp.asarray(meshes[0])))
    with pytest.raises(NotImplementedError, match="Kaiser-Bessel"):
        tpa.read_multi(T(pos), T(meshes[0]), order=5, kernel_type="kaiser_bessel")


# ------------------------------------------------------------------- (c)
def test_growth_lookups_and_kick_coefficients_match_jax():
    """g2g2, g2f, g2f2, g2dg2dg and the BullFrog / FastPM kick coefficients,
    values and d/dOmega_m, at g0 = a2g(0) (the table's lower edge, where
    g2dg2dg is a safe_div of two small numbers) and mid-range."""
    def outs(bg, g0, dg, gs):
        return [bg.g2g2(gs), bg.g2f(gs), bg.g2f2(gs), bg.g2dg2dg(gs),
                jpm.alpha_bullfrog(bg, g0, dg) if isinstance(bg, jbg.Background)
                else tpm.alpha_bullfrog(bg, g0, dg),
                jpm.alpha_fastpm(bg, g0 + dg, dg) if isinstance(bg, jbg.Background)
                else tpm.alpha_fastpm(bg, g0 + dg, dg)]

    def jfun(om, s8, dtype=jnp.float32):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=s8))
        g0 = bg.a2g(jnp.asarray(0.0, dtype))
        dg = (bg.a2g(jnp.asarray(0.5, dtype)) - g0) / 10
        gs = jnp.stack([g0, g0 + dg / 2, jnp.asarray(0.3, dtype), jnp.asarray(0.75, dtype)])
        return outs(bg, g0, dg, gs)

    def tfun(om, s8):
        bg = tbg.Background.create(tbg.get_cosmology(Omega_m=om, sigma8=s8))
        g0 = bg.a2g(0.0)
        dg = (bg.a2g(0.5) - g0) / 10
        gs = torch.stack([g0, g0 + dg / 2, torch.tensor(0.3), torch.tensor(0.75)])
        return outs(bg, g0, dg, gs)

    om, s8 = np.float32(0.31), np.float32(0.81)
    vj = jax.jit(jfun)(om, s8)
    # the port integrates the tables in float64 (K8): its derivatives are
    # held against JAX's in float64, whose float32 RK4 steps err by up to
    # 5.7e-4 in d(g2g2)/dOmega_m at the table's lower edge
    with jax.enable_x64(True):
        jac = jax.jit(jax.jacobian(lambda o: jfun(o, float(s8), jnp.float64)))(float(om))
    omt = T(om, True)
    vt = tfun(omt, T(s8))
    for t, j, dj in zip(vt, vj, jac):
        close(t, j, 1e-5, 1e-6)
        # d/dOmega_m through the tables, float32 lookups: ~1e-4, as for a2g
        (gt,) = torch.autograd.grad(t.sum(), omt, retain_graph=True)
        close(gt, np.asarray(dj).sum(), 1e-4, 1e-6)
    assert float(vt[3][0].detach()) != 0.0  # g2dg2dg at a2g(0): the ratio, not safe_div's 0


# ------------------------------------------------------------------- (d)
def _nbody_inputs(final=16, box=128.0, seed=25):
    from test_torch_ops import _lin_field

    shape = (final,) * 3
    return shape, (box,) * 3, _lin_field(shape, (box,) * 3, seed)


def _nbody_bf_case(snapshots):
    """(kw, the linear field (real), the random functional's pos/vel
    weights) of test_nbody_bf_matches_jax's case `snapshots`."""
    shape, box, lin = _nbody_inputs()
    lin = np.fft.irfftn(lin, shape, axes=(0, 1, 2)).astype(np.float32)  # real input: one gradient convention
    kw = dict(a0=0.0, a1=1.0, n_steps=3, snapshots=snapshots, lattice_shape=shape,
              max_disp=1, sites_shape=shape)
    rng = np.random.default_rng(26)
    n_snap = 1 if snapshots is None else snapshots
    rp, rv = (rng.standard_normal((n_snap, int(np.prod(shape)), 3)).astype(np.float32)
              for _ in range(2))
    return kw, lin, rp, rv


@lru_cache(maxsize=None)
def _jax_nbody_bf():
    """The JAX results of both cases of test_nbody_bf_matches_jax, value
    and gradient, in one compiled program."""
    shape = _nbody_inputs()[0]

    def case(snapshots):
        kw, _, rp, rv = _nbody_bf_case(snapshots)

        def jfun(m, om):
            bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=0.8))
            pos, vel = jpm.nbody_bf(bg, jnp.fft.rfftn(m), jbr.regular_pos(shape), **kw)
            return (pos * rp).sum() + (vel * rv).sum(), (pos, vel)

        return jax.value_and_grad(jfun, (0, 1), has_aux=True)

    cases = {s: case(s) for s in (None, 3)}
    lin = _nbody_bf_case(None)[1]
    out = jax.jit(lambda m, om: {str(s): f(m, om) for s, f in cases.items()})(
        jnp.asarray(lin), jnp.float32(0.31))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("snapshots", [None, 3])
def test_nbody_bf_matches_jax(snapshots):
    """nbody_bf (pos, vel) at 16^3 after 3 steps to a=1, with the model's
    lattice_shape and sites_shape and a bound max_disp=1 that the clamp
    crosses; with snapshots=3 the stacked states.  Gradient of a random
    linear functional of the result w.r.t. the linear field and Omega_m.
    The JAX side of both cases is one compiled program."""
    shape = _nbody_inputs()[0]
    kw, lin, rp, rv = _nbody_bf_case(snapshots)
    (_, (pj, vj)), (gmj, goj) = _jax_nbody_bf()[str(snapshots)]

    mt, omt = T(lin, True), T(np.float32(0.31), True)
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=omt, sigma8=torch.tensor(0.8)))
    pt, vt = tpm.nbody_bf(bg, tfo.rfftn(mt), tbr.regular_pos(shape), **kw)
    ((pt * T(rp)).sum() + (vt * T(rv)).sum()).backward()

    close(pt, pj, 1e-4, 1e-5)
    close(vt, vj, 1e-4, 1e-5)
    disp = np.abs(np.asarray(pj)[-1] - np.asarray(jbr.regular_pos(shape)))
    assert (disp > 1).any(), "no particle crossed the clamp bound"
    close(mt.grad, gmj, 1e-3, 1e-4)
    close(omt.grad, goj, 1e-3)


# ------------------------------------------------------------------- (e, f)
def test_golden_forward_nbody_32():
    golden_forward_32("nbody")


def test_model_defaults_to_the_card_and_refuses_unported_configs():
    """FieldLevelModel targets the card unless told otherwise.  The N-body
    light cone on the flat and on the curved sky, every B-spline order and
    the Kaiser-Bessel windows of support 1-4 build; Kaiser-Bessel windows of
    support 5 and more are refused, naming their ROADMAP item, and a
    register file that does not exist is a FileNotFoundError (Eulerian
    bias, AP with ap_auto True or False and PNG with png_type 'fNL' or
    'bias' build, and one value+grad of the N-body light cone with
    ap_auto=True and png_type='fNL' is finite); snapshots on the light cone
    (exclusive in the JAX package too), B-spline orders outside 1-4, unknown
    kernel types, ap_auto and png_type values are invalid."""
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    assert FieldLevelModel.__dataclass_fields__["device"].default == "cuda"
    conf = dict(default_config)
    conf.update(final_shape=(8, 8, 8), evolution="nbody", a_obs=None, curved_sky=False,
                box_center=(0.0, 0.0, 500.0))
    for order in (1, 2, 3, 4):
        for kernel in ("rectangular", "kaiser_bessel"):
            m = FieldLevelModel(**{**conf, "paint_order": order, "kernel_type": kernel},
                                device="cpu")
            assert (m.paint_order, m.kernel_type) == (order, kernel)
    assert FieldLevelModel(**{**conf, "curved_sky": True}, device="cpu").curved_sky
    with pytest.raises(NotImplementedError, match="Queue B item 8"):
        FieldLevelModel(**{**conf, "kernel_type": "kaiser_bessel", "paint_order": 5},
                        device="cpu")
    assert FieldLevelModel(**{**conf, "bias_type": "eulerian"}, device="cpu").bias_type \
        == "eulerian"
    for key, value in (("ap_auto", True), ("png_type", "fNL")):
        m = FieldLevelModel(**{**conf, key: value, "nbody_n_steps": 2}, device="cpu")
        assert getattr(m, key) == value
    for key, value in (("ap_auto", False), ("png_type", "bias")):
        assert getattr(FieldLevelModel(**{**conf, key: value}, device="cpu"), key) == value
    m = FieldLevelModel(**{**conf, "ap_auto": True, "png_type": "fNL", "nbody_n_steps": 2},
                        device="cpu")
    p = {k: torch.as_tensor(v).requires_grad_(True) for k, v in m.reparam(
        {k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True).items()}
    p["white_mesh_"] = torch.randn(m.init_shape, generator=torch.Generator().manual_seed(0),
                                   requires_grad=True)
    lp = m.logpdf({**p, "count_mesh": torch.ones(m.final_shape)})
    grads = torch.autograd.grad(lp, list(p.values()))
    assert torch.isfinite(lp) and all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(FileNotFoundError, match="counts.h5"):
        FieldLevelModel(**{**conf, "register": "counts.h5"}, device="cpu")
    for key, value in (("ap_auto", "auto"), ("png_type", "fnl")):
        with pytest.raises(ValueError, match=key):
            FieldLevelModel(**{**conf, key: value}, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        FieldLevelModel(**{**conf, "nbody_snapshots": 3}, device="cpu")
    for order in (0, 5):
        with pytest.raises(ValueError, match="paint_order"):
            FieldLevelModel(**{**conf, "paint_order": order}, device="cpu")
    with pytest.raises(ValueError, match="kernel type"):
        FieldLevelModel(**{**conf, "kernel_type": "gaussian"}, device="cpu")
