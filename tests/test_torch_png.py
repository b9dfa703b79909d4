"""The port's primordial non-Gaussianity (PNG) against the JAX package on the
CPU: `b_phi`, `b_phi_delta` and `fNL_bias` at png_type None, 'fNL' and
'bias'; `trans_phi2delta_interp` (the lookup of `uniform_interp(logx=True)`,
K9 its backward on the card); `add_png`; the PNG terms of `kaiser_boost` and
of `kaiser_model` in the flat-sky light cone and on the curved sky;
`lagrangian_bias`'s PNG operators at the lattice sites and off them; and
`eulerian_bias`'s with its advected phi mesh: values and gradients (in
Omega_m, the PNG amplitudes and the fields), on seeded numpy inputs at
16^3.  The model case (Eulerian bias with png_type='bias' on the
curved-sky light cone) is in test_torch_png_bias_model.py.

Tolerances: the bias relations 1e-6 relative (float32 in both packages).
The transfer, `add_png` and the Kaiser terms, the port's float32 against
the JAX package's float64 (one compile each): the transfer 1e-5 relative
of its largest value (EH98 and the growth tables), values within 1e-5 of
the largest entry and gradients in the fields within 1e-4 of the largest,
in the scalar amplitudes rtol 1e-4; their gradients in Omega_m (through
K8's tables, EH98 and the 1/Omega_m of the transfer) rtol 2e-3, the port
in float64 (a sum over the mesh that cancels).  The bias operators (float32
in both packages, FFTs in another order): values within 1e-5 of the
largest entry, gradients in the fields within 1e-4 of the largest, in the
scalar amplitudes rtol 1e-4.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.models import bricks as jbr
from montecosmo_tpu.ops import background as jbg, power as jpo

from montecosmo_tpu_torch.models import bricks as tbr
from montecosmo_tpu_torch.ops import background as tbg

from test_torch_likelihoods import jit_vjp

torch.set_num_threads(1)

SHAPE, BOX, OM, S8 = (16, 16, 16), np.array([256.0] * 3), 0.29, 0.81
PNG_NAMES = ("fNL", "fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2", "fNL_bn2p")
PNG = dict(zip(PNG_NAMES, np.array([40.0, 1.3, -0.7, 0.2, 0.4, -3.0], np.float32)))
BIAS = {"b1": 0.5, "b2": 0.3, "bs2": -0.2, "b3": 0.1, "bds2": 0.1, "bs3": -0.05, "bn2": 0.05,
        "bnpar": 0.2}


def _close(t, j, rtol, atol_rel=0.0):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_rel * max(np.abs(j).max(), 1e-30))


def _lin(seed):
    """A linear rfft field at 16^3 with the fiducial spectrum, complex64."""
    x = np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)
    pm = np.asarray(jpo.lin_power_mesh(jbg.Planck18(), SHAPE, BOX))
    return (np.fft.rfftn(x) * np.sqrt(pm) * np.prod(np.divide(SHAPE, BOX)) ** 0.5).astype(
        np.complex64)


def _kmesh():
    k = np.fft.fftfreq(16, 16.0) * 2 * np.pi
    kz = np.fft.rfftfreq(16, 16.0) * 2 * np.pi
    return np.sqrt(k[:, None, None]**2 + k[None, :, None]**2 + kz[None, None, :]**2).astype(
        np.float32)


def _cosmo_t(om):
    return tbg.get_cosmology(Omega_m=om, sigma8=torch.tensor(S8, dtype=om.dtype))


def _cosmo_j(om):
    return jbg.get_cosmology(Omega_m=om, sigma8=jnp.asarray(S8, om.dtype))


def _jax64(fn, *args):
    """(outputs, gradients in every argument) of the JAX function `fn`
    (returning (scalar loss, outputs)) in float64: one compile under
    jax.enable_x64."""
    with jax.enable_x64(True):
        (_, o), g = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(args))),
                                               has_aux=True))(
            *(jnp.asarray(a, jnp.float64) for a in args))
        return jax.tree_util.tree_map(np.asarray, (o, g))


@pytest.mark.parametrize("png_type", [None, "fNL", "bias"])
def test_fnl_bias_matches_jax(png_type):
    """`fNL_bias`'s effective fNL_bp, fNL_bpd (with `b_phi` and
    `b_phi_delta` inside) and their gradients in fNL, fNL_bp, fNL_bpd, b1
    and b2."""
    names = ("fNL", "fNL_bp", "fNL_bpd", "b1", "b2")
    vals = np.array([40.0, 1.3, -0.7, 0.5, 0.3], np.float32)
    leaves = [torch.tensor(v, requires_grad=True) for v in vals]

    def split(x):
        return dict(zip(names[:3], x[:3])), dict(zip(names[3:], x[3:]))

    out = tbr.fNL_bias(*split(leaves), png_type=png_type)
    gt = torch.autograd.grad(out["fNL_bp"] + 3 * out["fNL_bpd"], leaves, allow_unused=True)
    fj = lambda *x: jbr.fNL_bias(*split(x), png_type=png_type)
    oj = fj(*map(jnp.float32, vals))
    gj = jax.grad(lambda *x: (lambda o: o["fNL_bp"] + 3 * o["fNL_bpd"])(fj(*x)),
                  argnums=tuple(range(5)))(*map(jnp.float32, vals))
    for k in ("fNL_bp", "fNL_bpd"):
        _close(out[k], oj[k], 1e-6)
    for a, b in zip(gt, gj):
        _close(torch.zeros(()) if a is None else a, b, 1e-6)
    for fn, args in (("b_phi", (0.7,)), ("b_phi_delta", (0.7, -0.4))):
        _close(torch.tensor(getattr(tbr, fn)(*args)), getattr(jbr, fn)(*args), 1e-6)


def test_transfer_and_add_png_match_jax():
    """The primordial-potential transfer on a 16^3 k mesh (zero at k = 0
    and past the table) and `add_png` of a linear field: values, and the
    gradients in the field, fNL (float32) and Omega_m (float64)."""
    lin, ct = _lin(1), np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    kq = np.concatenate([_kmesh().ravel(), [0.0, 20.0]]).astype(np.float32)

    def port(dtype):
        om = torch.tensor(OM, dtype=dtype, requires_grad=True)
        fnl = torch.tensor(40.0, dtype=dtype, requires_grad=True)
        re = torch.tensor(lin.real, dtype=dtype, requires_grad=True)
        im = torch.tensor(lin.imag, dtype=dtype, requires_grad=True)
        cosmo = _cosmo_t(om)
        bg = tbg.Background.create(cosmo)
        trans = tbr.trans_phi2delta_interp(cosmo, bg=bg)(torch.tensor(kq, dtype=dtype))
        phik, tr = tbr.phi_transfer(cosmo, torch.complex(re, im), BOX, bg=bg)
        out = torch.fft.irfftn(tbr.add_png(fnl, torch.fft.irfftn(phik, s=SHAPE), tr), s=SHAPE)
        loss = (out * torch.tensor(ct, dtype=dtype)).sum() + 1e-6 * trans.sum()
        return (trans, out), torch.autograd.grad(loss, [re, im, fnl, om])

    def jaxs(re, im, fnl, om):
        cosmo = _cosmo_j(om)
        bg = jbg.Background.create(cosmo)
        trans = jbr.trans_phi2delta_interp(cosmo, bg=bg)(jnp.asarray(kq, om.dtype))
        out = jnp.fft.irfftn(jbr.add_png(cosmo, fnl, re + 1j * im, BOX, bg=bg), s=SHAPE)
        return (out * ct).sum() + 1e-6 * trans.sum(), (trans, out)

    (trans, out), gt = port(torch.float32)
    (tj, oj), gj = _jax64(jaxs, lin.real, lin.imag, 40.0, OM)
    assert trans[-2:].abs().max() == 0 and np.abs(tj[-2:]).max() == 0
    _close(trans, tj, 1e-5, 1e-5)
    _close(out, oj, 0, 1e-5)
    for a, b in zip(gt[:2], gj[:2]):
        _close(a, b, 0, 1e-4)
    _close(gt[2], gj[2], 1e-4)
    _close(port(torch.float64)[1][3], gj[3], 2e-3)


@pytest.mark.parametrize("regime", ["flat light cone", "curved"])
def test_kaiser_png_terms_match_jax(regime):
    """`kaiser_model`'s PNG term, fNL_bp irfftn(lin / transfer), in the
    flat-sky light cone (a per cell) and on the curved sky (a line of sight
    per cell), and `kaiser_boost`'s, fNL_bp / transfer; values and the
    gradients in the field, fNL_bp (float32) and Omega_m (float64)."""
    lin, ct = _lin(3), np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 0.8, SHAPE).astype(np.float32)
    if regime == "curved":
        pos = np.stack(np.meshgrid(*[np.arange(16.0)] * 3, indexing="ij"), -1) - 8.0
        pos = pos + np.array([3.0, -2.0, 40.0])
        los = (pos / np.linalg.norm(pos, axis=-1, keepdims=True)).astype(np.float32)
    else:
        los = np.array([0.0, 0.0, 1.0], np.float32)

    def port(dtype):
        om = torch.tensor(OM, dtype=dtype, requires_grad=True)
        fbp = torch.tensor(1.3, dtype=dtype, requires_grad=True)
        re = torch.tensor(lin.real, dtype=dtype, requires_grad=True)
        im = torch.tensor(lin.imag, dtype=dtype, requires_grad=True)
        cosmo = _cosmo_t(om)
        bg = tbg.Background.create(cosmo)
        lt = torch.tensor(los, dtype=dtype) if regime == "curved" else tuple(los.tolist())
        out = tbr.kaiser_model(cosmo, torch.tensor(a, dtype=dtype), torch.complex(re, im), BOX,
                               1.7, fNL_bp=fbp, png_type="fNL", los=lt, bg=bg)
        boost = tbr.kaiser_boost(cosmo, 0.6, SHAPE, BOX, 1.7, fNL_bp=fbp, png_type="fNL",
                                 los=(0.0, 0.0, 1.0), bg=bg)
        loss = (out * torch.tensor(ct, dtype=dtype)).sum() + 1e-3 * boost.sum()
        return (out, boost), torch.autograd.grad(loss, [re, im, fbp, om])

    def jaxs(re, im, fbp, om):
        cosmo = _cosmo_j(om)
        bg = jbg.Background.create(cosmo)
        out = jbr.kaiser_model(cosmo, a.astype(om.dtype), re + 1j * im, BOX, 1.7, fNL_bp=fbp,
                               png_type="fNL", los=jnp.asarray(los, om.dtype), bg=bg)
        boost = jbr.kaiser_boost(cosmo, 0.6, SHAPE, BOX, 1.7, fNL_bp=fbp, png_type="fNL",
                                 los=(0.0, 0.0, 1.0), bg=bg)
        return (out * ct).sum() + 1e-3 * boost.sum(), (out, boost)

    (out, boost), gt = port(torch.float32)
    (oj, bj), gj = _jax64(jaxs, lin.real, lin.imag, 1.3, OM)
    _close(out, oj, 0, 1e-5)
    _close(boost, bj, 1e-5, 1e-5)
    for a_, b_ in zip(gt[:2], gj[:2]):
        _close(a_, b_, 0, 1e-4)
    _close(gt[2], gj[2], 1e-4)
    _close(port(torch.float64)[1][3], gj[3], 2e-3)


@pytest.mark.parametrize("sites", [True, False], ids=["sites", "off-lattice"])
def test_lagrangian_bias_png_operators_match_jax(sites):
    """`lagrangian_bias` with png_type set: the five fNL operators (phi,
    phi dL, phi dL^2, phi s^2, lap phi) read at the lattice sites (strided
    slices) or off them (a 12^3 lattice, `read_multi` at order 1), and the
    full phi mesh it returns: values, and the gradients in the field and
    the six PNG amplitudes."""
    lin = _lin(6)
    ptcl = SHAPE if sites else (12, 12, 12)
    ct = np.random.default_rng(7).standard_normal(int(np.prod(ptcl))).astype(np.float32)
    cphi = np.random.default_rng(8).standard_normal(SHAPE).astype(np.float32)
    bt, bj = tbg.Background.create(tbg.Planck18()), jbg.Background.create(jbg.Planck18())
    re = torch.tensor(lin.real, requires_grad=True)
    im = torch.tensor(lin.imag, requires_grad=True)
    png = {k: torch.tensor(v, requires_grad=True) for k, v in PNG.items()}
    lin_t = torch.complex(re, im)
    w, _, phi = tbr.lagrangian_bias(tbr.regular_pos(SHAPE, ptcl), 0.5, BOX, lin_t, BIAS, bt,
                                    ptcl if sites else None, png=png,
                                    phik=tbr.phi_transfer(tbg.Planck18(), lin_t, BOX, bg=bt)[0])
    # fNL itself enters only through fNL_bias (the amplitudes are its output)
    gt = [torch.zeros(()) if g is None else g for g in torch.autograd.grad(
        (w * torch.tensor(ct)).sum() + (phi * torch.tensor(cphi)).sum(), [re, im, *png.values()],
        allow_unused=True)]

    def jaxs(re, im, *amps):
        wj, _, phij = jbr.lagrangian_bias(
            jbg.Planck18(), jbr.regular_pos(SHAPE, ptcl), 0.5, BOX, re + 1j * im, BIAS,
            dict(zip(PNG_NAMES, amps)), png_type="fNL", read_order=1, bg=bj,
            sites_shape=ptcl if sites else None)
        return (wj * ct).sum() + (phij * cphi).sum(), (wj, phij)

    (_, (wj, phij)), gj = jax.jit(jax.value_and_grad(jaxs, argnums=tuple(range(8)),
                                                     has_aux=True))(
        jnp.asarray(lin.real), jnp.asarray(lin.imag), *map(jnp.float32, PNG.values()))
    _close(w, wj, 0, 1e-5)
    _close(phi, phij, 0, 1e-5)
    for a, b in zip(gt[:2], gj[:2]):
        _close(a, b, 0, 1e-4)
    for a, b in zip(gt[2:], gj[2:]):
        _close(a, b, 1e-4)


def test_eulerian_bias_png_terms_match_jax():
    """`eulerian_bias` with png_type set, on an advected matter mesh and an
    advected phi mesh: fNL bp phi + fNL bpdE (phi d - <phi d>) with bpdE
    the Eulerian bpd; values, and the gradients in both meshes and in fNL,
    fNL_bp and fNL_bpd."""
    rng = np.random.default_rng(9)
    x = (1.0 + 0.3 * rng.standard_normal(SHAPE)).astype(np.float32)
    ph = (1e-4 * rng.standard_normal(SHAPE)).astype(np.float32)
    ct = rng.standard_normal(SHAPE).astype(np.float32)
    names = ("b1", "b2", "bs2", "bn2")
    bias = dict(zip(names, np.array([0.8, -0.3, 0.2, 4.0], np.float32)))
    xt, pt = torch.tensor(x, requires_grad=True), torch.tensor(ph, requires_grad=True)
    png = {k: torch.tensor(PNG[k], requires_grad=True) for k in ("fNL", "fNL_bp", "fNL_bpd")}
    out = tbr.eulerian_bias(torch.fft.rfftn(xt), BOX, bias, phi_mesh=torch.fft.rfftn(pt),
                            png=png, png_type="bias")
    gt = torch.autograd.grad(out, [xt, pt, *png.values()], torch.tensor(ct))

    def fj(y, p, *amps):
        return jbr.eulerian_bias(jnp.fft.rfftn(y), jnp.fft.rfftn(p), BOX, bias,
                                 dict(zip(("fNL", "fNL_bp", "fNL_bpd"), amps)),
                                 png_type="bias")[0]

    oj, gj = jit_vjp(fj, (jnp.asarray(x), jnp.asarray(ph),
                          *(jnp.float32(PNG[k]) for k in ("fNL", "fNL_bp", "fNL_bpd"))),
                     jnp.asarray(ct))
    _close(out, oj, 0, 1e-5)
    for a, b in zip(gt[:2], gj[:2]):
        _close(a, b, 0, 1e-4)
    for a, b in zip(gt[2:], gj[2:]):
        _close(a, b, 1e-4)
