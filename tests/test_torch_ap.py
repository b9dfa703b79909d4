"""The port's Alcock-Paczynski (AP) geometry against the JAX package on the
CPU: `scale_pos`, `parperp2isoap`, `isoap2parperp`, `ap_param`, `ap_auto`,
`ap_auto_absdetjac`, `rsd_ap_auto` and `Background.a2chi`, values and
gradients, on the flat and the curved sky; and two model cases through
`model_parity` (its tolerances and its float64 JAX reference,
test_torch_likelihoods.py): 2LPT with ap_auto=True and png_type='fNL'
(there the JAX package's
float32 gradient is off its own float64 one by 12% in Omega_m_, 30% in
bnpar_ and 6% in white_mesh_, where the port's float32 is within 1.4e-4
of its float64; measured), and the Kaiser evolution with ap_auto=False
(its re-paint through `nufft`) and png_type='fNL'; the JAX model's state
carried by `convert.config_from_numpy`.

Tolerances: the geometry helpers and `ap_param` 1e-6 relative (float32
in both packages).  `ap_auto`, `ap_auto_absdetjac`, `rsd_ap_auto` and
`a2chi`, the port's float32 against the JAX package's float64: 2e-5
relative in value (the port's float32 tables and lookups), the gradients
in the positions and velocities 1e-4 of their largest entry.  At a table node
the slope of the lookups jumps, by up to 3% between neighbouring brackets,
and a distance that rounds to the node's other side in the other package
takes the other slope: of |det J| (its alpha' is that slope) and of the
remaps' position and velocity gradients at most 1% of the entries may be
off 1e-4, and those within 5e-2 (at most 3 of 1536 measured).  Gradients in Omega_m are
held in float64 in both packages at 2e-3 relative: a cotangent-weighted
sum over the particles of a derivative through the tables cancels, and
both packages' float32 sums are off their float64 ones by more than the
sum (rsd_ap_auto, below).  |det J|'s gradients (alpha'', and alpha', a
difference of terms 1/r apart, 200 times smaller than they are; the
port's distance grid and nodes are float32 in both dtypes, JAX's float64
under x64: alpha' 5e-4 apart in float64, measured) at 1e-2 of their
largest entry, in float64.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.models import bricks as jbr
from montecosmo_tpu.ops import background as jbg

from montecosmo_tpu_torch.models import bricks as tbr
from montecosmo_tpu_torch.ops import background as tbg
from test_torch_likelihoods import BASE, UNBOUNDED, jax_logpdf_program, model_parity, \
    parity_inputs

torch.set_num_threads(1)

OM, OM_FID, S8 = 0.29, 0.3111, 0.81
CENTER = np.array([0.0, 0.0, 1000.0])
LOS = CENTER / np.linalg.norm(CENTER)
SKIES = [False, True]
# the fiducial cosmology moved off the prior's centre, so that the AP remap
# (which reads the fiducial distances) depends on it
MOVED = {k: dict(v, **{"Omega_m": {"loc_fid": 0.30}, "sigma8": {"loc_fid": 0.79}}.get(k, {}))
         for k, v in UNBOUNDED.items()}
MODEL_CASES = {"lpt_ap_auto_fNL": dict(evolution="lpt", ap_auto=True, png_type="fNL",
                                       latents=MOVED),
               "kaiser_ap_param_fNL": dict(evolution="kaiser", ap_auto=False, png_type="fNL")}


def _close(t, j, rtol, atol_rel=0.0):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_rel * max(np.abs(j).max(), 1e-30))


def _close_but_nodes(t, j):
    """Within 1e-4 (relative, and of the largest entry) but for at most 1%
    of the entries, those within 5e-2: the positions whose distance falls
    on the other side of a table node in the other package."""
    t, j = (t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)), np.asarray(j)
    off = np.abs(t - j) > 1e-4 * (np.abs(j) + np.abs(j).max())
    assert np.mean(off) <= 0.01, (np.sum(off), off.size)
    np.testing.assert_allclose(t, j, rtol=5e-2, atol=1e-4 * np.abs(j).max())


def _inputs(n=512, seed=0):
    """Physical positions in a 400 Mpc/h box around CENTER, velocities,
    cotangents and per-particle scale factors, float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pos = (CENTER + rng.uniform(-200, 200, (n, 3))).astype(np.float32)
    return dict(pos=pos, vel=30 * f(n, 3), ct=f(n, 3), cj=f(n),
                a=rng.uniform(0.6, 0.8, (n, 1)).astype(np.float32))


def _bgs_torch(om):
    """The sampled and the fiducial backgrounds in `om`'s dtype."""
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=om, sigma8=torch.tensor(S8)))
    fid = torch.tensor(OM_FID, dtype=om.dtype)
    return bg, tbg.Background.create(tbg.get_cosmology(Omega_m=fid, sigma8=S8))


def _bgs_jax(om):
    bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=S8))
    fid = jnp.asarray(OM_FID, om.dtype)
    return bg, jbg.Background.create(jbg.get_cosmology(Omega_m=fid, sigma8=S8))


def _both(fn_t, fn_j, x, argnames):
    """The port's `fn_t` in float32 and in float64, and the JAX package's
    `fn_j` in float64 (one jax.enable_x64 compile), of the inputs `x` named
    `argnames` and Omega_m, each function returning (a list of scalar
    losses, outputs): {dtype: (outputs, [gradients of each loss])} for the
    port and JAX, `None` for the port's unused inputs."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        args = [torch.tensor(x[k], dtype=dtype, requires_grad=True) for k in argnames]
        om = torch.tensor(OM, dtype=dtype, requires_grad=True)
        losses, outs = fn_t(*args, om)
        out[dtype] = (outs, [torch.autograd.grad(l, [*args, om], retain_graph=True,
                                                 allow_unused=True) for l in losses])
    with jax.enable_x64(True):
        argnums = tuple(range(len(argnames) + 1))
        jac, outs_j = jax.jit(jax.jacrev(lambda *a: (lambda l, o: (jnp.stack(l), o))(
            *fn_j(*a)), argnums=argnums, has_aux=True))(
            *[jnp.asarray(x[k], jnp.float64) for k in argnames], jnp.float64(OM))
        outs_j, jac = jax.tree_util.tree_map(np.asarray, (outs_j, jac))
    out["jax"] = (outs_j, [[g[i] for g in jac] for i in range(len(jac[0]))])
    return out


def test_ap_geometry_helpers_match_jax():
    """`scale_pos` along a line of sight and per-position ones, and the
    (par, perp) <-> (iso, AP) conversions, with their gradients."""
    x = _inputs()
    los_each = x["vel"] / np.linalg.norm(x["vel"], axis=-1, keepdims=True)
    for los in (LOS, los_each):
        pt = torch.tensor(x["pos"], requires_grad=True)
        sp = torch.tensor(1.03, requires_grad=True)
        sq = torch.tensor(0.97, requires_grad=True)
        out = tbr.scale_pos(pt, los, sp, sq)
        gt = torch.autograd.grad((out * torch.tensor(x["ct"])).sum(), [pt, sp, sq])
        fj = lambda p, a, b: (jbr.scale_pos(p, jnp.asarray(los, jnp.float32), a, b)
                              * x["ct"]).sum()
        gj = jax.jit(jax.grad(fj, argnums=(0, 1, 2)))(jnp.asarray(x["pos"]), jnp.float32(1.03),
                                                      jnp.float32(0.97))
        _close(out, jbr.scale_pos(jnp.asarray(x["pos"]), jnp.asarray(los, jnp.float32), 1.03,
                                  0.97), 1e-6)
        for a, b in zip(gt, gj):
            _close(a, b, 1e-5, 1e-6)
    for fn in ("parperp2isoap", "isoap2parperp"):
        a, b = torch.tensor(1.04, requires_grad=True), torch.tensor(0.95, requires_grad=True)
        ot = getattr(tbr, fn)(a, b)
        gt = torch.autograd.grad(ot[0] + 3 * ot[1], [a, b])
        oj = getattr(jbr, fn)(jnp.float32(1.04), jnp.float32(0.95))
        gj = jax.grad(lambda u, v: (lambda o: o[0] + 3 * o[1])(getattr(jbr, fn)(u, v)),
                      argnums=(0, 1))(jnp.float32(1.04), jnp.float32(0.95))
        for u, v in zip(ot + gt, oj + gj):
            _close(u, v, 1e-6)
    back = tbr.isoap2parperp(*tbr.parperp2isoap(torch.tensor(1.04), torch.tensor(0.95)))
    _close(torch.stack(back), np.array([1.04, 0.95], np.float32), 1e-6)


@pytest.mark.parametrize("curved_sky", SKIES, ids=["flat", "curved"])
def test_ap_param_matches_jax(curved_sky):
    """`ap_param`: alpha_iso (curved sky) or alpha_par, alpha_perp along the
    line of sight (flat sky); gradients in the positions and both alphas."""
    x = _inputs(seed=1)
    pt = torch.tensor(x["pos"], requires_grad=True)
    al = {k: torch.tensor(v, requires_grad=True) for k, v in (("alpha_iso", 1.02),
                                                               ("alpha_ap", 0.97))}
    out = tbr.ap_param(pt, LOS, al, curved_sky)
    gt = torch.autograd.grad((out * torch.tensor(x["ct"])).sum(), [pt, *al.values()],
                             allow_unused=True)

    def fj(p, iso, ap):
        return (jbr.ap_param(p, LOS, {"alpha_iso": iso, "alpha_ap": ap}, curved_sky)
                * x["ct"]).sum()

    oj = jbr.ap_param(jnp.asarray(x["pos"]), LOS, {"alpha_iso": jnp.float32(1.02),
                                                   "alpha_ap": jnp.float32(0.97)}, curved_sky)
    gj = jax.jit(jax.grad(fj, argnums=(0, 1, 2)))(jnp.asarray(x["pos"]), jnp.float32(1.02),
                                                  jnp.float32(0.97))
    _close(out, oj, 1e-6)
    for a, b in zip(gt, gj):
        _close(torch.zeros(()) if a is None else a, b, 1e-5, 1e-6)


@pytest.mark.parametrize("curved_sky", SKIES, ids=["flat", "curved"])
def test_ap_auto_and_absdetjac_match_jax(curved_sky):
    """`ap_auto` and `ap_auto_absdetjac` (the remap and its |det J|, alpha'
    by autograd in the port, `jax.grad` in JAX) with a sampled Omega_m
    against the fiducial one; `Background.a2chi`.  Gradients of
    cotangent-weighted sums in the positions (the remap's in float32) and
    in Omega_m (through K8's tables and both lookups); |det J|'s gradients
    in float64 in both packages (its position gradient is alpha'' and
    alpha', differences of terms 1/r apart)."""
    x = _inputs(seed=2)
    x["a_q"] = np.linspace(0.0005, 1.0, 97).astype(np.float32)

    def fn_t(pos, a_q, om):
        bg, bg_fid = _bgs_torch(om)
        out = tbr.ap_auto(pos, LOS, bg, bg_fid, curved_sky)
        pos2, jac = tbr.ap_auto_absdetjac(pos, LOS, bg, bg_fid, curved_sky)
        chi = bg.a2chi(a_q)
        f = lambda k: torch.tensor(x[k], dtype=pos.dtype)
        return [((out + pos2) * f("ct")).sum() + 1e-3 * chi.sum(), (jac * f("cj")).sum()], \
            (out, pos2, chi, jac)

    def fn_j(pos, a_q, om):
        bg, bg_fid = _bgs_jax(om)
        out = jbr.ap_auto(pos, LOS, bg, bg_fid, curved_sky)
        pos2, jac = jbr.ap_auto_absdetjac(pos, LOS, bg, bg_fid, curved_sky)
        chi = bg.a2chi(a_q)
        return [((out + pos2) * x["ct"]).sum() + 1e-3 * chi.sum(), (jac * x["cj"]).sum()], \
            (out, pos2, chi, jac)

    res = _both(fn_t, fn_j, x, ("pos", "a_q"))
    (out, pos2, chi, jac), (gt, _) = res[torch.float32]
    (oj, pj, cj, jj), (gj, gj_jac) = res["jax"]
    _close(out, oj, 2e-5)
    _close(pos2, pj, 2e-5)
    _close(chi, cj, 2e-5, 1e-6)
    _close_but_nodes(gt[0], gj[0])
    _close_but_nodes(jac, jj)
    _, (gt, gt_jac) = res[torch.float64]
    _close(gt[-1], gj[-1], 2e-3)
    # |det J|'s gradients: 1e-2 of their largest entry (or of 1e-12: on the
    # flat sky the position gradient is (chi_fid(a(r)))'', zero between
    # table nodes)
    for a, b in zip(gt_jac[::2], gj_jac[::2]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2 * max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("curved_sky", SKIES, ids=["flat", "curved"])
def test_rsd_ap_auto_matches_jax(curved_sky):
    """`rsd_ap_auto`: the scale factor redshifted by the line-of-sight
    velocity through the port's `Esqr`, placed at the fiducial distance;
    gradients in the positions and velocities (float32) and in Omega_m
    (float64 in both packages: in float32 a cancelling sum, -0.615 and
    -0.619 against float64's +0.2626 on the flat sky, measured)."""
    x = _inputs(seed=3)
    x["rpos"] = np.linalg.norm(x["pos"], axis=-1, keepdims=True).astype(np.float32)
    los = x["pos"] / x["rpos"] if curved_sky else LOS

    def fn_t(pos, vel, om):
        f = lambda k: torch.tensor(x[k], dtype=pos.dtype)
        out = tbr.rsd_ap_auto(pos, vel, f("rpos"), los, f("a"), *_bgs_torch(om), curved_sky)
        return [(out * f("ct")).sum()], out

    def fn_j(pos, vel, om):
        out = jbr.rsd_ap_auto(pos, vel, x["rpos"].astype(pos.dtype), jnp.asarray(los, pos.dtype),
                              x["a"].astype(pos.dtype), *_bgs_jax(om), curved_sky)
        return [(out * x["ct"]).sum()], out

    res = _both(fn_t, fn_j, x, ("pos", "vel"))
    (out, (gt,)), (oj, (gj,)) = res[torch.float32], res["jax"]
    _close(out, oj, 2e-5)
    for a, b in zip(gt[:2], gj[:2]):
        _close_but_nodes(a, b)
    _close(res[torch.float64][1][0][2], gj[2], 2e-3)


@pytest.mark.parametrize("case", ["lpt_ap_auto_fNL", "kaiser_ap_param_fNL"])
def test_ap_models_match_jax(case):
    """The logpdf value and gradient of the 8^3 model with AP (and PNG): the
    2LPT particles remapped through the fiducial distances after RSD
    (alpha_iso_ and alpha_ap_ then have no gradient), and the Kaiser mesh
    read at the particle lattice, remapped by the `ap` latents and painted
    back through `nufft` (K1/K3, K2 in the backward)."""
    model_parity(**MODEL_CASES[case])


def test_config_from_numpy_carries_ap_and_png_state():
    """`convert.config_from_numpy` of the JAX model of the 2LPT ap_auto=True,
    png_type='fNL' case (its fiducial cosmology moved off the prior's
    centre, its `png` and `ap` latents): the port's model built from it has
    the JAX model's fiducial cosmology and derived configuration, and its
    float64 logpdf at the same latents and counts is the JAX package's
    (float64, the case's own compiled program) within 1e-7 relative (the
    port's lookups take float32 nodes in both dtypes: 3.4e-8 measured); the
    port's model built from the default fiducial is not (the state
    matters: 1.3e-3 apart measured, held > 1e-4)."""
    from dataclasses import asdict

    from montecosmo_tpu_torch import FieldLevelModel, default_config
    from montecosmo_tpu_torch.convert import config_from_numpy, params_from_numpy

    updates = MODEL_CASES["lpt_ap_auto_fNL"]
    jm, _, p = parity_inputs({**BASE, **updates}, False, x64=True)
    jm, vg64 = jax_logpdf_program(jm, ("count_mesh", False, repr(sorted(updates.items()))))
    tm = FieldLevelModel(**config_from_numpy(asdict(jm), device="cpu"))
    assert (tm.ap_auto, tm.png_type) == (True, "fNL")
    assert {"alpha_iso", "alpha_ap"} <= set(tm.groups["ap"])
    assert {"fNL", "fNL_bp", "fNL_bpd"} <= set(tm.groups["png"])
    np.testing.assert_allclose([float(tm.cosmo_fid.Omega_m), float(tm.cosmo_fid.sigma8)],
                               [0.30, 0.79], rtol=1e-12)
    for attr in ("init_shape", "paint_shape", "max_disp", "paint_lattice", "n_rbins"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    np.testing.assert_allclose(tm.a_fid, jm.a_fid, rtol=1e-5)
    obs = tm.predict(seed=1, samples=params_from_numpy(p, "cpu"), hide_samp=False)["count_mesh"]
    q64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}
    lt = tm.logpdf({**q64, "count_mesh": obs.double()}).item()
    with jax.enable_x64(True):
        lj = float(vg64({k: jnp.asarray(v, jnp.float64) for k, v in p.items()},
                        {"count_mesh": jnp.asarray(obs.numpy(), jnp.float64)})[0])
    assert abs(lt - lj) <= 1e-7 * abs(lj), (lt, lj)
    tdef = FieldLevelModel(**{**default_config, **BASE, **updates, "latents": UNBOUNDED},
                           device="cpu")
    ld = tdef.logpdf({**q64, "count_mesh": obs.double()}).item()
    assert abs(ld - lj) > 1e-4 * abs(lj), (ld, lj)
