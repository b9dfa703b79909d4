"""The PyTorch port's curved sky against the JAX package on the same numpy
inputs, on the CPU: the curved-sky bricks, the off-lattice branch of
`lagrangian_bias`, and the JAX package's own default configuration; the
helpers of the 16^3 curved-sky 2LPT light cone with the Kaiser-Bessel
window of support 3, whose test is in test_torch_kb_curved_model.py.
Tolerances as test_torch_model.py.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp
from jax.scipy.spatial.transform import Rotation as JRotation

from montecosmo_tpu.ops import background as jbg
from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.ops import background as tbg
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_ops import T, _lin_field, close

torch.set_num_threads(1)

KB = "kaiser_bessel"


@lru_cache(maxsize=None)
def _backgrounds():
    return tbg.Background.create(tbg.Planck18()), jbg.Background.create(jbg.Planck18())


def _rotations(rotvec):
    return tbr.Rotation(rotvec), JRotation.from_rotvec(jnp.asarray(rotvec, jnp.float32))


@pytest.mark.parametrize("rotvec", [(0.0, 0.0, 0.0), (0.1, -0.2, 0.3)])
def test_curved_sky_bricks_match_jax(rotvec):
    """radius_mesh (bit for bit without rotation: the radial bins are cut
    from it), pos_mesh, los_scalefactor_pos / _mesh on the light cone and at
    a fixed a_obs, and rsd with a per-particle line of sight; the observer
    sits on a lattice site and a mesh cell (box_center 0, even mesh)."""
    rt, rj = _rotations(rotvec)
    shape, box, center = (8, 8, 8), (64.0,) * 3, (0.0, 0.0, 0.0)
    tol = 0 if not any(rotvec) else 1e-5
    close(tbr.radius_mesh(center, rt, box, shape), jbr.radius_mesh(center, rj, box, shape), tol, tol)
    close(tbr.radius_mesh((5.0, -3.0, 40.0), rt, box, shape),
          jbr.radius_mesh((5.0, -3.0, 40.0), rj, box, shape), tol, tol)
    bt, bj = _backgrounds()
    rng = np.random.default_rng(68)
    pos = (tbr.regular_pos(shape).numpy() + rng.normal(0, 0.8, (512, 3))).astype(np.float32)
    pos[0] = 4.0  # a particle on the observer
    vel = rng.standard_normal((512, 3)).astype(np.float32)

    def jax_side(p, v):
        out = {"pos_mesh": jbr.pos_mesh(center, rj, box, shape)}
        for a_obs in (None, 0.6):
            out[f"mesh {a_obs}"] = jbr.los_scalefactor_mesh(center, rj, box, shape, bj, a_obs)
            lj, aj = jbr.los_scalefactor_pos(p, center, rj, box, shape, bj, a_obs)
            out[f"pos {a_obs}"] = (lj, aj, jbr.rsd(bj, v, lj, aj, rj, box, shape))
        # the gradient of the light cone's a(|pos|) and line of sight
        out["grad"] = jax.grad(lambda q: sum(x.sum() for x in jbr.los_scalefactor_pos(
            q, center, rj, box, shape, bj)))(p)
        return out

    res = jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(pos, vel))
    close(tbr.pos_mesh(center, rt, box, shape), res["pos_mesh"], 1e-6, 1e-6)
    for a_obs in (None, 0.6):
        lt, at = tbr.los_scalefactor_mesh(center, rt, box, shape, bt, a_obs)
        lj, aj = res[f"mesh {a_obs}"]
        close(lt, lj, 1e-6, 1e-6)
        close(at, aj, 1e-5, 1e-6)
        lt, at = tbr.los_scalefactor_pos(T(pos), center, rt, box, shape, bt, a_obs)
        lj, aj, rsd_j = res[f"pos {a_obs}"]
        close(lt, lj, 1e-5, 1e-6)
        close(at, aj, 1e-5, 1e-6)
        assert not lt[0].abs().max()
        close(tbr.rsd(bt, T(vel), lt, at, rt, box, shape), rsd_j, 1e-4, 1e-5)
    # at the observer: 0 in the port (torch's norm), NaN in the JAX package
    pt = T(pos, True)
    lt, at = tbr.los_scalefactor_pos(pt, center, rt, box, shape, bt)
    (at.sum() + lt.sum()).backward()
    gj = res["grad"]
    assert not pt.grad[0].abs().max() and np.isnan(np.asarray(gj)[0]).all()
    close(pt.grad[1:], np.asarray(gj)[1:], 1e-5, 1e-6)


def test_lagrangian_bias_off_lattice_matches_jax():
    """The off-lattice branch of lagrangian_bias (sites_shape None): the
    fields are read with read_multi at order 1 (K4 at NGP) at the particles
    of a 12^3 lattice in a 16^3 mesh, which it does not refine."""
    shape, ptcl, box, a = (16, 16, 16), (12, 12, 12), (256.0,) * 3, 0.5
    lin = _lin_field(shape, box, 69)
    bias = {"b1": 0.5, "b2": 0.3, "bs2": -0.2, "b3": 0.1, "bds2": 0.1, "bs3": -0.05,
            "bn2": 0.05, "bnpar": 0.2}
    png = {k: 0.0 for k in ("fNL", "fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2", "fNL_bn2p")}
    bt, bj = _backgrounds()
    pt, pj = tbr.regular_pos(shape, ptcl), jbr.regular_pos(shape, ptcl)
    close(pt, pj, 0, 0)
    wt, dvt, _ = tbr.lagrangian_bias(pt, a, box, torch.tensor(lin),
                                     {k: torch.tensor(v) for k, v in bias.items()}, bt, None)
    wj, dvj, _ = jax.jit(lambda m: jbr.lagrangian_bias(
        jbg.Planck18(), pj, a, box, m, bias, png, read_order=1, bg=bj, sites_shape=None))(
        jnp.asarray(lin))
    assert wt.shape == (12**3,)
    close(wt, wj, 1e-4, 1e-5)
    close(dvt, dvj, 1e-4, 1e-5)


def _curved_conf(**updates):
    """The 16^3 curved-sky 2LPT light cone with the JAX package's default
    geometry (observer at the box center), every mesh 16^3."""
    conf = dict(final_shape=(16, 16, 16), cell_length=8.0, evolution="lpt", a_obs=None,
                curved_sky=True, box_center=(0.0, 0.0, 0.0), lik_type="quad_gauss",
                precond="kaiser", kernel_type=KB, paint_order=3, init_oversamp=1.0,
                evol_oversamp=1.0, ptcl_oversamp=1.0, paint_oversamp=1.0)
    return conf | updates


def _port_value_and_grad(tm, p, count):
    from montecosmo_tpu_torch.convert import params_from_numpy

    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    lt = tm.logpdf({**tp, "count_mesh": torch.as_tensor(count)})
    lt.backward()
    return lt.item(), {k: v.grad.numpy() for k, v in tp.items()}


def _close_value_and_grad(lt, gt, lj, gj, scale):
    """logpdf relative 1e-5; gradients rtol 1e-3 with atol 1e-4 * scale[k]
    per latent k (test_torch_model.py:115-120, where the scale is max|g| of
    the one input)."""
    assert np.isfinite(lt) and abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
    assert set(gj) == set(gt)
    for k, gjk in gj.items():
        assert np.isfinite(gt[k]).all(), k
        np.testing.assert_allclose(gt[k], gjk, rtol=1e-3, atol=1e-4 * scale[k], err_msg=k)


def test_default_config_builds_and_evaluates_on_the_cpu():
    """The JAX package's own default geometry (curved sky, light cone,
    observer at the box center) builds in the port; at 16^3 with the
    Kaiser-Bessel window of support 4 and a particle lattice (12^3) that the
    evolution and paint meshes do not refine (order-1 reads, scatter paint),
    one logpdf value+grad is finite.  The 64^3 default itself is evaluated
    by chip_smoke.py, on the card and on the CPU."""
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    big = FieldLevelModel(**default_config, device="cpu")
    assert big.curved_sky and big.a_obs is None and big.evol_sites == big.ptcl_shape
    m = FieldLevelModel(**{**default_config, **_curved_conf(paint_order=4, ptcl_oversamp=0.75)},
                        device="cpu")
    assert m.evol_sites is None and m.paint_lattice is None
    p = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    p["white_mesh_"] = torch.as_tensor(
        np.random.default_rng(71).standard_normal(m.init_shape).astype(np.float32))
    obs = {"count_mesh": m.predict(seed=1, samples=p, hide_samp=False)["count_mesh"]}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    lp = m.logpdf({**leaves, **obs})
    lp.backward()
    assert np.isfinite(lp.item())
    assert all(bool(torch.isfinite(v.grad).all()) for v in leaves.values())
