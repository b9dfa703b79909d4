"""The port's catalogs and selections against the JAX package on the CPU:
the sky <-> cartesian geometry, the top-hat and generalized-Gaussian
selections and the box fitted to randoms; the helpers and tolerances of
the `register_catalog` tests (the port's on the CPU runs K1's and K3's
plain versions): the cut sky's in test_torch_survey_register.py, the full
sky's in test_torch_box_register.py, each a 16^3 cell budget.

Catalogs: the geometry of examples/cutsky_inference.py (RA 150-210 deg, DEC
+-20 deg uniform on the sphere, z triangular 0.8-1.0-1.2, unit weights),
seeded numpy.  Tolerances (float32 in both packages):
* coordinates and selections: 2e-6 of the largest value (elementwise
  float32 chains, the radius through the distance table);
* the box: `minmax_box` equal (float32 min/max in both), the fitted
  shape equal, cell length and centre within 1e-5 relative (of cartesian
  randoms that differ by float32 rounding);
* register masks: equal cell for cell (a boolean of a float paint: the
  plain paint is a sum of non-negative terms, zero only where no corner
  reaches);
* register counts: 1e-5 of the largest value (the same paints, summed in
  another order, through FFTs in another order); the selection 2e-5 (also
  divided by its float32 mean over the footprint, and resampled to the
  paint shape through two more FFTs: 1.25e-5 measured);
* the full sky's count conservation (its assert, rtol 1e-3) holds, and the
  counts sum to the tracers' weight within 1e-5.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.models import bricks as jbr
from montecosmo_tpu.ops import background as jbg
from montecosmo_tpu.utils import geometry as jgeo

from montecosmo_tpu_torch.models import bricks as tbr
from montecosmo_tpu_torch.ops import background as tbg
from montecosmo_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)

OMEGA_M, SIGMA8 = 0.3137721, 0.8076354


def catalog(n, seed):
    """The cut-sky catalog of examples/cutsky_inference.py:29-48."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(150.0, 210.0, n)
    smin, smax = np.sin(np.deg2rad(-20.0)), np.sin(np.deg2rad(20.0))
    dec = np.rad2deg(np.arcsin(rng.uniform(smin, smax, n)))
    z = rng.triangular(0.8, 1.0, 1.2, n)
    return dict(RA=ra, DEC=dec, Z=z, WEIGHT=np.ones(n))


def _close(t, j, rtol):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * np.abs(j).max())


def _cosmos():
    return (tbg.get_cosmology(Omega_m=OMEGA_M, sigma8=SIGMA8),
            jbg.get_cosmology(Omega_m=OMEGA_M, sigma8=SIGMA8))


def test_sky_geometry_and_selections_match_jax():
    """radecrad2cart / cart2radecrad, radecz2cart / cart2radecz (the
    distance table both ways), top_hat_selection at three norm and power
    orders with padding, gen_gauss_selection on the flat and the curved
    sky, minmax_box, get_mesh_shape and cutsky2config."""
    cat = catalog(2000, 0)
    ct, cj = _cosmos()
    bt, bj = tbg.Background.create(ct), jbg.Background.create(cj)
    radius = np.linspace(100.0, 3000.0, 2000)
    _close(tgeo.radecrad2cart(cat["RA"], cat["DEC"], radius),
           jgeo.radecrad2cart(jnp.asarray(cat["RA"]), jnp.asarray(cat["DEC"]),
                              jnp.asarray(radius)), 2e-6)
    cart = tbr.radecz2cart(bt, cat)
    _close(cart, jbr.radecz2cart(bj, cat), 2e-6)
    back_t, back_j = tbr.cart2radecz(bt, cart), jbr.cart2radecz(bj, jnp.asarray(cart.numpy()))
    for k in ("RA", "DEC", "Z"):
        _close(back_t[k], back_j[k], 2e-6)
        _close(back_t[k], cat[k], 5e-5)  # the round trip, through float32 tables

    for norm, power, pad in ((np.inf, np.inf, 0.0), (2.0, 4.0, 0.2), (1.0, 2.0, 0.1)):
        _close(tbr.top_hat_selection((12, 10, 8), pad, norm, power),
               jbr.top_hat_selection((12, 10, 8), pad, norm, power), 2e-6)
    box_size, center = np.array([400.0, 300.0, 500.0]), np.array([100.0, -50.0, 1500.0])
    for curved in (False, True):
        rot_t, rot_j = tbr.Rotation([0.1, -0.2, 0.3]), None
        from jax.scipy.spatial.transform import Rotation as JRotation
        rot_j = JRotation.from_rotvec(jnp.asarray([0.1, -0.2, 0.3]))
        _close(tbr.gen_gauss_selection(center, rot_t, box_size, (12, 10, 8), curved),
               jbr.gen_gauss_selection(center, rot_j, box_size, (12, 10, 8), curved), 2e-6)

    size_t, center_t, rot_t = tbr.minmax_box(cart)
    size_j, center_j, rot_j = jbr.minmax_box(jnp.asarray(cart.numpy()))
    np.testing.assert_array_equal(size_t, size_j)
    np.testing.assert_array_equal(center_t, center_j)
    assert tbr.get_mesh_shape(size_t, 4096, 0.1) == jbr.get_mesh_shape(size_j, 4096, 0.1)
    shape_t, cell_t, c_t, r_t = tbr.cutsky2config(cat, bt, 16**3)
    shape_j, cell_j, c_j, r_j = jbr.cutsky2config(cat, bj, 16**3)
    assert shape_t == shape_j and all(s % 2 == 0 for s in shape_t)
    np.testing.assert_allclose(cell_t, cell_j, rtol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(r_t, r_j)


def _register_both(**kwargs):
    from montecosmo_tpu import FieldLevelModel as JaxModel
    from montecosmo_tpu_torch import FieldLevelModel

    ct, cj = _cosmos()
    return (FieldLevelModel.register_catalog(cosmo_fid=ct, device="cpu", **kwargs),
            JaxModel.register_catalog(cosmo_fid=cj, **kwargs))


def _hold_register(rt, rj):
    assert set(k for k, v in rt.items() if v is not None) == set(
        k for k, v in rj.items() if v is not None)
    for k, vj in rj.items():
        vt = rt[k]
        if vj is None or k in ("count_mesh", "selec_mesh", "mask_mesh"):
            continue
        if isinstance(vj, dict):
            assert vt == pytest.approx(vj, rel=1e-7), k
        elif isinstance(vj, (str, bool)) or vj is None:
            assert vt == vj, k
        else:
            np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-2, err_msg=k)
        assert type(vt) is type(vj) or np.ndim(vj) > 0, (k, type(vt), type(vj))
    _close(rt["count_mesh"], rj["count_mesh"], 1e-5)
    assert rt["count_mesh"].shape == rj["count_mesh"].shape


def registered_parity(h5_path, npz_path, **updates):
    """The logpdf value and gradient of the model of a register file: the
    port's (from `npz_path`, float32 and float64) against the JAX package's
    (from `h5_path`, built and run in float64, one compile), on the same
    numpy latents (the fiducial moved 0.3 sigma but s_e2_, a seeded white
    mesh) and the register's own counts, at
    `test_torch_likelihoods.hold_value_and_grad`'s tolerances.  The latents
    are unbounded (as in `model_parity`: the truncated-normal transports
    cost ~25 s of each JAX compile), n_rbins 1 (the CLI's).  Returns the
    port's model."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default
    from montecosmo_tpu_torch import FieldLevelModel, default_config
    from test_torch_likelihoods import UNBOUNDED, hold_value_and_grad

    conf = dict(latents=UNBOUNDED, n_rbins=1, **updates)
    with jax.enable_x64(True):
        jm = JaxModel(**{**jax_default, **conf, "register": str(h5_path)})
    tm = FieldLevelModel(**{**default_config, **conf, "register": str(npz_path)}, device="cpu")
    for attr in ("final_shape", "init_shape", "evol_shape", "paint_shape", "ptcl_shape",
                 "max_disp", "paint_lattice", "a_obs", "curved_sky", "n_rbins"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    np.testing.assert_allclose(tm.redges, jm.redges, rtol=1e-6)
    obs = np.asarray(jm.count_mesh)
    np.testing.assert_array_equal(tm.count_mesh.numpy(), obs)
    assert (tm.mask_mesh is None) == (jm.mask_mesh is None)
    if tm.mask_mesh is not None:
        np.testing.assert_array_equal(tm.mask_mesh.numpy(), jm.mask_mesh)
    for k, v in jm.fiduc.items():
        np.testing.assert_allclose(tm.fiduc[k], v, rtol=1e-12, err_msg=k)

    rng = np.random.default_rng(0)
    p = {k: np.asarray(v, np.float32) for k, v in jm.reparam(dict(jm.fiduc), inv=True).items()}
    for k in p:
        if k != "s_e2_":
            p[k] = (p[k] + 0.3 * rng.standard_normal(np.shape(p[k]))).astype(np.float32)
    p["white_mesh_"] = rng.standard_normal(jm.init_shape).astype(np.float32)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tp = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in p.items()}
        lp = tm.logpdf({**tp, "count_mesh": torch.as_tensor(obs, dtype=dtype)})
        lp.backward()
        grads[dtype] = (lp.item(), {k: v.grad.numpy() for k, v in tp.items()})
    with jax.enable_x64(True):
        lj, gj = jax.jit(jax.value_and_grad(lambda q, o: jm.logpdf({**q, "count_mesh": o})))(
            {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}, jnp.asarray(obs, jnp.float64))
        lj, gj = float(lj), {k: np.asarray(v) for k, v in gj.items()}
    hold_value_and_grad(*grads[torch.float32], grads[torch.float64][1], lj, gj)
    return tm
