"""The PyTorch port's FieldLevelModel (montecosmo_tpu_torch) against the JAX
package, on the CPU: the golden 32^3 forward, the 16^3 logpdf value and
gradient, and the import boundary (the port never imports jax).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from montecosmo_tpu_torch import FieldLevelModel, default_config
from montecosmo_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def golden_forward_32(evolution):
    """The port's `predict` on the golden white mesh, held to the committed
    gxy_<evolution> at test_golden_bundle.py's tolerances (transfer within
    2e-3, coherence above 1 - 1e-5, multipoles rtol 5e-3)."""
    import test_golden_bundle as tg
    from montecosmo_tpu.metrics import powtranscoh

    conf = dict(default_config)
    conf.update(final_shape=3 * (tg.FINAL,), cell_length=tg.BOX / tg.FINAL,
                evolution=evolution, lpt_order=2, a_obs=tg.A_OBS, curved_sky=False,
                box_center=(0.0, 0.0, 2000.0), ap_auto=None, lik_type="quad_gauss",
                precond="real")
    model = FieldLevelModel(**conf, device="cpu")
    g = np.load(tg.GOLDEN)
    params = model.reparam({k: np.asarray(v) for k, v in model.fiduc.items()}
                           | tg.FID_UPDATES, inv=True)
    params["white_mesh_"] = torch.as_tensor(g["white"])
    gxy = model.predict(seed=1, samples=params, hide_base=False, hide_det=False,
                        hide_samp=False)["gxy_mesh"].numpy()
    ref = g[f"gxy_{evolution}"]
    assert gxy.shape == ref.shape and np.isfinite(gxy).all()
    _, _, trans, coh = (np.asarray(x) for x in powtranscoh(
        gxy - 1.0, ref - 1.0, box_size=3 * (tg.BOX,), include_corners=False))
    np.testing.assert_allclose(trans, 1.0, atol=2e-3)
    assert coh.min() > 1 - 1e-5, coh.min()
    k, p = tg.multipoles(gxy)
    kr, pr = tg.multipoles(ref)
    np.testing.assert_allclose(k, kr, rtol=1e-6)
    # the bundle stores the multipole keys only, so compare the multipoles
    # of both meshes (monopole, quadrupole, hexadecapole)
    from montecosmo_tpu.metrics import spectrum

    _, pp = spectrum(gxy - 1.0, box_size=3 * (tg.BOX,), ells=tg.ELLS,
                     los=(0.0, 0.0, 1.0), include_corners=False)
    _, pq = spectrum(ref - 1.0, box_size=3 * (tg.BOX,), ells=tg.ELLS,
                     los=(0.0, 0.0, 1.0), include_corners=False)
    pp = np.stack([np.asarray(pp[e]) for e in tg.ELLS])
    pq = np.stack([np.asarray(pq[e]) for e in tg.ELLS])
    np.testing.assert_allclose(pp, pq, rtol=5e-3, atol=2e-3 * np.abs(pq[0]).max())


def test_golden_forward_lpt_32():
    golden_forward_32("lpt")


# the JAX value_and_grad of each configuration, compiled once per process
# (the latents and the counts are its arguments): the two 16^3 2LPT tests
# share one, in float64, with test_torch_handlers.py
JAX_VALUE_AND_GRAD = {}


def jax_value_and_grad_16(jm, conf, x64=False):
    """The JAX package's jitted value_and_grad of jm.logpdf({**q, **o})
    (latents q, observation o) of configuration `conf`, cached per process
    under (conf, x64): traced at its first call, so `jm` must then be
    unconditioned; with `x64`, call it under jax.enable_x64.  At o = the
    counts it is the conditioned model's logpdf, which
    test_torch_handlers.py holds the port's handlers against."""
    import jax

    key = (repr(sorted((k, v) for k, v in conf.items())), x64)
    if key not in JAX_VALUE_AND_GRAD:
        JAX_VALUE_AND_GRAD[key] = jax.jit(jax.value_and_grad(lambda q, o: jm.logpdf({**q, **o})))
    return JAX_VALUE_AND_GRAD[key]


def logpdf_and_grad_16(evolution, s_e2=None, x64=False, **updates):
    """logpdf value and gradient (white_mesh_ and every scalar latent) at the
    __graft_entry__._small_model(final=16, evolution) configuration with
    `updates`, same numpy inputs and the same count_mesh for both packages.

    Tolerances: logpdf relative 1e-5 (a float32 sum of ~10^4 terms taken in
    another order); gradients rtol 1e-3 with atol 1e-4 * max|g_jax| per
    latent.  The scalar latents are moved off the fiducial point by
    0.3 sigma, except s_e2_, which is `s_e2` when given and else its
    fiducial 0 (as in entry()), where the likelihood takes its Gaussian
    branch.  At s_e2 != 0 the JAX package's float32 gradient in scale2 is
    ill-conditioned (its completed square cancels two numbers of size
    |s1 / (2 s2)|: 1-3% from float64), and the port's, written without that
    cancellation (tests/test_torch_quadgauss.py), is held instead against
    the port's own model run in float64 on the CPU, at the same tolerance.
    With `x64` the JAX side runs in float64 (the JAX model built in
    float32, its program traced and run under jax.enable_x64).
    """
    import jax
    from jax import numpy as jnp

    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default

    # __graft_entry__._small_model(final=16, evolution), then `updates`
    conf = dict(final_shape=(16, 16, 16), cell_length=8.0, evolution=evolution, a_obs=0.5,
                curved_sky=False, box_center=(0.0, 0.0, 1000.0), lik_type="quad_gauss",
                precond="kaiser", init_oversamp=1.0, evol_oversamp=1.0,
                ptcl_oversamp=1.0, paint_oversamp=1.0)
    conf.update(updates)
    jm = JaxModel(**{**jax_default, **conf})
    tm = FieldLevelModel(**{**default_config, **conf}, device="cpu")
    assert (tm.max_disp, tm.paint_lattice) == (jm.max_disp, jm.paint_lattice)

    rng = np.random.default_rng(0)
    p = {k: np.asarray(v, np.float32) for k, v in jm.reparam(dict(jm.fiduc), inv=True).items()}
    for k in p:
        if k != "s_e2_":
            p[k] = (p[k] + 0.3 * rng.standard_normal(np.shape(p[k]))).astype(np.float32)
    p["white_mesh_"] = rng.standard_normal(jm.init_shape).astype(np.float32)
    if s_e2 is not None:
        p["s_e2_"] = np.asarray(jm.reparam({"s_e2": np.float32(s_e2)}, inv=True)["s_e2_"],
                                np.float32)
    count = tm.predict(seed=1, samples=params_from_numpy(p, "cpu"), hide_base=False,
                       hide_det=False, hide_samp=False)["count_mesh"].numpy()

    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    lt = tm.logpdf({**tp, "count_mesh": torch.as_tensor(count)})
    lt.backward()

    dtype = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        lj, gj = jax_value_and_grad_16(jm, conf, x64)(
            {k: jnp.asarray(v, dtype) for k, v in p.items()},
            {"count_mesh": jnp.asarray(count, dtype)})
        lj, gj = float(lj), {k: np.asarray(g) for k, g in gj.items()}

    assert np.isfinite(lt.item()) and abs(lt.item() - float(lj)) <= 1e-5 * abs(float(lj))
    assert set(gj) == set(tp)
    ref = dict(gj)
    if s_e2 is not None:
        t64 = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True) for k, v in p.items()}
        tm.logpdf({**t64, "count_mesh": torch.as_tensor(count, dtype=torch.float64)}).backward()
        ref["s_e2_"] = t64["s_e2_"].grad.numpy()
        # measured at s_e2 = 0.03: port float32 -1.226501, float64 -1.226494,
        # JAX float32 -1.238844 (1.0% off)
        print(f"gradient in s_e2_: port float32 {tp['s_e2_'].grad.item():.6f}, float64 "
              f"{ref['s_e2_'].item():.6f}; JAX {'float64' if x64 else 'float32'} "
              f"{float(gj['s_e2_']):.6f}")
    for k, gk in ref.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), gk, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(gk).max(), 1e-30), err_msg=k)


def test_logpdf_and_grad_match_jax_16():
    """The JAX side in float64 (its program shared with
    test_torch_handlers.py)."""
    logpdf_and_grad_16("lpt", x64=True)


def test_logpdf_and_grad_match_jax_16_s_e2():
    """The same at s_e2 = 0.03 (|scale2 / scale1| ~ 0.03), the quad-Gaussian
    likelihood's own branch: the s_e2_ gradient against the port in
    float64."""
    logpdf_and_grad_16("lpt", s_e2=0.03, x64=True)


def test_port_never_imports_jax():
    """A fresh interpreter that imports the port, its samplers, its files
    (utils.io, utils.geometry, utils.catalogs), chains, the campaign and its
    CLI, the register and accuracy CLIs, the analysis layer (metrics, the
    bispectrum's K10 wrapper, bdec, and plot with matplotlib present),
    builds a model, conditions and blocks it and draws the samplers' start
    leaves keeps jax, the JAX package, h5py and PyYAML out of
    sys.modules."""
    code = ("import sys, torch, montecosmo_tpu_torch as m\n"
            "from montecosmo_tpu_torch.ops import paint, pm, _kernels\n"
            "from montecosmo_tpu_torch import convert, samplers, chains, script, infer\n"
            "from montecosmo_tpu_torch import register, accuracy, metrics, bdec, plot\n"
            "from montecosmo_tpu_torch.ops import bispectrum\n"
            "from montecosmo_tpu_torch.utils import io, geometry, catalogs\n"
            "c = dict(m.default_config); c.update(final_shape=(8, 8, 8), curved_sky=False,"
            " a_obs=0.5, box_center=(0, 0, 500.0))\n"
            "f = m.FieldLevelModel(**c, device='cpu')\n"
            "m.FieldLevelModel(**{**c, 'evolution': 'nbody'}, device='cpu')\n"
            "f.count_mesh = 1 + torch.rand(8, 8, 8)\n"
            "f.substitute(f.fiduc | f.obs_data(), from_base=True)\n"
            "f.block()\n"
            "assert set(f.kaiser_post(0)) == {'white_mesh_'}\n"
            "bad = sorted(k for k in sys.modules if k in ('jax', 'montecosmo_tpu', 'h5py', 'yaml')"
            " or k.startswith(('jax.', 'jaxlib', 'montecosmo_tpu.', 'h5py.', 'yaml.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("case", ["flagship_128", "golden_32", "kcut_16", "lightcone_16"])
def test_derived_config_matches_jax(case):
    """Everything __post_init__ derives from a config (shapes, the 'auto'
    paint choice and its max_disp, radial bins, fiducial scale factor, the
    k-cut mask) equals the JAX package's; no JAX compile."""
    from montecosmo_tpu import FieldLevelModel as JaxModel

    conf = dict(default_config)
    conf.update(evolution="lpt", a_obs=0.5, curved_sky=False, lik_type="quad_gauss")
    if case == "flagship_128":    # bench.py:34-46
        conf.update(final_shape=(128,) * 3, cell_length=500.0 * 2 / 128,
                    box_center=(0.0, 0.0, 1500.0), precond="kaiser")
    elif case == "golden_32":     # tests/test_golden_bundle.py::make_model
        conf.update(final_shape=(32,) * 3, cell_length=1000.0 / 32,
                    box_center=(0.0, 0.0, 2000.0), precond="real")
    elif case == "kcut_16":
        conf.update(final_shape=(16,) * 3, cell_length=8.0, box_center=(0.0, 0.0, 1000.0),
                    k_cut=0.3)
    else:                         # light cone: a(chi) per particle and cell
        conf.update(final_shape=(16,) * 3, cell_length=8.0, box_center=(0.0, 0.0, 1000.0),
                    a_obs=None)
    jm, tm = JaxModel(**conf), FieldLevelModel(**conf, device="cpu")
    for attr in ("init_shape", "evol_shape", "ptcl_shape", "paint_shape", "paint_lattice",
                 "max_disp", "evol_sites", "n_rbins"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    np.testing.assert_array_equal(tm.redges, jm.redges)
    np.testing.assert_array_equal(tm.rmasked, np.asarray(jm.rmasked))
    # a_fid = g2a(mean a2g(a)) over the cells: a float32 mean in another order
    np.testing.assert_allclose(tm.a_fid, jm.a_fid, rtol=1e-5)
    np.testing.assert_allclose(tm.count_fid, jm.count_fid, rtol=1e-12)
    if case == "kcut_16":
        np.testing.assert_array_equal(tm.cut_mask.numpy(), jm.cut_mask)
        p = tm.reparam({k: np.asarray(v) for k, v in tm.fiduc.items()}, inv=True)
        p["white_mesh_"] = torch.zeros(int(tm.cut_mask.sum()))
        assert torch.isfinite(tm.logpdf({**p, "count_mesh": torch.ones(tm.final_shape)}))
    else:
        assert tm.cut_mask is None and jm.cut_mask is None


def test_lightcone_forward_matches_jax_16():
    """a_obs=None: every particle at its own scale factor a(chi).  The port's
    galaxy mesh against the JAX package's on the same white mesh."""
    import jax
    from jax import numpy as jnp

    from montecosmo_tpu import FieldLevelModel as JaxModel

    conf = dict(default_config)
    conf.update(final_shape=(16,) * 3, cell_length=8.0, evolution="lpt", a_obs=None,
                curved_sky=False, box_center=(0.0, 0.0, 1000.0), lik_type="quad_gauss",
                precond="kaiser")
    jm, tm = JaxModel(**conf), FieldLevelModel(**conf, device="cpu")
    p = {k: np.asarray(v, np.float32) for k, v in jm.reparam(dict(jm.fiduc), inv=True).items()}
    p["white_mesh_"] = np.random.default_rng(3).standard_normal(jm.init_shape).astype(np.float32)
    kw = dict(hide_base=False, hide_det=False, hide_samp=False)
    gj = np.asarray(jm.predict(seed=1, samples={k: jnp.asarray(v) for k, v in p.items()},
                               **kw)["gxy_mesh"])
    gt = tm.predict(seed=1, samples=p, **kw)["gxy_mesh"].numpy()
    # float32 chains through a(chi) per particle: ~1e-5 of the field's range
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5 * np.abs(gj).max())
