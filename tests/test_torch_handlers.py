"""The port's `Model` handler algebra and the samplers' start against the JAX
package, on the CPU, at the 16^3 configuration of
test_torch_model.py::logpdf_and_grad_16: substitute (plain and from base
values), block (default and hide=), trace, seed, reset, potential, force,
`reparam` on substituted data, batched predict, the Kaiser posterior and its
`kaiser_post` start, count2delta, and one McLachlan step of the conditioned,
blocked model from the same state.

One JAX model serves the module, and its value+grad is compiled once: JAX
sites are listed from an abstract trace (jax.eval_shape), values from
jitted calls.
"""
import numpy as np
import pytest
import torch

import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu.samplers import mclmc as J
from montecosmo_tpu_torch import FieldLevelModel, default_config
from montecosmo_tpu_torch.models.bricks import count2delta, kaiser_posterior
from montecosmo_tpu_torch.samplers import mclmc as T

torch.set_num_threads(1)

CONF = dict(final_shape=(16, 16, 16), cell_length=8.0, evolution="lpt", a_obs=0.5,
            curved_sky=False, box_center=(0.0, 0.0, 1000.0), lik_type="quad_gauss",
            precond="kaiser", init_oversamp=1.0, evol_oversamp=1.0, ptcl_oversamp=1.0,
            paint_oversamp=1.0)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, sample-space params (numpy), count mesh)."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default

    jm = JaxModel(**{**jax_default, **CONF})
    tm = FieldLevelModel(**{**default_config, **CONF}, device="cpu")
    rng = np.random.default_rng(0)
    p = {k: np.asarray(v, np.float32) for k, v in jm.reparam(dict(jm.fiduc), inv=True).items()}
    for k in p:
        if k != "s_e2_":
            p[k] = (p[k] + 0.3 * rng.standard_normal(np.shape(p[k]))).astype(np.float32)
    p["white_mesh_"] = rng.standard_normal(jm.init_shape).astype(np.float32)
    count = tm.predict(seed=1, samples=p, hide_base=False, hide_det=False,
                       hide_samp=False)["count_mesh"].numpy()
    jm.count_mesh, tm.count_mesh = jnp.asarray(count), torch.as_tensor(count)
    yield jm, tm, p, count
    jm.reset()
    tm.reset()


def condition(*models):
    """Condition on the counts and block, as the full warmup does."""
    for m in models:
        m.reset()
        m.substitute(m.obs_data(), from_base=True)
        m.block()


def f64(p):
    return {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}


@pytest.fixture(scope="module")
def conditioned(pair):
    """The JAX value+grad of the conditioned, blocked model's logpdf in
    float64, compiled (and so bound to that model) here; call it under
    jax.enable_x64.  Off s_e2 = 0 the JAX package's float32 gradient in
    s_e2_ is ill-conditioned (1.86 relative off at a step from the test's
    point; test_torch_quadgauss.py), its float64 one is not."""
    jm, tm, p, count = pair
    with jax.enable_x64(True):
        condition(jm)
        vg = jax.jit(jax.value_and_grad(jm.logpdf))
        jax.block_until_ready(vg(f64(p)))
    jm.reset()
    return vg


def jax_sites(jm, fn=None):
    """{site: (type, observed)} of a JAX model's trace, traced abstractly."""
    out = {}

    def run(key):
        tr = jm.trace(key) if fn is None else fn(key)
        out.update({k: (s["type"], bool(s.get("is_observed"))) for k, s in tr.items()})
        return 0

    jax.eval_shape(run, jr.key(0))
    return out


def port_sites(tm):
    tr = tm.trace(0)
    return {k: (s["type"], bool(s.get("is_observed"))) for k, s in tr.items()}


def to_np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_values_close(vt, vj, rtol, atol_frac, what=""):
    vt, vj = to_np(vt), np.asarray(vj)
    assert vt.shape == vj.shape, (what, vt.shape, vj.shape)
    np.testing.assert_allclose(vt, vj, rtol=rtol, atol=atol_frac * max(np.abs(vj).max(), 1e-30),
                               err_msg=what)


def test_handlers_give_the_jax_sites(pair):
    """reset, substitute (plain, from_base), block (default, hide=), seed:
    the same sites, types and observed flags as the JAX package after each
    sequence, and the same substituted data."""
    jm, tm, p, count = pair
    fid = {k: np.asarray(v) for k, v in jm.fiduc.items()}
    steps = [
        ("reset", lambda m, obs: None),
        ("substitute counts", lambda m, obs: m.substitute({"count_mesh": obs})),
        ("block", lambda m, obs: m.block()),
        ("reset + substitute fiducial from base + block",
         lambda m, obs: (m.reset(), m.substitute(fid | {"count_mesh": obs}, from_base=True),
                         m.block())),
        ("block hide=", lambda m, obs: m.block(hide=["count_mesh", "white_mesh_"])),
        ("reset + block(hide_det=False)", lambda m, obs: (m.reset(), m.block(hide_det=False))),
        ("block expose_types", lambda m, obs: m.block(expose_types=["sample"])),
    ]
    for m in (jm, tm):
        m.reset()
    for what, step in steps:
        step(jm, jnp.asarray(count))
        step(tm, torch.as_tensor(count))
        sj, st = jax_sites(jm), port_sites(tm)
        assert st == sj, (what, sorted(set(st) ^ set(sj)))
        assert set(tm.data) == set(jm.data), what
        for k, v in jm.data.items():
            assert_values_close(tm.data[k], v, 1e-6, 1e-7, f"{what}: data[{k}]")
    # seed: the seeded model runs on its own and draws the unset sites
    for m, key in ((jm, jr.key(3)), (tm, 3)):
        m.reset()
        m.seed(key)
    out = tm()
    assert out.shape == tuple(jm.final_shape) and torch.isfinite(out).all()
    assert jax.eval_shape(jm).shape == out.shape
    assert "count_mesh" in tm.render()
    for m in (jm, tm):
        m.reset()
    assert tm.data == {} and tm.model == tm._model


def test_trace_values_match_jax(pair):
    """With every latent and the counts substituted, the trace is fixed:
    each site's value against the JAX package's (scalars and base values
    1e-5 relative; the meshes within 1e-5 of their largest value)."""
    jm, tm, p, count = pair
    data = p | {"count_mesh": count}
    for m in (jm, tm):
        m.reset()
    jm.substitute({k: jnp.asarray(v) for k, v in data.items()})
    tm.substitute(data)
    vj = jax.jit(lambda key: {k: s["value"] for k, s in jm.trace(key).items()})(jr.key(0))
    vt = {k: s["value"] for k, s in tm.trace(0).items()}
    assert set(vt) == set(vj)
    for k in vj:
        assert_values_close(vt[k], vj[k], 1e-5, 1e-5, k)
    for m in (jm, tm):
        m.reset()


def test_potential_and_force_match_jax(pair, conditioned):
    """The conditioned, blocked model: potential = -logpdf within 1e-5
    relative; force, the gradient dict of logpdf (the JAX package's
    `grad(logpdf)`, compiled with its value, in float64), on the same keys
    within rtol 1e-3 and 1e-4 of each latent's largest |gradient|."""
    jm, tm, p, _ = pair
    condition(tm)
    with jax.enable_x64(True):
        lj, gj = jax.tree.map(np.asarray, conditioned(f64(p)))
    pot = tm.potential(p)
    assert abs(pot.item() + float(lj)) <= 1e-5 * abs(float(lj))
    ft = tm.force(p)
    assert set(ft) == set(gj) == set(p)
    for k, g in gj.items():
        assert_values_close(ft[k], g, 1e-3, 1e-4, k)


def test_reparam_merges_substituted_data(pair):
    """Substitute part of the latents (base values), then reparam the rest
    both ways: the output holds the counterparts of the asked keys only,
    with the JAX package's values."""
    jm, tm, p, count = pair
    fid = {k: np.asarray(v) for k, v in jm.fiduc.items()}
    part = {k: fid[k] for k in ("Omega_m", "b1", "ngbars")} | {"count_mesh": count}
    for m in (jm, tm):
        m.reset()
        m.substitute(part, from_base=True)
    rest = {k: v for k, v in fid.items() if k not in part}
    rest["white_mesh"] = np.asarray(jm.reparam({"white_mesh_": jnp.asarray(p["white_mesh_"])})
                                    ["white_mesh"])
    oj, ot = jm.reparam(rest, inv=True), tm.reparam(rest, inv=True)
    assert set(ot) == set(oj) == {k + "_" for k in rest}
    for k in oj:
        assert_values_close(ot[k], oj[k], 1e-5, 1e-6, k)
    back_j, back_t = jm.reparam(oj), tm.reparam(ot)
    assert set(back_t) == set(back_j) == set(rest)
    for k in back_j:
        assert_values_close(back_t[k], back_j[k], 1e-5, 1e-6, k)
    # a key of the data and of params: params' value wins, nothing else leaks
    mixed = {"b1": np.float32(1.7), "sigma8": np.float32(0.7)}
    oj, ot = jm.reparam(mixed, inv=True), tm.reparam(mixed, inv=True)
    assert set(ot) == set(oj) == {"b1_", "sigma8_"}
    for k in oj:
        assert_values_close(ot[k], oj[k], 1e-6, 1e-7, k)
    for m in (jm, tm):
        m.reset()


def test_batched_predict_matches_jax(pair):
    """predict on a dict with batch_ndim=1: the JAX package's keys and
    shapes; its deterministic sites within 1e-5; the counts drawn per
    sample (different generators) only finite.  An int batch stacks the
    same keys."""
    jm, tm, p, _ = pair
    for m in (jm, tm):
        m.reset()
    rng = np.random.default_rng(5)
    batch = {k: np.stack([v, (v + 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)])
             for k, v in p.items()}
    kw = dict(batch_ndim=1, hide_det=False, hide_base=False)
    oj = jm.predict(jr.key(0), samples={k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    ot = tm.predict(0, samples=batch, **kw)
    assert set(ot) == set(oj)
    for k in oj:
        assert tuple(ot[k].shape) == tuple(oj[k].shape), k
        if k == "count_mesh":
            assert torch.isfinite(ot[k]).all()
        else:
            assert_values_close(ot[k], oj[k], 1e-5, 1e-5, k)
    prior = tm.predict(1, samples=(2, 1))
    assert set(prior) == set(p) | {"count_mesh"}
    assert prior["count_mesh"].shape == (2, 1) + jm.final_shape
    assert all(v.shape[:2] == (2, 1) for v in prior.values())


def test_kaiser_posterior_and_start_match_jax(pair):
    """kaiser_posterior's mean and std fields, and kaiser_post at temp=0
    (the posterior mean, no draw): within 1e-5 relative of the JAX
    package's, both without substituted data (every latent at its fiducial)
    and as the field warmup conditions the model (white_mesh_ only).
    count2delta too."""
    from montecosmo_tpu.models.bricks import kaiser_posterior as jax_kaiser_posterior
    from montecosmo_tpu.ops.fourier import rfftn as jax_rfftn
    from montecosmo_tpu.ops.hermitian import chreshape as jax_chreshape, r2chshape

    jm, tm, p, count = pair
    for m in (jm, tm):
        m.reset()
    dj, dt = jm.count2delta(jnp.asarray(count)), tm.count2delta(torch.as_tensor(count))
    assert_values_close(dt, dj, 1e-5, 1e-6, "count2delta")
    assert_values_close(count2delta(torch.as_tensor(count), torch.tensor(1.0)), dj, 1e-5, 1e-6,
                        "bricks.count2delta")

    obs_j = jax_chreshape(jax_rfftn(dj), r2chshape(jm.init_shape))
    b1E, var = 1 + float(np.mean(jm.fiduc["b1"])), 1.3e-2
    mj, sj = jax_kaiser_posterior(obs_j, jm.cosmo_fid, jm.a_fid, jm.box_size, var, b1E,
                                  los=jm.los_fid, bg=jm.bg_fid)
    mt, st = kaiser_posterior(torch.tensor(np.asarray(obs_j)), tm.cosmo_fid, tm.a_fid,
                              tm.box_size, var, b1E, los=tm.los_fid, bg=tm.bg_fid)
    assert_values_close(torch.view_as_real(mt), np.stack([mj.real, mj.imag], -1), 1e-5, 1e-5,
                        "means")
    assert_values_close(st, sj, 1e-5, 1e-6, "stds")

    fid = {k: np.asarray(v) for k, v in jm.fiduc.items()}
    for what, data in (("no data", None), ("field warmup", fid | {"count_mesh": count})):
        for m in (jm, tm):
            m.reset()
            if data is not None:
                m.substitute(data, from_base=True)
        sj0 = jm.kaiser_post(jr.key(0), temp=0.0)
        st0 = tm.kaiser_post(0, temp=0.0)
        assert set(st0) == set(sj0), what
        for k in sj0:
            assert_values_close(st0[k], sj0[k], 1e-5, 1e-5, f"{what}: {k}")
        base = tm.kaiser_post(torch.Generator().manual_seed(1), base=True, scale_field=7 / 8)
        assert torch.isfinite(base["white_mesh"]).all()
    for m in (jm, tm):
        m.reset()


def _jitted_logdf(vg):
    """The JAX log-density whose value+grad is the compiled `vg`, so that
    the package's eager _mclachlan_step calls the compiled program."""

    @jax.custom_vjp
    def logdf(x):
        return vg(x)[0]

    def fwd(x):
        return vg(x)

    def bwd(g, ct):
        return (jax.tree.map(lambda a: a * ct, g),)

    logdf.defvjp(fwd, bwd)
    return logdf


def test_mclachlan_step_of_the_model_matches_jax(pair, conditioned):
    """One McLachlan step of the conditioned, blocked 16^3 model from the
    same position and momentum in both packages, in float64 (the step moves
    s_e2 off 0, see `conditioned`): logdensity and energy change within 1e-5
    relative, positions within 1e-5 of their largest value, momentum within
    1e-5 (of |u| = 1).  The port's float32 step is held against its float64
    one at the same tolerances (momentum 1e-4)."""
    jm, tm, p, _ = pair
    condition(tm)
    d = sum(int(np.size(v)) for v in p.values())
    u = np.random.default_rng(7).standard_normal(d)
    u /= np.linalg.norm(u)
    eps = 0.3 * d**0.5 / 10
    with jax.enable_x64(True):
        logdf_j = _jitted_logdf(conditioned)
        sj = J.mclmc_init(f64(p), logdf_j, jr.key(0))._replace(momentum=jnp.asarray(u))
        nj, ej = J._mclachlan_step(sj, logdf_j, jnp.float64(eps), jnp.float64(1.0))
        nj, ej = jax.tree.map(np.asarray, (nj, ej))
    steps = {}
    for dtype in (torch.float64, torch.float32):
        st = T.mclmc_init({k: torch.tensor(v, dtype=dtype) for k, v in p.items()}, tm.logpdf,
                          torch.tensor(u, dtype=dtype))
        with torch.no_grad():
            steps[dtype] = T._mclachlan_step(st, tm.logpdf, torch.tensor(eps, dtype=dtype),
                                             torch.tensor(1.0, dtype=dtype))
    for (nt, et), (nr, er), u_tol in ((steps[torch.float64], (nj, ej), 1e-5),
                                      (steps[torch.float32], steps[torch.float64], 1e-4)):
        assert abs(float(nt.logdensity) - float(nr.logdensity)) <= 1e-5 * abs(float(nr.logdensity))
        assert abs(float(et) - float(er)) <= 1e-5 * max(abs(float(er)), 1.0), (float(et), float(er))
        for k in p:
            assert_values_close(nt.position[k], to_np(nr.position[k]), 1e-5, 1e-5, k)
            assert not np.allclose(to_np(nt.position[k]), p[k])
        np.testing.assert_allclose(to_np(nt.momentum), to_np(nr.momentum), rtol=0, atol=u_tol)
