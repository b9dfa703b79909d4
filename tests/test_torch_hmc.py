"""The port's HMC / NUTS (montecosmo_tpu_torch.samplers.hmc) against the
JAX package's (montecosmo_tpu.samplers.hmc), on the CPU.

Exact parity, in float64 (`jax.enable_x64`, the port dtype-generic), at
1e-12 relative: `_leapfrog`, `_kinetic`, `_momentum` (diagonal and dense,
JAX's own normal draw passed in), `_is_turning`, dual averaging,
`_adaptation_schedule`, the Welford updates of `_wa_post` (diagonal and
dense) and `find_reasonable_step_size` from the momentum JAX draws.  NUTS
and HMC transitions, a 100-step window adaptation and one NUTS-within-Gibbs
sweep are replayed: the port takes its draws (momentum, each doubling's
direction, each leaf's and each merge's uniform) from an object that
computes JAX's from its keys (`JaxDraws`), so trees, proposals and the
tuned step size and mass agree at 1e-10 (1e-8 after the 100 adaptation
steps).  Window adaptation and
NUTS-within-Gibbs also recover the moments of tests/test_samplers.py's
Gaussians on their own (float32), and a JAX warmup's state and
per-block config continue in the port (`convert`).
"""
import numpy as np
import pytest
import torch

import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu.samplers import hmc as J
from montecosmo_tpu_torch.convert import hmc_state_from_numpy, nuts_config_from_numpy
from montecosmo_tpu_torch.samplers import hmc as H
from montecosmo_tpu_torch.script import _segmented_nuts_warmup

torch.set_num_threads(1)

D = 8
SCALES = np.geomspace(0.5, 3.0, D)
RHO = 0.9
COV3 = np.array([[1.0, RHO, 0.0], [RHO, 1.0, 0.0], [0.0, 0.0, 0.04]])
TIGHT = dict(rtol=1e-12, atol=1e-12)
REPLAY = dict(rtol=1e-10, atol=1e-10)
# 100 adaptation steps feed each step's float64 rounding back through the
# step size: the histories drift apart by ~2e-10 by the end
ADAPT = dict(rtol=1e-8, atol=1e-8)


def gauss(lib, scales):
    s = lib.asarray(scales) if lib is jnp else torch.as_tensor(scales)
    return lambda x: -0.5 * ((x["x"] / s) ** 2).sum()


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(t, j, tol=TIGHT):
    np.testing.assert_allclose(np_of(t), np.asarray(j), **tol)


class JaxDraws:
    """The draws of one JAX `nuts_kernel` / `hmc_kernel` transition from its
    key, computed as that kernel splits it, in the order the port asks."""

    def __init__(self, key):
        self.key_mom, self.key = jr.split(key)

    def momentum(self, like):
        return torch.tensor(np.asarray(jr.normal(self.key_mom, tuple(like.shape), jnp.float64)))

    def direction(self, like):
        self.key, key_dir, self.key_sub, self.key_take = jr.split(self.key, 4)
        return 1.0 if bool(jr.bernoulli(key_dir)) else -1.0

    def leaf(self, like):
        key, self.key_sub = jr.split(self.key_sub)
        return torch.as_tensor(float(jr.uniform(key)), dtype=like.dtype)

    def take(self, like):
        return torch.as_tensor(float(jr.uniform(self.key_take)), dtype=like.dtype)

    def accept(self, like):  # hmc_kernel: key_mom, key_acc = split(key)
        return torch.as_tensor(float(jr.uniform(self.key)), dtype=like.dtype)


def states(x0, lp_j, lp_t):
    sj = J.hmc_init({"x": jnp.asarray(x0)}, lp_j)
    return sj, H.hmc_init({"x": torch.as_tensor(x0)}, lp_t)


def invmm_of(kind, d=D):
    rng = np.random.default_rng(3)
    if kind == "unit":
        return np.ones(d)
    if kind == "diag":
        return rng.uniform(0.5, 2.0, d)
    a = rng.standard_normal((d, d))
    return a @ a.T / d + 0.5 * np.eye(d)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog_kinetic_momentum_turning_match_jax(kind):
    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        x, r, g = (rng.standard_normal(D) for _ in range(3))
        im = invmm_of(kind)
        unravel_j = J._ravel({"x": jnp.asarray(x)})[1]
        unravel_t = lambda v: {"x": v}
        lp_j, lp_t = gauss(jnp, SCALES), gauss(torch, SCALES)
        out_j = J._leapfrog(jnp.asarray(x), jnp.asarray(r), jnp.asarray(g), lp_j, unravel_j, 0.3,
                            jnp.asarray(im))
        out_t = H._leapfrog(*(torch.as_tensor(v) for v in (x, r, g)), lp_t, unravel_t, 0.3,
                            torch.as_tensor(im))
        for a, b in zip(out_t, out_j):
            close(a, b)
        close(H._kinetic(torch.as_tensor(r), torch.as_tensor(im)),
              J._kinetic(jnp.asarray(r), jnp.asarray(im)))
        key = jr.key(5)
        xi = np.array(jr.normal(key, (D,), jnp.float64))
        close(H._momentum(torch.as_tensor(xi), torch.as_tensor(im)),
              J._momentum(key, jnp.asarray(im), jnp.asarray(x)))
        for seed in range(6):
            a, b, c = (np.random.default_rng(seed).standard_normal((3, D)))
            assert bool(H._is_turning(*(torch.as_tensor(v) for v in (a, b, c)),
                                      torch.as_tensor(im))) == bool(
                J._is_turning(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(im)))


def test_dual_averaging_and_schedule_match_jax():
    for n in (5, 19, 20, 47, 100, 600, 1000):
        for a, b in zip(H._adaptation_schedule(n), J._adaptation_schedule(n)):
            np.testing.assert_array_equal(a, b)
    acc = np.random.default_rng(1).uniform(0, 1, 30)
    with jax.enable_x64(True):
        st_j, st_t = J._da_init(jnp.asarray(0.3)), H._da_init(torch.tensor(0.3, dtype=torch.float64))
        for a in acc:
            st_j, st_t = J._da_update(st_j, a, 0.8), H._da_update(st_t, torch.tensor(a), 0.8)
            for x, y in zip(st_t, st_j):
                close(x, y)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_window_post_matches_jax(dense):
    """100 steps of `_wa_post` on the schedule of 100 (two slow windows,
    two mass refreshes): the dual averaging, the Welford sums and the mass."""
    n, d = 100, 3
    rng = np.random.default_rng(2)
    xs, accs = rng.standard_normal((n, d)) * [1.0, 2.0, 0.5], rng.uniform(0, 1, n)
    upd, slow = J._adaptation_schedule(n)
    assert upd.sum() >= 2
    with jax.enable_x64(True):
        lp_j, lp_t = gauss(jnp, np.ones(d)), gauss(torch, np.ones(d))
        im0 = np.eye(d) if dense else None
        cj = J._wa_carry0(lp_j, {"x": jnp.zeros(d)}, 0.1, im0)
        ct = H._wa_carry0(lp_t, {"x": torch.zeros(d, dtype=torch.float64)}, 0.1, im0)
        post = jax.jit(J._wa_post)
        for x, a, u, s in zip(xs, accs, upd, slow):
            cj = post((cj[0]._replace(position={"x": jnp.asarray(x)}), *cj[1:]),
                            {"acceptance_rate": jnp.asarray(a)}, u, s)
            ct = H._wa_post((ct[0]._replace(position={"x": torch.as_tensor(x)}), *ct[1:]),
                            {"acceptance_rate": torch.tensor(a)}, u, s)
            for y, z in zip(jax.tree.leaves(ct[1:]), jax.tree.leaves(cj[1:])):
                close(y, z)
        assert ct[2].ndim == (2 if dense else 1)


@pytest.mark.parametrize("eps0", [100.0, 1e-6, 1.0])
@pytest.mark.parametrize("kind", ["unit", "dense"])
def test_find_reasonable_step_size_matches_jax(eps0, kind):
    with jax.enable_x64(True):
        x0 = np.random.default_rng(4).standard_normal(D)
        im = invmm_of(kind)
        key = jr.key(7)
        eps_j = J.find_reasonable_step_size(gauss(jnp, SCALES), {"x": jnp.asarray(x0)}, key,
                                            jnp.asarray(im), eps0)
        xi = torch.tensor(np.asarray(jr.normal(key, (D,), jnp.float64)))
        eps_t = H.find_reasonable_step_size(gauss(torch, SCALES), {"x": torch.as_tensor(x0)}, xi,
                                            torch.as_tensor(im), eps0)
        close(eps_t, eps_j)
        assert 1e-4 < float(eps_t) < 50


@pytest.mark.parametrize("kind,eps", [("unit", 0.4), ("diag", 0.9), ("dense", 0.5),
                                      ("unit", 6.0)])
def test_nuts_transitions_replay_jax(kind, eps):
    """Three NUTS transitions from one state with JAX's draws: the proposal,
    its logdensity and gradient, and every info (eps 6 diverges)."""
    with jax.enable_x64(True):
        x0 = np.random.default_rng(5).standard_normal(D)
        im = invmm_of(kind)
        sj, st = states(x0, gauss(jnp, SCALES), gauss(torch, SCALES))
        kj = jax.jit(J.nuts_kernel(gauss(jnp, SCALES), eps, jnp.asarray(im), max_num_doublings=6))
        kt = H.nuts_kernel(gauss(torch, SCALES), eps, torch.as_tensor(im), max_num_doublings=6)
        for key in jr.split(jr.key(11), 3):
            sj, ij = kj(key, sj)
            st, it = kt(JaxDraws(key), st)
            close(st.position["x"], sj.position["x"], REPLAY)
            close(st.logdensity, sj.logdensity, REPLAY)
            close(st.logdensity_grad["x"], sj.logdensity_grad["x"], REPLAY)
            assert (it["num_integration_steps"], it["depth"], it["is_divergent"]) == (
                int(ij["num_integration_steps"]), int(ij["depth"]), bool(ij["is_divergent"]))
            close(it["acceptance_rate"], ij["acceptance_rate"], REPLAY)
        if eps == 6.0:
            assert it["is_divergent"]


def test_hmc_kernel_replays_jax():
    with jax.enable_x64(True):
        x0 = np.random.default_rng(6).standard_normal(D)
        sj, st = states(x0, gauss(jnp, SCALES), gauss(torch, SCALES))
        kj = jax.jit(J.hmc_kernel(gauss(jnp, SCALES), 0.6, 5, jnp.asarray(invmm_of("diag"))))
        kt = H.hmc_kernel(gauss(torch, SCALES), 0.6, 5, torch.as_tensor(invmm_of("diag")))
        for key in jr.split(jr.key(12), 4):
            sj, ij = kj(key, sj)
            st, it = kt(JaxDraws(key), st)
            close(st.position["x"], sj.position["x"], REPLAY)
            assert it["is_accepted"] == bool(ij["is_accepted"])


@pytest.mark.parametrize("dense", [False, True])
def test_window_adaptation_replays_jax(dense):
    """100 warmup steps (two slow windows) on the correlated 3-dim Gaussian
    of test_samplers.py, JAX's per-step keys replayed: the tuned step size,
    the (dense or diagonal) mass, the last state, every acceptance."""
    with jax.enable_x64(True):
        Ci = np.linalg.inv(COV3)
        lp_j = lambda p: -0.5 * p["x"] @ jnp.asarray(Ci) @ p["x"]
        lp_t = lambda p: -0.5 * p["x"] @ torch.as_tensor(Ci) @ p["x"]
        im0 = np.eye(3) if dense else np.ones(3)
        key = jr.key(1)
        assert J._adaptation_schedule(100)[0].sum() == 2
        (sj, pj), hj = J.window_adaptation(J.nuts_kernel, lp_j, 100, {"x": jnp.full(3, 0.5)}, 0.8,
                                           rng_key=key, initial_inverse_mass_matrix=im0,
                                           max_num_doublings=5)
        draws = [JaxDraws(k) for k in jr.split(key, 100)]
        (st, pt), ht = H.window_adaptation(H.nuts_kernel, lp_t, 100,
                                           {"x": torch.full((3,), 0.5, dtype=torch.float64)}, 0.8,
                                           rng=draws, initial_inverse_mass_matrix=im0,
                                           max_num_doublings=5)
        close(ht["acceptance_rate"], hj["acceptance_rate"], ADAPT)
        close(ht["num_integration_steps"], hj["num_integration_steps"], TIGHT)
        close(pt["step_size"], pj["step_size"], ADAPT)
        close(pt["inverse_mass_matrix"], pj["inverse_mass_matrix"], ADAPT)
        close(st.position["x"], sj.position["x"], ADAPT)


def two_block(lib):
    def logdf(p):
        return -0.5 * ((p["mesh_"] / 2.0) ** 2).sum() - 0.5 * (p["rest_"] ** 2).sum()
    return logdf


def test_nutswg_sweep_replays_jax():
    """One NUTS-within-Gibbs sweep (blocks mesh_ then rest_, each re-initialised
    on the other's current value) from the same state with JAX's per-block
    keys."""
    with jax.enable_x64(True):
        blocks = {"mesh_": ["mesh_"], "rest_": ["rest_"]}
        init = {"mesh_": np.linspace(-1, 1, 6), "rest_": np.array([0.3, -0.2, 0.1])}
        conf = {k: {"step_size": 0.5, "inverse_mass_matrix": 1.0} for k in blocks}
        sf, inf, _, _ = J.nutswg_init(two_block(jnp))
        sj = J.get_init_state({k: jnp.asarray(v) for k, v in init.items()}, two_block(jnp), inf,
                              blocks)
        tf, tinf, _, _ = H.nutswg_init(two_block(torch))
        st = H.get_init_state({k: torch.as_tensor(v) for k, v in init.items()}, two_block(torch),
                              tinf, blocks)
        seed = jr.key(5)
        sj, ij = J.mwg_kernel_general(seed, sj, two_block(jnp), sf, inf, conf)
        keys = dict(zip(blocks, jr.split(seed, 2)))
        st, it = H.mwg_kernel_general({k: JaxDraws(v) for k, v in keys.items()}, st,
                                      two_block(torch), tf, tinf, conf)
        for k in blocks:
            close(st[k].position[k], sj[k].position[k], REPLAY)
        close(it["logdensity"], ij["logdensity"], REPLAY)
        assert int(it["n_evals"]) == int(ij["n_evals"])


def test_window_adaptation_and_nutswg_moments():
    """The port alone on test_samplers.py's targets (float32): window
    adaptation on the 8-dim Gaussian tunes a mass near the variances and a
    late acceptance near the target; blocked NUTS-within-Gibbs recovers
    both blocks' scales."""
    gen = torch.Generator().manual_seed(4)
    lp = gauss(torch, SCALES.astype(np.float32))
    (state, params), hist = H.window_adaptation(H.nuts_kernel, lp, 300,
                                                {"x": torch.randn(D, generator=gen)}, 0.8, rng=gen)
    ratio = params["inverse_mass_matrix"].numpy() / SCALES**2
    assert np.all(ratio > 0.05) and np.all(ratio < 20), ratio
    assert 0.01 < float(params["step_size"]) < 5.0
    assert 0.55 < float(hist["acceptance_rate"][-100:].mean()) <= 1.0

    step_fn, init_fn, _, _ = H.nutswg_init(two_block(torch))
    state = H.get_init_state({"mesh_": torch.zeros(6), "rest_": torch.zeros(3)}, two_block(torch),
                             init_fn, {"mesh_": ["mesh_"], "rest_": ["rest_"]})
    conf = {k: {"step_size": 0.5, "inverse_mass_matrix": 1.0} for k in state}
    _, (pos, infos) = H.sampling_loop_general(gen, state, two_block(torch), step_fn, init_fn,
                                              conf, n_samples=800)
    np.testing.assert_allclose(pos["mesh_"][200:].std().item(), 2.0, rtol=0.2)
    np.testing.assert_allclose(pos["rest_"][200:].std().item(), 1.0, rtol=0.2)
    assert int(infos["n_evals"].sum()) > 0


def test_jax_nuts_warmup_continues_in_port():
    """A JAX window adaptation's last state and tuned (step size, mass) as
    numpy, through `convert`, then two NUTS transitions in each package
    with the same keys."""
    with jax.enable_x64(True):
        lp_j, lp_t = gauss(jnp, SCALES), gauss(torch, SCALES)
        (sj, pj), _ = J.window_adaptation(J.nuts_kernel, lp_j, 25, {"x": jnp.ones(D)},
                                          rng_key=jr.key(2), max_num_doublings=5)
        st = hmc_state_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
        conf = nuts_config_from_numpy({"rest_": jax.tree.map(np.asarray, pj)}, "cpu")["rest_"]
        kj = jax.jit(J.nuts_kernel(lp_j, pj["step_size"], pj["inverse_mass_matrix"], 5))
        kt = H.nuts_kernel(lp_t, conf["step_size"], conf["inverse_mass_matrix"], 5)
        for key in jr.split(jr.key(9), 2):
            sj, _ = kj(key, sj)
            st, _ = kt(JaxDraws(key), st)
        close(st.position["x"], sj.position["x"], REPLAY)


def test_segmented_nuts_warmup_dense_scalar_block():
    """The blocked warmup (as test_samplers.py holds the JAX one): the scalar
    block adapts a dense mass that captures the target's correlation, the
    mesh block a diagonal one; bracketed step sizes; n_evals counts the
    brackets and the integration steps; dense_max=0 falls back to a
    diagonal mass."""
    rho = 0.95
    Ci = torch.as_tensor(np.linalg.inv([[1.0, rho], [rho, 1.0]]), dtype=torch.float32)

    calls = [0]

    def logdf(p):
        calls[0] += 1
        s = torch.stack([p["om_"], p["b1_"]])
        return -0.5 * s @ Ci @ s - 0.5 * (p["white_mesh_"] ** 2).sum()

    gen = torch.Generator().manual_seed(3)
    n_chains = 2
    pos = {"om_": torch.randn(n_chains, generator=gen), "b1_": torch.randn(n_chains, generator=gen),
           "white_mesh_": torch.randn(n_chains, 8, generator=gen)}
    state, config, n_ev = _segmented_nuts_warmup(logdf, 120, n_chains, gen, pos,
                                                 log=lambda *a: None)
    assert config["mesh_"]["inverse_mass_matrix"].shape == (n_chains, 8)
    rest = config["rest_"]["inverse_mass_matrix"].numpy()
    assert rest.shape == (n_chains, 2, 2)
    corr = rest[:, 0, 1] / np.sqrt(rest[:, 0, 0] * rest[:, 1, 1])
    assert (corr > 0.5).all(), corr
    assert state["rest_"].position["om_"].shape == (n_chains,)
    # every value+grad is counted but each block-chain's carry init
    assert n_ev == calls[0] - 2 * n_chains
    _, config_d, _ = _segmented_nuts_warmup(logdf, 40, n_chains, gen, pos, dense_max=0,
                                            log=lambda *a: None)
    assert config_d["rest_"]["inverse_mass_matrix"].shape == (n_chains, 2)
