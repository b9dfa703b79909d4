"""The port's MCLMC / MAMS (montecosmo_tpu_torch.samplers) against the JAX
package's, on the CPU: the momentum bounce, the refresh, the McLachlan step,
a warmup and a MAMS trajectory fed the same numpy (or JAX-drawn) inputs; the
moments the port alone recovers on the 8-dim Gaussian of test_samplers.py;
the NaN guard; the run-and-save runner; and a JAX warmup's state carried
into a port run.
"""
import numpy as np
import pytest
import torch

import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu.samplers import mclmc as J
from montecosmo_tpu_torch.convert import mclmc_config_from_numpy, mclmc_state_from_numpy
from montecosmo_tpu_torch.samplers import mclmc as T
from montecosmo_tpu_torch.samplers import (
    get_mams_run, get_mams_warmup, get_mclmc_run, get_mclmc_warmup, sample_and_save, save_run,
)

torch.set_num_threads(1)

D = 8
SCALES_NP = np.geomspace(0.5, 3.0, D).astype(np.float32)
SCALES_J = jnp.asarray(SCALES_NP)
SCALES_T = torch.as_tensor(SCALES_NP)


def logdf_j(x):
    return -0.5 * jnp.sum((x["x"] / SCALES_J) ** 2)


def logdf_t(x):
    return -0.5 * torch.sum((x["x"] / SCALES_T) ** 2)


def init_np(seed=0):
    return {"x": np.random.default_rng(seed).standard_normal(D).astype(np.float32)}


def as_t(tree):
    return jax.tree.map(lambda v: torch.tensor(np.asarray(v)), tree)


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Counter:
    """A log-density that counts its value+grads."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, x):
        self.n += 1
        return self.fn(x)


def test_ravel_is_ravel_pytree():
    """Sorted keys, each leaf in C order: the layout of a JAX momentum."""
    rng = np.random.default_rng(0)
    tree = {"b_": rng.standard_normal((2, 3)).astype(np.float32),
            "a_": np.float32(1.5), "white_mesh_": rng.standard_normal((2, 2, 2)).astype(np.float32)}
    flat_j, _ = jax.flatten_util.ravel_pytree({k: jnp.asarray(v) for k, v in tree.items()})
    flat_t, unravel = T._ravel(as_t(tree))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unravel(flat_t)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("d", [8, 100_000])
@pytest.mark.parametrize("invmm", ["scalar", "vector"])
def test_momentum_update_matches_jax(d, invmm):
    """u' within 1e-6 relative (of |u'| = 1) and dKE within 1e-5 of
    max(|dKE|, 1), over step sizes 1e-6 to 1: the log1p/expm1 form (the
    naive log form is off by ~(d-1) 1e-7, 1e-2 at d = 1e5).

    dKE is a difference of two terms of size (d-1) delta = eps |g|, whose
    float32 reductions (|g| and u.e over d terms) round differently in XLA
    and in torch: at d = 1e5, eps |g| ~ 300 (vector, eps = 1) the JAX
    package's own dKE is 1.5e-5 of |dKE| from the same formula in float64.
    So dKE is held against JAX within 1e-5 of max(|dKE|, 1) beyond the JAX
    value's own distance from float64, and against float64 within 1e-5 of
    max(|dKE|, 1)."""
    rng = np.random.default_rng(d)
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    g = (10 * rng.standard_normal(d)).astype(np.float32)
    sq = np.float32(0.7) if invmm == "scalar" else rng.uniform(0.2, 2.0, d).astype(np.float32)
    for eps in (1e-6, 1e-4, 1e-2, 0.1, 1.0):
        uj, kj = J._momentum_update(jnp.asarray(u), jnp.asarray(g), jnp.asarray(sq),
                                    jnp.float32(eps))
        ut, kt = T._momentum_update(torch.as_tensor(u), torch.as_tensor(g),
                                    torch.as_tensor(sq), torch.tensor(eps))
        _, k64 = T._momentum_update(*(torch.as_tensor(np.float64(x)) for x in (u, g, sq, eps)))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-6)
        kt, kj, k64 = float(kt), float(kj), float(k64)
        tol = 1e-5 * max(abs(kj), 1.0)
        assert abs(kt - k64) <= tol, (eps, kt, k64)
        assert abs(kt - kj) <= tol + abs(kj - k64), (eps, kt, kj, k64)


def test_partial_refresh_matches_jax():
    """Fed JAX's own jr.normal draw: within 1e-6."""
    d = 1000
    u = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    key = jr.key(3)
    for eps, L in ((0.1, 3.0), (1.0, 0.5)):
        uj = J._partial_refresh(jnp.asarray(u), key, jnp.float32(eps), jnp.float32(L))
        noise = torch.tensor(np.asarray(jr.normal(key, (d,))))
        ut = T._partial_refresh(torch.as_tensor(u), noise, torch.tensor(eps), torch.tensor(L))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-6)


def gauss_state(seed=0):
    """The same MCLMC state of the 8-dim Gaussian in both packages."""
    pos = init_np(seed)
    u = np.random.default_rng(seed + 1).standard_normal(D).astype(np.float32)
    sj = J.mclmc_init({"x": jnp.asarray(pos["x"])}, logdf_j, jr.key(seed))
    sj = sj._replace(momentum=jnp.asarray(u / np.linalg.norm(u)))
    st = T.mclmc_init(as_t(pos), logdf_t, torch.as_tensor(u))
    return sj, st


def assert_states_close(st, sj, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(st.position["x"].numpy(), np.asarray(sj.position["x"]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(st.momentum.numpy(), np.asarray(sj.momentum), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(st.logdensity), float(sj.logdensity), rtol=rtol, atol=atol)
    np.testing.assert_allclose(st.logdensity_grad["x"].numpy(),
                               np.asarray(sj.logdensity_grad["x"]), rtol=rtol, atol=atol)


def test_mclachlan_step_matches_jax():
    """One McLachlan step on test_samplers.py's Gaussian from the same
    position and momentum: states within 1e-6, energy change within 1e-5."""
    sj, st = gauss_state()
    assert_states_close(st, sj)
    sq = np.sqrt(SCALES_NP**2 / 2)
    for eps in (0.05, 0.8):
        nj, ej = J._mclachlan_step(sj, logdf_j, jnp.float32(eps), jnp.asarray(sq))
        count = Counter(logdf_t)
        nt, et = T._mclachlan_step(st, count, torch.tensor(eps), torch.as_tensor(sq))
        assert count.n == 2
        assert_states_close(nt, nj)
        assert abs(float(et) - float(ej)) <= 1e-5 * max(abs(float(ej)), 1.0)


@pytest.mark.parametrize("diag", [False, True])
def test_warmup_matches_jax_30_steps(diag):
    """A 30-step warmup driven by JAX's own draws (the init momentum and the
    per-step refresh draws of mclmc_warmup's key splits) in both packages:
    the tuned step_size, L and diagonal inverse mass within 1e-4 relative.
    Both run in float64 (measured agreement ~1e-8): in float32 the first
    steps' energy changes, ~1e-4 from differences of logdensities ~4, carry
    ~1e-3 relative rounding that the tuner's feedback amplifies, so two
    float32 sums taken in another order end 1e-3 apart."""
    n_steps, dev, seed = 30, 5e-4, jr.key(7)
    pos = init_np(2)["x"].astype(np.float64)
    s64_t = torch.as_tensor(SCALES_NP).double()
    lt = lambda x: -0.5 * torch.sum((x["x"] / s64_t) ** 2)
    with jax.enable_x64(True):
        s64_j = jnp.asarray(SCALES_NP, jnp.float64)
        lj = lambda x: -0.5 * jnp.sum((x["x"] / s64_j) ** 2)
        sj, cj = J.mclmc_warmup(seed, {"x": jnp.asarray(pos)}, lj, n_steps=n_steps,
                                desired_energy_var=dev, diagonal_preconditioning=diag)
        sj, cj = jax.tree.map(np.asarray, (sj, cj))
        init_seed, tune_seed = jr.split(seed, 2)
        keys1, keys2 = jr.split(tune_seed)
        steps1 = n_steps // 2
        draws = lambda keys: torch.tensor(np.asarray(
            jax.vmap(lambda k: jr.normal(k, (D,), jnp.float64))(keys)))
        u0 = torch.tensor(np.asarray(jr.normal(init_seed, (D,), jnp.float64)))
        noise1, noise2 = draws(jr.split(keys1, steps1)), draws(jr.split(keys2, n_steps - steps1))

    st = T.mclmc_init({"x": torch.as_tensor(pos)}, lt, u0)
    config = T.MCLMCAdaptationState(*(torch.tensor(x, dtype=torch.float64) for x in (
        D**0.5, D**0.5 / 1e4, np.ones(D))))
    carry = T._warmup_carry0(st, config, torch.float64, D)
    carry = T._warmup_chunk(carry, noise1, False, lt, dev)
    carry = T._warmup_chunk(carry, noise2, True, lt, dev)
    st, ct = T._warmup_finalize(carry, diag)
    for name in ("step_size", "L", "inverse_mass_matrix"):
        np.testing.assert_allclose(np_of(getattr(ct, name)), getattr(cj, name), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(st.position["x"].numpy(), sj.position["x"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_mams_trajectory_matches_jax(n):
    """The port's loop of exactly n McLachlan steps (2n value+grads)
    against JAX's scan of max_steps = 6 masked past n; then one MAMS
    transition fed the JAX kernel's own draws (momentum, length, accept)."""
    max_steps = 6
    sj, st = gauss_state(3)
    sq = np.ones(D, np.float32)
    tj, ej = J._trajectory(sj, logdf_j, jnp.float32(0.4), jnp.asarray(sq), jnp.asarray(n),
                           max_steps)
    count = Counter(logdf_t)
    tt, et = T._trajectory(st, count, torch.tensor(0.4), torch.as_tensor(sq), n)
    assert count.n == 2 * n
    assert_states_close(tt, tj, atol=1e-5, rtol=1e-5)
    assert abs(float(et) - float(ej)) <= 1e-5 * max(abs(float(ej)), 1.0)

    # a MAMS transition whose length draw gives n steps: avg_steps = n / 2
    # and U = 1 - 1e-3 (so ceil(U n) = n), found among the JAX keys
    avg = n / 2
    key = next(k for k in jr.split(jr.key(11), 256)
               if int(np.ceil(float(jr.uniform(jr.split(k, 3)[1])) * 2 * avg)) == n)
    key_mom, key_len, key_acc = jr.split(key, 3)
    kj = J.mams_kernel(logdf_j, jnp.ones(D), jnp.float32(0.4), jnp.float32(avg), max_steps)
    nj, ij = kj(key, sj)
    count = Counter(logdf_t)
    kt = T.mams_kernel(count, torch.ones(D), torch.tensor(0.4), torch.tensor(avg), max_steps)
    draws = (torch.tensor(np.asarray(jr.normal(key_mom, (D,)))),
             torch.tensor(np.asarray(jr.uniform(key_len))),
             torch.tensor(np.asarray(jr.uniform(key_acc))))
    nt, it = kt(draws, st)
    assert it["num_integration_steps"] == int(ij["num_integration_steps"]) == n
    assert count.n == 2 * n
    assert bool(it["is_accepted"]) == bool(ij["is_accepted"])
    np.testing.assert_allclose(float(it["acceptance_rate"]), float(ij["acceptance_rate"]),
                               rtol=1e-5, atol=1e-6)
    assert_states_close(nt, nj, atol=1e-5, rtol=1e-5)


def test_mclmc_recovers_moments():
    """test_samplers.py's MCLMC checks on the port alone (fewer samples)."""
    gen = torch.Generator().manual_seed(0)
    state, config = get_mclmc_warmup(logdf_t, n_steps=600, desired_energy_var=5e-4)(
        gen, as_t(init_np()))
    assert np.isfinite(float(config.step_size)) and float(config.step_size) > 0
    L_expect = float(np.sqrt(np.sum(SCALES_NP**2)))
    assert 0.3 * L_expect < float(config.L) < 3 * L_expect, (config.L, L_expect)
    state, samples = get_mclmc_run(logdf_t, n_samples=1000, thinning=4)(gen, state, config)
    xs = samples["x"].numpy()
    assert xs.shape == (1000, D)
    assert np.all(np.abs(xs.mean(0) / SCALES_NP) < 0.35), xs.mean(0)
    np.testing.assert_allclose(xs.std(0), SCALES_NP, rtol=0.3)
    assert float(samples["mse_per_dim"].mean()) < 100 * 5e-4
    assert np.all(samples["n_evals"].numpy() == 8)  # 2 grads x thinning 4


def test_mclmc_preconditioning_recovers_variances():
    gen = torch.Generator().manual_seed(1)
    _, config = get_mclmc_warmup(logdf_t, n_steps=800, diagonal_preconditioning=True)(
        gen, as_t(init_np()))
    ratio = config.inverse_mass_matrix.numpy() / SCALES_NP**2
    assert np.all(ratio > 0.1) and np.all(ratio < 10), ratio


def test_mams_recovers_moments():
    gen = torch.Generator().manual_seed(2)
    state, config = get_mams_warmup(logdf_t, n_steps=300)(gen, as_t(init_np()))
    state, samples = get_mams_run(logdf_t, n_samples=600, thinning=2)(gen, state, config)
    xs = samples["x"].numpy()
    np.testing.assert_allclose(xs.mean(0), 0.0, atol=0.5)
    np.testing.assert_allclose(xs.std(0), SCALES_NP, rtol=0.35)
    acc = float(samples["acceptance_rate"].mean())
    assert 0.3 < acc <= 1.0, acc
    assert np.all(samples["n_evals"].numpy() >= 2 * 2)


def test_mams_run_counts_value_and_grads():
    """n_evals is 2 x the McLachlan steps the transitions took, and the
    log-density ran exactly that often: no masked steps."""
    gen = torch.Generator().manual_seed(3)
    state = T.mclmc_init(as_t(init_np()), logdf_t, gen)
    config = T.MCLMCAdaptationState(torch.tensor(4.0), torch.tensor(0.5), torch.ones(D))
    count = Counter(logdf_t)
    _, samples = T.mams_run(gen, state, config, count, n_samples=5, thinning=3, max_steps=40)
    n_evals = samples["n_evals"].numpy()
    assert count.n == int(n_evals.sum()) and np.all(n_evals >= 2 * 3)
    assert np.all(n_evals <= 2 * 3 * 16)  # ceil(U * 2 * L / eps) <= 16 < max_steps


def test_nan_guard_rejects_and_caps():
    sj, st = gauss_state()
    bad = st._replace(position={"x": torch.full((D,), float("nan"))},
                      logdensity=torch.tensor(float("nan")))
    cap, eps = torch.tensor(np.inf), torch.tensor(0.5)
    ok, state, cap_new, de = T._nan_guard(st, bad, cap, torch.tensor(0.3), eps)
    assert not bool(ok) and torch.isinf(de)
    np.testing.assert_allclose(float(cap_new), 0.4)
    assert torch.equal(state.position["x"], st.position["x"])
    assert torch.equal(state.logdensity, st.logdensity)
    ok, state, cap_new, de = T._nan_guard(st, st, cap, torch.tensor(0.3), eps)
    assert bool(ok) and float(de) == pytest.approx(0.3) and torch.isinf(cap_new)


def test_save_run_and_resume(tmp_path):
    """sample_and_save writes the warmup and each run as .npz, the last state
    as numpy; a second call resumes from it and runs only what is missing."""
    path = str(tmp_path / "chain")
    config = T.MCLMCAdaptationState(torch.tensor(3.0), torch.tensor(0.5), torch.tensor(1.0))
    calls = []

    def warmup_fn(gen, state):
        state, config_ = T.mclmc_warmup(gen, state.position, logdf_t, n_steps=10)
        return {}, {}, state, config_

    def run_fn(gen, state):
        calls.append(1)
        state, samples = T.mclmc_run(gen, state, config, logdf_t, n_samples=3, thinning=2)
        infos = {k: samples.pop(k) for k in ("logdensity", "mse_per_dim", "n_evals")}
        return samples, infos, state

    init = T.mclmc_init(as_t(init_np()), logdf_t, torch.Generator().manual_seed(0))
    last = sample_and_save(run_fn, init, path, start=0, end=2, warmup_fn=warmup_fn, seed=4)
    assert len(calls) == 2
    run1 = np.load(f"{path}_1.npz")
    assert set(run1.files) == {"x", "logdensity", "mse_per_dim", "n_evals"}
    assert run1["x"].shape == (3, D) and np.all(run1["n_evals"] == 4)
    import pickle

    with open(f"{path}_last_state.p", "rb") as f:
        saved = pickle.load(f)
    assert isinstance(saved.position["x"], np.ndarray)
    np.testing.assert_array_equal(saved.position["x"], last.position["x"].numpy())

    (tmp_path / "chain_2.npz").unlink()
    resumed = sample_and_save(run_fn, init, path, start=0, end=2, warmup_fn=warmup_fn, seed=5)
    assert len(calls) == 3 and (tmp_path / "chain_2.npz").exists()
    assert torch.is_tensor(resumed.position["x"])

    save_run({"x": torch.zeros(2, D)}, {"num_integration_steps": torch.tensor([3, 4])},
             last, 9, path)
    assert set(np.load(f"{path}_9.npz").files) == {"x", "n_evals"}


def test_jax_warmup_state_continues_in_port():
    """A JAX warmup's (state, config), carried over as numpy, continues in
    the port's mclmc_run fed the JAX run's own draws: the same chain."""
    sj, cj = J.mclmc_warmup(jr.key(5), {"x": jnp.asarray(init_np(4)["x"])}, logdf_j,
                            n_steps=40, diagonal_preconditioning=True)
    st = mclmc_state_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
    ct = mclmc_config_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    assert isinstance(st, T.IntegratorState) and isinstance(ct, T.MCLMCAdaptationState)
    n_samples, thinning, seed = 4, 2, jr.key(6)
    _, out_j = J.mclmc_run(seed, sj, cj, logdf_j, n_samples, thinning=thinning)
    keys = jr.split(seed, (n_samples, thinning))
    noise = jax.vmap(jax.vmap(lambda k: jr.normal(k, (D,))))(keys)
    _, out_t = T.mclmc_run(torch.tensor(np.asarray(noise)), st, ct, logdf_t, n_samples,
                           thinning=thinning)
    np.testing.assert_allclose(out_t["x"].numpy(), np.asarray(out_j["x"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_t["logdensity"].numpy(), np.asarray(out_j["logdensity"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out_t["n_evals"].numpy(), np.asarray(out_j["n_evals"]))
