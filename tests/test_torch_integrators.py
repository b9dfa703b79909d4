"""The port's scale-factor-time integrators and the minimal BullFrog run
against the JAX package on the same numpy inputs, on the CPU: `lpt_fpm` at
both orders, `nbody_bf_scan`, a 4-step `nbody_rk4` (states and gradients),
`nbody_tsit5` with snapshots (a step rejected on the way) and its a0 == a1
short cut; then the port's Tsit5 against its own 64-step RK4 (the
property of tests/test_pm.py::test_tsit5_matches_fine_rk4).  The gradient
through Tsit5 is in test_torch_tsit5_grad.py.

Float32 on both sides: the JAX package's nbody_tsit5 does not run in
float64 (under x64 its step branch returns a float64 step size and error
where the done branch keeps float32, and `lax.cond` refuses them; the
witness is in `test_tsit5_matches_jax`).  The port's Tsit5 runs in float64
too and agrees with its float32 run.

Tolerances (float32): LPT states 1e-4 relative with an atol of 1e-5 of the
largest value, gradients 1e-3 / 1e-4 (test_torch_nbody.py's); Tsit5's
states 1e-4 of their largest value (37 force evaluations, the rounding of
each carried through the controller's step sizes: 3.1e-6 / 3.0e-5
measured).
The JAX references of the file come from one jitted program (`jax_refs`).
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg, pm as jpm
from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.ops import background as tbg, fourier as tfo, pm as tpm
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_ops import T, _lin_field, close

torch.set_num_threads(1)

SHAPE = (16, 16, 16)
BOX = (64.0,) * 3         # 4 Mpc/h cells: a strong field, Tsit5 rejects a step
BOX_RK4 = (200.0,) * 3    # tests/test_pm.py's box for the Tsit5 / RK4 property
OM = np.float32(0.31)


def _lin(box=BOX, seed=42):
    return np.fft.irfftn(_lin_field(SHAPE, box, seed), SHAPE, axes=(0, 1, 2)).astype(np.float32)


def _run(bg, pm, link, pos0):
    """Every state the file compares, from one package."""
    return {"lpt_fpm1": pm.lpt_fpm(bg, link, pos0, 0.3, 1, grad_fd=4),
            "lpt_fpm2": pm.lpt_fpm(bg, link, pos0, 0.3, 2, grad_fd=4),
            "bf_scan": pm.nbody_bf_scan(bg, link, pos0, 0.5, n_steps=3, grad_fd=4),
            "rk4": pm.nbody_rk4(bg, link, pos0, 0.1, 1.0, n_steps=4),
            "tsit5": pm.nbody_tsit5(bg, link, pos0, 0.1, 1.0, tol=1e-3, snapshots=3)}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX states of `_run` and the gradient of sum(sin(pos) + sin(vel))
    of the RK4 state in the linear field and Omega_m, one jitted program."""
    def states(m, om):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=0.8))
        return _run(bg, jpm, jnp.fft.rfftn(m), jbr.regular_pos(SHAPE))

    def loss(m, om):
        out = states(m, om)
        return sum(jnp.sin(x).sum() for x in out["rk4"]), out

    def program(m, om):
        (_, out), grad = jax.value_and_grad(loss, (0, 1), has_aux=True)(m, om)
        return out, grad

    out = jax.jit(program)(jnp.asarray(_lin()), jnp.float32(OM))
    return jax.tree_util.tree_map(np.asarray, out)


def _port(dtype=torch.float32, grad=False):
    mt, omt = T(_lin(), grad).to(dtype), T(OM, grad).to(dtype)
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=omt, sigma8=torch.tensor(0.8, dtype=dtype)))
    return mt, omt, bg, tfo.rfftn(mt), tbr.regular_pos(SHAPE).to(dtype)


def test_lpt_fpm_and_bf_scan_match_jax(jax_refs):
    """lpt_fpm at orders 1 and 2 (FastPM momentum, each order with its own
    growth rate) and nbody_bf_scan (Zel'dovich velocity at g = 0, 3 plain
    steps, a leading singleton axis), at grad_fd 4."""
    _, _, bg, link, pos0 = _port()
    for key, fn in (("lpt_fpm1", lambda: tpm.lpt_fpm(bg, link, pos0, 0.3, 1, grad_fd=4)),
                    ("lpt_fpm2", lambda: tpm.lpt_fpm(bg, link, pos0, 0.3, 2, grad_fd=4)),
                    ("bf_scan", lambda: tpm.nbody_bf_scan(bg, link, pos0, 0.5, n_steps=3,
                                                          grad_fd=4))):
        for x, xj in zip(fn(), jax_refs[0][key]):
            close(x, xj, 1e-4, 1e-5)
    assert jax_refs[0]["bf_scan"][0].shape == (1, 16**3, 3)


def test_rk4_matches_jax(jax_refs):
    """A 4-step nbody_rk4 from a = 0.1 to 1 (grad_fd 4, each step
    checkpointed): the states and the gradient of sum(sin(pos) + sin(vel))
    in the linear field and Omega_m; a0 == a1 returns the (1,) LPT state."""
    mt, omt, bg, link, pos0 = _port(grad=True)
    pos, vel = tpm.nbody_rk4(bg, link, pos0, 0.1, 1.0, n_steps=4)
    (torch.sin(pos).sum() + torch.sin(vel).sum()).backward()
    states, (gm, gom) = jax_refs
    for x, xj in zip((pos, vel), states["rk4"]):
        close(x, xj, 1e-4, 1e-5)
    close(mt.grad, gm, 1e-3, 1e-4)
    close(omt.grad, gom, 1e-3)
    with torch.no_grad():
        same = tpm.nbody_rk4(bg, link, pos0, 0.3, 0.3)
        lpt = tpm.lpt_fpm(bg, link, pos0, 0.3, 1, grad_fd=4)
    assert same[0].shape == (1, 16**3, 3)
    torch.testing.assert_close(same[0][0], pos0 + lpt[0], rtol=0, atol=0)
    torch.testing.assert_close(same[1][0], lpt[1], rtol=0, atol=0)


def test_tsit5_matches_jax(jax_refs):
    """nbody_tsit5 at tol 1e-3 from a = 0.1 to 1 with 3 snapshots (the first
    the LPT start), against the JAX package in float32 (the port's accepted
    and rejected counts printed); the port in float64 takes the same steps
    and agrees with its float32 run within 1e-4; a0 == a1 returns the (1,)
    LPT state; the JAX package's function under x64 with float64 inputs
    raises (the float32 comparison's witness)."""
    with torch.no_grad():
        states = {}
        for dtype in (torch.float32, torch.float64):
            _, _, bg, link, pos0 = _port(dtype)
            stats = {}
            states[dtype] = tpm.nbody_tsit5(bg, link, pos0, 0.1, 1.0, tol=1e-3, snapshots=3,
                                            stats=stats)
            print(dtype, stats)
            if dtype == torch.float32:
                counts, pos32 = stats, pos0
                same = tpm.nbody_tsit5(bg, link, pos0, 0.5, 0.5)
                lpt = tpm.lpt_fpm(bg, link, pos0, 0.5, 1, grad_fd=4)
        assert stats == counts and counts["rejected"] >= 1, (stats, counts)
    pos, vel = states[torch.float32]
    assert pos.shape == (3, 16**3, 3)
    for x, xj in zip((pos, vel), jax_refs[0]["tsit5"]):
        close(x, xj, 0, 1e-4)
    for x, x64 in zip(states[torch.float32], states[torch.float64]):
        close(x, x64.numpy(), 0, 1e-4)
    assert same[0].shape == (1, 16**3, 3)
    torch.testing.assert_close(same[0][0], pos32 + lpt[0], rtol=0, atol=0)
    torch.testing.assert_close(same[1][0], lpt[1], rtol=0, atol=0)

    def jax_float64(m):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=jnp.float64(0.31), sigma8=0.8))
        return jpm.nbody_tsit5(bg, jnp.fft.rfftn(m), jbr.regular_pos(SHAPE).astype(m.dtype),
                               0.1, 1.0)

    with jax.enable_x64(True), pytest.raises(TypeError, match="do not match"):
        jax.eval_shape(jax_float64, jax.ShapeDtypeStruct(SHAPE, jnp.float64))


def test_tsit5_matches_fine_rk4():
    """The port's Tsit5 (tol 1e-4) agrees with its own 64-step RK4 of the
    same FastPM-convention ODE from the same 1LPT start, within 2e-3
    cells and 2e-3 in momentum: tests/test_pm.py's property on its own
    linear field (Planck18, box 200 Mpc/h, default_rng(42)'s normal draw
    through rg2cgh).  On `_lin_field(SHAPE, BOX_RK4, 42)` both packages'
    pairs differ by 0.022 cells: the bound is that realization's."""
    from montecosmo_tpu_torch.ops.hermitian import rg2cgh
    from montecosmo_tpu_torch.ops.power import lin_power_mesh

    white = rg2cgh(torch.tensor(np.random.default_rng(42).standard_normal(SHAPE), dtype=torch.float32))
    cell_vol = np.prod(np.divide(BOX_RK4, SHAPE))
    link = white * (lin_power_mesh(tbg.Planck18(), SHAPE, BOX_RK4) / cell_vol) ** 0.5
    bg = tbg.Background.create(tbg.Planck18())
    pos0 = tbr.regular_pos(SHAPE)
    with torch.no_grad():
        pos_ad, vel_ad = tpm.nbody_tsit5(bg, link, pos0, 0.1, 1.0, tol=1e-4)
        pos_rk, vel_rk = tpm.nbody_rk4(bg, link, pos0, 0.1, 1.0, n_steps=64)
    assert (pos_ad[-1] - pos0).abs().max() > 0.5  # displacements of order a cell
    np.testing.assert_allclose(pos_ad[-1].numpy(), pos_rk[-1].numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(vel_ad[-1].numpy(), vel_rk[-1].numpy(), rtol=0, atol=2e-3)
