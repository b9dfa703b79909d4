"""The port's finite-difference Fourier filters and the force arguments that
take them (`grad_fd`, `lap_fd`, `kcut`) against the JAX package on the
same numpy inputs, on the CPU.

At fd_order 2 the JAX package's inverse Laplacian has the sign of +1/k^2
(it divides by the Laplacian's eigenvalue, not by minus it: repulsive
forces); the port divides by minus the eigenvalue at every order (ROADMAP,
the kept differences).  `test_fd_filters_match_jax` holds the two
packages' filters, that sign and its witness; the force tests at
`lap_fd=2` hold the port against the JAX package's functions with its
order-2 filter negated (`_jax_fd2_corrected`), the rest of the JAX code
as it is; at `lap_fd=4` against the JAX package as it is.

Tolerances, float32, as test_torch_nbody.py's: values 1e-4 relative with
an atol of 1e-5 of the largest value (FFT and read rounding), gradients
1e-3 / 1e-4.  The JAX references of the file come from one jitted
program (`jax_refs`).
"""
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg, fourier as jfo, pm as jpm
from montecosmo_tpu.models import bricks as jbr

from montecosmo_tpu_torch.ops import background as tbg, fourier as tfo, pm as tpm
from montecosmo_tpu_torch.models import bricks as tbr

from test_torch_ops import T, _lin_field, close

torch.set_num_threads(1)

SHAPE, BOX = (16, 16, 16), (128.0,) * 3
FD = dict(grad_fd=4, lap_fd=2)
KCUT = 1.5  # a Gaussian cut of the potential at k = 1.5 (cell units)


@contextmanager
def _jax_fd2_corrected():
    """The JAX package's pm functions with their order-2 inverse Laplacian
    negated (the sign the port takes), every other filter as it is."""
    def invlaplace_hat(kvec, fd_order=np.inf):
        out = jfo.invlaplace_hat(kvec, fd_order)
        return -out if fd_order == 2 else out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpm, "invlaplace_hat", invlaplace_hat)
        yield


def _inputs():
    rng = np.random.default_rng(40)
    lin = np.fft.irfftn(_lin_field(SHAPE, BOX, 41), SHAPE, axes=(0, 1, 2)).astype(np.float32)
    pos = (np.asarray(jbr.regular_pos(SHAPE)) + rng.normal(0, 1.5, (16**3, 3))).astype(
        np.float32)
    cts = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("force", (16**3, 3)), ("delta2", SHAPE))}
    return lin, pos, cts


def _lpt_nbody(bg, pm, link, pos0, fd):
    """(lpt order 1, lpt order 2, 2-step nbody_bf) of one package."""
    l1 = pm.lpt(bg, link, pos0, 0.5, 1, 2, **fd)
    l2 = pm.lpt(bg, link, pos0, 0.5, 2, 2, **fd)
    nb = pm.nbody_bf(bg, link, pos0, a0=0.0, a1=1.0, n_steps=2, **fd)
    return l1, l2, nb


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of the file from one jitted program: the forces
    at (lap_fd 2, 4), the delta2 source and LPT / N-body states and their
    VJPs in the linear field and Omega_m, at grad_fd 4."""
    lin, pos, cts = _inputs()

    def forces(p, m):
        out = {}
        for lap in (2, 4):
            f = lambda pp, mm: jpm.pm_forces(pp, SHAPE, 2, grad_fd=4, lap_fd=lap, kcut=KCUT) + \
                jpm.pm_forces(pp, jnp.fft.rfftn(mm), 2, grad_fd=4, lap_fd=lap)
            v, vjp = jax.vjp(f, p, m)
            out[f"lap{lap}"] = (v, *vjp(cts["force"]))
        d2, vjp = jax.vjp(lambda mm: jpm.delta2_source(jnp.fft.rfftn(mm), **FD), m)
        out["delta2"] = (d2, *vjp(cts["delta2"]))
        return out

    def states(m, om):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=om, sigma8=0.8))
        return _lpt_nbody(bg, jpm, jnp.fft.rfftn(m), jbr.regular_pos(SHAPE), FD)

    def program(p, m, om):
        st, vjp = jax.vjp(states, m, om)
        # the gradient of sum(sin(states)), a nonlinear functional
        return forces(p, m), st, vjp(jax.tree_util.tree_map(jnp.cos, st))

    with _jax_fd2_corrected():
        out = jax.jit(program)(jnp.asarray(pos), jnp.asarray(lin), jnp.float32(0.31))
    return jax.tree_util.tree_map(np.asarray, out)


def test_fd_filters_match_jax():
    """gradient_hat at orders 2, 4 and inf equals the JAX package's;
    invlaplace_hat at orders 4 and inf too, at order 2 minus it (the sign
    witness: the JAX package's order-2 filter is positive where its exact
    and order-4 ones are negative, the port's tends to -1/k^2 as k -> 0);
    any other order is the same ValueError in both."""
    kj, kt = jfo.rfftk(SHAPE), tfo.rfftk(SHAPE)
    for order in (2, 4, np.inf):
        for d in range(3):
            close(tfo.gradient_hat(kt, d, order), jfo.gradient_hat(kj, d, order), 1e-6, 1e-7)
        sign = -1 if order == 2 else 1
        close(tfo.invlaplace_hat(kt, order), sign * np.asarray(jfo.invlaplace_hat(kj, order)),
              1e-6, 1e-7)
    kk = sum(np.asarray(k) ** 2 for k in kj)
    low = (kk > 0) & (kk < 0.05)
    jax2 = np.broadcast_to(np.asarray(jfo.invlaplace_hat(kj, 2)), kk.shape)
    port2 = np.broadcast_to(tfo.invlaplace_hat(kt, 2).numpy(), kk.shape)
    assert (jax2[kk > 0] > 0).all() and (np.asarray(jfo.invlaplace_hat(kj, 4))[kk > 0] < 0).all()
    np.testing.assert_allclose(port2[low], -1 / kk[low], rtol=1e-2)
    for order in (1, 3, 6):
        for fn in (lambda k: k.invlaplace_hat, lambda k: lambda kv, o: k.gradient_hat(kv, 0, o)):
            with pytest.raises(ValueError, match="fd_order must be 2, 4, or inf."):
                fn(tfo)(kt, order)
            with pytest.raises(ValueError, match="fd_order must be 2, 4, or inf."):
                fn(jfo)(kj, order)


@pytest.mark.parametrize("lap_fd", [2, 4])
def test_pm_forces_fd_matches_jax(jax_refs, lap_fd):
    """pm_forces at grad_fd 4 and lap_fd 2 / 4: the particles' own paint with
    a Gaussian cut of the potential, plus the forces of the rfft mesh of the
    linear field read at the same positions; values and the VJP in the
    positions and the mesh."""
    lin, pos, cts = _inputs()
    pt, mt = T(pos, True), T(lin, True)
    f = tpm.pm_forces(pt, SHAPE, 2, grad_fd=4, lap_fd=lap_fd, kcut=KCUT) + \
        tpm.pm_forces(pt, tfo.rfftn(mt), 2, grad_fd=4, lap_fd=lap_fd)
    f.backward(T(cts["force"]))
    vj, gpj, gmj = jax_refs[0][f"lap{lap_fd}"]
    close(f, vj, 1e-4, 1e-5)
    close(pt.grad, gpj, 1e-3, 1e-4)
    close(mt.grad, gmj, 1e-3, 1e-4)


def test_delta2_source_fd_matches_jax(jax_refs):
    """delta2_source at grad_fd 4, lap_fd 2: values and the VJP in the
    linear field."""
    lin, _, cts = _inputs()
    mt = T(lin, True)
    d2 = tpm.delta2_source(tfo.rfftn(mt), **FD)
    d2.backward(T(cts["delta2"]))
    vj, gj = jax_refs[0]["delta2"]
    close(d2, vj, 1e-4, 1e-5)
    close(mt.grad, gj, 1e-3, 1e-4)


def test_lpt_and_nbody_fd_match_jax(jax_refs):
    """lpt orders 1 and 2 (read at CIC, no sites) and a 2-step nbody_bf (the
    particles' own paint, as the integrators take it), all at grad_fd 4,
    lap_fd 2: the states, and the gradient of sum(sin(states)) in the
    linear field and Omega_m."""
    lin, _, _ = _inputs()
    mt, omt = T(lin, True), T(np.float32(0.31), True)
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=omt, sigma8=torch.tensor(0.8)))
    st = _lpt_nbody(bg, tpm, tfo.rfftn(mt), tbr.regular_pos(SHAPE), FD)
    sum(torch.sin(x).sum() for s in st for x in s).backward()
    _, sj, (gmj, goj) = jax_refs
    for s, j in zip(st, sj):
        for x, xj in zip(s, j):
            close(x, xj, 1e-4, 1e-5)
    close(mt.grad, gmj, 1e-3, 1e-4)
    close(omt.grad, goj, 1e-3)
    assert np.abs(sj[2][0][-1] - np.asarray(jbr.regular_pos(SHAPE))).max() > 1
