"""The port's bispectrum against the JAX package on the CPU, and K10's
plain version against numpy.

The field is tests/test_bispectrum.py's local-quadratic one, delta = g +
fnl (g^2 - <g^2>) with g white (fnl 0.05, cell 2 Mpc/h), at 16^3.  Both
packages get the same float32 numpy field.  The bin means, triples and
mode counts are the same numpy plan, so they are held equal; B is held
within 1e-4 of max |B| (the JAX package averages float32 products, the
port sums them in float64: measured <= 9.7e-6 of max |B| over the closed
triples, <= 6.6e-5 with `open_triangles`, whose triples of a few
triangles divide by a float32 mean of the unit fields that has lost
digits), and the gate (at least half a closed triangle) must decide
every triple alike.
"""
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from montecosmo_tpu.metrics import bispectrum as jax_bispectrum

from montecosmo_tpu_torch.metrics import _bispectrum_inputs, _closed_triples, bispectrum
from montecosmo_tpu_torch.ops import bispectrum as BS
from montecosmo_tpu_torch.ops.bispectrum import (
    MAX_BINS, bispectrum_plan, bispectrum_triples, bispectrum_triples_plain,
)

N, BOX, FNL = 16, (32.0,) * 3, 0.05


def _local_quadratic(seed):
    g = np.random.default_rng(seed).normal(size=(N,) * 3)
    return (g + FNL * (g**2 - np.mean(g**2))).astype(np.float32)


@pytest.mark.parametrize("kedges", [6, 7])
def test_bispectrum_matches_jax(kedges):
    """kmean, triples and counts equal, B within 1e-4 of max |B|, the same
    gate decisions; also from the rfft of the field, and with
    `open_triangles`, whose extra triples must stay exactly 0 where they
    hold no triangle."""
    delta = _local_quadratic(kedges)
    closed = None
    for open_tri in (False, True):
        kj, tj, bj, cj = jax_bispectrum(jnp.asarray(delta), box_size=BOX, kedges=kedges,
                                        open_triangles=open_tri)
        kt, tt, bt, ct = bispectrum(torch.as_tensor(delta), box_size=BOX, kedges=kedges,
                                    open_triangles=open_tri)
        bj = np.asarray(bj)
        np.testing.assert_array_equal(tt, np.asarray(tj))
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_allclose(kt, np.asarray(kj), rtol=1e-12)
        assert bt.dtype == torch.float32 and bt.shape == bj.shape
        np.testing.assert_array_equal(bt.numpy() != 0, bj != 0)
        np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-4 * np.abs(bj).max())
        closed = closed or (tt, bt)
    # the same from the rfft mesh
    _, tf, bf, _ = bispectrum(torch.fft.rfftn(torch.as_tensor(delta)), box_size=BOX,
                              kedges=kedges)
    np.testing.assert_array_equal(tf, closed[0])
    np.testing.assert_allclose(bf.numpy(), closed[1].numpy(), rtol=0,
                               atol=1e-5 * np.abs(closed[1].numpy()).max())


def test_triples_plain_matches_numpy_einsum(monkeypatch):
    """K10's plain version against numpy float64 einsums over the same
    triples (rtol 1e-12, the same float64 products summed in another
    order), in chunks of 5 triples; its absolute sums bound the sums; a
    gradient is refused."""
    monkeypatch.setattr(BS, "PLAIN_CHUNK_BYTES", 4096 * 32 * 5)
    rng = np.random.default_rng(7)
    F = rng.normal(size=(9, 4096)).astype(np.float32)
    U = rng.normal(size=(9, 4096)).astype(np.float32)
    kmean = np.sort(rng.uniform(0.1, 1.0, 9))
    triples = _closed_triples(np.linspace(0.05, 1.05, 10), kmean, False)
    want = np.stack([np.einsum("tn,tn,tn->t", *(X.astype(np.float64)[triples[:, c]]
                                                for c in range(3))) for X in (F, U)], -1)
    got, mag = bispectrum_triples_plain(torch.as_tensor(F), torch.as_tensor(U),
                                        torch.as_tensor(triples), with_abs=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * mag.numpy().max())
    assert np.all(mag.numpy() >= np.abs(want) * (1 - 1e-12))
    assert torch.equal(bispectrum_triples(torch.as_tensor(F), torch.as_tensor(U),
                                          torch.as_tensor(triples)), got)
    Fg = torch.as_tensor(F).requires_grad_(True)
    out = bispectrum_triples(Fg, torch.as_tensor(U), torch.as_tensor(triples))
    with pytest.raises(NotImplementedError):
        out.sum().backward()


def test_k10_plan_fits_shared_memory():
    """The tile and accumulators fit a CTA's shared memory at every bin
    count up to MAX_BINS (128^3 takes tiles of 256 cells, 256^3 of 128),
    the cell ranges cover the mesh, and more bins are refused."""
    assert bispectrum_plan(128**3, 35, 4347)[0] == 8
    assert bispectrum_plan(256**3, 72, 34343)[0] == 4
    for bins in (1, 35, 72, 97, 98, 195, 196, MAX_BINS):
        m, per, nx = bispectrum_plan(100_000, bins, 5000)
        assert (2 * bins * 32 * m + 2 * 2048) * 8 <= 232448
        assert per % (32 * m) == 0 and (nx - 1) * per < 100_000 <= nx * per
    with pytest.raises(ValueError):
        bispectrum_plan(1000, MAX_BINS + 1, 10)


def test_bispectrum_norm_past_int64():
    """At 2^21 cells (8 x 8 x 32768), where the JAX package's integer N^3
    wraps to -2^63 and flips B's sign, B is V^2 / N^9 times the ratio of
    the triple sums in floats: within 1e-6 of max |B| of that product in
    float64, with its sign."""
    shape, box = (8, 8, 32768), (8.0, 8.0, 32768.0)
    g = np.random.default_rng(3).normal(size=shape)
    delta = torch.as_tensor((g + FNL * (g**2 - np.mean(g**2))).astype(np.float32))
    kedges = np.array([0.5, 0.9, 1.3, 1.7])
    _, tri, b, _ = bispectrum(delta, box_size=box, kedges=kedges)
    F, U, t, _ = _bispectrum_inputs(delta, box, kedges)
    np.testing.assert_array_equal(tri, t.numpy())
    sums = bispectrum_triples_plain(F, U, t).numpy()
    n = 2.0**21
    want = np.where(sums[:, 1] * n**2 > 0.5,
                    np.prod(box)**2 / n**3 * sums[:, 0] / sums[:, 1], 0.0)
    assert len(want) >= 4 and np.all(want != 0)
    np.testing.assert_array_equal(np.sign(b.numpy()), np.sign(want))
    np.testing.assert_allclose(b.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
