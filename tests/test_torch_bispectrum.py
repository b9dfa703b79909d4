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
import itertools

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
    """The stages and tile fit a CTA's shared memory at every bin count up
    to MAX_BINS (128^3 takes tiles of 128 cells, 256^3 of 64), the cell
    ranges cover the mesh, and more bins, or triples out of order, are
    refused."""
    def plan(n, bins, t=None):
        every = ((i, j, l) for l in range(bins) for j in range(l + 1) for i in range(j + 1))
        tri = np.array(list(itertools.islice(every, t)), np.int32)
        return bispectrum_plan(tri, bins, n)

    assert plan(128**3, 35, 50)["tile"] == 128
    assert plan(256**3, 72, 50)["tile"] == 64
    for bins in (1, 35, 72, 97, 98, 195, 196, MAX_BINS):
        p = plan(100_000, bins, 500)
        assert BS.tile_bytes(bins, p["tile"]) <= BS.SMEM_LIMIT and p["tile"] % 16 == 0
        assert p["per"] % p["tile"] == 0 and (p["nx"] - 1) * p["per"] < 100_000 <= p["nx"] * p["per"]
    with pytest.raises(ValueError):
        plan(1000, MAX_BINS + 1, 10)
    with pytest.raises(ValueError):
        bispectrum_plan(np.array([[2, 1, 3]], np.int32), 4, 1000)


def test_k10_plan_on_a_device_is_one_cached_plan():
    """With `device`, the plan's strips and entries are tensors on it with
    the numpy plan's values (what the wrapper launches with), and a second
    call, the device named either way, returns the same cached plan."""
    tri = np.array([(i, j, l) for l in range(20) for j in range(l + 1) for i in range(j + 1)],
                   np.int32)
    host = bispectrum_plan(tri, 20, 4096)
    dev = bispectrum_plan(tri, 20, 4096, device="cpu")
    assert dev is bispectrum_plan(tri, 20, 4096, device=torch.device("cpu"))
    assert dev is not host and bispectrum_plan(tri, 20, 4096) is host
    for key in ("strips", "entries"):
        assert isinstance(dev[key], torch.Tensor) and dev[key].device.type == "cpu"
        np.testing.assert_array_equal(dev[key].numpy(), host[key])
    assert all(dev[k] == host[k] for k in ("tile", "ny", "per", "nx"))


def _emulate_k10(F, U, tri, sms):
    """K10's plan as the kernel runs it, in float64 torch: each strip's 16 x
    8 blocks (F_I F_l) F_J^T for its l's, summed over each cell range, the
    entries picked for the triples, the ranges added in order."""
    bins, n = F.shape
    plan = bispectrum_plan(tri.numpy(), bins, n, sms)
    pad = BS.padded_bins(bins)
    out = torch.zeros(tri.shape[0], 2, dtype=torch.float64)
    for x0 in range(0, n, plan["per"]):
        part = torch.full((tri.shape[0], 2), float("nan"), dtype=torch.float64)
        for col, X in enumerate((F, U)):
            Xp = torch.zeros(pad, min(n, x0 + plan["per"]) - x0, dtype=torch.float64)
            Xp[:bins] = X[:, x0:x0 + plan["per"]].double()
            for s, (ib, jb, l0, nl) in enumerate(plan["strips"]):
                for w in range(nl):
                    block = (Xp[16 * ib:16 * ib + 16] * Xp[l0 + w]) @ Xp[8 * jb:8 * jb + 8].T
                    ent = torch.as_tensor(plan["entries"][s, w])
                    on = ent >= 0
                    part[ent[on].long(), col] = block.reshape(-1)[on]
        assert not torch.isnan(part).any()
        out += part
    return out, plan


@pytest.mark.parametrize("n,kedges", [(16, None), (16, 6), (32, None), (32, 24)])
def test_k10_block_plan_covers_triples_and_matches_plain(n, kedges):
    """K10's block plan at 16^3 and 32^3, with the default `kedges` (3
    and 8 bins: one and two strips) and `kedges` as a count (5 and 23 bins:
    one strip, and 10 over two CTA rows; a shell with no mode sums to 0):
    every closed triple is one entry of one strip's 16 x 8 block, at slot
    l - l0 and entry 8 (i - 16 ib) + j - 8 jb, its blocks inside the B
    fields (padded to a multiple of 16), and the blocked float64 sums within
    1e-12 of each triple's sum of |products| of `bispectrum_triples_plain`."""
    g = np.random.default_rng(n).normal(size=(n,) * 3)
    delta = torch.as_tensor((g + FNL * (g**2 - np.mean(g**2))).astype(np.float32))
    F, U, tri, _ = _bispectrum_inputs(delta, (2.0 * n,) * 3, kedges)
    bins = F.shape[0]
    got, plan = _emulate_k10(F, U, tri, sms=4)
    entries = plan["entries"]
    assert np.array_equal(np.sort(entries[entries >= 0]), np.arange(tri.shape[0]))
    for s, (ib, jb, l0, nl) in enumerate(plan["strips"]):
        assert 0 <= nl <= BS.SLOTS and (entries[s, nl:] == -1).all()
        if nl:
            assert 2 * ib <= jb and 8 * jb < bins and l0 + nl <= bins
        for w, e in zip(*np.nonzero(entries[s] >= 0)):
            i, j, l = tri[entries[s, w, e]].tolist()
            assert (i, j, l) == (16 * ib + e // 8, 8 * jb + e % 8, l0 + w)
    ref, mag = bispectrum_triples_plain(F, U, tri, with_abs=True)
    assert float(((got - ref).abs() / mag.clamp(min=1e-300)).max()) <= 1e-12


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
