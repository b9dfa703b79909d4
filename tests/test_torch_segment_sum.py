"""K9 (`ops/segment.py`, the deterministic segment sum and the table
gather whose adjoint it is) on the CPU, where K9 runs its plain version:

* `segment_sum_plain` against numpy `add.at` in float64, with out-of-range
  ids dropped, at light-cone-like ids (sorted, in runs) and uniform ids,
  trailing channel axes flattened (exact up to float64 summation order:
  1e-12 of the largest sum);
* `take_rows`' gradient against the VJP of JAX's `jnp.take` (the scatter
  add of `uniform_interp`'s gather) in float32, rtol 1e-6 and atol 1e-6
  of the largest entry (sums of the same terms in another order);
* `gradcheck` and `gradgradcheck` of the Function pair in float64, and a
  third derivative;
* the power spectrum's `_segment_reduce` against JAX's (float32, the same
  terms summed in another order: rtol 1e-5).
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu_torch.ops.segment import segment_sum, segment_sum_plain, take_rows

torch.set_num_threads(1)


def _ids(kind, n, rows, rng):
    """Ids in [-2, rows + 2): sorted (runs of equal ids, as a light cone's
    lattice-ordered lookups) or uniform; some fall outside [0, rows)."""
    ids = rng.integers(-2, rows + 2, n)
    return np.sort(ids) if kind == "runs" else ids


@pytest.mark.parametrize("kind", ["runs", "uniform"])
@pytest.mark.parametrize("shape", [(3000, 1), (3000, 2), (2000, 2, 4)])
def test_plain_matches_numpy_add_at(kind, shape):
    rng = np.random.default_rng(0)
    rows = 37
    src = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, (shape[0],) + (1,) * (
        len(shape) - 1))
    ids = _ids(kind, shape[0], rows, rng)
    ref = np.zeros((rows + 1,) + shape[1:])
    ok = (ids >= 0) & (ids < rows)
    np.add.at(ref, np.where(ok, ids, rows), src)
    ref = ref[:rows]
    for dtype in (torch.int32, torch.int64):
        flat = torch.tensor(src.reshape(shape[0], -1))
        got = segment_sum_plain(flat, torch.tensor(ids, dtype=dtype), rows)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        got = segment_sum(torch.tensor(src), torch.tensor(ids, dtype=dtype), rows)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("trail", [(2,), (2, 4)])
def test_take_rows_gradient_matches_jax_take(trail):
    """The stacked-pair tables' gather ((n - 1, 2) pairs; (n - 1, 2, 4) for
    the four growth tables) at lattice-ordered and at uniform ids: values
    and the VJP of a random cotangent, against jnp.take."""
    rng = np.random.default_rng(1)
    rows = 127
    tab = rng.standard_normal((rows,) + trail).astype(np.float32)
    for kind in ("runs", "uniform"):
        ids = np.clip(_ids(kind, 5000, rows, rng), 0, rows - 1).reshape(50, 100)
        ct = rng.standard_normal(ids.shape + trail).astype(np.float32)
        t = torch.tensor(tab, requires_grad=True)
        out = take_rows(t, torch.tensor(ids))
        (g,) = torch.autograd.grad(out, t, torch.tensor(ct))
        val, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(ids), axis=0), jnp.asarray(tab))
        (gj,) = vjp(jnp.asarray(ct))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(val))
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(gj)).max())


def test_function_pair_gradcheck_to_third_order():
    """take_rows and segment_sum are each other's adjoint: gradcheck and
    gradgradcheck of both (float64, out-of-range ids in segment_sum), and
    the third derivative of a quartic functional of a gather against its
    closed form."""
    gen = torch.Generator().manual_seed(0)
    tab = torch.randn(7, 2, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    i = torch.randint(0, 7, (5, 4), generator=gen)
    assert torch.autograd.gradcheck(lambda t: take_rows(t, i), (tab,))
    assert torch.autograd.gradgradcheck(lambda t: take_rows(t, i), (tab,))
    src = torch.randn(40, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    idx = torch.randint(-2, 9, (40,), generator=gen)
    assert torch.autograd.gradcheck(lambda s: segment_sum(s, idx, 7), (src,))
    assert torch.autograd.gradgradcheck(lambda s: segment_sum(s, idx, 7), (src,))

    # f(t) = sum_q t[i_q]^4: d3f/dt^3 along v, contracted with u and w, is
    # sum_q 24 t[i_q] u[i_q] v[i_q] w[i_q]
    u, v, w = (torch.randn(7, 2, 3, dtype=torch.float64, generator=gen) for _ in range(3))
    (g,) = torch.autograd.grad((take_rows(tab, i) ** 4).sum(), tab, create_graph=True)
    (h,) = torch.autograd.grad((g * u).sum(), tab, create_graph=True)
    (d3,) = torch.autograd.grad((h * v).sum(), tab)
    want = segment_sum((24 * take_rows(tab.detach() * u * v, i)).reshape(-1, 2, 3),
                       i.reshape(-1), 7).detach()
    torch.testing.assert_close((d3 * w).sum(), (want * w).sum(), rtol=1e-12, atol=0)


def test_spectrum_segment_reduce_matches_jax():
    """metrics._segment_reduce (K9's forward) against JAX's, on a 16^3
    plan's bins and weights times random mode powers."""
    from montecosmo_tpu import metrics as jmet
    from montecosmo_tpu_torch import metrics as tmet

    plan = tmet.spectrum_plan((16, 16, 16), (128.0,) * 3, None, (0, 2, 4), False, (0, 0, 1.0))
    power = np.random.default_rng(2).exponential(size=(plan["seg"].shape[0], 1))
    data = (power * plan["wl"]).astype(np.float32)
    got = tmet._segment_reduce(torch.tensor(data), torch.tensor(plan["seg"]), plan["nb"])
    ref = np.asarray(jmet._segment_reduce(jnp.asarray(data), plan["seg"], plan["nb"]))
    assert got.shape == ref.shape == (plan["nb"], 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
