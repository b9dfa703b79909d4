"""The port's table lookups against the JAX package on the same numpy
inputs, on the CPU: `uniform_interp` (one gather of the stacked (n-1, 2,
...) pairs, 1-D and channel tables), `Background._growth` (the four growth
tables bracketed once), the per-particle table gathers left in a light
cone's autograd graph, and the radial bins of `set_radial_count` at exact
float32 edges.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.models import bricks as jbr
from montecosmo_tpu.ops import background as jbg, interp as jin
from montecosmo_tpu_torch.models import bricks as tbr
from montecosmo_tpu_torch.ops import background as tbg, interp as tin

torch.set_num_threads(1)


def close(t, j, rtol, atol_rel):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_rel * max(np.abs(j).max(), 1e-30))


def _case(name, rng):
    """(x, (x0, dx), ytab, keyword arguments) of one lookup: queries below,
    inside and above the grid (and x <= 0 in log space).  The log-space
    tables are smooth, as the growth and power tables are: torch's and
    XLA's float32 log round some queries an ulp apart, which moves the
    fraction by ulp(log x) / dx (~2e-6 here), and a table of white noise
    would turn that into a 1e-5 difference that is not the lookup's."""
    if name == "linear":
        ytab = rng.standard_normal(32).astype(np.float32)
        x = rng.uniform(-3.0, 35.0, 300).astype(np.float32)
        return x, (0.0, 1.0), ytab, dict(left=0.0)
    nodes = np.logspace(-2, 1, 40)
    x0, dx = float(np.log(nodes[0])), float(np.log(nodes[1] / nodes[0]))
    x = np.exp(rng.uniform(np.log(2e-3), np.log(30.0), (60, 5))).astype(np.float32)
    x[0, :2] = (0.0, -1.0)
    grid = np.linspace(0.0, 3.0, 40)[:, None]
    ytab = (1.5 + np.sin(grid * rng.uniform(0.5, 2.0, 4) + rng.uniform(0, 6, 4))).astype(
        np.float32)
    if name == "log_channels":
        return x, (x0, dx), ytab, dict(logx=True)
    if name == "log_nodes_1d":
        return x, (x0, dx), ytab[:, 0].copy(), dict(logx=True, xtab=nodes)
    return x, (x0, dx), ytab, dict(logx=True, xtab=nodes, left=-2.0, right=3.0)


@pytest.mark.parametrize("name", ["linear", "log_channels", "log_nodes_1d", "log_nodes_channels"])
def test_uniform_interp_matches_jax(name):
    """Values, and the gradients to the queries and to the table, against
    the JAX function: 1-D and (n, 4) tables, linear and log brackets, with
    node positions, clamped and with left/right values."""
    rng = np.random.default_rng(40)
    x, (x0, dx), ytab, kw = _case(name, rng)
    out_shape = x.shape + ytab.shape[1:]
    cot = rng.standard_normal(out_shape).astype(np.float32)

    xt, yt = torch.tensor(x, requires_grad=True), torch.tensor(ytab, requires_grad=True)
    vt = tin.uniform_interp(xt, x0, dx, yt, **kw)
    vt.backward(torch.tensor(cot))
    vj, vjp = jax.vjp(jax.jit(lambda q, y: jin.uniform_interp(q, x0, dx, y, **kw)),
                      jnp.asarray(x), jnp.asarray(ytab))
    gxj, gyj = vjp(jnp.asarray(cot))
    assert vt.shape == out_shape
    close(vt, vj, 1e-6, 1e-6)
    close(xt.grad, gxj, 1e-6, 1e-6)
    close(yt.grad, gyj, 1e-6, 1e-6)


def test_growth_is_the_four_lookups_and_its_omega_gradient_matches_jax():
    """`Background._growth` gives a2g, a2g2, a2f, a2f2 bit for bit (one
    bracket, the same lerp per channel), and a2dg2dg is their ratio; the
    Omega_m gradient of a weighted sum of the four, through the RK4 tables,
    against the JAX package's (float32 steps: 1e-4, as for the tables)."""
    rng = np.random.default_rng(41)
    a = rng.uniform(0.3, 0.9, (500, 1)).astype(np.float32)
    a[:3, 0] = (0.0, 1e-4, 1.0)
    w = rng.standard_normal(4).astype(np.float32)

    om = torch.tensor(np.float32(0.31), requires_grad=True)
    bg = tbg.Background.create(tbg.get_cosmology(Omega_m=om, sigma8=torch.tensor(0.8)))
    at = torch.tensor(a)
    four = bg._growth(at)
    for got, want in zip(four, (bg.a2g(at), bg.a2g2(at), bg.a2f(at), bg.a2f2(at))):
        assert got.shape == at.shape and torch.equal(got, want)
    g, g2, f, f2 = four
    assert torch.equal(bg.a2dg2dg(at), tbr.safe_div(g2 * f2, g * f))
    (gt,) = torch.autograd.grad(sum(wk * v.sum() for wk, v in zip(w, four)), om)

    def scal_j(o):
        bj = jbg.Background.create(jbg.get_cosmology(Omega_m=o, sigma8=0.8))
        return sum(wk * v.sum() for wk, v in zip(w, (bj.a2g(a), bj.a2g2(a), bj.a2f(a),
                                                        bj.a2f2(a))))

    gj = jax.jit(jax.grad(scal_j))(jnp.float32(0.31))
    close(gt, gj, 1e-4, 0)


def _per_particle_gathers(root, n_particles):
    """Gather-backward nodes of the graph under `root` whose index holds at
    least one entry per particle: the per-particle table lookups
    (`take_rows`, whose backward is K9; advanced indexing), and the final
    mesh's radial-count lookup at 16^3 (one entry a cell)."""
    seen, stack, n = set(), [root], 0
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if type(f).__name__ in ("IndexBackward0", "IndexSelectBackward0", "_TakeRowsBackward"):
            idx = (f.saved_tensors if type(f).__name__ == "_TakeRowsBackward" else
                   getattr(f, "_saved_indices", None) or [getattr(f, "_saved_index", None)])
            n += sum(t.numel() for t in idx if t is not None) >= n_particles
        stack.extend(nf for nf, _ in f.next_functions)
    return n


@pytest.mark.parametrize("evolution", ["lpt", "nbody"])
def test_light_cone_graph_has_few_table_backwards(evolution):
    """One 16^3 light-cone value+grad (2LPT on the curved sky at
    Kaiser-Bessel support 3; BullFrog N-body on the flat sky at TSC) keeps
    at most 6 gathers over the particles in its autograd graph: chi2a at
    the Lagrangian and at the Eulerian positions, the bias growth, lpt's
    or the light cone's growth, rsd's, and the radial counts.  Each gather
    with a backward costs a sort-based scatter on the card; the lookup
    before the stacked-pair gather kept 23 (2LPT) and 13 (N-body)."""
    from montecosmo_tpu_torch import FieldLevelModel, default_config
    from montecosmo_tpu_torch.convert import params_from_numpy

    conf = dict(final_shape=(16, 16, 16), cell_length=8.0, evolution=evolution, a_obs=None,
                lik_type="quad_gauss", precond="kaiser", paint_order=3, init_oversamp=1.0,
                evol_oversamp=1.0, ptcl_oversamp=1.0, paint_oversamp=1.0)
    if evolution == "lpt":
        conf |= dict(curved_sky=True, box_center=(0.0, 0.0, 0.0), kernel_type="kaiser_bessel")
    else:
        conf |= dict(curved_sky=False, box_center=(0.0, 0.0, 1000.0))
    m = FieldLevelModel(**{**default_config, **conf}, device="cpu")
    p = {k: v.numpy() for k, v in m.reparam(dict(m.fiduc), inv=True).items()}
    rng = np.random.default_rng(42)
    p["white_mesh_"] = rng.standard_normal(m.init_shape).astype(np.float32)
    count = torch.tensor(rng.uniform(0.5, 1.5, m.final_shape).astype(np.float32))
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    lp = m.logpdf({**leaves, "count_mesh": count})
    assert 1 <= _per_particle_gathers(lp.grad_fn, int(np.prod(m.ptcl_shape))) <= 6
    lp.backward()
    assert np.isfinite(lp.item()) and all(bool(torch.isfinite(v.grad).all())
                                          for v in leaves.values())


def test_radial_bins_right_closed_at_float32_edges():
    """Radii exactly on the float32 bin edges, and one ulp either side, are
    binned right-closed, (e_b, e_{b+1}], by the port's lookup.
    Witness: the JAX package's ceil lookup puts one of these exact-edge
    radii in the next bin (montecosmo_tpu/models/bricks.py:974)."""
    redges = np.linspace(1000.0 / 3, 2000.0 / 3 + 7, 10)
    e32 = redges.astype(np.float32)
    r = np.concatenate([e32, np.nextafter(e32, np.inf), np.nextafter(e32, -np.inf)])
    n = len(redges) - 1
    counts = (10 + np.arange(n)).astype(np.float32)
    ref = np.searchsorted(e32, r, side="left") - 1
    want = np.where((ref >= 0) & (ref < n), 10 + ref, 1).astype(np.float32)
    got_t = tbr.set_radial_count(torch.ones(r.shape), torch.tensor(r), redges,
                                 torch.tensor(counts)).numpy()
    got_j = np.asarray(jbr.set_radial_count(jnp.ones(r.shape), jnp.asarray(r), redges,
                                            jnp.asarray(counts)))
    np.testing.assert_array_equal(got_t, want)
    assert np.sum(got_j != want) >= 1
