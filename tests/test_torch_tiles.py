"""The lattice-brick decompositions of the tiled K1 (paint) and K5 (read
adjoint), and of the tiled K4 (read), on the CPU.

`tile_plan` must fit its shared-memory budget (and the 232,448 bytes a
block of an H100 can have) for every geometry the flagships and
`chip_smoke.py` use.  A numpy emulation of what the CUDA kernels do, kept
here, must reproduce `paint_cic_plain` and `read_cic_adjoint_plain`'s
`dmesh`: bricks of lattice sites with their tiles of margin R, the split of
each particle between its brick's tile and the mesh (all of its window
cells in the tile, in unwrapped coordinates, or none), and the periodic
fold of the tiles into the mesh, with the tile's sums in the kernels' fixed
point (each value rounded to a multiple of 2^-k, n_site max|value| 2^k <
2^50, their sums held below 2^52).  The cases cover a tile wider than the
mesh, partial bricks at the lattice's far edge, particles past the clamp,
ties, every window, and margins below the plan's (which send particles to
the mesh): the result does not depend on R.  The plain versions sum in
float32, hence the 1e-6 relative tolerance.

The gather (csrc/read_tiled.cu) is emulated the same way: per brick, the
box of tile cells that the windows falling wholly in the tile reach, that
box of the mesh staged with periodic wrapping (a box wider than the mesh
holds duplicated cells), each window read from the staged box when it lies
in it and from the mesh otherwise; against `read_cic_plain`, with the
plan of a read tile (float32, 4 bytes a value).
"""
from itertools import product

import numpy as np
import pytest
import torch

from montecosmo_tpu_torch.ops import paint as tpa

from test_torch_card import _lattice_particles, _with_ties

torch.set_num_threads(1)

WINDOWS = [(k, o) for k in ("rectangular", "kaiser_bessel") for o in (1, 2, 3, 4)]
# (mesh, lattice, max_disp): at 16^3 every tile is wider than the mesh along
# some axis; the 24 x 20 x 20 lattice (12, 10, 20) is no multiple of any brick
CASES = {"16^3 stride 2": ((16, 16, 16), (8, 8, 8), 5),
         "32^3 stride 2": ((32, 32, 32), (16, 16, 16), 5),
         "24x20x20 partial bricks": ((24, 20, 20), (12, 10, 20), 4)}
SMEM_PER_BLOCK = 232_448  # an H100 block's dynamic shared memory at most


def _geometry(case, n_shift, kernel, order):
    shape, lattice, H = CASES[case]
    return tpa.cic_geometry(shape, n_shift, lattice, H, True, order, kernel, 192 / 224)


def _inputs(case, seed):
    shape, lattice, H = CASES[case]
    stride = tuple(m // l for m, l in zip(shape, lattice))
    pos, w = _lattice_particles(lattice, stride, H, seed)
    pos = _with_ties(pos, lattice, stride, np.random.default_rng(seed + 1))
    return torch.tensor(pos), torch.tensor(w)


def _windows(pos, geom):
    """Per shift: the unwrapped window cells (order, P, 3) and weights of
    each particle, as the plain versions (and the kernels) place them."""
    out = []
    for _, x, sites in tpa._shifted(pos, geom):
        cells, w, _ = tpa._axis_windows(x, geom, tpa._tie_base(sites, geom))
        out.append((cells.numpy(), w.double().numpy()))
    return out


def _bricks(geom, brick):
    """(first site, extent) of every brick of the lattice, partial at its
    far edge."""
    starts = [range(0, l, b) for l, b in zip(geom.lattice, brick)]
    for first in product(*starts):
        yield first, tuple(min(b, l - f) for b, l, f in zip(brick, geom.lattice, first))


def _fixed_point_scale(vals):
    """The kernels' scale 2^k of a brick's values: n_site max|value| 2^k <
    2^50 (`scale_of` in paint_tiled.cu)."""
    vmax = np.abs(vals).max()
    if vmax == 0:
        return 1.0
    e1 = np.frexp(vmax)[1]                    # vmax < 2^e1
    nb = int(np.ceil(np.log2(len(vals))))     # n_site <= 2^nb
    return 2.0 ** (50 - e1 - nb)


def _tiled_scatter(cells, w, vals, geom, brick, R):
    """Emulation of the tiled kernels' scatter of vals (P, C) through the
    windows (cells, w): returns the (X, Y, Z, C) mesh and the number of
    particles sent to the mesh."""
    return _tiled_scatter_corners(
        cells, lambda a, b, c, ids: (w[a, ids, 0] * w[b, ids, 1] * w[c, ids, 2])[:, None]
        * vals[ids], vals, geom, brick, R)


def _tiled_scatter_corners(cells, corner, bound, geom, brick, R):
    """The same for any corner values: corner(a, b, c, ids) gives the (n, C)
    values of particles `ids` at corner (a, b, c); `bound` (P, C) bounds
    their magnitudes and sets each brick's fixed-point scale."""
    order, shape = geom.order, np.array(geom.shape)
    C = bound.shape[1]
    mesh = np.zeros(geom.shape + (C,))
    corners = list(product(range(order), repeat=3))
    lat = np.arange(int(np.prod(geom.lattice))).reshape(geom.lattice)
    tile_shape = tuple((b - 1) * s + 2 * R + order for b, s in zip(brick, geom.stride))
    n_out = 0
    for first, extent in _bricks(geom, brick):
        ids = lat[tuple(slice(f, f + n) for f, n in zip(first, extent))].reshape(-1)
        origin = np.array(first) * geom.stride - R - (order - 1) // 2
        lo = cells[0, ids] - origin                     # first window cell, tile coords
        inside = np.all((lo >= 0) & (lo + order <= np.array(tile_shape)), axis=1)
        tile = np.zeros(tile_shape + (C,), np.int64)
        scale = _fixed_point_scale(bound[ids])
        for a, b, c in corners:
            cell = np.stack([cells[a, ids, 0], cells[b, ids, 1], cells[c, ids, 2]], -1)
            prod_ = corner(a, b, c, ids)
            t = (cell - origin)[inside]
            q = np.rint(prod_[inside] * scale).astype(np.int64)
            np.add.at(tile, (t[:, 0], t[:, 1], t[:, 2]), q)
            m = np.remainder(cell[~inside], shape)
            np.add.at(mesh, (m[:, 0], m[:, 1], m[:, 2]), prod_[~inside])
        n_out += int((~inside).sum())
        # the fold: every tile cell added at its wrapped mesh cell (aliases
        # of a tile wider than the mesh in turn)
        assert np.abs(tile).max(initial=0) < 2**52
        idx = np.stack(np.meshgrid(*[np.arange(n) for n in tile_shape], indexing="ij"), -1)
        m = np.remainder(idx.reshape(-1, 3) + origin, shape)
        np.add.at(mesh, (m[:, 0], m[:, 1], m[:, 2]), tile.reshape(-1, C) / scale)
    return mesh, n_out


def _margins(plan):
    """The plan's margin, and margins 1 and 0, which send particles to the
    mesh."""
    return sorted({plan.R, 1, 0}, reverse=True)


@pytest.mark.parametrize("shape, lattice, H", [((224,) * 3, (224,) * 3, 9),
                                               ((32,) * 3, (16,) * 3, 5)],
                         ids=["224^3 stride 1", "32^3 stride 2"])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_tile_plan_fits(shape, lattice, H, order):
    """Every plan of the flagships' and chip_smoke.py's geometries fits the
    budget (two CTAs per SM) and a block's shared memory; its tile holds the
    brick's window cells for displacements up to R, R never exceeds the
    clamp bound, and the brick lies in the lattice."""
    assert tpa.TILE_BYTES <= SMEM_PER_BLOCK // 2
    for n_shift, C in product((1, 2), (1, 2, 3, 4)):
        geom = tpa.cic_geometry(shape, n_shift, lattice, H, True, order)
        plan = tpa.tile_plan(geom, C)
        assert plan.nbytes == 8 * C * np.prod(plan.tile) <= tpa.TILE_BYTES
        assert 0 <= plan.R <= H
        assert all(1 <= b <= l for b, l in zip(plan.brick, lattice))
        assert plan.tile == tuple((b - 1) * s + 2 * plan.R + order
                                  for b, s in zip(plan.brick, geom.stride))
        assert np.prod(plan.brick) <= 1024  # the fixed-point tile's bound


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel, order", WINDOWS)
def test_tiled_paint_emulation_matches_plain(case, kernel, order):
    """K1's decomposition (the C = 1 tile, once per interlace shift)
    against paint_cic_plain, at the plan's margin and below it."""
    geom = _geometry(case, 2, kernel, order)
    pos, w = _inputs(case, 60)
    ref = tpa.paint_cic_plain(pos, w, geom).double().numpy()
    plan = tpa.tile_plan(geom)
    if case.startswith("16^3"):
        assert any(t > n for t, n in zip(plan.tile, geom.shape))
    if case.endswith("partial bricks"):
        assert any(l % b for l, b in zip(geom.lattice, plan.brick))
    n_out = {}
    for R in _margins(plan):
        out = []
        n_out[R] = 0
        for cells, wts in _windows(pos, geom):
            mesh, n = _tiled_scatter(cells, wts, w.double().numpy()[:, None], geom, plan.brick, R)
            out.append(mesh[..., 0])
            n_out[R] += n
        err = np.abs(np.stack(out) - ref).max() / np.abs(ref).max()
        assert err <= 1e-6, (R, err)
    assert n_out[0] > 0  # margin 0 sends particles to the mesh


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel, order", WINDOWS)
def test_tiled_read_adjoint_emulation_matches_plain(case, kernel, order):
    """K5's decomposition (the C-channel tile of the cotangent's paint)
    against read_cic_adjoint_plain's dmesh, C = 3 (the force read) and 2,
    at the plan's margin and below it."""
    geom = _geometry(case, 1, kernel, order)
    pos, _ = _inputs(case, 61)
    rng = np.random.default_rng(62)
    ((cells, wts),) = _windows(pos, geom)
    for C in (3, 2):
        mesh = torch.tensor(rng.standard_normal(geom.shape + (C,)).astype(np.float32))
        ct = rng.standard_normal((pos.shape[0], C)).astype(np.float32)
        _, ref = tpa.read_cic_adjoint_plain(pos, mesh, torch.tensor(ct), geom)
        ref = ref.double().numpy()
        plan = tpa.tile_plan(geom, C)
        for R in _margins(plan):
            dmesh, n_out = _tiled_scatter(cells, wts, ct.astype(np.float64), geom, plan.brick, R)
            err = np.abs(dmesh - ref).max() / np.abs(ref).max()
            assert err <= 1e-6, (C, R, err)
            assert R > 0 or n_out > 0


@pytest.mark.parametrize("shape, lattice, H", [((224,) * 3, (224,) * 3, 9),
                                               ((32,) * 3, (16,) * 3, 5)],
                         ids=["224^3 stride 1", "32^3 stride 2"])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_read_tile_plan_fits(shape, lattice, H, order):
    """The read tiles' plans (4 bytes a value, K4's C channels) fit the
    budget and a block's shared memory, as the paint tiles' do; at 224^3
    they take the 8 x 8 x 16 brick."""
    for C in (1, 3, 4):
        geom = tpa.cic_geometry(shape, 1, lattice, H, True, order)
        plan = tpa.tile_plan(geom, C, "read")
        assert plan.nbytes == 4 * C * np.prod(plan.tile) <= tpa.TILE_BYTES <= SMEM_PER_BLOCK
        assert 0 <= plan.R <= H
        assert all(1 <= b <= l for b, l in zip(plan.brick, lattice))
        assert plan.tile == tuple((b - 1) * s + 2 * plan.R + order
                                  for b, s in zip(plan.brick, geom.stride))
        assert np.prod(plan.brick) <= 1024
        # a read tile takes the brick of the most sites (the smallest halo)
        assert np.prod(plan.brick) >= np.prod(tpa.tile_plan(geom, C).brick)
        if shape[0] == 224:
            assert plan.brick == (8, 8, 16) and plan.R >= 1


def _tiled_gather(cells, w, mesh, geom, brick, R):
    """Emulation of the tiled K4's gather of mesh (X, Y, Z, C) through the
    windows (cells, w): returns the (P, C) values and the number of
    particles read from the mesh."""
    corners, n_out = _staged_corners(cells, mesh, geom, brick, R)
    vals = sum((w[a, :, 0] * w[b, :, 1] * w[c, :, 2])[:, None] * val
               for (a, b, c), val in corners.items())
    return vals, n_out


def _staged_corners(cells, mesh, geom, brick, R):
    """What each particle reads at each corner (a, b, c) of its window in
    the tiled gather: {corner: (P, C) values}, from the brick's staged box
    or from the mesh, and the number of particles read from the mesh."""
    order, shape = geom.order, np.array(geom.shape)
    n_p = int(np.prod(geom.lattice))
    out = {k: np.zeros((n_p, mesh.shape[-1])) for k in product(range(order), repeat=3)}
    lat = np.arange(n_p).reshape(geom.lattice)
    tile = np.array([(b - 1) * s + 2 * R + order for b, s in zip(brick, geom.stride)])
    n_out = 0
    for first, extent in _bricks(geom, brick):
        ids = lat[tuple(slice(f, f + n) for f, n in zip(first, extent))].reshape(-1)
        origin = np.array(first) * geom.stride - R - (order - 1) // 2
        t = cells[0, ids] - origin                                       # tile coords
        reached = t[np.all((t >= 0) & (t + order <= tile), axis=1)]
        box_lo = reached.min(0) if len(reached) else np.zeros(3, int)
        box_n = reached.max(0) + order - box_lo if len(reached) else np.zeros(3, int)
        # the staged box, wrapped periodically (duplicated cells when wider)
        ix = [np.remainder(origin[a] + box_lo[a] + np.arange(box_n[a]), shape[a])
              for a in range(3)]
        staged = mesh[np.ix_(*ix)]
        in_box = np.all((t >= box_lo) & (t + order <= box_lo + box_n), axis=1)
        n_out += int((~in_box).sum())
        for a, b, c in product(range(order), repeat=3):
            cell = np.stack([cells[a, ids, 0], cells[b, ids, 1], cells[c, ids, 2]], -1)
            val = mesh[tuple(np.remainder(cell, shape).T)]
            rel = cell[in_box] - origin - box_lo
            val[in_box] = staged[tuple(rel.T)]
            out[a, b, c][ids] = val
    return out, n_out


def _check_tiled_read(case, kernel, order, channels, seed):
    """K4's gather decomposition against read_cic_plain for each C in
    `channels`, at the plan's margin and below it; whether some plan's
    tile was wider than the mesh."""
    geom = _geometry(case, 1, kernel, order)
    pos, _ = _inputs(case, seed)
    rng = np.random.default_rng(seed + 1)
    ((cells, w),) = _windows(pos, geom)
    wider = False
    for C in channels:
        mesh = rng.standard_normal(geom.shape + (C,)).astype(np.float32)
        ref = tpa.read_cic_plain(pos, torch.tensor(mesh), geom).double().numpy()
        plan = tpa.tile_plan(geom, C, "read")
        wider |= any(t > n for t, n in zip(plan.tile, geom.shape))
        if case.endswith("partial bricks"):
            assert any(l % b for l, b in zip(geom.lattice, plan.brick))
        for R in _margins(plan):
            vals, n_out = _tiled_gather(cells, w, mesh.astype(np.float64), geom, plan.brick, R)
            err = np.abs(vals - ref).max() / np.abs(ref).max()
            assert err <= 1e-6, (C, R, err)
            assert R > 0 or n_out > 0
    return wider


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel, order", WINDOWS)
def test_tiled_read_emulation_matches_plain(case, kernel, order):
    """K4's gather decomposition (C channels staged from one mesh) against
    read_cic_plain, C = 3 (the force read) and 1, at the plan's margin
    and below it; at 16^3 some tile is wider than the mesh."""
    wider = _check_tiled_read(case, kernel, order, (3, 1), 63)
    assert wider or not case.startswith("16^3")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel, order", WINDOWS)
def test_tiled_read_emulation_matches_plain_two_and_four_channels(case, kernel, order):
    """The same at C = 2 and 4, the other channel counts of one launch (a
    6-channel read is launched as 4 + 2), on other inputs."""
    _check_tiled_read(case, kernel, order, (2, 4), 65)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel", ["rectangular", "kaiser_bessel"])
def test_route_by_order(kernel, order):
    """The design each kernel takes (`_tiled`): on a lattice geometry K1
    and K5 take the lattice-brick design from CIC up, K4 from TSC up; K2
    has none; without a lattice none does."""
    clamped = tpa.cic_geometry((32,) * 3, 2, (16,) * 3, 5, True, order, kernel, 1.5)
    free = tpa.cic_geometry((32,) * 3, 2, order=order, kernel_type=kernel, oversamp=1.5)
    want = {"paint_cic": order >= 2, "read_cic_adjoint": order >= 2, "read_cic": order >= 3,
            "paint_cic_adjoint": False}
    for name, tiled in want.items():
        assert tpa._tiled(name, clamped) == tiled, name
        assert not tpa._tiled(name, free)


# ------------------------------------------------- K6 and K7 (double backward)
def _windows_grad(pos, geom):
    """Per shift: the unwrapped window cells, weights and derivatives
    (order, P, 3) of each particle, the derivatives zeroed along clamped
    axes (as K6 and K7 take them), the shifted positions and sites."""
    out = []
    for v, x, sites in tpa._shifted(pos, geom):
        cells, w, dw = tpa._axis_windows(x, geom, tpa._tie_base(sites, geom))
        mask = tpa._clamp_mask(v, sites, geom)
        out.append((cells.numpy(), w.double().numpy(), (dw * mask).double().numpy(), x, sites,
                    mask))
    return out


@pytest.mark.parametrize("shape, lattice, H", [((224,) * 3, (224,) * 3, 9),
                                               ((32,) * 3, (16,) * 3, 5)],
                         ids=["224^3 stride 1", "32^3 stride 2"])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_double_backward_tile_plans_fit(shape, lattice, H, order):
    """The tiled K6's plans (a paint tile of beta's C channels, 8 bytes a
    value) and the tiled K7's (a read tile of the S shifts' C channels, 4
    bytes a value, each shift's region rounded up to 16 bytes as
    `read_cic_hess_tiled` lays it out) fit the budget and a block's shared
    memory, R within the clamp bound, the brick within the lattice and
    kMaxSites."""
    for S, C in product((1, 2), (1, 3, 4)):
        geom = tpa.cic_geometry(shape, S, lattice, H, True, order)
        p6, p7 = tpa.tile_plan(geom, C), tpa.tile_plan(geom, S * C, "read")
        assert p6.nbytes == 8 * C * np.prod(p6.tile) <= tpa.TILE_BYTES
        assert p7.nbytes == 4 * S * C * np.prod(p7.tile) <= tpa.TILE_BYTES
        room = -(-C * int(np.prod(p7.tile)) // 4) * 4
        assert p7.nbytes <= 4 * S * room <= min(p7.nbytes + 16 * S, SMEM_PER_BLOCK)
        for plan in (p6, p7):
            assert 0 <= plan.R <= H and np.prod(plan.brick) <= 1024
            assert all(1 <= b <= l for b, l in zip(plan.brick, lattice))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_tiled_paint_grad_emulation_matches_plain(case, order):
    """K6's decomposition (the C-channel fixed-point tile per shift, corner
    values alpha W + beta . grad W with clamped axes' derivatives zeroed,
    each brick's scale from its largest |alpha| + |beta|_1) against
    paint_cic_grad_plain: the render's case (2 shifts, C = 1, alpha) and
    the force read's (1 shift, C = 3, no alpha), at the plan's margin and
    below it."""
    pos, _ = _inputs(case, 66)
    rng = np.random.default_rng(67)
    for S, C in ((2, 1), (1, 3)):
        geom = _geometry(case, S, "rectangular", order)
        n = pos.shape[0]
        alpha = rng.standard_normal((n, C)) if S == 2 else np.zeros((n, C))
        beta = rng.standard_normal((n, C, 3))
        ref = tpa.paint_cic_grad_plain(
            pos, torch.tensor(alpha, dtype=torch.float32) if S == 2 else None,
            torch.tensor(beta, dtype=torch.float32), geom).double().numpy()
        bound = np.abs(alpha) + np.abs(beta).sum(-1)
        plan = tpa.tile_plan(geom, C)
        for R in _margins(plan):
            out, n_out = [], 0
            for cells, w, dw, *_ in _windows_grad(pos, geom):
                def corner(a, b, c, ids):
                    wt = w[a, ids, 0] * w[b, ids, 1] * w[c, ids, 2]
                    grad = np.stack([dw[a, ids, 0] * w[b, ids, 1] * w[c, ids, 2],
                                     w[a, ids, 0] * dw[b, ids, 1] * w[c, ids, 2],
                                     w[a, ids, 0] * w[b, ids, 1] * dw[c, ids, 2]], -1)
                    return alpha[ids] * wt[:, None] + (beta[ids] * grad[:, None]).sum(-1)

                mesh, n = _tiled_scatter_corners(cells, corner, bound, geom, plan.brick, R)
                out.append(mesh)
                n_out += n
            # NGP without alpha paints zeros (its window has no gradient)
            err = np.abs(np.stack(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= 1e-6, (S, C, R, err)
            assert R > 0 or n_out > 0


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_tiled_read_hess_emulation_matches_plain(case, order):
    """K7's decomposition (each shift's reached box of its mesh staged, a
    window read from it when it lies in it and from the mesh otherwise,
    the plan a read tile of S C channels) against read_cic_hess_plain: g
    and h for the render's case (2 shifts, C = 1) and the force read's (1
    shift, C = 3), at the plan's margin and below it."""
    pos, _ = _inputs(case, 68)
    rng = np.random.default_rng(69)
    b = rng.standard_normal((pos.shape[0], 3))
    for S, C in ((2, 1), (1, 3)):
        geom = _geometry(case, S, "rectangular", order)
        mesh = rng.standard_normal((S,) + geom.shape + (C,)).astype(np.float32)
        ref = tpa.read_cic_hess_plain(pos, torch.tensor(mesh), torch.tensor(b, dtype=torch.float32),
                                      geom)
        plan = tpa.tile_plan(geom, S * C, "read")
        for R in _margins(plan):
            g, h, n_out = 0.0, 0.0, 0
            for s, (cells, *_, x, sites, mask) in enumerate(_windows_grad(pos, geom)):
                corners, n = _staged_corners(cells, mesh[s].astype(np.float64), geom,
                                             plan.brick, R)
                n_out += n
                terms = tpa._corner_terms(x, geom, True, tpa._tie_base(sites, geom), mask,
                                          hess=True)
                for ((a, bb, c), val), (_, _, dwc, hwc) in zip(corners.items(), terms):
                    dwc, hwc = dwc.double().numpy(), hwc.double().numpy()
                    g = g + val[:, :, None] * dwc[:, None]
                    h = h + val[:, :, None] * np.einsum("pij,pj->pi", hwc, b)[:, None]
            for got, want in zip((g, h), ref):
                want = want.double().numpy()
                err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
                assert err <= 1e-6, (S, C, R, err)
            assert R > 0 or n_out > 0
