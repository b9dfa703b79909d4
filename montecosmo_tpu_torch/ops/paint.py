"""Mass assignment (paint), reads, interlacing and the NUFFT.

The particle work of every model evaluation goes through five hand-written
kernels (sources in `montecosmo_tpu_torch/csrc/`).  K1, K2, K4 and K5 take
the B-spline window of order 1 (NGP), 2 (CIC), 3 (TSC) or 4 (PCS), or the
Kaiser-Bessel window (`kernel_type='kaiser_bessel'`) of support 1-4, whose
cutoff is `optim_kcut(oversamp)`; their names come from the CIC (order-2)
version.  As in the JAX window path, the clamped (lattice) window of
support 1 is the one-hot NGP whatever the kernel type.

* K1 `paint_cic`: B-spline scatter of lattice-ordered particles, every
  interlace shift painted in one particle pass, each shifted position
  clamped to +-max_disp around its lattice site (the window contract of
  `montecosmo_tpu/ops/paint_window.py`); CUDA.  The lattice-brick design
  (`paint_cic_tiled`, `csrc/paint_tiled.cu`): one CTA per brick of sites
  sums its corners in a shared-memory tile of the mesh (`tile_plan`) and
  folds it in; the atomic design (`csrc/paint_cic.cu`): every corner an
  atomic add.
* K2 `paint_cic_adjoint`: its VJP, a gather of the cotangent meshes giving
  the weight and position gradients; CUDA, no atomics, per-particle.
* K3 `nufft_epilogue`: the interlace phase sum, units jacobian and window
  deconvolution (B-spline or Kaiser-Bessel) in one pass over the rfft grid;
  CUDA (`csrc/nufft_epilogue.cu`), from per-axis tables of the window and
  the phases (`_epilogue_tables`).  Its backward is the same kernel with
  the conjugated phase.
* K4 `read_cic`: the B-spline read of C channel-last fields at (clamped)
  particle positions, behind `read_window`, `read_multi` and `read`; CUDA,
  no atomics; lattice-brick (`read_cic_tiled`, `csrc/read_tiled.cu`: a
  brick's box of the mesh staged in shared memory and gathered from), or
  per-particle.
* K5 `read_cic_adjoint`: its VJP in one particle pass, the C-channel paint
  of the cotangent and the position gradient; CUDA, lattice-brick
  (`read_cic_adjoint_tiled`) as K1, or atomic.
* K6 `paint_cic_grad`: the paint of the window and its gradient,
  sum_p alpha_p W(x_p - c) + beta_p . grad W(x_p - c), over the interlace
  shifts and C channels; CUDA, lattice-brick (`paint_cic_grad_tiled`,
  `csrc/paint_tiled.cu`, K5's C-channel fixed-point tile) or atomic
  (`csrc/paint_hess.cu`).  K1, K5 and K6 add into the mesh through a
  64-bit fixed-point accumulator (`_accumulator`, `csrc/mesh_fixed.cuh`),
  so their meshes, and a gradient or a Hessian-vector product through
  them, are the same bit for bit from launch to launch.
* K7 `read_cic_hess`: the read of the window's gradient and Hessian,
  g_p = sum_c M[c] grad W(x_p - c) and h_p = sum_c M[c] H_W(x_p - c) b_p,
  its corner sums factored per (i, j); CUDA, one thread per particle
  (`csrc/paint_hess.cu`) or lattice-brick (`read_cic_hess_tiled`,
  `csrc/read_tiled.cu`, every shift's box staged).

The double backward (Hessian-vector products): K1's backward is an
`_PaintCICAdjoint` (K2) and K4's a `_ReadCICAdjoint` (K5), whose own
backwards are built from K6, K7 and the K4/K5 launches; K3 is linear, and
its backward and the backward's backward are K3 itself.  Derivatives on a
clamped axis (|pos - site| >= H) are 0 at every order.  Kaiser-Bessel
windows have no double backward yet (`_KB_HESSIAN`).

The route is fixed by the kernel, the geometry and the order (`_tiled`,
`TILED_FROM`): on a clamped (lattice) geometry K1, K5 and K6 take the
lattice-brick design from CIC up, K4 from TSC up, K7 never; NGP (order 1:
B-spline order 1 and the clamped Kaiser-Bessel support 1, the one-hot NGP)
and every unclamped call take the per-particle designs (PERF.md, Findings,
has the timings).  Each wrapper launches its kernel for a CUDA tensor (or
raises), and runs the kernel's plain PyTorch version, kept in this module,
for a CPU tensor.  `LAUNCHES` counts kernel launches per (kernel, window,
order), the window "bspline" or "kb", the two designs of K1, K4-K7 under
two names each (`paint_cic` and `paint_cic_tiled`, and so on); K3's order
is that of its deconvolution, 0 for none (`ops/_kernels.py` keeps the
count, which K8 in `ops/background.py` shares).

Parity: `montecosmo_tpu/ops/paint.py:35-240` (the windows, paint, read,
read_multi, read_sites, interlace, nufft) and
`montecosmo_tpu/ops/paint_window.py:42-130` and `:330-401` (window weights
and geometry, the clamp to sites, read_window).  One difference: at an exact
half-integer position the JAX window path paints a Kaiser-Bessel window of
odd support on P + 1 cells (its support mask keeps |s| <= P/2 on both
sides); the port, like the JAX scatter path, on the P cells around
round(x).
"""
import ctypes
from dataclasses import dataclass
from functools import lru_cache
from itertools import product
from math import prod

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from montecosmo_tpu_torch.ops.fourier import (
    bspline, bspline_hat, dbspline, dkaiser_bessel, kaiser_bessel, kaiser_bessel_hat,
    kaiser_bessel_norm, optim_kcut, rfftk, rfftn,
)
from montecosmo_tpu_torch.ops._kernels import LAUNCHES
from montecosmo_tpu_torch.ops.hermitian import chreshape, r2chshape, scale_shape

ORDERS = (1, 2, 3, 4)


def reset_launches():
    LAUNCHES.clear()


def launches_at(order, window="bspline"):
    """{kernel: launches} at `order` of `window` ("bspline" or "kb") since
    the last reset."""
    return {k: n for (k, w, o), n in LAUNCHES.items() if o == order and w == window}


def _check_window(kernel_type, order):
    """The B-spline windows of orders 1-4 and the Kaiser-Bessel windows of
    support 1-4 are ported; a wider Kaiser-Bessel window is not."""
    if kernel_type == "rectangular":
        _require(order in ORDERS, f"B-spline order must be in 1..4, got {order}")
    elif kernel_type == "kaiser_bessel":
        if int(order) > max(ORDERS):
            raise NotImplementedError(
                f"Kaiser-Bessel windows of support {order} are not ported yet (ROADMAP "
                "Queue B item 8: supports 1-4 are)")
        _require(order in ORDERS, f"Kaiser-Bessel support must be >= 1, got {order}")
    else:
        raise ValueError(f"Unknown kernel type: {kernel_type}")


# the Kaiser-Bessel windows' double backward is not ported: the JAX window
# path's own first derivative there is NaN (ROADMAP Queue C, KB finding 1)
_KB_HESSIAN = ("double backward (Hessian-vector products) through Kaiser-Bessel windows is not "
               "ported yet (ROADMAP Queue B item 10: the B-spline windows of orders 1-4 are)")


def _check_hessian(geom):
    """Raise for a second derivative of a Kaiser-Bessel paint or read."""
    if geom.kcut is not None:
        raise NotImplementedError(_KB_HESSIAN)


def _kcut(kernel_type, oversamp):
    """The Kaiser-Bessel cutoff of `kernel_type` at `oversamp`, None for the
    B-spline."""
    return None if kernel_type == "rectangular" else optim_kcut(oversamp)


# ----------------------------------------------------------------- geometry
@dataclass(frozen=True)
class CICGeometry:
    """Static description of one interlaced paint or read."""
    shape: tuple            # mesh (X, Y, Z)
    n_shift: int            # interlace shifts s/n_shift, s = 0..n_shift-1
    lattice: tuple = None   # particle lattice when clamping, else None
    stride: tuple = (1, 1, 1)
    H: tuple = (np.inf, np.inf, np.inf)
    order: int = 2          # window order (support): B-spline 1 NGP, 2 CIC, 3 TSC, 4 PCS
    # NGP ties (clamped order 1 only): `paint_window` rounds x - b, b the
    # window base of the particle's lattice group, b = (q // span) * span -
    # margin for its site q, so a half-integer x goes to the neighbour of b's
    # parity; zeros: round x itself, as `ops/paint.py::paint`
    span: tuple = (0, 0, 0)
    margin: tuple = (0, 0, 0)
    kcut: float = None      # Kaiser-Bessel cutoff; None: the B-spline window

    @property
    def window(self):
        return "bspline" if self.kcut is None else "kb"


def _pick_group(extent, want):
    """Largest divisor of `extent` that is <= want (>= 1), as
    `paint_window._pick_group`."""
    want = max(1, min(int(want), int(extent)))
    return next(g for g in range(want, 0, -1) if extent % g == 0)


def cic_geometry(shape, n_shift=1, lattice_shape=None, max_disp=8, clip=False, order=2,
                 kernel_type="rectangular", oversamp=1.0):
    """Geometry checks of `paint_window` (`_window_geometry`): the mesh must
    be a multiple of the particle lattice; the clamp bound is per axis."""
    _check_window(kernel_type, order)
    shape = tuple(int(s) for s in shape)
    kcut = _kcut(kernel_type, oversamp)
    if lattice_shape is None or not clip:
        return CICGeometry(shape, int(n_shift), order=int(order), kcut=kcut)
    lattice = tuple(int(s) for s in lattice_shape)
    _require(all(m % l == 0 for m, l in zip(shape, lattice)),
             f"mesh {shape} must be a multiple of lattice {lattice}")
    stride = tuple(m // l for m, l in zip(shape, lattice))
    H = tuple(float(int(h)) for h in np.broadcast_to(max_disp, (3,)))
    span = margin = (0, 0, 0)
    if order == 1:  # the default groups and margins of `_window_geometry`
        want = (8, 8, _pick_group(lattice[2], 64))
        span = tuple(_pick_group(l, g) * s for l, g, s in zip(lattice, want, stride))
        margin = tuple(int(h) + order // 2 + 2 for h in H)
    return CICGeometry(shape, int(n_shift), lattice, stride, H, int(order), span, margin, kcut)


def _sites(geom, device):
    """(P, 3) lattice sites in mesh cells, lattice-major order."""
    axes = [torch.arange(l, dtype=torch.float32, device=device) * s
            for l, s in zip(geom.lattice, geom.stride)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def _shifted(pos, geom):
    """Per shift: (unclamped shifted positions, painted positions).

    The shift is added BEFORE the clamp, as `interlace` adds it before
    `paint_window` clamps (the two orders differ for outliers).  The
    position gradient passes only strictly inside the bound, |d| < H, as in
    K2 (at |d| = H exactly, `jnp.clip` passes 1/2 and `torch.clamp` 1)."""
    sites = _sites(geom, pos.device) if geom.lattice is not None else None
    H = torch.tensor(geom.H, dtype=pos.dtype, device=pos.device)
    out = []
    for s in range(geom.n_shift):
        v = pos + s / geom.n_shift
        if sites is None:
            x = v
        else:
            d = v - sites
            x = sites + torch.where(d.abs() < H, d, torch.clamp(d, -H, H).detach())
        out.append((v, x, sites))
    return out


def _tie_base(sites, geom):
    """(P, 3) NGP tie origins of the clamped order-1 window (`CICGeometry`),
    or None."""
    if sites is None or geom.order != 1:
        return None
    span = torch.tensor(geom.span, dtype=sites.dtype, device=sites.device)
    margin = torch.tensor(geom.margin, dtype=sites.dtype, device=sites.device)
    return torch.div(sites, span, rounding_mode="floor") * span - margin


def _axis_windows(x, geom, tie_base=None, hess=False):
    """Per axis, the `order` cells around x (order, P, 3) (unwrapped), their
    window weights, the weights' derivatives d/dx and, with `hess`, their
    second derivatives.  The base cell is round(x) (half to even) for odd
    orders, floor(x) for even ones, and the stencil
    `arange(order) - (order - 1) // 2`, as `ops/paint.py::paint`.  The
    Kaiser-Bessel derivative is written out (`dkaiser_bessel`), finite at the
    support edge; the clamped window of order 1 is the one-hot NGP."""
    order = geom.order
    if order % 2:
        c0 = torch.round(x) if tie_base is None else torch.round(x - tie_base) + tie_base
    else:
        c0 = torch.floor(x)
    offs = torch.arange(order, dtype=x.dtype, device=x.device) - (order - 1) // 2
    cells = c0[None] + offs[:, None, None]
    s = cells - x
    if geom.kcut is not None and not (order == 1 and geom.lattice is not None):
        if hess:
            _check_hessian(geom)
        return (cells.long(), kaiser_bessel(s, order, geom.kcut),
                -dkaiser_bessel(s, order, geom.kcut))
    t = x - c0
    if order == 2:  # 1 - t and t: K1's arithmetic
        one = torch.ones_like(t)
        out = cells.long(), torch.stack([1 - t, t]), torch.stack([-one, one])
    else:
        out = cells.long(), bspline(s, order), -dbspline(s, order)
    return out + (_d2_window(t, order),) if hess else out


def _d2_window(t, order):
    """The B-spline weights' second derivatives d^2/dx^2 at the order cells,
    from t = x - c0 as `csrc/paint_window.cuh` writes them: 0 at NGP and
    CIC, (1, -2, 1) at TSC, (1 - t, -2 + 3t, -2 + 3(1 - t), t) at PCS (at a
    cell edge, the side the base cell puts the particle on)."""
    one = torch.ones_like(t)
    if order in (1, 2):
        return torch.zeros((order,) + t.shape, dtype=t.dtype, device=t.device)
    if order == 3:
        return torch.stack([one, -2 * one, one])
    u = 1 - t
    return torch.stack([u, -2 + 3 * t, -2 + 3 * u, t])


def _corner_terms(x, geom, grad=False, tie_base=None, mask=None, hess=False):
    """The order^3 (flat wrapped cell, weight, weight gradient (P, 3) or
    None, weight Hessian (P, 3, 3) or None) of the window at x; the gradient
    only with `grad` (the adjoints), the Hessian only with `hess`.  `mask`
    (P, 3), where given, zeroes the derivatives along the axes it is False
    on (the clamped ones)."""
    shape, order = geom.shape, geom.order
    cells, w, dw, *d2 = _axis_windows(x, geom, tie_base, hess)
    if mask is not None:
        dw = dw * mask
        d2 = [d * mask for d in d2]
    n = torch.tensor(shape, device=x.device)
    cells = torch.remainder(cells, n)
    for a, b, c in product(range(order), repeat=3):
        idx = (cells[a, :, 0] * shape[1] + cells[b, :, 1]) * shape[2] + cells[c, :, 2]
        wx, wy, wz = w[a, :, 0], w[b, :, 1], w[c, :, 2]
        if not (grad or hess):
            yield idx, wx * wy * wz, None, None
            continue
        dx, dy, dz = dw[a, :, 0], dw[b, :, 1], dw[c, :, 2]
        grad_w = torch.stack([dx * wy * wz, wx * dy * wz, wx * wy * dz], -1)
        if not hess:
            yield idx, wx * wy * wz, grad_w, None
            continue
        hx, hy, hz = d2[0][a, :, 0], d2[0][b, :, 1], d2[0][c, :, 2]
        xy, xz, yz = dx * dy * wz, dx * wy * dz, wx * dy * dz
        hess_w = torch.stack([torch.stack([hx * wy * wz, xy, xz], -1),
                              torch.stack([xy, wx * hy * wz, yz], -1),
                              torch.stack([xz, yz, wx * wy * hz], -1)], -2)
        yield idx, wx * wy * wz, grad_w, hess_w


# ------------------------------------------------------------ K1 / K2 plain
def paint_cic_plain(pos, weights, geom: CICGeometry):
    """Plain PyTorch K1: (S, X, Y, Z) meshes, differentiable by autograd."""
    P = pos.shape[0]
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=pos.dtype, device=pos.device), (P,))
    N = int(np.prod(geom.shape))
    meshes = []
    for _, x, sites in _shifted(pos, geom):
        mesh = pos.new_zeros(N)
        for idx, wc, _, _ in _corner_terms(x, geom, tie_base=_tie_base(sites, geom)):
            mesh = mesh.index_add(0, idx, w * wc)
        meshes.append(mesh.reshape(geom.shape))
    return torch.stack(meshes)


def paint_cic_adjoint_plain(pos, weights, grads, geom: CICGeometry):
    """Plain PyTorch K2: gather the (S, X, Y, Z) cotangents at each
    particle's corners -> (dpos (P, 3), dweights (P,)).  dpos is zero on the
    axes where the clamp was active."""
    dw = torch.zeros_like(weights)
    dpos = torch.zeros_like(pos)
    for s, (v, x, sites) in enumerate(_shifted(pos, geom)):
        g = grads[s].reshape(-1)
        ds = torch.zeros_like(pos)
        for idx, wc, dwc, _ in _corner_terms(x, geom, True, _tie_base(sites, geom)):
            val = g[idx]
            dw = dw + val * wc
            ds = ds + val[:, None] * dwc
        if sites is not None:
            H = torch.tensor(geom.H, dtype=pos.dtype, device=pos.device)
            ds = torch.where((v - sites).abs() < H, ds, torch.zeros_like(ds))
        dpos = dpos + ds
    return dpos * weights[:, None], dw


def _clamp_mask(v, sites, geom):
    """(P, 3) where the position derivative passes the clamp, |d| < H (K2's
    rule), or None without a lattice."""
    if sites is None:
        return None
    return (v - sites).abs() < torch.tensor(geom.H, dtype=v.dtype, device=v.device)


# ------------------------------------------------------------ K6 / K7 plain
def paint_cic_grad_plain(pos, alpha, beta, geom: CICGeometry):
    """Plain PyTorch K6: the (S, X, Y, Z, C) meshes sum_p alpha_p W(x_p - c)
    + beta_p . grad W(x_p - c) for alpha (P, C) (None: 0) and beta (P, C, 3),
    at every interlace shift, the window's gradient zero along clamped axes."""
    C, N = beta.shape[1], int(np.prod(geom.shape))
    meshes = []
    for v, x, sites in _shifted(pos, geom):
        mesh = pos.new_zeros((N, C))
        for idx, wc, dwc, _ in _corner_terms(x, geom, True, _tie_base(sites, geom),
                                             _clamp_mask(v, sites, geom)):
            val = (beta * dwc[:, None]).sum(-1)
            mesh = mesh.index_add(0, idx, val if alpha is None else val + alpha * wc[:, None])
        meshes.append(mesh.reshape(geom.shape + (C,)))
    return torch.stack(meshes)


def read_cic_hess_plain(pos, mesh, b, geom: CICGeometry):
    """Plain PyTorch K7: from (S, X, Y, Z, C) meshes M_s and b (P, 3), the
    (P, C, 3) sums over the shifts g_p = sum_c M_s[c] grad W(x_ps - c) and
    h_p = sum_c M_s[c] H_W(x_ps - c) b_p, both derivatives zero along clamped
    axes."""
    C = mesh.shape[-1]
    g = pos.new_zeros((pos.shape[0], C, 3))
    h = torch.zeros_like(g)
    for s, (v, x, sites) in enumerate(_shifted(pos, geom)):
        flat = mesh[s].reshape(-1, C)
        for idx, _, dwc, hwc in _corner_terms(x, geom, True, _tie_base(sites, geom),
                                              _clamp_mask(v, sites, geom), hess=True):
            val = flat[idx][:, :, None]
            g = g + val * dwc[:, None]
            h = h + val * (hwc @ b[:, :, None])[:, None, :, 0]
    return g, h


# ---------------------------------------------------------- K1 / K2 launch
def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _geom_args(geom):
    lat = geom.lattice if geom.lattice is not None else (1, 1, 1)
    return ([ctypes.c_int(v) for v in geom.shape] + [ctypes.c_int(v) for v in lat]
            + [ctypes.c_float(float(v)) for v in geom.stride]
            + [ctypes.c_float(float(v)) for v in geom.H]
            + [ctypes.c_int(int(geom.lattice is not None)), ctypes.c_int(geom.n_shift),
               ctypes.c_int(geom.order)]
            + [ctypes.c_int(v) for v in geom.span + geom.margin]
            + _window_args(geom))


def _window_args(geom):
    """(Kaiser-Bessel?, beta, 1 / norm) as the kernels take them."""
    if geom.kcut is None:
        return [ctypes.c_int(0), ctypes.c_float(0.0), ctypes.c_float(0.0)]
    beta, norm = kaiser_bessel_norm(geom.order, geom.kcut)
    return [ctypes.c_int(1), ctypes.c_float(beta), ctypes.c_float(1 / norm)]


def _require(ok, msg):
    if not ok:
        raise ValueError(msg)


def _check_cuda_inputs(pos, weights, geom):
    """What the kernels assume of the buffers they are handed."""
    _require(pos.dtype == weights.dtype == torch.float32, "float32 positions and weights only")
    _require(pos.ndim == 2 and pos.shape[1] == 3 and weights.shape == pos.shape[:1],
             f"positions (P, 3) and weights (P,), got {tuple(pos.shape)}, {tuple(weights.shape)}")
    _require(pos.is_contiguous() and weights.is_contiguous(), "contiguous buffers only")
    _require(weights.device == pos.device, "positions and weights on one device")
    _require(geom.lattice is None or int(np.prod(geom.lattice)) == pos.shape[0],
             "lattice paint: one particle per lattice site, in lattice order")


def _launch_status(code, name):
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")


# The lattice-brick kernels' tile budget: four CTAs' tiles (each CTA with
# its 1 KiB reserve and 64 bytes of static shared memory) fit the 228 KiB of
# shared memory of an H100 SM (four CTAs of 256 threads, at most 64
# registers a thread: __launch_bounds__ in csrc/lattice_brick.cuh).
TILE_BYTES = 228 * 1024 // 4 - 1024 - 64
# candidate bricks in lattice sites, z (the lattice's contiguous axis) last
BRICKS = ((8, 8, 8), (4, 8, 16), (8, 8, 16))
# The two kinds of tile: the bytes of a value, and the rule that picks the
# brick, a key over (brick, margin R, tile extent) to maximise.  A paint
# tile (K1, K5) holds fixed point in two 32-bit words and takes the brick
# that reaches the largest R, then the longest z run, then the fewest tile
# cells per site.  A read tile (K4) holds float32 and takes the brick of the
# most sites, then the largest R, then the longest z run: a read stages
# only the box its particles reach, whose halo per site the larger brick
# shrinks, and a margin beyond the displacements buys nothing there.
TILE_KINDS = {
    "paint": (8, lambda b, R, tile: (R, b[2], -prod(tile) / prod(b))),
    "read": (4, lambda b, R, tile: (R >= 0, prod(b), R, b[2])),
}


@dataclass(frozen=True)
class TilePlan:
    """Brick and tile of a lattice-brick launch (`tile_plan`)."""
    brick: tuple    # lattice sites per CTA
    R: int          # margin, mesh cells
    tile: tuple     # tile extent, mesh cells
    nbytes: int     # its dynamic shared memory


@lru_cache(maxsize=64)
def tile_plan(geom: CICGeometry, channels=1, kind="paint"):
    """The brick of lattice sites one CTA of a tiled kernel owns and its
    shared-memory tile of `channels` values per cell, of the TILE_KINDS
    `kind`: per axis (brick - 1) stride + 2 R + order cells, the window
    cells of every site of the brick displaced by at most R.  R is the
    largest margin, up to the clamp bound, whose tile fits TILE_BYTES; the
    brick is the one among the BRICKS (cut to the lattice, halved until one
    fits) that the kind's rule picks.  A particle whose cells leave the tile
    goes to device memory, so no choice here changes the result."""
    _require(geom.lattice is not None, "a tile plan needs the particle lattice")
    value_bytes, rule = TILE_KINDS[kind]

    def tile(brick, R):
        return tuple((b - 1) * s + 2 * R + geom.order for b, s in zip(brick, geom.stride))

    def nbytes(brick, R):
        return value_bytes * channels * prod(tile(brick, R))

    bricks = [tuple(min(b, l) for b, l in zip(brick, geom.lattice)) for brick in BRICKS]
    while all(nbytes(b, 0) > TILE_BYTES for b in bricks):
        bricks = [tuple(max(1, v // 2) if i == b.index(max(b)) else v for i, v in enumerate(b))
                  for b in bricks]
    r_max = int(np.ceil(max(geom.H)))

    def margin(brick):
        if nbytes(brick, 0) > TILE_BYTES:
            return -1
        return max(r for r in range(r_max + 1) if nbytes(brick, r) <= TILE_BYTES)

    brick = max(bricks, key=lambda b: rule(b, margin(b), tile(b, margin(b))))
    R = margin(brick)
    return TilePlan(brick, R, tile(brick, R), nbytes(brick, R))


def _tile_args(plan):
    return [ctypes.c_int(v) for v in plan.brick + (plan.R,) + plan.tile + (plan.nbytes,)]


def _counter(outliers, device):
    """The device pointer of the optional outlier counter: a one-element
    int64 tensor on `device` that the tiled kernels add their count of
    corner products sent to device memory to."""
    if outliers is None:
        return ctypes.c_void_p(None)
    _require(outliers.dtype == torch.int64 and outliers.numel() == 1
             and outliers.device == device, "outliers: one int64 element on the kernel's device")
    return _ptr(outliers)


def _accumulator(mesh, fixed=True):
    """The pointer to K1's, K5's and K6's fixed-point accumulator for the float32
    `mesh` they add into (csrc/mesh_fixed.cuh): one int64 a cell and one
    for the values' largest magnitude, zeroed by the kernel's launch.  With
    `fixed` False a null pointer: the kernels then add floats with
    atomics, in a run-dependent order (kept to time the fixed point's cost
    against)."""
    if not fixed:
        return ctypes.c_void_p(None)
    return _ptr(torch.empty(mesh.numel() + 1, dtype=torch.int64, device=mesh.device))


def paint_cic_kernel(pos, weights, geom: CICGeometry):
    """K1 on the card, the atomic design: (S, X, Y, Z) float32 meshes."""
    return _paint_cic(pos, weights, geom, tiled=False)


def paint_cic_tiled_kernel(pos, weights, geom: CICGeometry, outliers=None):
    """K1 on the card, the lattice-brick design (a lattice geometry), as
    `paint_cic_kernel`; `outliers` as in `_counter`."""
    return _paint_cic(pos, weights, geom, tiled=True, outliers=outliers)


def _paint_cic(pos, weights, geom, tiled, outliers=None, fixed=True):
    from montecosmo_tpu_torch.ops import _kernels

    _check_cuda_inputs(pos, weights, geom)
    lib = _kernels.cuda_library()
    out = torch.zeros((geom.n_shift,) + geom.shape, dtype=torch.float32, device=pos.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
    if tiled:
        name = "paint_cic_tiled"
        code = lib.paint_cic_tiled_forward(_ptr(pos), _ptr(weights), *_geom_args(geom),
                                           *_tile_args(tile_plan(geom)), _ptr(out),
                                           _counter(outliers, pos.device),
                                           _accumulator(out, fixed), stream)
    else:
        name = "paint_cic"
        code = lib.paint_cic_forward(_ptr(pos), _ptr(weights), ctypes.c_longlong(pos.shape[0]),
                                     *_geom_args(geom), _ptr(out), _accumulator(out, fixed),
                                     stream)
    LAUNCHES[name, geom.window, geom.order] += 1
    _launch_status(code, name)
    return out


def paint_cic_adjoint_kernel(pos, weights, grads, geom: CICGeometry):
    """K2 on the card: (dpos, dweights)."""
    from montecosmo_tpu_torch.ops import _kernels

    _check_cuda_inputs(pos, weights, geom)
    grads = grads.contiguous()
    _require(grads.dtype == torch.float32 and grads.shape == (geom.n_shift,) + geom.shape,
             f"cotangent meshes {(geom.n_shift,) + geom.shape} float32 expected")
    lib = _kernels.cuda_library()
    dpos = torch.empty_like(pos)
    dw = torch.empty_like(weights)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    code = lib.paint_cic_adjoint(_ptr(pos), _ptr(weights), _ptr(grads),
                                 ctypes.c_longlong(pos.shape[0]), *_geom_args(geom),
                                 _ptr(dpos), _ptr(dw), ctypes.c_void_p(stream))
    LAUNCHES["paint_cic_adjoint", geom.window, geom.order] += 1
    _launch_status(code, "paint_cic_adjoint")
    return dpos, dw


# The lowest window order at which each kernel takes its lattice-brick
# design on a clamped (lattice) geometry, from the 224^3 timings of both
# designs (PERF.md, Findings): below it, and without a lattice, the
# per-particle design runs.  K1 and K5 from CIC (at NGP one atomic add a
# particle is cheaper than a brick's set-up); K4 from TSC (at NGP and CIC
# the per-particle gather is faster than staging the brick's box); K6 from
# CIC (since its corners add fixed point, its tile is the faster at CIC on
# the render's case, the force read's and a flagship HVP column's own
# inputs; at NGP one 64-bit atomic a corner and shift still is).  K7's
# per-particle gather (its corner
# sums factored per (i, j)) measured faster than its staged boxes at every
# order of the render's case, so it has no entry; K2 has the per-particle
# design only.
TILED_FROM = {"paint_cic": 2, "read_cic_adjoint": 2, "read_cic": 3, "paint_cic_grad": 2}


def _tiled(kernel, geom):
    """Whether `kernel` takes its lattice-brick design for `geom`."""
    return geom.lattice is not None and geom.order >= TILED_FROM.get(kernel, np.inf)


def _paint(pos, weights, geom):
    """K1 in the design `_tiled` picks on the card, its plain version on the
    CPU."""
    if pos.is_cuda:
        kernel = paint_cic_tiled_kernel if _tiled("paint_cic", geom) else paint_cic_kernel
        return kernel(pos, weights, geom)
    return paint_cic_plain(pos, weights, geom)


def _paint_adjoint(pos, weights, grads, geom):
    """K2 on the card, its plain version on the CPU."""
    if pos.is_cuda:
        return paint_cic_adjoint_kernel(pos, weights, grads, geom)
    return paint_cic_adjoint_plain(pos, weights, grads, geom)


def _add(a, b):
    """a + b, where None stands for a zero."""
    return b if a is None else a if b is None else a + b


class _PaintCIC(torch.autograd.Function):
    """K1 forward in the design `_tiled` picks; backward `_PaintCICAdjoint`
    (K2), itself differentiable."""

    @staticmethod
    def forward(ctx, pos, weights, geom):
        ctx.geom = geom
        ctx.save_for_backward(pos, weights)
        return _paint(pos, weights, geom)

    @staticmethod
    def backward(ctx, grads):
        pos, weights = ctx.saved_tensors
        dpos, dw = _PaintCICAdjoint.apply(pos, weights, grads, ctx.geom)
        return dpos, dw, None


class _PaintCICAdjoint(torch.autograd.Function):
    """K2: (positions, weights w, cotangent meshes G) -> (dpos, dweights).
    Its backward, for cotangents b (P, 3) on dpos and a (P,) on dweights:
    G gets K6 with alpha = a and beta = w b; with (g, h) = K7 of G and b,
    the positions get a g + w h and the weights b . g (a 0 where a
    cotangent is None)."""

    @staticmethod
    def forward(ctx, pos, weights, grads, geom):
        ctx.geom = geom
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pos, weights, grads)
        return _paint_adjoint(pos, weights, grads.contiguous(), geom)

    @staticmethod
    @once_differentiable
    def backward(ctx, b, a):
        geom = ctx.geom
        _check_hessian(geom)
        pos, weights, grads = ctx.saved_tensors
        need_pos, need_w, need_grads = ctx.needs_input_grad[:3]
        b = torch.zeros_like(pos) if b is None else b.contiguous()
        a = torch.zeros_like(weights) if a is None else a.contiguous()
        dpos = dw = dgrads = None
        if need_grads:
            dgrads = _paint_grad(pos, a[:, None], (weights[:, None] * b)[:, None], geom)[..., 0]
        if need_pos or need_w:
            g, h = (t[:, 0] for t in _read_hess(pos, grads.contiguous()[..., None], b, geom))
            dpos = a[:, None] * g + weights[:, None] * h if need_pos else None
            dw = (b * g).sum(-1) if need_w else None
        return dpos, dw, dgrads, None


def paint_cic(pos, shape, weights=1.0, n_shift=1, lattice_shape=None, max_disp=8,
              clip=False, order=2, kernel_type="rectangular", oversamp=1.0):
    """Interlaced paint with the window of `order` and `kernel_type`:
    (n_shift, *shape) meshes, shift s painted at pos + s/n_shift.  With
    `lattice_shape` and clip=True, each shifted position is clamped to
    +-max_disp cells around its lattice site."""
    geom = cic_geometry(shape, n_shift, lattice_shape, max_disp, clip, order, kernel_type,
                        oversamp)
    pos = pos.reshape(-1, 3).contiguous()
    w = torch.as_tensor(weights, dtype=pos.dtype, device=pos.device)
    w = torch.broadcast_to(w.reshape(-1) if w.ndim else w, pos.shape[:1]).contiguous()
    return _PaintCIC.apply(pos, w, geom)


# ------------------------------------------------------------------ paint
def paint(pos, shape: tuple, weights=1.0, order: int = 2, kernel_type="rectangular",
          oversamp=1.0, *, lattice_shape=None, max_disp=8, clip=False):
    """Scatter particle `weights` onto a mesh of `shape` (positions in cell
    units, periodic) with the window of `order` (the B-spline, or with
    kernel_type='kaiser_bessel' the Kaiser-Bessel window of cutoff
    `optim_kcut(oversamp)`): K1 with one shift.  With `lattice_shape` and
    clip=True, positions are clamped to +-max_disp around their sites."""
    return paint_cic(pos, shape, weights, 1, lattice_shape, max_disp, clip, order, kernel_type,
                     oversamp)[0]


# ------------------------------------------------------------ K4 / K5 plain
def read_cic_plain(pos, mesh, geom: CICGeometry):
    """Plain PyTorch K4: (P, C) values of the (X, Y, Z, C) mesh at the
    (clamped) positions, differentiable by autograd."""
    ((_, x, sites),) = _shifted(pos, geom)
    flat = mesh.reshape(-1, mesh.shape[-1])
    out = 0.0
    for idx, w, _, _ in _corner_terms(x, geom, tie_base=_tie_base(sites, geom)):
        out = out + flat[idx] * w[:, None]
    return out


def read_cic_adjoint_plain(pos, mesh, ct, geom: CICGeometry):
    """Plain PyTorch K5: (dpos (P, 3), dmesh (X, Y, Z, C)) for the (P, C)
    cotangent `ct`.  dpos is zero on the axes where the clamp was active."""
    ((v, x, sites),) = _shifted(pos, geom)
    C = mesh.shape[-1]
    flat = mesh.reshape(-1, C)
    dmesh = mesh.new_zeros(flat.shape)
    dpos = torch.zeros_like(pos)
    for idx, w, dw, _ in _corner_terms(x, geom, True, _tie_base(sites, geom)):
        dmesh = dmesh.index_add(0, idx, ct * w[:, None])
        dpos = dpos + (flat[idx] * ct).sum(-1, keepdim=True) * dw
    if sites is not None:
        H = torch.tensor(geom.H, dtype=pos.dtype, device=pos.device)
        dpos = torch.where((v - sites).abs() < H, dpos, torch.zeros_like(dpos))
    return dpos, dmesh.reshape(mesh.shape)


# ---------------------------------------------------------- K4 / K5 launch
def _check_read_inputs(pos, mesh, geom):
    _require(pos.dtype == mesh.dtype == torch.float32, "float32 positions and mesh only")
    _require(pos.ndim == 2 and pos.shape[1] == 3, f"positions (P, 3), got {tuple(pos.shape)}")
    _require(mesh.ndim == 4 and tuple(mesh.shape[:3]) == geom.shape,
             f"channel-last mesh {geom.shape} + (C,) expected, got {tuple(mesh.shape)}")
    _require(mesh.shape[-1] >= 1, "a mesh of at least one channel")
    _require(pos.is_contiguous() and mesh.is_contiguous(), "contiguous buffers only")
    _require(mesh.device == pos.device, "positions and mesh on one device")
    _require(geom.n_shift == 1, "a read has one shift")
    _require(geom.lattice is None or int(np.prod(geom.lattice)) == pos.shape[0],
             "lattice read: one particle per lattice site, in lattice order")


# channels of one K4/K5 launch (kMaxC in paint_window.cuh); more go in several
MAX_CHANNELS = 4


def _channel_chunks(*ts):
    """The channel-last tensors `ts` cut into chunks of at most MAX_CHANNELS
    channels, each contiguous."""
    C = ts[0].shape[-1]
    return [[t[..., c:c + MAX_CHANNELS].contiguous() for t in ts]
            for c in range(0, C, MAX_CHANNELS)]


def read_cic_kernel(pos, mesh, geom: CICGeometry):
    """K4 on the card, the per-particle design: (P, C) float32 values, one
    launch per 4 channels."""
    return _read_cic(pos, mesh, geom, tiled=False)


def read_cic_tiled_kernel(pos, mesh, geom: CICGeometry, outliers=None):
    """K4 on the card, the lattice-brick design (a lattice geometry), as
    `read_cic_kernel`; `outliers` as in `_counter`."""
    return _read_cic(pos, mesh, geom, tiled=True, outliers=outliers)


def _read_cic(pos, mesh, geom, tiled, outliers=None):
    from montecosmo_tpu_torch.ops import _kernels

    _check_read_inputs(pos, mesh, geom)
    if mesh.shape[-1] > MAX_CHANNELS:
        return torch.cat([_read_cic(pos, m, geom, tiled, outliers)
                          for (m,) in _channel_chunks(mesh)], -1)
    lib = _kernels.cuda_library()
    C = mesh.shape[-1]
    out = torch.empty((pos.shape[0], C), dtype=torch.float32, device=pos.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
    if tiled:
        name = "read_cic_tiled"
        code = lib.read_cic_tiled(_ptr(pos), _ptr(mesh), ctypes.c_int(C), *_geom_args(geom),
                                  *_tile_args(tile_plan(geom, C, "read")), _ptr(out),
                                  _counter(outliers, pos.device), stream)
    else:
        name = "read_cic"
        code = lib.read_cic_forward(_ptr(pos), _ptr(mesh), ctypes.c_longlong(pos.shape[0]),
                                    ctypes.c_int(C), *_geom_args(geom), _ptr(out), stream)
    LAUNCHES[name, geom.window, geom.order] += 1
    _launch_status(code, name)
    return out


def read_cic_adjoint_kernel(pos, mesh, ct, geom: CICGeometry):
    """K5 on the card, the atomic design: (dpos (P, 3), dmesh (X, Y, Z, C)),
    one launch per 4 channels (their position gradients summed)."""
    return _read_cic_adjoint(pos, mesh, ct, geom, tiled=False)


def read_cic_adjoint_tiled_kernel(pos, mesh, ct, geom: CICGeometry, outliers=None):
    """K5 on the card, the lattice-brick design (a lattice geometry), as
    `read_cic_adjoint_kernel`; `outliers` as in `_counter`."""
    return _read_cic_adjoint(pos, mesh, ct, geom, tiled=True, outliers=outliers)


def _read_cic_adjoint(pos, mesh, ct, geom, tiled, outliers=None, fixed=True):
    from montecosmo_tpu_torch.ops import _kernels

    _check_read_inputs(pos, mesh, geom)
    ct = ct.contiguous()
    _require(ct.dtype == torch.float32 and ct.shape == (pos.shape[0], mesh.shape[-1]),
             f"cotangent {(pos.shape[0], mesh.shape[-1])} float32 expected")
    if mesh.shape[-1] > MAX_CHANNELS:
        parts = [_read_cic_adjoint(pos, m, c, geom, tiled, outliers, fixed)
                 for m, c in _channel_chunks(mesh, ct)]
        return sum(d for d, _ in parts), torch.cat([m for _, m in parts], -1)
    lib = _kernels.cuda_library()
    C = mesh.shape[-1]
    dmesh = torch.zeros_like(mesh)
    dpos = torch.empty_like(pos)
    stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
    if tiled:
        name = "read_cic_adjoint_tiled"
        code = lib.read_cic_adjoint_tiled(_ptr(pos), _ptr(mesh), _ptr(ct), ctypes.c_int(C),
                                          *_geom_args(geom), *_tile_args(tile_plan(geom, C)),
                                          _ptr(dmesh), _ptr(dpos),
                                          _counter(outliers, pos.device),
                                          _accumulator(dmesh, fixed), stream)
    else:
        name = "read_cic_adjoint"
        code = lib.read_cic_adjoint(_ptr(pos), _ptr(mesh), _ptr(ct),
                                    ctypes.c_longlong(pos.shape[0]), ctypes.c_int(C),
                                    *_geom_args(geom), _ptr(dmesh), _ptr(dpos),
                                    _accumulator(dmesh, fixed), stream)
    LAUNCHES[name, geom.window, geom.order] += 1
    _launch_status(code, name)
    return dpos, dmesh


def _read(pos, mesh, geom):
    """K4 in the design `_tiled` picks on the card, its plain version on the
    CPU."""
    if pos.is_cuda:
        kernel = read_cic_tiled_kernel if _tiled("read_cic", geom) else read_cic_kernel
        return kernel(pos, mesh, geom)
    return read_cic_plain(pos, mesh, geom)


def _read_adjoint(pos, mesh, ct, geom):
    """K5 in the design `_tiled` picks on the card, its plain version on the
    CPU."""
    if pos.is_cuda:
        kernel = (read_cic_adjoint_tiled_kernel if _tiled("read_cic_adjoint", geom)
                  else read_cic_adjoint_kernel)
        return kernel(pos, mesh, ct, geom)
    return read_cic_adjoint_plain(pos, mesh, ct, geom)


class _ReadCIC(torch.autograd.Function):
    """K4 forward; backward `_ReadCICAdjoint` (K5), itself differentiable."""

    @staticmethod
    def forward(ctx, pos, mesh, geom):
        ctx.geom = geom
        ctx.save_for_backward(pos, mesh)
        return _read(pos, mesh, geom)

    @staticmethod
    def backward(ctx, ct):
        pos, mesh = ctx.saved_tensors
        dpos, dmesh = _ReadCICAdjoint.apply(pos, mesh, ct, ctx.geom)
        return dpos, dmesh, None


class _ReadCICAdjoint(torch.autograd.Function):
    """K5: (positions, mesh M (X, Y, Z, C), cotangent r (P, C)) -> (dpos,
    dmesh).  Its backward, for cotangents b (P, 3) on dpos and B (X, Y, Z,
    C) on dmesh: M gets K6 with beta = r (x) b; with (g, h) = K7 of M and b,
    r gets b . g plus K4 of B, and the positions sum_C r h plus K5's
    position gradient of B for r."""

    @staticmethod
    def forward(ctx, pos, mesh, ct, geom):
        ctx.geom = geom
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pos, mesh, ct)
        return _read_adjoint(pos, mesh, ct.contiguous(), geom)

    @staticmethod
    @once_differentiable
    def backward(ctx, b, bmesh):
        geom = ctx.geom
        _check_hessian(geom)
        pos, mesh, ct = ctx.saved_tensors
        ct = ct.contiguous()
        need_pos, need_mesh, need_ct = ctx.needs_input_grad[:3]
        dpos = dmesh = dct = None
        if b is not None:
            b = b.contiguous()
            if need_mesh:
                dmesh = _paint_grad(pos, None, ct[:, :, None] * b[:, None], geom)[0]
            if need_pos or need_ct:
                g, h = _read_hess(pos, mesh[None], b, geom)
                dpos = (ct[:, :, None] * h).sum(1) if need_pos else None
                dct = (b[:, None] * g).sum(-1) if need_ct else None
        if bmesh is not None:
            bmesh = bmesh.contiguous()
            if need_ct:
                dct = _add(dct, _read(pos, bmesh, geom))
            if need_pos:
                dpos = _add(dpos, _read_adjoint(pos, bmesh, ct, geom)[0])
        return dpos, dmesh, dct, None


def _channels_last(meshes):
    """(X, Y, Z), (X, Y, Z, C) or a list of (X, Y, Z) -> ((X, Y, Z, C), squeeze)."""
    if isinstance(meshes, (list, tuple)):
        return torch.stack(meshes, -1), False
    if meshes.ndim == 3:
        return meshes[..., None], True
    return meshes, False


def read_cic(pos, mesh, lattice_shape=None, max_disp=8, clip=False, order=2,
             kernel_type="rectangular", oversamp=1.0):
    """Read of (X, Y, Z, C) fields at (P, 3) positions with the window of
    `order` and `kernel_type`: K4 forward, K5 backward; with `lattice_shape`
    and clip=True each position is first clamped to +-max_disp cells around
    its lattice site, as K1 paints it."""
    mesh = mesh.contiguous()
    geom = cic_geometry(mesh.shape[:3], 1, lattice_shape, max_disp, clip, order, kernel_type,
                        oversamp)
    return _ReadCIC.apply(pos.reshape(-1, 3).contiguous(), mesh, geom)


def read_window(pos, meshes, lattice_shape: tuple, order: int = 2, kernel_type="rectangular",
                oversamp=1.0, max_disp=8, clip=False):
    """Mesh read at lattice-ordered positions (the adjoint of the lattice
    paint), as `paint_window.read_window`: (P,) values for one (X, Y, Z)
    mesh, (P, C) for an (X, Y, Z, C) mesh or a list of C meshes.  With
    clip=True positions are clamped to +-max_disp around their sites; without
    it the read is the unclamped one, which equals the JAX window read
    whenever its displacement contract |pos - site| <= max_disp holds (NGP
    ties aside: unclamped, they round the position itself; and unclamped,
    the Kaiser-Bessel window of support 1 is not the one-hot NGP)."""
    mesh, squeeze = _channels_last(meshes)
    shape, lattice = tuple(mesh.shape[:3]), tuple(int(s) for s in lattice_shape)
    _require(all(m % l == 0 for m, l in zip(shape, lattice)),
             f"mesh {shape} must be a multiple of lattice {lattice}")
    vals = read_cic(pos, mesh, lattice, max_disp, clip, order, kernel_type, oversamp)
    return vals[:, 0] if squeeze else vals


def read_multi(pos, meshes, order: int = 2, kernel_type="rectangular", oversamp=1.0):
    """Read several fields at the same (..., 3) positions, unclamped and
    periodic: `meshes` is a list of (X, Y, Z), one (X, Y, Z, C) or one
    (X, Y, Z) (C = 1); returns (..., C)."""
    mesh, _ = _channels_last(meshes)
    vals = read_cic(pos, mesh, order=order, kernel_type=kernel_type, oversamp=oversamp)
    return vals.reshape(pos.shape[:-1] + (mesh.shape[-1],))


def read(pos, mesh, order: int = 2, kernel_type="rectangular", oversamp=1.0):
    """Read one (X, Y, Z) mesh at (..., 3) positions (the adjoint of `paint`
    w.r.t. the weights): (...,) values."""
    return read_multi(pos, mesh, order, kernel_type, oversamp)[..., 0]


def read_sites(meshes, sites_shape: tuple):
    """Read mesh(es) at the `regular_pos(mesh_shape, sites_shape)` lattice:
    strided slicing when the mesh is a multiple of the site lattice.

    meshes : (X, Y, Z), (X, Y, Z, C), or a list of (X, Y, Z) tensors.
    Returns (prod(sites_shape),) or (prod(sites_shape), C).
    """
    if isinstance(meshes, (list, tuple)):
        meshes = torch.stack(meshes, -1)
    shape = meshes.shape[:3]
    assert all(int(m) % int(p) == 0 for m, p in zip(shape, sites_shape)), (
        f"mesh {tuple(shape)} must be a multiple of the site lattice {sites_shape}")
    r = [int(m) // int(p) for m, p in zip(shape, sites_shape)]
    vals = meshes[::r[0], ::r[1], ::r[2]]
    return vals.reshape((-1,) + tuple(meshes.shape[3:]))


# ---------------------------------------------------------- K6 / K7 launch
def _check_hess_inputs(pos, vec, geom):
    """What K6 and K7 assume of the positions and of the per-particle
    vectors `vec` (K6's beta, K7's b) they are handed."""
    _check_hessian(geom)
    _require(pos.dtype == vec.dtype == torch.float32, "float32 positions and vectors only")
    _require(pos.ndim == 2 and pos.shape[1] == 3 and vec.shape[0] == pos.shape[0]
             and vec.shape[-1] == 3, f"positions (P, 3) and (P, ..., 3) vectors, got "
             f"{tuple(pos.shape)}, {tuple(vec.shape)}")
    _require(pos.is_contiguous() and vec.is_contiguous(), "contiguous buffers only")
    _require(vec.device == pos.device, "positions and vectors on one device")
    _require(geom.lattice is None or int(np.prod(geom.lattice)) == pos.shape[0],
             "lattice paint: one particle per lattice site, in lattice order")


def paint_cic_grad_kernel(pos, alpha, beta, geom: CICGeometry):
    """K6 on the card, the per-particle atomic design: (S, X, Y, Z, C)
    float32 meshes for alpha (P, C) (or None) and beta (P, C, 3), one launch
    per 4 channels."""
    return _paint_cic_grad(pos, alpha, beta, geom, tiled=False)


def paint_cic_grad_tiled_kernel(pos, alpha, beta, geom: CICGeometry, outliers=None):
    """K6 on the card, the lattice-brick design (a lattice geometry), as
    `paint_cic_grad_kernel`; `outliers` as in `_counter`."""
    return _paint_cic_grad(pos, alpha, beta, geom, tiled=True, outliers=outliers)


def _paint_cic_grad(pos, alpha, beta, geom, tiled, outliers=None, fixed=True):
    from montecosmo_tpu_torch.ops import _kernels

    _check_hess_inputs(pos, beta, geom)
    C = beta.shape[1]
    _require(alpha is None or (alpha.shape == beta.shape[:2] and alpha.dtype == torch.float32
                               and alpha.is_contiguous() and alpha.device == pos.device),
             f"alpha {tuple(beta.shape[:2])} float32, contiguous, expected")
    if C > MAX_CHANNELS:
        return torch.cat([_paint_cic_grad(
            pos, None if alpha is None else alpha[:, c:c + MAX_CHANNELS].contiguous(),
            beta[:, c:c + MAX_CHANNELS].contiguous(), geom, tiled, outliers, fixed)
            for c in range(0, C, MAX_CHANNELS)], -1)
    lib = _kernels.cuda_library()
    out = torch.zeros((geom.n_shift,) + geom.shape + (C,), dtype=torch.float32, device=pos.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
    al = ctypes.c_void_p(None) if alpha is None else _ptr(alpha)
    if tiled:
        name = "paint_cic_grad_tiled"
        code = lib.paint_cic_grad_tiled(_ptr(pos), al, _ptr(beta), ctypes.c_int(C),
                                        *_geom_args(geom), *_tile_args(tile_plan(geom, C)),
                                        _ptr(out), _counter(outliers, pos.device),
                                        _accumulator(out, fixed), stream)
    else:
        name = "paint_cic_grad"
        code = lib.paint_cic_grad(_ptr(pos), al, _ptr(beta), ctypes.c_longlong(pos.shape[0]),
                                  ctypes.c_int(C), *_geom_args(geom), _ptr(out),
                                  _accumulator(out, fixed), stream)
    LAUNCHES[name, geom.window, geom.order] += 1
    _launch_status(code, name)
    return out


def read_cic_hess_kernel(pos, mesh, b, geom: CICGeometry):
    """K7 on the card, one thread per particle: (g, h), each (P, C, 3)
    float32, for the (S, X, Y, Z, C) meshes and b (P, 3), one launch per 4
    channels."""
    return _read_cic_hess(pos, mesh, b, geom, tiled=False)


def read_cic_hess_tiled_kernel(pos, mesh, b, geom: CICGeometry, outliers=None):
    """K7 on the card, the lattice-brick design (a lattice geometry), as
    `read_cic_hess_kernel`; its read tile holds the S shifts' C channels;
    `outliers` as in `_counter`."""
    return _read_cic_hess(pos, mesh, b, geom, tiled=True, outliers=outliers)


def _read_cic_hess(pos, mesh, b, geom, tiled, outliers=None):
    from montecosmo_tpu_torch.ops import _kernels

    _check_hess_inputs(pos, b, geom)
    _require(mesh.dtype == torch.float32 and mesh.is_contiguous() and mesh.device == pos.device
             and tuple(mesh.shape[:4]) == (geom.n_shift,) + geom.shape and mesh.ndim == 5,
             f"contiguous float32 meshes {(geom.n_shift,) + geom.shape} + (C,) expected, got "
             f"{tuple(mesh.shape)}")
    C = mesh.shape[-1]
    if C > MAX_CHANNELS:
        parts = [_read_cic_hess(pos, m, b, geom, tiled, outliers)
                 for (m,) in _channel_chunks(mesh)]
        return tuple(torch.cat(t, 1) for t in zip(*parts))
    lib = _kernels.cuda_library()
    g = torch.empty((pos.shape[0], C, 3), dtype=torch.float32, device=pos.device)
    h = torch.empty_like(g)
    stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
    if tiled:
        name = "read_cic_hess_tiled"
        plan = tile_plan(geom, geom.n_shift * C, "read")
        code = lib.read_cic_hess_tiled(_ptr(pos), _ptr(mesh), _ptr(b), ctypes.c_int(C),
                                       *_geom_args(geom), *_tile_args(plan), _ptr(g), _ptr(h),
                                       _counter(outliers, pos.device), stream)
    else:
        name = "read_cic_hess"
        code = lib.read_cic_hess(_ptr(pos), _ptr(mesh), _ptr(b), ctypes.c_longlong(pos.shape[0]),
                                 ctypes.c_int(C), *_geom_args(geom), _ptr(g), _ptr(h), stream)
    LAUNCHES[name, geom.window, geom.order] += 1
    _launch_status(code, name)
    return g, h


def _paint_grad(pos, alpha, beta, geom):
    """K6 in the design `_tiled` picks on the card, its plain version on the
    CPU."""
    if pos.is_cuda:
        kernel = (paint_cic_grad_tiled_kernel if _tiled("paint_cic_grad", geom)
                  else paint_cic_grad_kernel)
        return kernel(pos, alpha, beta.contiguous(), geom)
    return paint_cic_grad_plain(pos, alpha, beta, geom)


def _read_hess(pos, mesh, b, geom):
    """K7 in the design `_tiled` picks on the card, its plain version on the
    CPU."""
    if pos.is_cuda:
        kernel = (read_cic_hess_tiled_kernel if _tiled("read_cic_hess", geom)
                  else read_cic_hess_kernel)
        return kernel(pos, mesh.contiguous(), b.contiguous(), geom)
    return read_cic_hess_plain(pos, mesh, b, geom)


# ---------------------------------------------------------------- K3 plain
@dataclass(frozen=True)
class EpilogueGeometry:
    shape: tuple       # real paint mesh (X, Y, Z)
    n_shift: int
    scale: float       # units jacobian
    order: int         # deconvolution order (window support), 0 for none
    kcut: float = None  # Kaiser-Bessel cutoff; None: the B-spline window

    @property
    def window(self):
        return "bspline" if self.kcut is None else "kb"


def _window_hat(kvec, geom):
    """The Fourier transform of the paint window K3 divides by."""
    if geom.kcut is None:
        return bspline_hat(kvec, geom.order)
    return kaiser_bessel_hat(kvec, geom.order, geom.kcut)


def nufft_epilogue_plain(fk, geom: EpilogueGeometry):
    """Plain PyTorch K3, written as `interlace` + `nufft` write it:
    sum_s F_s exp(i s/n (kx+ky+kz)) / n * scale / window_hat(k)."""
    kvec = rfftk(geom.shape, device=fk.device)
    out = 0.0
    for s in range(geom.n_shift):
        phase = 1.0
        for ki in kvec:
            phase = phase * torch.exp(1j * (s / geom.n_shift) * ki)
        out = out + fk[s] * phase / geom.n_shift
    out = out * geom.scale
    if geom.order:
        out = out / _window_hat(kvec, geom)
    return out


def _epilogue_factors(geom, device):
    """Per shift, the complex factor exp(i s/n ksum) * scale / (n W(k))."""
    kvec = rfftk(geom.shape, device=device)
    c = torch.full(r2chshape(geom.shape), geom.scale / geom.n_shift, device=device)
    if geom.order:
        c = c / _window_hat(kvec, geom)
    ksum = kvec[0] + kvec[1] + kvec[2]
    one = torch.ones_like(c)
    return [torch.polar(one, ksum * (s / geom.n_shift)) * c for s in range(geom.n_shift)]


def _epilogue_math(x, geom, backward):
    """K3's arithmetic in plain PyTorch (the CPU side of the wrapper)."""
    factors = _epilogue_factors(geom, x.device)
    if backward:
        return torch.stack([x * f.conj() for f in factors])
    return sum(x[s] * f for s, f in enumerate(factors))


@lru_cache(maxsize=None)
def _epilogue_tables(geom, device):
    """K3's per-axis tables on `device`, from the plain version's own
    functions: the window's factor of each axis, (X,), (Y,) and (Zc,)
    float32 (`_window_hat` of one axis of `rfftk`, whose product over the
    axes, taken in that order, is the plain version's W bit for bit), and
    each axis's phases exp(i s k / n) for s = 1..n-1, (n-1, N) complex64,
    rounded from float64."""
    kvec = [k.reshape(-1) for k in rfftk(geom.shape, device=device)]
    win = [_window_hat((k,), geom).contiguous() if geom.order else torch.ones_like(k)
           for k in kvec]
    s = torch.arange(1, geom.n_shift, dtype=torch.float64, device=device)[:, None] / geom.n_shift
    phase = [torch.polar(torch.ones_like(s * k.double()), s * k.double()).to(torch.complex64)
             for k in kvec]
    return (*win, *phase)


def nufft_epilogue_kernel(x, geom: EpilogueGeometry, backward=False):
    """K3 on the card.  Forward: (S, X, Y, Zc) -> (X, Y, Zc) complex64;
    backward: (X, Y, Zc) cotangent -> (S, X, Y, Zc)."""
    from montecosmo_tpu_torch.ops import _kernels

    cshape = r2chshape(geom.shape)
    want = cshape if backward else (geom.n_shift,) + cshape
    _require(x.dtype == torch.complex64 and tuple(x.shape) == want,
             f"complex64 {want} expected, got {x.dtype} {tuple(x.shape)}")
    _require(1 <= geom.n_shift <= 8 and geom.n_shift * prod(cshape) < 2**31,
             f"1-8 interlace shifts of fewer than 2^31 values, got {geom.n_shift} x {cshape}")
    lib = _kernels.cuda_library()
    src = x.contiguous()
    dst = torch.empty(((geom.n_shift,) + cshape) if backward else cshape,
                      dtype=torch.complex64, device=x.device)
    tables = _epilogue_tables(geom, x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    code = lib.nufft_epilogue(_ptr(src), _ptr(dst), geom.n_shift, *cshape,
                              ctypes.c_float(geom.scale / geom.n_shift), int(geom.order > 0),
                              int(backward), *map(_ptr, tables), stream)
    LAUNCHES["nufft_epilogue", geom.window, geom.order] += 1
    _launch_status(code, "nufft_epilogue")
    return dst


class _NufftEpilogue(torch.autograd.Function):
    """K3 forward; backward `_NufftEpilogueAdjoint` (K3 with the conjugated
    phase): K3 is linear, so each is the other's backward."""

    @staticmethod
    def forward(ctx, fk, geom):
        ctx.geom = geom
        if fk.is_cuda:
            return nufft_epilogue_kernel(fk, geom)
        return _epilogue_math(fk, geom, backward=False)

    @staticmethod
    def backward(ctx, g):
        return _NufftEpilogueAdjoint.apply(g, ctx.geom), None


class _NufftEpilogueAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, geom):
        ctx.geom = geom
        if g.is_cuda:
            return nufft_epilogue_kernel(g, geom, backward=True)
        return _epilogue_math(g, geom, backward=True)

    @staticmethod
    def backward(ctx, gg):
        return _NufftEpilogue.apply(gg, ctx.geom), None


def nufft_epilogue(fk, shape, scale=1.0, order=0, kcut=None):
    """Interlace phase sum, units jacobian and window deconvolution (the
    B-spline of `order`, or the Kaiser-Bessel window of support `order` and
    cutoff `kcut`) of the stacked rffts `fk` (S, X, Y, Zc) of S shifted
    paints."""
    geom = EpilogueGeometry(tuple(int(s) for s in shape), int(fk.shape[0]),
                            float(scale), int(order), kcut)
    return _NufftEpilogue.apply(fk, geom)


# ------------------------------------------------------ interlace / nufft
def interlace(pos, shape: tuple, weights=1.0, paint_order: int = 2,
              interlace_order: int = 2, kernel_type="rectangular", paint_oversamp=1.0, *,
              lattice_shape=None, max_disp=8, clip=False, scale=1.0, deconv=False):
    """Equal-spacing interlaced painting in Fourier space: the phase-rotated
    rffts of `interlace_order` diagonally shifted paints, averaged (K1 paints
    every shift in one particle pass), times `scale`, divided by the paint
    window when `deconv` (K3 does all of it in one pass)."""
    shape = tuple(int(s) for s in shape)
    meshes = paint_cic(pos, shape, weights, interlace_order, lattice_shape, max_disp, clip,
                       paint_order, kernel_type, paint_oversamp)
    return nufft_epilogue(rfftn(meshes), shape, scale, paint_order if deconv else 0,
                          _kcut(kernel_type, paint_oversamp))


def nufft(pos, final_shape: tuple, paint_shape=None, weights=1.0,
          paint_order: int = 2, interlace_order: int = 2,
          kernel_type="rectangular", paint_deconv=True, lattice_shape=None,
          max_disp=8, clip=False):
    """Non-uniform FFT: oversampled paint + interlace + window deconvolution +
    power-preserving Fourier downsample to `final_shape`.  `pos` is in
    final-shape cell units; the irfftn of the result sums to the total
    weight.  Returns the rfft mesh at `r2chshape(final_shape)`.

    The window's oversampling factor (the Kaiser-Bessel cutoff) follows the
    JAX package: `paint_shape` itself when a float, else
    exp(mean log(final_shape / paint_shape)) for a shape (below 1 when the
    paint mesh is the finer one)."""
    if paint_shape is None:
        paint_shape, paint_oversamp = final_shape, 1.0
    elif isinstance(paint_shape, float):
        paint_oversamp = paint_shape
        paint_shape = scale_shape(final_shape, paint_oversamp)
    elif isinstance(paint_shape, (tuple, list, np.ndarray)):
        paint_oversamp = float(np.exp(np.log(np.divide(final_shape, paint_shape)).mean()))
    else:
        raise ValueError("paint_shape must be None, a float, or a shape")
    paint_shape = tuple(int(s) for s in paint_shape)

    ratio = np.divide(paint_shape, final_shape)
    pos = pos * torch.as_tensor(ratio.astype(np.float32), device=pos.device)
    mesh = interlace(pos, paint_shape, weights, paint_order, interlace_order, kernel_type,
                     paint_oversamp, lattice_shape=lattice_shape, max_disp=max_disp, clip=clip,
                     scale=float(ratio.prod()), deconv=paint_deconv)
    if tuple(final_shape) != tuple(paint_shape):
        mesh = chreshape(mesh, r2chshape(final_shape))
    return mesh
