"""Mass assignment (paint), reads, interlacing and the NUFFT.

The particle work of every model evaluation goes through five hand-written
kernels (sources in `montecosmo_tpu_torch/csrc/`).  K1, K2, K4 and K5 take
the B-spline window of order 1 (NGP), 2 (CIC), 3 (TSC) or 4 (PCS); their
names come from the CIC (order-2) version.

* K1 `paint_cic`: B-spline scatter of lattice-ordered particles, every
  interlace shift painted in one particle pass, each shifted position
  clamped to +-max_disp around its lattice site (the window contract of
  `montecosmo_tpu/ops/paint_window.py`); CUDA, atomic adds.
* K2 `paint_cic_adjoint`: its VJP, a gather of the cotangent meshes giving
  the weight and position gradients; CUDA, no atomics.
* K3 `nufft_epilogue`: the interlace phase sum, units jacobian and window
  deconvolution in one pass over the rfft grid; Triton.  Its backward is the
  same kernel with the conjugated phase.
* K4 `read_cic`: the B-spline read of C channel-last fields at (clamped)
  particle positions, behind `read_window`, `read_multi` and `read`; CUDA,
  no atomics.
* K5 `read_cic_adjoint`: its VJP in one particle pass, the C-channel paint
  of the cotangent (atomics) and the position gradient; CUDA.

Each wrapper launches its kernel for a CUDA tensor (or raises), and runs the
kernel's plain PyTorch version, kept in this module, for a CPU tensor.
`LAUNCHES` counts kernel launches per (kernel, order); K3's order is that of
its deconvolution, 0 for none.

Parity: `montecosmo_tpu/ops/paint.py:57-240` (paint, read, read_multi,
read_sites, interlace, nufft) and `montecosmo_tpu/ops/paint_window.py:103-130`
and `:330-401` (window geometry, the clamp to sites, read_window).
"""
import ctypes
from collections import Counter
from dataclasses import dataclass
from itertools import product

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from montecosmo_tpu_torch.ops.fourier import bspline, bspline_hat, dbspline, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import chreshape, r2chshape, scale_shape

LAUNCHES = Counter()
ORDERS = (1, 2, 3, 4)


def reset_launches():
    LAUNCHES.clear()


def launches_at(order):
    """{kernel: launches} at B-spline `order` since the last reset."""
    return {k: n for (k, o), n in LAUNCHES.items() if o == order}


# ----------------------------------------------------------------- geometry
@dataclass(frozen=True)
class CICGeometry:
    """Static description of one interlaced B-spline paint or read."""
    shape: tuple            # mesh (X, Y, Z)
    n_shift: int            # interlace shifts s/n_shift, s = 0..n_shift-1
    lattice: tuple = None   # particle lattice when clamping, else None
    stride: tuple = (1, 1, 1)
    H: tuple = (np.inf, np.inf, np.inf)
    order: int = 2          # B-spline order: 1 NGP, 2 CIC, 3 TSC, 4 PCS
    # NGP ties (clamped order 1 only): `paint_window` rounds x - b, b the
    # window base of the particle's lattice group, b = (q // span) * span -
    # margin for its site q, so a half-integer x goes to the neighbour of b's
    # parity; zeros: round x itself, as `ops/paint.py::paint`
    span: tuple = (0, 0, 0)
    margin: tuple = (0, 0, 0)


def _pick_group(extent, want):
    """Largest divisor of `extent` that is <= want (>= 1), as
    `paint_window._pick_group`."""
    want = max(1, min(int(want), int(extent)))
    return next(g for g in range(want, 0, -1) if extent % g == 0)


def cic_geometry(shape, n_shift=1, lattice_shape=None, max_disp=8, clip=False, order=2):
    """Geometry checks of `paint_window` (`_window_geometry`): the mesh must
    be a multiple of the particle lattice; the clamp bound is per axis."""
    _require(order in ORDERS, f"B-spline order must be in 1..4, got {order}")
    shape = tuple(int(s) for s in shape)
    if lattice_shape is None or not clip:
        return CICGeometry(shape, int(n_shift), order=int(order))
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
    return CICGeometry(shape, int(n_shift), lattice, stride, H, int(order), span, margin)


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


def _axis_windows(x, order, tie_base=None):
    """Per axis, the `order` cells around x (order, P, 3) (unwrapped), their
    B-spline weights and the weights' derivatives d/dx.  The base cell is
    round(x) (half to even) for odd orders, floor(x) for even ones, and the
    stencil `arange(order) - (order - 1) // 2`, as `ops/paint.py::paint`."""
    if order % 2:
        c0 = torch.round(x) if tie_base is None else torch.round(x - tie_base) + tie_base
    else:
        c0 = torch.floor(x)
    offs = torch.arange(order, dtype=x.dtype, device=x.device) - (order - 1) // 2
    cells = c0[None] + offs[:, None, None]
    if order == 2:  # 1 - t and t: K1's arithmetic
        t = x - c0
        one = torch.ones_like(t)
        return cells.long(), torch.stack([1 - t, t]), torch.stack([-one, one])
    s = cells - x
    return cells.long(), bspline(s, order), -dbspline(s, order)


def _corner_terms(x, shape, order=2, grad=False, tie_base=None):
    """The order^3 (flat wrapped cell, weight, weight gradient (P, 3) or
    None) of the B-spline window at x; the gradient only with `grad` (the
    adjoints)."""
    cells, w, dw = _axis_windows(x, order, tie_base)
    n = torch.tensor(shape, device=x.device)
    cells = torch.remainder(cells, n)
    for a, b, c in product(range(order), repeat=3):
        idx = (cells[a, :, 0] * shape[1] + cells[b, :, 1]) * shape[2] + cells[c, :, 2]
        wx, wy, wz = w[a, :, 0], w[b, :, 1], w[c, :, 2]
        if not grad:
            yield idx, wx * wy * wz, None
            continue
        dx, dy, dz = dw[a, :, 0], dw[b, :, 1], dw[c, :, 2]
        yield idx, wx * wy * wz, torch.stack([dx * wy * wz, wx * dy * wz, wx * wy * dz], -1)


# ------------------------------------------------------------ K1 / K2 plain
def paint_cic_plain(pos, weights, geom: CICGeometry):
    """Plain PyTorch K1: (S, X, Y, Z) meshes, differentiable by autograd."""
    P = pos.shape[0]
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=pos.dtype, device=pos.device), (P,))
    N = int(np.prod(geom.shape))
    meshes = []
    for _, x, sites in _shifted(pos, geom):
        mesh = pos.new_zeros(N)
        for idx, wc, _ in _corner_terms(x, geom.shape, geom.order,
                                        tie_base=_tie_base(sites, geom)):
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
        for idx, wc, dwc in _corner_terms(x, geom.shape, geom.order, True,
                                          _tie_base(sites, geom)):
            val = g[idx]
            dw = dw + val * wc
            ds = ds + val[:, None] * dwc
        if sites is not None:
            H = torch.tensor(geom.H, dtype=pos.dtype, device=pos.device)
            ds = torch.where((v - sites).abs() < H, ds, torch.zeros_like(ds))
        dpos = dpos + ds
    return dpos * weights[:, None], dw


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
            + [ctypes.c_int(v) for v in geom.span + geom.margin])


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


def paint_cic_kernel(pos, weights, geom: CICGeometry):
    """K1 on the card: (S, X, Y, Z) float32 meshes."""
    from montecosmo_tpu_torch.ops import _kernels

    _check_cuda_inputs(pos, weights, geom)
    lib = _kernels.cuda_library()
    out = torch.zeros((geom.n_shift,) + geom.shape, dtype=torch.float32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    code = lib.paint_cic_forward(_ptr(pos), _ptr(weights), ctypes.c_longlong(pos.shape[0]),
                                 *_geom_args(geom), _ptr(out), ctypes.c_void_p(stream))
    LAUNCHES["paint_cic", geom.order] += 1
    _launch_status(code, "paint_cic")
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
    LAUNCHES["paint_cic_adjoint", geom.order] += 1
    _launch_status(code, "paint_cic_adjoint")
    return dpos, dw


class _PaintCIC(torch.autograd.Function):
    """K1 forward, K2 backward.  Double backward is not supported."""

    @staticmethod
    def forward(ctx, pos, weights, geom):
        ctx.geom = geom
        ctx.save_for_backward(pos, weights)
        if pos.is_cuda:
            return paint_cic_kernel(pos, weights, geom)
        return paint_cic_plain(pos, weights, geom)

    @staticmethod
    @once_differentiable
    def backward(ctx, grads):
        pos, weights = ctx.saved_tensors
        if grads.is_cuda:
            dpos, dw = paint_cic_adjoint_kernel(pos, weights, grads, ctx.geom)
        else:
            dpos, dw = paint_cic_adjoint_plain(pos, weights, grads, ctx.geom)
        return dpos, dw, None


def paint_cic(pos, shape, weights=1.0, n_shift=1, lattice_shape=None, max_disp=8,
              clip=False, order=2):
    """Interlaced B-spline paint of `order`: (n_shift, *shape) meshes, shift
    s painted at pos + s/n_shift.  With `lattice_shape` and clip=True, each
    shifted position is clamped to +-max_disp cells around its lattice
    site."""
    geom = cic_geometry(shape, n_shift, lattice_shape, max_disp, clip, order)
    pos = pos.reshape(-1, 3).contiguous()
    w = torch.as_tensor(weights, dtype=pos.dtype, device=pos.device)
    w = torch.broadcast_to(w.reshape(-1) if w.ndim else w, pos.shape[:1]).contiguous()
    return _PaintCIC.apply(pos, w, geom)


# ------------------------------------------------------------------ paint
def _check_window(kernel_type):
    """The B-spline windows are ported (`cic_geometry` checks the order);
    Kaiser-Bessel is not."""
    if kernel_type != "rectangular":
        raise NotImplementedError(
            f"kernel_type={kernel_type!r} is not ported yet (ROADMAP Queue B, B1: "
            "Kaiser-Bessel windows)")


def paint(pos, shape: tuple, weights=1.0, order: int = 2, kernel_type="rectangular", *,
          lattice_shape=None, max_disp=8, clip=False):
    """Scatter particle `weights` onto a mesh of `shape` (positions in cell
    units, periodic) with the B-spline window of `order`: K1 with one shift.
    With `lattice_shape` and clip=True, positions are clamped to +-max_disp
    around their sites."""
    _check_window(kernel_type)
    return paint_cic(pos, shape, weights, 1, lattice_shape, max_disp, clip, order)[0]


# ------------------------------------------------------------ K4 / K5 plain
def read_cic_plain(pos, mesh, geom: CICGeometry):
    """Plain PyTorch K4: (P, C) values of the (X, Y, Z, C) mesh at the
    (clamped) positions, differentiable by autograd."""
    ((_, x, sites),) = _shifted(pos, geom)
    flat = mesh.reshape(-1, mesh.shape[-1])
    out = 0.0
    for idx, w, _ in _corner_terms(x, geom.shape, geom.order,
                                   tie_base=_tie_base(sites, geom)):
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
    for idx, w, dw in _corner_terms(x, geom.shape, geom.order, True, _tie_base(sites, geom)):
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


# channels of one K4/K5 launch (kMaxC in paint_cic.cu); more go in several
MAX_CHANNELS = 4


def _channel_chunks(*ts):
    """The channel-last tensors `ts` cut into chunks of at most MAX_CHANNELS
    channels, each contiguous."""
    C = ts[0].shape[-1]
    return [[t[..., c:c + MAX_CHANNELS].contiguous() for t in ts]
            for c in range(0, C, MAX_CHANNELS)]


def read_cic_kernel(pos, mesh, geom: CICGeometry):
    """K4 on the card: (P, C) float32 values, one launch per 4 channels."""
    from montecosmo_tpu_torch.ops import _kernels

    _check_read_inputs(pos, mesh, geom)
    if mesh.shape[-1] > MAX_CHANNELS:
        return torch.cat([read_cic_kernel(pos, m, geom) for (m,) in _channel_chunks(mesh)], -1)
    lib = _kernels.cuda_library()
    out = torch.empty((pos.shape[0], mesh.shape[-1]), dtype=torch.float32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    code = lib.read_cic_forward(_ptr(pos), _ptr(mesh), ctypes.c_longlong(pos.shape[0]),
                                ctypes.c_int(mesh.shape[-1]), *_geom_args(geom), _ptr(out),
                                ctypes.c_void_p(stream))
    LAUNCHES["read_cic", geom.order] += 1
    _launch_status(code, "read_cic")
    return out


def read_cic_adjoint_kernel(pos, mesh, ct, geom: CICGeometry):
    """K5 on the card: (dpos (P, 3), dmesh (X, Y, Z, C)), one launch per 4
    channels (their position gradients summed)."""
    from montecosmo_tpu_torch.ops import _kernels

    _check_read_inputs(pos, mesh, geom)
    ct = ct.contiguous()
    _require(ct.dtype == torch.float32 and ct.shape == (pos.shape[0], mesh.shape[-1]),
             f"cotangent {(pos.shape[0], mesh.shape[-1])} float32 expected")
    if mesh.shape[-1] > MAX_CHANNELS:
        parts = [read_cic_adjoint_kernel(pos, m, c, geom) for m, c in _channel_chunks(mesh, ct)]
        return sum(d for d, _ in parts), torch.cat([m for _, m in parts], -1)
    lib = _kernels.cuda_library()
    dmesh = torch.zeros_like(mesh)
    dpos = torch.empty_like(pos)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    code = lib.read_cic_adjoint(_ptr(pos), _ptr(mesh), _ptr(ct), ctypes.c_longlong(pos.shape[0]),
                                ctypes.c_int(mesh.shape[-1]), *_geom_args(geom), _ptr(dmesh),
                                _ptr(dpos), ctypes.c_void_p(stream))
    LAUNCHES["read_cic_adjoint", geom.order] += 1
    _launch_status(code, "read_cic_adjoint")
    return dpos, dmesh


class _ReadCIC(torch.autograd.Function):
    """K4 forward, K5 backward.  Double backward is not supported."""

    @staticmethod
    def forward(ctx, pos, mesh, geom):
        ctx.geom = geom
        ctx.save_for_backward(pos, mesh)
        if pos.is_cuda:
            return read_cic_kernel(pos, mesh, geom)
        return read_cic_plain(pos, mesh, geom)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        pos, mesh = ctx.saved_tensors
        if ct.is_cuda:
            dpos, dmesh = read_cic_adjoint_kernel(pos, mesh, ct, ctx.geom)
        else:
            dpos, dmesh = read_cic_adjoint_plain(pos, mesh, ct, ctx.geom)
        return dpos, dmesh, None


def _channels_last(meshes):
    """(X, Y, Z), (X, Y, Z, C) or a list of (X, Y, Z) -> ((X, Y, Z, C), squeeze)."""
    if isinstance(meshes, (list, tuple)):
        return torch.stack(meshes, -1), False
    if meshes.ndim == 3:
        return meshes[..., None], True
    return meshes, False


def read_cic(pos, mesh, lattice_shape=None, max_disp=8, clip=False, order=2):
    """B-spline read of `order` of (X, Y, Z, C) fields at (P, 3) positions: K4
    forward, K5 backward; with `lattice_shape` and clip=True each position is
    first clamped to +-max_disp cells around its lattice site, as K1 paints
    it."""
    mesh = mesh.contiguous()
    geom = cic_geometry(mesh.shape[:3], 1, lattice_shape, max_disp, clip, order)
    return _ReadCIC.apply(pos.reshape(-1, 3).contiguous(), mesh, geom)


def read_window(pos, meshes, lattice_shape: tuple, order: int = 2, kernel_type="rectangular",
                max_disp=8, clip=False):
    """Mesh read at lattice-ordered positions (the adjoint of the lattice
    paint), as `paint_window.read_window`: (P,) values for one (X, Y, Z)
    mesh, (P, C) for an (X, Y, Z, C) mesh or a list of C meshes.  With
    clip=True positions are clamped to +-max_disp around their sites; without
    it the read is the unclamped one, which equals the JAX window read
    whenever its displacement contract |pos - site| <= max_disp holds (NGP
    ties aside: unclamped, they round the position itself)."""
    _check_window(kernel_type)
    mesh, squeeze = _channels_last(meshes)
    shape, lattice = tuple(mesh.shape[:3]), tuple(int(s) for s in lattice_shape)
    _require(all(m % l == 0 for m, l in zip(shape, lattice)),
             f"mesh {shape} must be a multiple of lattice {lattice}")
    vals = read_cic(pos, mesh, lattice, max_disp, clip, order)
    return vals[:, 0] if squeeze else vals


def read_multi(pos, meshes, order: int = 2, kernel_type="rectangular"):
    """Read several fields at the same (..., 3) positions, unclamped and
    periodic: `meshes` is a list of (X, Y, Z), one (X, Y, Z, C) or one
    (X, Y, Z) (C = 1); returns (..., C)."""
    _check_window(kernel_type)
    mesh, _ = _channels_last(meshes)
    return read_cic(pos, mesh, order=order).reshape(pos.shape[:-1] + (mesh.shape[-1],))


def read(pos, mesh, order: int = 2, kernel_type="rectangular"):
    """Read one (X, Y, Z) mesh at (..., 3) positions (the adjoint of `paint`
    w.r.t. the weights): (...,) values."""
    return read_multi(pos, mesh, order, kernel_type)[..., 0]


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


# ---------------------------------------------------------------- K3 plain
@dataclass(frozen=True)
class EpilogueGeometry:
    shape: tuple     # real paint mesh (X, Y, Z)
    n_shift: int
    scale: float     # units jacobian
    order: int       # B-spline deconvolution order, 0 for none


def nufft_epilogue_plain(fk, geom: EpilogueGeometry):
    """Plain PyTorch K3, written as `interlace` + `nufft` write it:
    sum_s F_s exp(i s/n (kx+ky+kz)) / n * scale / bspline_hat(k, order)."""
    kvec = rfftk(geom.shape, device=fk.device)
    out = 0.0
    for s in range(geom.n_shift):
        phase = 1.0
        for ki in kvec:
            phase = phase * torch.exp(1j * (s / geom.n_shift) * ki)
        out = out + fk[s] * phase / geom.n_shift
    out = out * geom.scale
    if geom.order:
        out = out / bspline_hat(kvec, geom.order)
    return out


def _epilogue_factors(geom, device):
    """Per shift, the complex factor exp(i s/n ksum) * scale / (n W(k))."""
    kvec = rfftk(geom.shape, device=device)
    c = torch.full(r2chshape(geom.shape), geom.scale / geom.n_shift, device=device)
    if geom.order:
        c = c / bspline_hat(kvec, geom.order)
    ksum = kvec[0] + kvec[1] + kvec[2]
    one = torch.ones_like(c)
    return [torch.polar(one, ksum * (s / geom.n_shift)) * c for s in range(geom.n_shift)]


def _epilogue_math(x, geom, backward):
    """K3's arithmetic in plain PyTorch (the CPU side of the wrapper)."""
    factors = _epilogue_factors(geom, x.device)
    if backward:
        return torch.stack([x * f.conj() for f in factors])
    return sum(x[s] * f for s, f in enumerate(factors))


def nufft_epilogue_kernel(x, geom: EpilogueGeometry, backward=False):
    """K3 on the card.  Forward: (S, X, Y, Zc) -> (X, Y, Zc) complex64;
    backward: (X, Y, Zc) cotangent -> (S, X, Y, Zc)."""
    from montecosmo_tpu_torch.ops import _kernels

    cshape = r2chshape(geom.shape)
    want = cshape if backward else (geom.n_shift,) + cshape
    _require(x.dtype == torch.complex64 and tuple(x.shape) == want,
             f"complex64 {want} expected, got {x.dtype} {tuple(x.shape)}")
    src = torch.view_as_real(x.contiguous())
    out_shape = ((geom.n_shift,) + cshape) if backward else cshape
    dst = torch.empty(out_shape + (2,), dtype=torch.float32, device=x.device)
    _kernels.launch_nufft_epilogue(src, dst, geom, backward)
    LAUNCHES["nufft_epilogue", geom.order] += 1
    return torch.view_as_complex(dst)


class _NufftEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fk, geom):
        ctx.geom = geom
        if fk.is_cuda:
            return nufft_epilogue_kernel(fk, geom)
        return _epilogue_math(fk, geom, backward=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if g.is_cuda:
            return nufft_epilogue_kernel(g, ctx.geom, backward=True), None
        return _epilogue_math(g, ctx.geom, backward=True), None


def nufft_epilogue(fk, shape, scale=1.0, order=0):
    """Interlace phase sum, units jacobian and window deconvolution of the
    stacked rffts `fk` (S, X, Y, Zc) of S shifted paints."""
    geom = EpilogueGeometry(tuple(int(s) for s in shape), int(fk.shape[0]),
                            float(scale), int(order))
    return _NufftEpilogue.apply(fk, geom)


# ------------------------------------------------------ interlace / nufft
def interlace(pos, shape: tuple, weights=1.0, paint_order: int = 2,
              interlace_order: int = 2, kernel_type="rectangular", *, lattice_shape=None,
              max_disp=8, clip=False, scale=1.0, deconv=False):
    """Equal-spacing interlaced painting in Fourier space: the phase-rotated
    rffts of `interlace_order` diagonally shifted paints, averaged (K1 paints
    every shift in one particle pass), times `scale`, divided by the paint
    window when `deconv` (K3 does all of it in one pass)."""
    _check_window(kernel_type)
    shape = tuple(int(s) for s in shape)
    meshes = paint_cic(pos, shape, weights, interlace_order, lattice_shape, max_disp, clip,
                       paint_order)
    return nufft_epilogue(rfftn(meshes), shape, scale, paint_order if deconv else 0)


def nufft(pos, final_shape: tuple, paint_shape=None, weights=1.0,
          paint_order: int = 2, interlace_order: int = 2,
          kernel_type="rectangular", paint_deconv=True, lattice_shape=None,
          max_disp=8, clip=False):
    """Non-uniform FFT: oversampled paint + interlace + window deconvolution +
    power-preserving Fourier downsample to `final_shape`.  `pos` is in
    final-shape cell units; the irfftn of the result sums to the total
    weight.  Returns the rfft mesh at `r2chshape(final_shape)`."""
    if paint_shape is None:
        paint_shape = final_shape
    elif isinstance(paint_shape, float):
        paint_shape = scale_shape(final_shape, paint_shape)
    elif not isinstance(paint_shape, (tuple, list, np.ndarray)):
        raise ValueError("paint_shape must be None, a float, or a shape")
    paint_shape = tuple(int(s) for s in paint_shape)

    ratio = np.divide(paint_shape, final_shape)
    pos = pos * torch.as_tensor(ratio.astype(np.float32), device=pos.device)
    mesh = interlace(pos, paint_shape, weights, paint_order, interlace_order, kernel_type,
                     lattice_shape=lattice_shape, max_disp=max_disp, clip=clip,
                     scale=float(ratio.prod()), deconv=paint_deconv)
    if tuple(final_shape) != tuple(paint_shape):
        mesh = chreshape(mesh, r2chshape(final_shape))
    return mesh
