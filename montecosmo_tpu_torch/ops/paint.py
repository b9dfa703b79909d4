"""Mass assignment (paint), lattice-site reads, interlacing and the NUFFT.

The particle work of every model evaluation goes through three hand-written
kernels (sources in `montecosmo_tpu_torch/csrc/`):

* K1 `paint_cic`: CIC scatter of lattice-ordered particles, every interlace
  shift painted in one particle pass, each shifted position clamped to
  +-max_disp around its lattice site (the window contract of
  `montecosmo_tpu/ops/paint_window.py`); CUDA, atomic adds.
* K2 `paint_cic_adjoint`: its VJP, a gather of the cotangent meshes giving
  the weight and position gradients; CUDA, no atomics.
* K3 `nufft_epilogue`: the interlace phase sum, units jacobian and window
  deconvolution in one pass over the rfft grid; Triton.  Its backward is the
  same kernel with the conjugated phase.

Each wrapper launches its kernel for a CUDA tensor (or raises), and runs the
kernel's plain PyTorch version, kept in this module, for a CPU tensor.
`LAUNCHES` counts kernel launches.

Parity: `montecosmo_tpu/ops/paint.py:57-240` (paint, read_sites, interlace,
nufft) and `montecosmo_tpu/ops/paint_window.py:103-130` (window geometry and
the clamp to sites).  `read`, `read_multi` and `read_window` are not ported
yet (ROADMAP Queue B, B3).
"""
import ctypes
from dataclasses import dataclass
from itertools import product

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from montecosmo_tpu_torch.ops.fourier import bspline_hat, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import chreshape, r2chshape, scale_shape

LAUNCHES = {"paint_cic": 0, "paint_cic_adjoint": 0, "nufft_epilogue": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------- geometry
@dataclass(frozen=True)
class CICGeometry:
    """Static description of one interlaced CIC paint."""
    shape: tuple            # mesh (X, Y, Z)
    n_shift: int            # interlace shifts s/n_shift, s = 0..n_shift-1
    lattice: tuple = None   # particle lattice when clamping, else None
    stride: tuple = (1, 1, 1)
    H: tuple = (np.inf, np.inf, np.inf)


def cic_geometry(shape, n_shift=1, lattice_shape=None, max_disp=8, clip=False):
    """Geometry checks of `paint_window` (`_window_geometry`): the mesh must
    be a multiple of the particle lattice; the clamp bound is per axis."""
    shape = tuple(int(s) for s in shape)
    if lattice_shape is None or not clip:
        return CICGeometry(shape, int(n_shift))
    lattice = tuple(int(s) for s in lattice_shape)
    _require(all(m % l == 0 for m, l in zip(shape, lattice)),
             f"mesh {shape} must be a multiple of lattice {lattice}")
    stride = tuple(m // l for m, l in zip(shape, lattice))
    H = tuple(float(int(h)) for h in np.broadcast_to(max_disp, (3,)))
    return CICGeometry(shape, int(n_shift), lattice, stride, H)


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


def _corners(x, shape):
    """Floor cell, fraction, and the 8 (flat wrapped index, weight factors)."""
    i0 = torch.floor(x)
    f = x - i0
    i0 = i0.long()
    n = torch.tensor(shape, device=x.device)
    lo = torch.remainder(i0, n)
    hi = torch.remainder(i0 + 1, n)
    return lo, hi, f


def _flat(ix, iy, iz, shape):
    return (ix * shape[1] + iy) * shape[2] + iz


# ------------------------------------------------------------ K1 / K2 plain
def paint_cic_plain(pos, weights, geom: CICGeometry):
    """Plain PyTorch K1: (S, X, Y, Z) meshes, differentiable by autograd."""
    P = pos.shape[0]
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=pos.dtype, device=pos.device), (P,))
    N = int(np.prod(geom.shape))
    meshes = []
    for _, x, _ in _shifted(pos, geom):
        lo, hi, f = _corners(x, geom.shape)
        mesh = pos.new_zeros(N)
        for a, b, c in product((0, 1), repeat=3):
            ix = (hi if a else lo)[:, 0]
            iy = (hi if b else lo)[:, 1]
            iz = (hi if c else lo)[:, 2]
            wx = f[:, 0] if a else 1 - f[:, 0]
            wy = f[:, 1] if b else 1 - f[:, 1]
            wz = f[:, 2] if c else 1 - f[:, 2]
            mesh = mesh.index_add(0, _flat(ix, iy, iz, geom.shape), w * (wx * wy * wz))
        meshes.append(mesh.reshape(geom.shape))
    return torch.stack(meshes)


def paint_cic_adjoint_plain(pos, weights, grads, geom: CICGeometry):
    """Plain PyTorch K2: gather the (S, X, Y, Z) cotangents at each
    particle's corners -> (dpos (P, 3), dweights (P,)).  dpos is zero on the
    axes where the clamp was active."""
    dw = torch.zeros_like(weights)
    dpos = torch.zeros_like(pos)
    for s, (v, x, sites) in enumerate(_shifted(pos, geom)):
        lo, hi, f = _corners(x, geom.shape)
        g = grads[s].reshape(-1)
        ds = torch.zeros_like(pos)
        for a, b, c in product((0, 1), repeat=3):
            val = g[_flat((hi if a else lo)[:, 0], (hi if b else lo)[:, 1],
                          (hi if c else lo)[:, 2], geom.shape)]
            wx = f[:, 0] if a else 1 - f[:, 0]
            wy = f[:, 1] if b else 1 - f[:, 1]
            wz = f[:, 2] if c else 1 - f[:, 2]
            sx, sy, sz = (1.0 if a else -1.0), (1.0 if b else -1.0), (1.0 if c else -1.0)
            dw = dw + val * (wx * wy * wz)
            ds = ds + val[:, None] * torch.stack(
                [sx * wy * wz, wx * sy * wz, wx * wy * sz], -1)
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
            + [ctypes.c_int(int(geom.lattice is not None)), ctypes.c_int(geom.n_shift)])


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
    LAUNCHES["paint_cic"] += 1
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
    LAUNCHES["paint_cic_adjoint"] += 1
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
              clip=False):
    """Interlaced CIC paint: (n_shift, *shape) meshes, shift s painted at
    pos + s/n_shift.  With `lattice_shape` and clip=True, each shifted
    position is clamped to +-max_disp cells around its lattice site."""
    geom = cic_geometry(shape, n_shift, lattice_shape, max_disp, clip)
    pos = pos.reshape(-1, 3).contiguous()
    w = torch.as_tensor(weights, dtype=pos.dtype, device=pos.device)
    w = torch.broadcast_to(w.reshape(-1) if w.ndim else w, pos.shape[:1]).contiguous()
    return _PaintCIC.apply(pos, w, geom)


# ------------------------------------------------------------------ paint
def _cic_only(order, kernel_type):
    if order != 2 or kernel_type != "rectangular":
        raise NotImplementedError(
            "only the order-2 rectangular (CIC) window is ported; orders 1/3/4 and "
            "Kaiser-Bessel windows are ROADMAP Queue B, B1")


def paint(pos, shape: tuple, weights=1.0, order: int = 2, kernel_type="rectangular", *,
          lattice_shape=None, max_disp=8, clip=False):
    """Scatter particle `weights` onto a mesh of `shape` (positions in cell
    units, periodic): K1 with one shift.  With `lattice_shape` and
    clip=True, positions are clamped to +-max_disp around their sites."""
    _cic_only(order, kernel_type)
    return paint_cic(pos, shape, weights, 1, lattice_shape, max_disp, clip)[0]


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
    LAUNCHES["nufft_epilogue"] += 1
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
    _cic_only(paint_order, kernel_type)
    shape = tuple(int(s) for s in shape)
    meshes = paint_cic(pos, shape, weights, interlace_order, lattice_shape, max_disp, clip)
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
