"""Hermitian real<->complex repacking and power-preserving Fourier resampling.

`rg2cgh` permutes and reweights a real Gaussian tensor into a complex Hermitian
tensor distributed exactly like `rfftn` of a white-noise field; `cgh2rg` is its
inverse.  Both are slices, flips and concatenations (contiguous copies).

Parity: `montecosmo_tpu/ops/hermitian.py:34-47, 143-413` (same packing, same
four norms; `boxreshape` :388).  `constrain_mesh` (a sharding hint) has no counterpart here.
"""
import numpy as np
import torch


def ch2rshape(shape):
    """Complex Hermitian (rfft) shape -> real shape (assumes even last dim)."""
    return (*shape[:-1], 2 * (shape[-1] - 1))


def r2chshape(shape):
    """Real shape -> complex Hermitian (rfft) shape."""
    return (*shape[:-1], shape[-1] // 2 + 1)


def scale_shape(shape: tuple, scale=1.0):
    """Nearest valid (even) scaled mesh shape."""
    out = 2 * np.rint(np.multiply(shape, scale) / 2).astype(int)
    return tuple(map(int, out))


def _base_weight(shape, norm):
    n = float(np.prod(shape))
    if norm == "backward":
        return (n / 2) ** 0.5
    if norm == "ortho":
        return 0.5 ** 0.5
    if norm == "forward":
        return 1 / (2 * n) ** 0.5
    if norm == "amp":
        return 1.0
    raise ValueError("norm must be one of ('backward', 'ortho', 'forward', 'amp')")


def _negx(a, axis=0):
    """Index map i -> (-i) mod N along `axis`."""
    head = a.narrow(axis, 0, 1)
    tail = torch.flip(a.narrow(axis, 1, a.shape[axis] - 1), (axis,))
    return torch.cat([head, tail], axis)


def _pack_line(col, Hx, corner_scale):
    """1D Hermitian line along x from a (Nx, ...) real column."""
    seg_r = col[1:Hx]
    seg_i = col[Hx + 1:]
    c0 = col[0:1] * corner_scale
    cH = col[Hx:Hx + 1] * corner_scale
    re = torch.cat([c0, seg_r, cH, torch.flip(seg_r, (0,))], 0)
    im = torch.cat([torch.zeros_like(c0), seg_i, torch.zeros_like(cH),
                    -torch.flip(seg_i, (0,))], 0)
    return re, im


def _pack_plane(p, corner_scale):
    """2D Hermitian plane (Nx, Ny) from a real (Nx, Ny) input plane."""
    Nx, Ny = p.shape[:2]
    Hx, Hy = Nx // 2, Ny // 2
    rows_r = p[:, 1:Hy]
    rows_i = p[:, Hy + 1:]
    mir_r = _negx(torch.flip(rows_r, (1,)), 0)
    mir_i = -_negx(torch.flip(rows_i, (1,)), 0)
    l0_r, l0_i = _pack_line(p[:, 0], Hx, corner_scale)
    lH_r, lH_i = _pack_line(p[:, Hy], Hx, corner_scale)
    re = torch.cat([l0_r[:, None], rows_r, lH_r[:, None], mir_r], 1)
    im = torch.cat([l0_i[:, None], rows_i, lH_i[:, None], mir_i], 1)
    return re, im


def rg2cgh(mesh, norm="backward"):
    """Real Gaussian tensor -> complex Gaussian Hermitian tensor.

    `rg2cgh(N(0,I), norm)` is distributed exactly as `rfftn(N(0,I), norm)`.
    norm='amp' returns the (real) RMS amplitude of the (real, imag) source
    pair, used to transport per-mode std fields into the real packing.
    """
    Nx, Ny, Nz = mesh.shape
    assert Nx % 2 == Ny % 2 == Nz % 2 == 0, "dimension lengths must be even."
    Hz = Nz // 2
    amp = norm == "amp"
    corner_scale = 1.0 if amp else 2**0.5

    bulk_r = mesh[:, :, 1:Hz]
    bulk_i = mesh[:, :, Hz + 1:]
    p0_r, p0_i = _pack_plane(mesh[:, :, 0], corner_scale)
    pH_r, pH_i = _pack_plane(mesh[:, :, Hz], corner_scale)
    re = torch.cat([p0_r[:, :, None], bulk_r, pH_r[:, :, None]], 2)
    im = torch.cat([p0_i[:, :, None], bulk_i, pH_i[:, :, None]], 2)

    if amp:
        im_amp = torch.where(im == 0, re, im)
        return ((re**2 + im_amp**2) / 2) ** 0.5
    w = _base_weight(mesh.shape, norm)
    return torch.complex(re * w, im * w)


def _unpack_line(re, im, Hx, corner_scale):
    return torch.cat([re[0:1] / corner_scale, re[1:Hx],
                      re[Hx:Hx + 1] / corner_scale, im[1:Hx]], 0)


def _unpack_plane(re, im, corner_scale):
    Nx, Ny = re.shape[:2]
    Hx, Hy = Nx // 2, Ny // 2
    l0 = _unpack_line(re[:, 0], im[:, 0], Hx, corner_scale)
    lH = _unpack_line(re[:, Hy], im[:, Hy], Hx, corner_scale)
    return torch.cat([l0[:, None], re[:, 1:Hy], lH[:, None], im[:, 1:Hy]], 1)


def cgh2rg(meshk, norm="backward"):
    """Complex Gaussian Hermitian tensor -> real Gaussian tensor (inverse of
    `rg2cgh`).  norm='amp' assigns to each real cell the real part of the
    coefficient it feeds; it also takes a real tensor."""
    shape = ch2rshape(meshk.shape)
    Hz = shape[2] // 2
    amp = norm == "amp"
    corner_scale = 1.0 if amp else 2**0.5
    if amp:
        re = im = meshk.real if meshk.is_complex() else meshk
    else:
        w = _base_weight(shape, norm)
        re, im = meshk.real / w, meshk.imag / w
    p0 = _unpack_plane(re[:, :, 0], im[:, :, 0], corner_scale)
    pH = _unpack_plane(re[:, :, Hz], im[:, :, Hz], corner_scale)
    return torch.cat([p0[:, :, None], re[:, :, 1:Hz], pH[:, :, None],
                      im[:, :, 1:Hz]], 2)


def hermitian_symmetric(arr):
    """out[i] = conj(arr[-i mod N]) over every axis."""
    for ax in range(arr.ndim):
        arr = torch.roll(torch.flip(arr, (ax,)), 1, ax)
    return arr.conj()


def _set_index(mesh, ax, i, value):
    """Out-of-place `mesh[..., i, ...] = value` along axis `ax`."""
    out = mesh.clone()
    out.select(ax, i).copy_(value)
    return out


def chreshape(mesh, shape):
    """Resample a complex Hermitian (rfft-layout) tensor to a new rfft `shape`,
    truncating or padding so that Hermitian symmetry and the mean coefficient
    power are preserved (Nyquist planes folded / split with 1/sqrt(2)
    weights), and the represented density field keeps its amplitude."""
    in_shape = tuple(mesh.shape)
    shape = tuple(int(s) for s in shape)
    if in_shape == shape:
        return mesh
    ndim = len(shape)
    scale = float(np.prod(np.divide(ch2rshape(shape), ch2rshape(in_shape))))

    # 1) fold Nyquist planes of truncated axes (last axis first)
    for ax in reversed(range(ndim)):
        ms, s = in_shape[ax], shape[ax]
        if s >= ms:
            continue
        if ax == ndim - 1:
            plane = mesh.select(ax, s - 1)
            plane = (plane + hermitian_symmetric(plane)) / 2**0.5
            mesh = _set_index(mesh, ax, s - 1, plane)
        else:
            pos, neg = s // 2, ms - s // 2
            folded = (mesh.select(ax, pos) + mesh.select(ax, neg)) / 2**0.5
            mesh = _set_index(mesh, ax, neg, folded)

    # 2) centered crop / pad, one axis at a time
    out = mesh
    for ax in range(ndim):
        ms, s = out.shape[ax], shape[ax]
        if s == ms:
            continue
        if ax == ndim - 1:
            if s < ms:
                out = out.narrow(ax, 0, s)
            else:
                pad_shape = list(out.shape)
                pad_shape[ax] = s - ms
                out = torch.cat([out, out.new_zeros(pad_shape)], ax)
        elif s < ms:
            out = torch.cat([out.narrow(ax, 0, s // 2),
                             out.narrow(ax, ms - s // 2, s // 2)], ax)
        else:
            pad_shape = list(out.shape)
            pad_shape[ax] = s - ms
            out = torch.cat([out.narrow(ax, 0, ms // 2), out.new_zeros(pad_shape),
                             out.narrow(ax, ms // 2, ms - ms // 2)], ax)

    # 3) split Nyquist planes of padded axes
    for ax in range(ndim):
        ms, s = in_shape[ax], shape[ax]
        if s <= ms:
            continue
        if ax == ndim - 1:
            out = _set_index(out, ax, ms - 1, out.select(ax, ms - 1) / 2**0.5)
        else:
            pos, neg = ms // 2, s - ms // 2
            half = out.select(ax, neg) / 2**0.5
            out = _set_index(out, ax, neg, half)
            out = _set_index(out, ax, pos, half)
    return out * scale


def boxreshape(mesh, shape):
    """Real-space centred pad or crop of a mesh to `shape` (even extents)."""
    shape = np.asarray(shape)
    ms = np.asarray(mesh.shape)
    assert np.all(shape % 2 == 0) and np.all(ms % 2 == 0), "dimension lengths must be even."
    half_down = np.maximum(ms - shape, 0) // 2
    mesh = mesh[tuple(slice(int(h), None if h == 0 else -int(h)) for h in half_down)]
    half_up = np.maximum(shape - np.asarray(mesh.shape), 0) // 2
    # torch.nn.functional.pad takes the last axis first
    pad = [int(p) for h in half_up[::-1] for p in (h, h)]
    return torch.nn.functional.pad(mesh, pad)


def mesh2masked(mesh, mask=None):
    """Extract the masked entries of a mesh (identity if mask is None)."""
    if mask is None:
        return mesh
    return mesh[..., mask]


def masked2mesh(masked, mask=None):
    """Scatter masked entries back into a zero mesh (identity if mask is None)."""
    if mask is None:
        return masked
    out = masked.new_zeros(masked.shape[:-1] + tuple(mask.shape))
    out[..., mask] = masked
    return out
