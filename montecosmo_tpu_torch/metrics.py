"""Summary statistics: the multipole power spectrum (the `powspec`
observable), the bispectrum, transfer and coherence against a reference
mesh, the binned MSEs and distributions, error bars, the Kaiser multipoles,
the curved-sky mu^2 operators, the window's Wigner 3j coefficients, and the
chains' diagnostics (ESS, Gelman-Rubin).

The spectrum's plan is host numpy, built once per geometry (`spectrum_plan`,
cached with its device tensors by `_plan`): the bin of every rfft mode and
one weight per mode and multipole that folds in the Hermitian multiplicity,
the (2 ell + 1) Legendre weight, the per-bin mode count and the units.  On
the device the estimator is then one segment sum of |delta_k|^2 times those
weights, K9 (`ops/segment.py::segment_sum`), whose backward is its gather.

The bispectrum (`bispectrum`) filters the rfft mesh into its k-shells with
`torch.fft` (cuFFT on the card), one inverse transform a shell for the
field and one for unit amplitudes, and takes every closed triangle's sums
over the cells in one kernel, K10 (`ops/bispectrum.py`).  The value
binning (`bin_and_aggregate` and what calls it), the angular
distribution, the error bars, `real_sph_harm` and the Wigner coefficients
are host numpy, as in the JAX package.

Parity: `montecosmo_tpu/metrics.py:27-186` (kbin_edges, _kmu_grid,
spectrum_plan, _segment_reduce, _spectrum, spectrum), `:179` (bispectrum),
`:250-278` (transfer, coherence, powtranscoh), `:280-412`
(bin_and_aggregate, mse_radius, mse_value, mse_wave, distr_radial,
distr_angular, mean_errorbar, var_errorbar), `:415` (kaiser_formula),
`:436-494` (real_sph_harm, naive_mu2_delta, _y2_cartesian,
optim_mu2_delta), `:501-543` (_wigner3j_zero_sq, wigner3j_square) and
`:545-606` (effective_sample_size, gelman_rubin, geomean, harmean,
multi_ess, multi_gr).  The plan is the JAX package's numpy, copied (the
port imports nothing of it).
"""
import math
from functools import lru_cache

import numpy as np
import torch
from scipy.special import factorial, legendre, lpmv

from montecosmo_tpu_torch.ops.bispectrum import bispectrum_triples
from montecosmo_tpu_torch.ops.fourier import bspline_hat, irfftn, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import ch2rshape
from montecosmo_tpu_torch.ops.segment import segment_sum
from montecosmo_tpu_torch.utils.io import to_np
from montecosmo_tpu_torch.utils.safe import safe_div


# ----------------------------------------------------------------------- binning
def _rfftk64(mesh_shape, box_size):
    """Broadcast-shaped float64 rfft wavevectors in h/Mpc (numpy)."""
    dim = len(mesh_shape)
    kvec = ()
    for ax, (s, b) in enumerate(zip(mesh_shape, box_size)):
        freq = np.fft.rfftfreq(s) if ax == dim - 1 else np.fft.fftfreq(s)
        shape = [1] * dim
        shape[ax] = -1
        kvec += ((freq * (2 * np.pi * s / b)).reshape(shape),)
    return kvec


def kbin_edges(mesh_shape, box_size, kedges=None, include_corners=True):
    """Closed-form k-bin edges: [0, kmax) in steps of sqrt(d) k_fund by
    default; kmax the smallest axis Nyquist (include_corners=False) or the
    corner |k_Nyq|.  An int is a number of bins, a float a width, an array
    the edges themselves."""
    box = np.broadcast_to(np.asarray(box_size, float), (len(mesh_shape),))
    knyq = np.pi * np.asarray(mesh_shape) / box
    kmax = float(np.linalg.norm(knyq)) if include_corners else float(knyq.min())
    if not isinstance(kedges, (type(None), int, float)):
        return np.asarray(kedges)
    if kedges is None:
        n_edges = max(int(kmax / (len(mesh_shape) ** 0.5 * 2 * np.pi / box.min())), 1)
    elif isinstance(kedges, int):
        n_edges = kedges
    else:
        n_edges = max(int(kmax / kedges), 1)
    return np.linspace(0.0, kmax, n_edges, endpoint=False) + kmax / n_edges / 2


def _kmu_grid(mesh_shape, box_size, los=(0.0, 0.0, 0.0)):
    """Numpy |k| mesh, mu mesh and Hermitian multiplicity over the rfft
    grid (modes with 0 < kz < Nyquist also stand for their conjugates)."""
    kvec = _rfftk64(tuple(mesh_shape), tuple(box_size))
    kmesh = np.sqrt(sum(ki**2 for ki in kvec))
    kpar = sum(ki * li for ki, li in zip(kvec, los))
    mumesh = np.divide(kpar, kmesh, out=np.zeros(kmesh.shape), where=kmesh > 0)
    mult = np.full(kmesh.shape, 2.0)
    mult[..., 0] = 1.0
    if mesh_shape[-1] % 2 == 0:
        mult[..., -1] = 1.0
    return kmesh, mumesh, mult


def spectrum_plan(mesh_shape, box_size=None, kedges=None, ells=(0,), include_corners=True,
                  los=(0.0, 0.0, 0.0)):
    """Host-side plan of the multipole spectra of an rfft mesh: seg
    (n_modes,) int32 bin ids (nb: out of range, the trash segment), wl
    (n_modes, n_ell) float32 per-mode weights, kedges, kmean, nmodes, nb,
    so that P_ell[bin] = sum over the modes of the bin of |delta_m|^2
    wl[m, ell]."""
    return _plan_and_grid(mesh_shape, box_size, kedges, ells, include_corners, los)[0]


def _plan_and_grid(mesh_shape, box_size, kedges, ells, include_corners, los):
    """`spectrum_plan` and the `_kmu_grid` (k, mu, multiplicity) it bins."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    box = (np.asarray(mesh_shape, float) if box_size is None
           else np.broadcast_to(np.asarray(box_size, float), (len(mesh_shape),)))
    kedges = kbin_edges(mesh_shape, box, kedges, include_corners)
    nb = len(kedges) - 1
    kmesh, mumesh, mult = _kmu_grid(mesh_shape, box, los)

    k = kmesh.reshape(-1)
    seg = np.searchsorted(kedges, k, side="right").astype(np.int32) - 1
    seg = np.where((seg < 0) | (seg >= nb), nb, seg)
    w = mult.reshape(-1)
    inbin = seg < nb

    nmodes = np.zeros(nb)
    np.add.at(nmodes, seg[inbin], w[inbin])
    ksum = np.zeros(nb)
    np.add.at(ksum, seg[inbin], (k * w)[inbin])
    kmean = ksum / np.maximum(nmodes, 1.0)

    unit = float(np.prod(box / np.asarray(mesh_shape, float) ** 2))
    inv_n = unit / np.maximum(nmodes, 1.0)
    per_mode = w * np.concatenate([inv_n, [0.0]])[seg]
    mu = np.broadcast_to(mumesh, kmesh.shape).reshape(-1)
    wl = np.stack([(2 * int(ell) + 1) * legendre(int(ell))(mu) * per_mode for ell in ells],
                  axis=-1)
    plan = dict(seg=seg, wl=np.asarray(wl, np.float32), kedges=np.asarray(kedges), kmean=kmean,
                nmodes=nmodes, nb=nb)
    return plan, (kmesh, mumesh, mult)


def _key(x):
    """A hashable form of a kedges / box / los argument."""
    if x is None or isinstance(x, (int, float)):
        return x
    return tuple(np.asarray(x, float).reshape(-1).tolist())


@lru_cache(maxsize=16)
def _plan_cached(mesh_shape, box, kedges, ells, include_corners, los, device):
    kedges = np.asarray(kedges) if isinstance(kedges, tuple) else kedges
    plan, grid = _plan_and_grid(mesh_shape, None if box is None else np.asarray(box), kedges,
                                ells, include_corners, np.asarray(los))
    seg = torch.as_tensor(plan["seg"], device=device)
    wl = torch.as_tensor(plan["wl"], device=device)
    empty = torch.as_tensor(plan["nmodes"] == 0, device=device)
    return plan, seg, wl, empty, grid


def _plan(mesh_shape, box_size, kedges, ells, include_corners, los, device):
    """`spectrum_plan`, its seg, wl and empty-bin tensors on `device`, and
    its host (k, mu, multiplicity) grid, built once per geometry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _plan_cached(tuple(int(s) for s in mesh_shape), _key(box_size), _key(kedges),
                        tuple(int(e) for e in ells), bool(include_corners), _key(los),
                        str(device))


def _segment_reduce(data, seg, nb):
    """Sum `data` (n_modes, ...) into nb k-bins (+1 trash bin, dropped): K9
    on the card."""
    return segment_sum(data, seg, nb + 1)[:nb]


def _spectrum(mesh0, mesh1=None, box_size=None, box_center=(0.0, 0.0, 0.0), ells=0, kedges=None,
              include_corners=True, deconv=(0, 0), los=None):
    """Auto or cross multipole power spectrum of 3-D fields (real meshes or
    their rffts): (kcount, kmean, P_ell or {ell: P_ell}).  `los` overrides
    the box-center line of sight.  Device side: the mode power times the
    plan's weights, one segment sum (K9); empty bins are NaN."""
    if los is None:
        box_center = np.asarray(box_center, float)
        los = safe_div(box_center, np.linalg.norm(box_center))
    if isinstance(deconv, int):
        deconv = (deconv, deconv)
    if not mesh0.is_complex():
        mesh_shape = tuple(mesh0.shape)
        mesh0 = rfftn(mesh0)
    else:
        mesh_shape = ch2rshape(mesh0.shape)
    kvec = rfftk(mesh_shape, device=mesh0.device)  # cell units
    if deconv[0]:
        mesh0 = mesh0 / bspline_hat(kvec, order=deconv[0])
    if mesh1 is not None:
        if not mesh1.is_complex():
            mesh1 = rfftn(mesh1)
        if deconv[1]:
            mesh1 = mesh1 / bspline_hat(kvec, order=deconv[1])

    ells_tup = tuple(int(e) for e in np.atleast_1d(ells))
    plan, seg, wl, empty, _ = _plan(mesh_shape, box_size, kedges, ells_tup, include_corners, los,
                                    mesh0.device)
    nb = plan["nb"]
    if mesh1 is None:
        power = (mesh0.real**2 + mesh0.imag**2).reshape(-1, 1)
        ptab = _segment_reduce(power * wl, seg, nb)
    else:
        cross = (mesh0 * mesh1.conj()).reshape(-1, 1)
        # (re, im) as a trailing real axis: one segment sum, then the
        # modulus per (bin, ell)
        parts = torch.stack([cross.real * wl, cross.imag * wl], -1)
        flat = _segment_reduce(parts.reshape(parts.shape[0], -1), seg, nb)
        flat = flat.reshape(nb, len(ells_tup), 2)
        ptab = torch.hypot(flat[..., 0], flat[..., 1])

    nan = torch.full((), float("nan"), dtype=ptab.dtype, device=ptab.device)
    pows = {ell: torch.where(empty, nan, ptab[:, i]) for i, ell in enumerate(ells_tup)}
    kcount = plan["nmodes"]
    kmean = np.where(kcount > 0, plan["kmean"], np.nan)
    if isinstance(ells, int):
        return kcount, kmean, pows[ells]
    return kcount, kmean, pows


def spectrum(mesh0, mesh1=None, box_size=None, box_center=(0.0, 0.0, 0.0), ells=0, kedges=None,
             include_corners=True, los=None):
    """Multipole auto or cross power spectrum: (k_mean, P_ell or {ell:
    P_ell})."""
    _, kmean, pows = _spectrum(mesh0, mesh1, box_size, box_center, ells, kedges,
                               include_corners, los=los)
    return kmean, pows


def _closed_triples(kedges, kmean, open_triangles):
    """Bin triples i <= j <= l that can close a triangle: k_i + k_j >= k_l
    at the bin means, or (`open_triangles`) at the bin edges."""
    n_bins = len(kedges) - 1
    lo, hi = kedges[:-1], kedges[1:]
    triples = []
    for i in range(n_bins):
        for j in range(i, n_bins):
            for l in range(j, n_bins):
                closes = (hi[i] + hi[j] >= lo[l]) if open_triangles \
                    else (kmean[i] + kmean[j] >= kmean[l])
                if closes:
                    triples.append((i, j, l))
    return np.asarray(triples, np.int32).reshape(-1, 3)


SHELL_CHUNK = 8  # k-shells inverse-transformed together by `_shell_fields`


def _shell_fields(meshk, seg, n_bins, mesh_shape, unit=False):
    """(n_bins, N) real fields, each the inverse rfft of `meshk` (or, with
    `unit`, of ones) restricted to one k-shell of `seg`; SHELL_CHUNK shells
    are transformed together."""
    out = []
    for b0 in range(0, n_bins, SHELL_CHUNK):
        bins = torch.arange(b0, min(b0 + SHELL_CHUNK, n_bins), device=seg.device)
        mask = (seg == bins.reshape(-1, 1, 1, 1)).to(meshk.real.dtype)
        spec = mask.to(meshk.dtype) if unit else meshk * mask
        out.append(torch.fft.irfftn(spec, s=tuple(mesh_shape), dim=(-3, -2, -1)).reshape(
            len(bins), -1))
    return torch.cat(out)


def _bispectrum_inputs(mesh, box_size=None, kedges=None, open_triangles=False,
                       los=(0.0, 0.0, 0.0)):
    """What K10 takes for the bispectrum of `mesh` (real, or its rfft):
    (F, U, triples, plan).  F and U are the (B, N) shell-filtered and
    unit-amplitude fields, triples the (T, 3) int32 closed triples, sorted
    by (i, j, l), on the mesh's device; plan the spectrum plan of the
    shells."""
    if not mesh.is_complex():
        mesh_shape = np.array(mesh.shape)
        mesh = rfftn(mesh)
    else:
        mesh_shape = np.array(ch2rshape(mesh.shape))
    box_size = mesh_shape if box_size is None else np.asarray(box_size)
    plan, seg, _, _, _ = _plan(tuple(mesh_shape), box_size, kedges, (0,), False,
                               np.asarray(los, float), mesh.device)
    seg = seg.reshape(mesh.shape)
    F = _shell_fields(mesh, seg, plan["nb"], mesh_shape)
    U = _shell_fields(mesh, seg, plan["nb"], mesh_shape, unit=True)
    triples = _closed_triples(plan["kedges"], plan["kmean"], open_triangles)
    return F, U, torch.as_tensor(triples, device=mesh.device), plan


def bispectrum(mesh, box_size=None, kedges=None, open_triangles=False, los=(0.0, 0.0, 0.0)):
    """The FFT binned bispectrum monopole (Scoccimarro estimator).  For
    every bin triple (i <= j <= l) that can close a triangle,

        B(i, j, l) = V^2 / N^9 * mean_x[F_i F_j F_l] / mean_x[I_i I_j I_l],

    F_b the inverse rfft of the mesh restricted to bin b, I_b the same of
    unit amplitudes (its triple mean times N^3 counts the closed triangles;
    a triple with less than half a triangle is 0).  The triple sums are K10
    on the card.  `open_triangles` keeps the triples whose bin edges, not
    centres, close.

    V^2 / N^9 is taken in floats: the JAX package's integer N^3 wraps past
    int64 from 2^21 cells (128^3) on.

    Returns (kmean, triples (n_tri, 3) int32 bin indices, B (n_tri,) in the
    mesh's real dtype, modes per bin)."""
    fs, ones, triples, plan = _bispectrum_inputs(mesh, box_size, kedges, open_triangles, los)
    sums = bispectrum_triples(fs, ones, triples)

    n_cells = float(fs.shape[1])
    volume = n_cells if box_size is None else float(np.prod(box_size, dtype=float))
    norm = volume**2 / n_cells**3
    num, den = sums[:, 0] / n_cells, sums[:, 1] / n_cells
    n_tri = den * n_cells**3
    bs = torch.where(n_tri > 0.5, norm * safe_div(num, den), torch.zeros_like(num))
    return plan["kmean"], triples.cpu().numpy(), bs.to(fs.dtype), plan["nmodes"]


def transfer(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """(k, (P1/P0)^1/2) per k-bin."""
    ks, pow0 = spectrum(mesh0, box_size=box_size, kedges=kedges, include_corners=include_corners)
    ks, pow1 = spectrum(mesh1, box_size=box_size, kedges=kedges, include_corners=include_corners)
    return ks, (pow1 / pow0) ** 0.5


def coherence(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """(k, P01 / (P0 P1)^1/2) per k-bin."""
    kw = dict(box_size=box_size, kedges=kedges, include_corners=include_corners)
    ks, pow01 = spectrum(mesh0, mesh1, **kw)
    ks, pow0 = spectrum(mesh0, **kw)
    ks, pow1 = spectrum(mesh1, **kw)
    return ks, pow01 / (pow0 * pow1) ** 0.5


def powtranscoh(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """(k, P1, transfer, coherence) of mesh1 against the reference mesh0."""
    kw = dict(box_size=box_size, kedges=kedges, include_corners=include_corners)
    ks, pow01 = spectrum(mesh0, mesh1, **kw)
    ks, pow0 = spectrum(mesh0, **kw)
    ks, pow1 = spectrum(mesh1, **kw)
    return ks, pow1, (pow1 / pow0) ** 0.5, pow01 / (pow0 * pow1) ** 0.5


# ----------------------------------------------------------------------- value binning
def bin_and_aggregate(targets, values, vedges, min_count=1, aggr_fn=None):
    """Bin `targets` by `values` and aggregate per bin (the mean by
    default); with `min_count` None, `vedges` are quantiles.  Host numpy.
    Returns (counts, value means, aggregated targets)."""
    targets = to_np(targets).reshape(-1)
    values = to_np(values).reshape(-1)
    assert len(targets) == len(values), "targets and values must have same length."

    if isinstance(vedges, (int, float)):
        vmin, vmax = (0.0, 1.0) if min_count is None else (values.min(), values.max())
        n_vedges = vedges if isinstance(vedges, int) else max(int((vmax - vmin) / vedges), 1)
        dv = (vmax - vmin) / n_vedges
        vedges = np.linspace(vmin, vmax, n_vedges, endpoint=False) + dv / 2
    if min_count is None:
        vedges = np.quantile(values, q=vedges)
        min_count = 1

    n_bins = len(vedges) + 1
    dig = np.digitize(values, vedges)
    vcount = np.bincount(dig, minlength=n_bins)[1:-1]
    keep = vcount >= min_count
    vcount = vcount[keep]
    vmean = np.bincount(dig, weights=values, minlength=n_bins)[1:-1][keep] / vcount
    if aggr_fn is None:
        taggr = np.bincount(dig, weights=targets, minlength=n_bins)[1:-1][keep] / vcount
    else:
        taggr = np.array([aggr_fn(targets[dig == i]) for i in range(1, n_bins - 1)])[keep]
    return vcount, vmean, taggr


def mse_radius(mesh0, mesh1, rmesh, cell_length, redges=None, aggr_fn=None):
    """The MSE between two meshes binned by radius, in (Mpc/h)^3."""
    if redges is None:
        redges = 3**0.5 * cell_length  # the least dr of connected shells
    se = (to_np(mesh0) - to_np(mesh1)) ** 2 * cell_length**3
    return bin_and_aggregate(se, rmesh, redges, aggr_fn=aggr_fn)


def mse_value(mesh0, mesh1, cell_length, vedges, min_count=None, aggr_fn=None):
    """The MSE between two meshes binned by the value of mesh0, in
    (Mpc/h)^3."""
    se = (to_np(mesh0) - to_np(mesh1)) ** 2 * cell_length**3
    return bin_and_aggregate(se, mesh0, vedges, min_count=min_count, aggr_fn=aggr_fn)


def mse_wave(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """The MSE between two meshes binned by wavenumber (the power of their
    difference): (kcount, kmean, P)."""
    return _spectrum(mesh1 - mesh0, box_size=box_size, kedges=kedges,
                     include_corners=include_corners)


def distr_radial(mesh, rmesh, cell_length, redges=None, aggr_fn=None):
    """The radial distribution of a mesh, in (h/Mpc)^3."""
    if redges is None:
        redges = 3**0.5 * cell_length
    rcount, rmean, maggr = bin_and_aggregate(mesh, rmesh, redges, aggr_fn=aggr_fn)
    return rcount, rmean, maggr / cell_length**3


def distr_angular(mesh, pos_mesh, n_costheta=12, n_phi=24, min_count=1, aggr_fn=None):
    """The angular distribution of a mesh per steradian: cells binned by
    their direction from the observer on an equal-area (cos theta, phi)
    grid (each bin 4 pi / n_bins sr), the mesh summed per bin (or
    `aggr_fn`).  `pos_mesh` (..., 3) are observer-centred positions.
    Returns (counts, (costheta centres, phi centres), aggregate) for the
    bins of at least `min_count` cells, costheta-major."""
    mesh = to_np(mesh).reshape(-1)
    pos = to_np(pos_mesh).reshape(-1, 3)
    assert len(mesh) == len(pos), "mesh and pos_mesh must match."

    r = np.maximum(np.sqrt((pos**2).sum(-1)), 1e-30)
    cost = np.clip(pos[:, 2] / r, -1.0, 1.0)
    phi = np.arctan2(pos[:, 1], pos[:, 0])
    ic = np.minimum(((cost + 1.0) / 2.0 * n_costheta).astype(int), n_costheta - 1)
    ip = np.minimum(((phi + np.pi) / (2 * np.pi) * n_phi).astype(int), n_phi - 1)
    dig = ic * n_phi + ip
    n_bins = n_costheta * n_phi

    count = np.bincount(dig, minlength=n_bins)
    keep = count >= min_count
    solid = 4.0 * np.pi / n_bins
    if aggr_fn is None:
        aggr = np.bincount(dig, weights=mesh, minlength=n_bins) / solid
    else:
        aggr = np.array([aggr_fn(mesh[dig == i]) if keep[i] else 0.0 for i in range(n_bins)])
    cost_c = -1.0 + (np.arange(n_costheta) + 0.5) * 2.0 / n_costheta
    phi_c = -np.pi + (np.arange(n_phi) + 0.5) * 2.0 * np.pi / n_phi
    centers = (np.repeat(cost_c, n_phi)[keep], np.tile(phi_c, n_costheta)[keep])
    return count[keep], centers, aggr[keep]


# ----------------------------------------------------------------------- error bars
def mean_errorbar(count, std, confidence=0.95, gaussian_approx=False):
    """(lo, hi) error bar of a sample mean (Student t, or Gaussian)."""
    from scipy.stats import norm, t
    count, std = np.asarray(count), to_np(std)
    if not gaussian_approx:
        df = count - 1
        lo, hi = t(df=df).interval(confidence)
        return np.stack((-std / df**0.5 * lo, std / df**0.5 * hi))
    hi = norm.interval(confidence)[1] * std / count**0.5
    return np.stack((hi, hi))


def var_errorbar(count, var, confidence=0.95, gaussian_approx=False):
    """(lo, hi) error bar of a sample variance (chi^2, or Gaussian)."""
    from scipy.stats import chi2, norm
    count, var = np.asarray(count), to_np(var)
    if not gaussian_approx:
        lo, hi = chi2(df=count).interval(confidence)
        lo, hi = var * count / hi, var * count / lo
        return np.stack((var - lo, hi - var))
    hi = var * (2 / count) ** 0.5 * norm.interval(confidence)[1]
    return np.stack((hi, hi))


# ----------------------------------------------------------------------- Kaiser multipoles
_KAISER = {0: lambda b: 1 + b * 2 / 3 + b**2 / 5,
           2: lambda b: b * 4 / 3 + b**2 * 4 / 7,
           4: lambda b: b**2 * 8 / 35}


def kaiser_formula(bg, a, lin_kpow, b1E, ells=0):
    """The analytic Kaiser multipoles P_ell(k) (ell in 0, 2, 4) of Eulerian
    bias b1E at scale factor `a` on the background `bg`, from the linear
    spectrum (k, P_lin(k)) at a = 1: (k, P (..., n_ell, n_k))."""
    ells = np.atleast_1d(np.asarray(ells))
    a = torch.as_tensor(a, dtype=torch.float32, device=bg.g_tab.device)
    beta = bg.a2f(a) / b1E
    k, pows = lin_kpow
    pows = torch.as_tensor(pows, device=a.device) * bg.a2g(a) ** 2
    weights = []
    for ell in ells:
        if int(ell) not in _KAISER:
            raise NotImplementedError(f"ell={ell} not in (0, 2, 4)")
        weights.append(b1E**2 * _KAISER[int(ell)](beta))
    return k, torch.movedim(pows[..., None] * torch.stack(weights, -1), -1, -2)


# ----------------------------------------------------------------------- curved-sky mu^2
def real_sph_harm(l, m, theta, phi):
    """The real spherical harmonic Y(l, m) at colatitude theta, longitude
    phi (host numpy, scipy's associated Legendre functions)."""
    m_abs = abs(m)
    norm = ((2 * l + 1) / (4 * np.pi) * factorial(l - m_abs) / factorial(l + m_abs)) ** 0.5
    asso = lpmv(m_abs, l, np.cos(theta))
    if m > 0:
        return 2**0.5 * norm * asso * np.cos(m * phi)
    if m < 0:
        return 2**0.5 * norm * asso * np.sin(m_abs * phi)
    return norm * asso


def naive_mu2_delta(mesh, los):
    """The (k.los/|k|)^2-weighted field by two successive mu projections
    (eight FFTs): `mesh` an rfft mesh, `los` (..., 3) per cell."""
    mesh_shape = ch2rshape(mesh.shape)
    kvec = rfftk(mesh_shape, device=mesh.device)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    mu_delta = torch.stack([irfftn(safe_div(kvec[i] * mesh, kmesh)) for i in range(3)], -1)
    mu_delta = rfftn((mu_delta * los).sum(-1))
    mu2_delta = torch.stack([irfftn(safe_div(kvec[i] * mu_delta, kmesh)) for i in range(3)], -1)
    return (mu2_delta * los).sum(-1)


def _y2_cartesian(u):
    """The five real l = 2 spherical harmonics of a unit vector field
    (..., 3), in closed cartesian form."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c15 = 0.5 * np.sqrt(15 / np.pi)
    c5 = 0.25 * np.sqrt(5 / np.pi)
    return (c15 * x * y,                      # m = -2
            c15 * y * z,                      # m = -1
            c5 * (3 * z**2 - 1),              # m = 0 (unit vector)
            c15 * z * x,                      # m = +1
            0.5 * c15 * (x**2 - y**2))        # m = +2


def optim_mu2_delta(mesh, los):
    """The mu^2-weighted field through the Y_2m decomposition of mu^2 (six
    irffts): mu^2 = 1/3 + 8 pi / 15 sum_m Y_2m(k-hat) Y_2m(r-hat).  `mesh`
    is an rfft mesh, `los` the per-cell unit line of sight (X, Y, Z, 3)
    (it may carry a gradient: on the light cone it depends on the
    cosmology).  Returns (delta, mu2_delta) in real space."""
    mesh_shape = ch2rshape(mesh.shape)
    kvec = rfftk(mesh_shape, device=mesh.device)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    khat = torch.stack([safe_div(torch.broadcast_to(ki, mesh.shape), kmesh) for ki in kvec], -1)
    ylos = _y2_cartesian(los)
    yk = _y2_cartesian(khat)

    delta = irfftn(mesh)
    mu2_delta = delta / 3
    for yl, ykm in zip(ylos, yk):
        mu2_delta = mu2_delta + 8 * np.pi / 15 * yl * irfftn(ykm * mesh)
    return delta, mu2_delta


# ----------------------------------------------------------------------- window convolution
def _wigner3j_zero_sq(l1, l2, l3):
    """The exact squared Wigner 3j symbol (l1 l2 l3; 0 0 0)^2 as a Fraction
    (Edmonds 1957 eq. 3.7.17); zero when l1 + l2 + l3 is odd or the
    triangle inequality fails."""
    from fractions import Fraction

    total = l1 + l2 + l3
    if total % 2 or not abs(l1 - l2) <= l3 <= l1 + l2:
        return Fraction(0)
    g = total // 2
    f = math.factorial
    D = Fraction(f(2 * (g - l1)) * f(2 * (g - l2)) * f(2 * (g - l3)), f(2 * g + 1))
    binom = Fraction(f(g), f(g - l1) * f(g - l2) * f(g - l3))
    return D * binom * binom


def wigner3j_square(ellout, ellin, prefactor=True):
    """The Legendre-product coefficients of the window convolution,
    P_ellout P_ellin = sum_L (2L+1) (ellout ellin L; 000)^2 P_L, with the
    (2 ellout + 1)/(2L+1) window-matrix prefactor by default, exact in
    rational arithmetic.  Returns (L values ascending, coefficients)."""
    from fractions import Fraction

    ells, coeffs = [], []
    for L in range(abs(ellout - ellin), ellout + ellin + 1, 2):
        c = (2 * L + 1) * _wigner3j_zero_sq(ellout, ellin, L)
        if prefactor:
            c *= Fraction(2 * ellout + 1, 2 * L + 1)
        ells.append(L)
        coeffs.append(float(c))
    return ells, coeffs


# ----------------------------------------------------------------------- chain diagnostics
def _draws(x):
    """Draws (n_chains, n_samples, ...) as a tensor (numpy float32 ->
    float32, float64 -> float64)."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def effective_sample_size(x):
    """ESS per parameter from (n_chains, n_samples, ...) draws: the
    initial-monotone-positive-sequence autocorrelation estimator (Geyer
    1992, as in Vehtari+2021), autocovariances by FFT."""
    x = _draws(x)
    n_chains, n_samples = x.shape[:2]
    xc = x - x.mean(1, keepdim=True)
    n_fft = int(2 ** np.ceil(np.log2(2 * n_samples)))
    f = torch.fft.rfft(xc, n=n_fft, dim=1)
    acov = torch.fft.irfft(f * f.conj(), n=n_fft, dim=1)[:, :n_samples] / n_samples

    within = acov[:, 0].mean(0)
    var_plus = within * (n_samples - 1) / n_samples
    if n_chains > 1:
        var_plus = var_plus + x.mean(1).var(0, unbiased=True)
    rho = 1.0 - (within - acov.mean(0)) / var_plus
    rho[0] = 1.0

    # paired sums, up to the first negative pair (monotone-positive sequence)
    n_pairs = n_samples // 2
    paired = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(1)
    mask = torch.cumprod((paired > 0).to(paired.dtype), 0)
    paired = torch.minimum(paired, torch.cat(
        [paired[:1], torch.cummin(paired, 0).values[:-1]], 0))
    tau = -1.0 + 2.0 * (paired * mask).sum(0)
    return n_chains * n_samples / torch.clamp(tau, min=1e-8)


def gelman_rubin(x):
    """The split-free potential scale reduction factor of (n_chains,
    n_samples, ...) draws."""
    x = _draws(x)
    n_samples = x.shape[1]
    W = x.var(1, unbiased=True).mean(0)
    B = n_samples * x.mean(1).var(0, unbiased=True)
    return torch.sqrt(((n_samples - 1) / n_samples * W + B / n_samples) / W)


def geomean(x, axis=None):
    x = _draws(x)
    return torch.exp(torch.log(x).mean() if axis is None else torch.log(x).mean(axis))


def harmean(x, axis=None):
    x = _draws(x)
    return 1 / ((1 / x).mean() if axis is None else (1 / x).mean(axis))


def multi_ess(x, axis=None):
    """The harmonic mean of the parameters' ESS."""
    return harmean(effective_sample_size(x), axis=axis)


def multi_gr(x, axis=None):
    """Multivariate Gelman-Rubin ~ (1 + n_chains / mESS)^1/2
    (arXiv:1812.09384)."""
    g2 = gelman_rubin(x) ** 2
    return (g2.mean() if axis is None else g2.mean(axis)) ** 0.5
