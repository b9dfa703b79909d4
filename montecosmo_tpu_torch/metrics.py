"""Summary statistics on the port's model paths: the multipole power
spectrum (the `powspec` observable), the curved-sky mu^2 operator (the
Kaiser evolution on the curved sky), transfer and coherence against a
reference mesh, and the chains' diagnostics (ESS, Gelman-Rubin).

The spectrum's plan is host numpy, built once per geometry (`spectrum_plan`,
cached with its device tensors by `_plan`): the bin of every rfft mode and
one weight per mode and multipole that folds in the Hermitian multiplicity,
the (2 ell + 1) Legendre weight, the per-bin mode count and the units.  On
the device the estimator is then one segment sum of |delta_k|^2 times those
weights, K9 (`ops/segment.py::segment_sum`), whose backward is its gather.

Parity: `montecosmo_tpu/metrics.py:27-186` (kbin_edges, _kmu_grid,
spectrum_plan, _segment_reduce, _spectrum, spectrum) and `:462-494`
(_y2_cartesian, optim_mu2_delta), `:250-278` (transfer, coherence,
powtranscoh) and `:545-606` (effective_sample_size, gelman_rubin, geomean,
harmean, multi_ess, multi_gr).  The plan is the JAX package's numpy,
copied (the port imports nothing of it).
"""
from functools import lru_cache

import numpy as np
import torch
from scipy.special import legendre

from montecosmo_tpu_torch.ops.fourier import bspline_hat, irfftn, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import ch2rshape
from montecosmo_tpu_torch.ops.segment import segment_sum
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


# ----------------------------------------------------------------------- curved-sky mu^2
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
