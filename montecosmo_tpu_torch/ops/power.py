"""Linear matter power spectrum: Eisenstein & Hu (1998) transfer with BAO,
sigma8-normalized, differentiable in the cosmological parameters.

Parity: `montecosmo_tpu/ops/power.py:16-143` (`lin_power`'s `kpow`: :89-110).
"""
import numpy as np
import torch

from montecosmo_tpu_torch.ops.background import Background, Cosmology, _device_of
from montecosmo_tpu_torch.ops.fourier import rfftk
from montecosmo_tpu_torch.ops.interp import log_uniform_interp_fn
from montecosmo_tpu_torch.utils import to_tensor

TCMB = 2.726  # K


def eisenstein_hu_transfer(cosmo: Cosmology, k):
    """EH98 matter transfer function with BAO; k in h/Mpc, T(k->0) = 1."""
    h = cosmo.h
    om = to_tensor(cosmo.Omega_m * h**2, k.device)
    ob = to_tensor(cosmo.Omega_b * h**2, k.device)
    fb = to_tensor(cosmo.Omega_b / cosmo.Omega_m, k.device)
    fc = 1.0 - fb
    theta = TCMB / 2.7

    kmpc = k * h

    z_eq = 2.50e4 * om * theta**-4
    k_eq = 7.46e-2 * om * theta**-2
    b1 = 0.313 * om**-0.419 * (1 + 0.607 * om**0.674)
    b2 = 0.238 * om**0.223
    z_d = 1291.0 * om**0.251 / (1 + 0.659 * om**0.828) * (1 + b1 * ob**b2)

    def R_of(z):
        return 31.5 * ob * theta**-4 * (1e3 / z)

    R_d, R_eq = R_of(z_d), R_of(z_eq)
    s = (2.0 / (3 * k_eq) * torch.sqrt(6.0 / R_eq)
         * torch.log((torch.sqrt(1 + R_d) + torch.sqrt(R_d + R_eq)) / (1 + torch.sqrt(R_eq))))
    k_silk = 1.6 * ob**0.52 * om**0.73 * (1 + (10.4 * om)**-0.95)

    q = kmpc / (13.41 * k_eq)

    a1 = (46.9 * om)**0.670 * (1 + (32.1 * om)**-0.532)
    a2 = (12.0 * om)**0.424 * (1 + (45.0 * om)**-0.582)
    alpha_c = a1**(-fb) * a2**(-fb**3)
    bb1 = 0.944 / (1 + (458.0 * om)**-0.708)
    bb2 = (0.395 * om)**-0.0266
    beta_c = 1.0 / (1 + bb1 * (fc**bb2 - 1))

    def T0(q, alpha, beta):
        C = 14.2 / alpha + 386.0 / (1 + 69.9 * q**1.08)
        L = torch.log(np.e + 1.8 * beta * q)
        return L / (L + C * q**2)

    f = 1.0 / (1 + (kmpc * s / 5.4)**4)
    Tc = f * T0(q, 1.0, beta_c) + (1 - f) * T0(q, alpha_c, beta_c)

    y = (1 + z_eq) / (1 + z_d)
    sy = torch.sqrt(1 + y)
    Gy = y * (-6 * sy + (2 + 3 * y) * torch.log((sy + 1) / (sy - 1)))
    alpha_b = 2.07 * k_eq * s * (1 + R_d)**-0.75 * Gy
    beta_b = 0.5 + fb + (3 - 2 * fb) * torch.sqrt((17.2 * om)**2 + 1)
    beta_node = 8.41 * om**0.435
    s_tilde = s / (1 + (beta_node / (kmpc * s))**3)**(1.0 / 3)
    x = kmpc * s_tilde
    j0 = torch.sinc(x / np.pi)
    Tb = (T0(q, 1.0, 1.0) / (1 + (kmpc * s / 5.2)**2)
          + alpha_b / (1 + (beta_b / (kmpc * s))**3) * torch.exp(-(kmpc / k_silk)**1.4)) * j0
    return fb * Tb + fc * Tc


def _sigma_r(cosmo: Cosmology, pk_unnorm_fn, device, r=8.0, n=512):
    """RMS of the density field smoothed with a top-hat of radius r [Mpc/h]."""
    lnk = torch.linspace(float(np.log(1e-4)), float(np.log(1e1)), n, device=device)
    k = torch.exp(lnk)
    x = k * r
    w = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x**3
    integrand = k**3 * pk_unnorm_fn(k) / (2 * np.pi**2) * w**2
    return torch.sqrt(torch.trapezoid(integrand, lnk))


def lin_power(cosmo: Cosmology, a=1.0, kpow=None, n_interp=256, bg: Background = None,
              device="cpu"):
    """Tabulated linear matter power spectrum (k [h/Mpc], P [(Mpc/h)^3]):
    with `kpow` a register's (k, P / sigma8^2) table times the sampled
    sigma8^2, else EH98 normalized to sigma8; scaled by D(a)^2 at a != 1."""
    device = _device_of(cosmo, device)
    if kpow is None:
        ks = torch.logspace(-4, 1, n_interp, device=device)
        raw = lambda k: k**cosmo.n_s * eisenstein_hu_transfer(cosmo, k)**2
        norm = (cosmo.sigma8 / _sigma_r(cosmo, raw, device))**2
        pows = raw(ks) * norm
    else:
        ks = torch.as_tensor(np.asarray(kpow[0], np.float32), device=device)
        pows = torch.as_tensor(np.asarray(kpow[1], np.float32), device=device) * cosmo.sigma8**2
    if not (isinstance(a, float) and a == 1.0):
        if bg is None:
            bg = Background.create(cosmo, device)
        pows = pows * bg.a2g(a)**2
    return ks, pows


def lin_power_interp(cosmo: Cosmology, a=1.0, kpow=None, n_interp=256, bg=None,
                     device="cpu"):
    """Interpolator k-mesh -> P(k), linear in k between log-spaced nodes
    (a register table's nodes, resampled once when not log-uniform)."""
    _, pows = lin_power(cosmo, a=a, kpow=kpow, n_interp=n_interp, bg=bg, device=device)
    nodes = np.logspace(-4, 1, n_interp) if kpow is None else np.asarray(kpow[0])
    return log_uniform_interp_fn(nodes, pows, left=0.0, right=0.0)


def lin_power_mesh(cosmo: Cosmology, mesh_shape: tuple, box_size, a=1.0,
                   kpow=None, n_interp=256, bg=None, device="cpu"):
    """Linear power spectrum on the rfft wavenumber mesh [(Mpc/h)^3]."""
    device = _device_of(cosmo, device)
    pow_fn = lin_power_interp(cosmo, a=a, kpow=kpow, n_interp=n_interp, bg=bg,
                              device=device)
    kvec = rfftk(mesh_shape, box_size, device)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    return pow_fn(kmesh)
