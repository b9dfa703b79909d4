"""Background cosmology: expansion history, growth factors, comoving distances.

* `Cosmology` is a NamedTuple of parameters (w0waCDM); fields are Python
  floats or 0-d tensors, so gradients flow from (Omega_m, sigma8).
* `Background.create(cosmo)` integrates the 1st/2nd-order growth ODE and the
  comoving-distance integral with fixed-step RK4 loops and returns
  differentiable tables.
* Lookups (`a2g`, `a2g2`, `a2f`, `a2dg2dg`, `chi2a`, and the growth-time
  `g2a`, `g2g2`, `g2f`, `g2f2`, `g2dg2dg` that BullFrog steps in)
  interpolate those tables.

The RK4 loops are 127 + 255 sequential steps of scalar tensor operations; on
the card every one of them is a kernel launch.

Parity: `montecosmo_tpu/ops/background.py:24-260` (same grids, same
normalizations: D1(a=1)=1, `a2g2 = -3/7 g2_raw`, f = dlnD/dlna).
"""
from typing import NamedTuple

import numpy as np
import torch

from montecosmo_tpu_torch.ops.interp import interp, uniform_interp
from montecosmo_tpu_torch.utils.safe import safe_div

# Hubble radius c / (100 km/s/Mpc) in Mpc/h
RH = 2997.92458

GROWTH_LOG10_AMIN = -3.0
GROWTH_STEPS = 128
DIST_LOG10_AMIN = -3.0
DIST_STEPS = 256
CHI_STEPS = 2048
CHI_GRID_MAX = 4.9 * RH


class Cosmology(NamedTuple):
    """Flat-ish w0waCDM parameters (floats or 0-d tensors)."""
    Omega_c: object
    Omega_b: object
    h: object
    n_s: object
    sigma8: object
    Omega_k: object = 0.0
    w0: object = -1.0
    wa: object = 0.0

    @property
    def Omega_m(self):
        return self.Omega_c + self.Omega_b

    @property
    def Omega_de(self):
        return 1.0 - self.Omega_m - self.Omega_k


# Planck 2018 VI (arXiv:1807.06209) Table 2 last column
def Planck18(**kw) -> Cosmology:
    return Cosmology(**{**dict(Omega_c=0.2607, Omega_b=0.0490, h=0.6766,
                               n_s=0.9665, sigma8=0.8102, Omega_k=0.0,
                               w0=-1.0, wa=0.0), **kw})


# AbacusSummit base cosmology c000
def AbacusSummit0(**kw) -> Cosmology:
    return Cosmology(**{**dict(Omega_c=0.26447041, Omega_b=0.04930169, h=0.6736,
                               n_s=0.9649, sigma8=0.8076353990239834,
                               Omega_k=0.0, w0=-1.0, wa=0.0), **kw})


def get_cosmology(**params) -> Cosmology:
    """Full cosmology from the sampled (Omega_m, sigma8), the other
    AbacusSummit0 parameters held fixed."""
    ref = AbacusSummit0()
    return ref._replace(Omega_c=params["Omega_m"] - ref.Omega_b,
                        sigma8=params["sigma8"])


def _device_of(cosmo, device):
    for v in cosmo:
        if torch.is_tensor(v):
            return v.device
    return torch.device(device)


def f_de(cosmo: Cosmology, a):
    """Dark-energy density evolution rho_de(a)/rho_de(1)."""
    return a ** (-3.0 * (1.0 + cosmo.w0 + cosmo.wa)) * torch.exp(-3.0 * cosmo.wa * (1.0 - a))


def Esqr(cosmo: Cosmology, a):
    """E^2(a) = H^2(a)/H0^2."""
    return (cosmo.Omega_m * a**-3 + cosmo.Omega_k * a**-2
            + cosmo.Omega_de * f_de(cosmo, a))


def _rk4(f, y0, ts):
    """Fixed-step RK4 over the grid `ts` (1-D tensor); y is a tuple of
    tensors.  Returns the stacked states at every node."""
    ys = [y0]
    y = y0
    for n in range(ts.shape[0] - 1):
        t0, t1 = ts[n], ts[n + 1]
        h = t1 - t0
        k1 = f(y, t0)
        k2 = f(tuple(yi + h / 2 * ki for yi, ki in zip(y, k1)), t0 + h / 2)
        k3 = f(tuple(yi + h / 2 * ki for yi, ki in zip(y, k2)), t0 + h / 2)
        k4 = f(tuple(yi + h * ki for yi, ki in zip(y, k3)), t1)
        y = tuple(yi + h / 6 * (a + 2 * b + 2 * c + d)
                  for yi, a, b, c, d in zip(y, k1, k2, k3, k4))
        ys.append(y)
    return tuple(torch.stack([s[i] for s in ys]) for i in range(len(y0)))


def _logspace(log10_min, n, device):
    # float32 nodes, as the JAX package's jnp.logspace builds them
    return torch.as_tensor(
        np.power(np.float32(10.0), np.linspace(log10_min, 0.0, n, dtype=np.float32)),
        device=device)


class Background(NamedTuple):
    """Growth and distance tables for one cosmology (differentiable)."""
    cosmo: Cosmology
    a_tab: torch.Tensor
    g_tab: torch.Tensor
    g2_tab: torch.Tensor
    f_tab: torch.Tensor
    f2_tab: torch.Tensor
    a_dist: torch.Tensor
    chi_tab: torch.Tensor
    a_chi_tab: torch.Tensor

    @classmethod
    def create(cls, cosmo: Cosmology, device="cpu"):
        device = _device_of(cosmo, device)
        atab = _logspace(GROWTH_LOG10_AMIN, GROWTH_STEPS, device)

        def derivs(y, a):
            esqr = Esqr(cosmo, a)
            om_a = cosmo.Omega_m * a**-3 / esqr
            ode_a = cosmo.Omega_de * f_de(cosmo, a) / esqr
            w = cosmo.w0 + cosmo.wa * (1.0 - a)
            q = (2.0 - (om_a + (1.0 + 3.0 * w) * ode_a) / 2.0) / a
            r = 1.5 * om_a / a**2
            g1, g2, d1, d2 = y
            return (d1, d2, -q * d1 + r * g1, -q * d2 + r * g2 - r * g1**2)

        a0 = atab[0]
        y0 = (a0, -3.0 / 7 * a0**2, torch.ones_like(a0), -6.0 / 7 * a0)
        y1, y2, d1, d2 = _rk4(derivs, y0, atab)
        gtab = y1 / y1[-1]
        g2tab = y2 / y2[-1]
        ftab = d1 / y1[-1] * atab / gtab
        f2tab = d2 / y2[-1] * atab / g2tab

        adist = _logspace(DIST_LOG10_AMIN, DIST_STEPS, device)

        def dchi(y, lna):
            a = torch.exp(lna)
            return (RH / (a * torch.sqrt(Esqr(cosmo, a))),)

        (chitab,) = _rk4(dchi, (torch.zeros((), device=device),), torch.log(adist))
        chitab = chitab[-1] - chitab

        chi_grid = torch.linspace(0.0, CHI_GRID_MAX, CHI_STEPS, device=device)
        a_chi_tab = interp(chi_grid, chitab.flip(0), adist.flip(0))
        return cls(cosmo, atab, gtab, g2tab, ftab, f2tab, adist, chitab, a_chi_tab)

    def _a_lookup(self, a, ytab):
        nodes = np.logspace(GROWTH_LOG10_AMIN, 0.0, ytab.shape[0])
        x0 = float(np.log(nodes[0]))
        dx = float((np.log(nodes[-1]) - x0) / (nodes.size - 1))
        return uniform_interp(a, x0, dx, ytab, logx=True, xtab=nodes)

    def a2g(self, a):
        return self._a_lookup(a, self.g_tab)

    def a2g2(self, a):
        return self._a_lookup(a, self.g2_tab) * (-3.0 / 7)

    def a2f(self, a):
        return self._a_lookup(a, self.f_tab)

    def a2f2(self, a):
        return self._a_lookup(a, self.f2_tab)

    def a2dg2dg(self, a):
        g, g2 = self.a2g(a), self.a2g2(a)
        f, f2 = self.a2f(a), self.a2f2(a)
        return safe_div(g2 * f2, g * f)

    def g2a(self, g):
        return interp(g, self.g_tab, self.a_tab)

    def g2g2(self, g):
        return interp(g, self.g_tab, self.g2_tab) * (-3.0 / 7)

    def g2f(self, g):
        return interp(g, self.g_tab, self.f_tab)

    def g2f2(self, g):
        return interp(g, self.g_tab, self.f2_tab)

    def g2dg2dg(self, g):
        g2, f, f2 = self.g2g2(g), self.g2f(g), self.g2f2(g)
        return safe_div(g2 * f2, g * f)

    def chi2a(self, chi):
        return uniform_interp(chi, 0.0, CHI_GRID_MAX / (CHI_STEPS - 1), self.a_chi_tab)
