"""Background cosmology: expansion history, growth factors, comoving distances.

* `Cosmology` is a NamedTuple of parameters (w0waCDM); fields are Python
  floats or 0-d tensors, so gradients flow from (Omega_m, sigma8).
* `Background.create(cosmo)` integrates the 1st/2nd-order growth ODE and the
  comoving-distance integral with fixed-step RK4 and returns differentiable
  tables.  Both integrations are one kernel, K8 `background_tables`
  (`csrc/background_rk4.cu`, float64), which carries every table's first
  and second derivatives with respect to Omega_m; `_BackgroundTables` turns
  them into the gradient (and, under `create_graph`, the second
  derivative).  Only Omega_m may carry a gradient into the tables.
* Lookups (`a2g`, `a2g2`, `a2f`, `a2dg2dg`, `a2chi`, `chi2a`, and the growth-time
  `g2a`, `g2g2`, `g2f`, `g2f2`, `g2dg2dg` that BullFrog steps in)
  interpolate those tables.  The four growth tables are kept stacked as one
  (n, 4) table, so a call site that needs several of them at the same scale
  factors brackets and gathers once (`Background._growth`).

On the card K8 launches once per `create`, reading Omega_m from device
memory; on the CPU its plain version (`background_tables_plain`, the same
float64 arithmetic in torch) runs.

Parity: `montecosmo_tpu/ops/background.py:24-260` (same grids, same
normalizations: D1(a=1)=1, `a2g2 = -3/7 g2_raw`, f = dlnD/dlna).
"""
import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from montecosmo_tpu_torch.ops._kernels import LAUNCHES
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


# ----------------------------------------------------------- K8 plain
# A jet: a value and its first and second derivatives in Omega_m, stacked on
# the leading axis, (3, ...) float64.
def _jet(v):
    """The jet of a constant v."""
    v = torch.as_tensor(v, dtype=torch.float64)
    return torch.stack([v, torch.zeros_like(v), torch.zeros_like(v)])


def _jmul(a, b):
    return torch.stack([a[0] * b[0], a[1] * b[0] + a[0] * b[1],
                        a[2] * b[0] + 2.0 * a[1] * b[1] + a[0] * b[2]])


def _jdiv(a, b):
    q = a[0] / b[0]
    q1 = (a[1] - q * b[1]) / b[0]
    return torch.stack([q, q1, (a[2] - 2.0 * q1 * b[1] - q * b[2]) / b[0]])


def _jsqrt(a):
    s = torch.sqrt(a[0])
    s1 = a[1] / (2.0 * s)
    return torch.stack([s, s1, (a[2] - 2.0 * s1 * s1) / (2.0 * s)])


def _jesqr(a, om, ok, w0, wa):
    """E^2(a) and its terms Omega_m a^-3 and Omega_de f_de(a), as jets in
    Omega_m, at the float64 abscissae `a`."""
    a3 = 1.0 / (a * a * a)
    fde = a ** (-3.0 * (1.0 + w0 + wa)) * torch.exp(-3.0 * wa * (1.0 - a))
    zero = torch.zeros_like(a)
    m = torch.stack([om * a3, a3, zero])
    de = torch.stack([(1.0 - om - ok) * fde, -fde, zero])
    return m + de + torch.stack([ok / (a * a), zero, zero]), m, de


def _midpoints(t):
    """The abscissae of fixed-step RK4 on the float32 nodes `t`, in float64:
    2n is node n, 2n + 1 the midpoint of step n."""
    t = t.double()
    mid = t[:-1] + 0.5 * (t[1:] - t[:-1])
    return torch.cat([torch.stack([t[:-1], mid], 1).reshape(-1), t[-1:]])


def _growth_rhs(y, q, r):
    """(d1, d2, r g1 - q d1, r g2 - q d2 - r g1^2) of the (3, 4) jet state
    y = (g1, g2, d1, d2)."""
    g1, g2, d1, d2 = y.unbind(1)
    rg1 = _jmul(r, g1)
    return torch.stack([d1, d2, rg1 - _jmul(q, d1), _jmul(r, g2) - _jmul(q, d2) - _jmul(rg1, g1)],
                       1)


@torch.no_grad()
def background_tables_plain(om, Omega_k, w0, wa, device, dtype=torch.float32):
    """Plain PyTorch K8: the raw tables (value, d/dOmega_m, d^2/dOmega_m^2),
    each (4 GROWTH_STEPS + DIST_STEPS,) of `dtype`: the growth states (g1,
    g2, d1, d2) node by node, then chi integrated up from a_min, in float64
    as the kernel computes them (`csrc/background_rk4.cu`).  `om` is a float
    or a 0-d tensor; no graph is recorded (`_BackgroundTables` gives the
    gradient)."""
    atab, _, lna = _nodes(torch.device(device))
    om = om.detach().double() if torch.is_tensor(om) else float(om)
    # the coefficients at every growth abscissa, the integrand at every
    # distance abscissa
    a = _midpoints(atab)
    e2, m, de = _jesqr(a, om, Omega_k, w0, wa)
    om_a, ode_a = _jdiv(m, e2), _jdiv(de, e2)
    w = w0 + wa * (1.0 - a)
    q = (1.0 / a) * (_jet(torch.full_like(a, 2.0)) - 0.5 * (om_a + (1.0 + 3.0 * w) * ode_a))
    r = (1.5 / (a * a)) * om_a
    x = torch.exp(_midpoints(lna))
    f = _jdiv(_jet(RH / x), _jsqrt(_jesqr(x, om, Omega_k, w0, wa)[0]))

    t = atab.double()
    a0 = t[0]
    y = _jet(torch.stack([a0, -3.0 / 7.0 * a0 * a0, torch.ones_like(a0), -6.0 / 7.0 * a0]))
    ys = [y]
    for n in range(GROWTH_STEPS - 1):
        h = t[n + 1] - t[n]
        k = _growth_rhs(y, q[:, 2 * n], r[:, 2 * n])
        acc = k
        k = _growth_rhs(y + 0.5 * h * k, q[:, 2 * n + 1], r[:, 2 * n + 1])
        acc = acc + 2.0 * k
        k = _growth_rhs(y + 0.5 * h * k, q[:, 2 * n + 1], r[:, 2 * n + 1])
        acc = acc + 2.0 * k
        k = _growth_rhs(y + h * k, q[:, 2 * n + 2], r[:, 2 * n + 2])
        y = y + h / 6.0 * (acc + k)
        ys.append(y)
    growth = torch.stack(ys, 1).reshape(3, -1)

    h = lna[1:].double() - lna[:-1].double()
    fm = f[:, 1::2]
    inc = h / 6.0 * (f[:, 0:-1:2] + 2.0 * fm + 2.0 * fm + f[:, 2::2])
    chi = torch.cumsum(torch.cat([torch.zeros_like(inc[:, :1]), inc], 1), 1)
    return tuple(torch.cat([growth, chi], 1).to(dtype).unbind(0))


# ---------------------------------------------------------- K8 launch
def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def background_tables_kernel(om, Omega_k, w0, wa, dtype=torch.float32):
    """K8 on the card: the raw tables of `background_tables_plain` for the
    0-d float32 or float64 CUDA tensor `om`, in one launch; `dtype` float32
    or float64."""
    from montecosmo_tpu_torch.ops import _kernels

    if not (om.is_cuda and om.numel() == 1 and om.dtype in (torch.float32, torch.float64)
            and dtype in (torch.float32, torch.float64)):
        raise ValueError(f"K8 takes a 0-d float32 or float64 CUDA Omega_m, got {om.dtype} "
                         f"{tuple(om.shape)} on {om.device}")
    lib = _kernels.cuda_library()
    atab, _, lna = _nodes(om.device)
    om = om.detach().contiguous()
    n = 4 * GROWTH_STEPS + DIST_STEPS
    out = [torch.empty(n, dtype=dtype, device=om.device) for _ in range(3)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(om.device).cuda_stream)
    code = lib.background_tables(_ptr(atab), _ptr(lna), _ptr(om),
                                 ctypes.c_int(om.dtype == torch.float64),
                                 *(ctypes.c_double(float(v)) for v in (Omega_k, w0, wa)),
                                 *map(_ptr, out), ctypes.c_int(dtype == torch.float64), stream)
    LAUNCHES["background_tables", "background", 0] += 1
    if code != 0:
        raise RuntimeError(f"background_tables launch failed: CUDA error {code}")
    return tuple(out)


def _tables(om, consts, device, dtype):
    """K8 on the card, its plain version on the CPU."""
    if torch.device(device).type == "cuda":
        if not torch.is_tensor(om):  # a fill on the card: no copy from the host
            om = torch.full((), float(om), dtype=torch.float64, device=device)
        return background_tables_kernel(om, *consts, dtype)
    return background_tables_plain(om, *consts, device, dtype)


# K8 carries the tables' first and second Omega_m derivatives, not the third
_THIRD = ("a third derivative through the background tables is not carried: K8 gives the "
          "tables' first and second Omega_m derivatives (ROADMAP Queue C item 2)")


class _SecondDerivative(torch.autograd.Function):
    """d2Y as a function of Omega_m whose own derivative raises: the d2Y
    term of `_BackgroundTables.backward`, differentiated again (a third
    derivative), would need d3Y."""

    @staticmethod
    def forward(ctx, om, d2y):
        return d2y.clone()

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_THIRD)


class _BackgroundTables(torch.autograd.Function):
    """Omega_m -> (raw tables Y, dY = dY/dOmega_m), K8 or its plain
    version.  dY is an output, so the backward (gY, gdY) -> sum gY dY +
    sum gdY d2Y, differentiated once more under `create_graph`, gives the
    exact second derivative (the Hessian-vector products of `lapprox` and
    `script._laplace_seed` are reverse over reverse).  A third derivative
    raises NotImplementedError: d2Y enters through `_SecondDerivative`."""

    @staticmethod
    def forward(ctx, om, consts, dtype):
        y, dy, d2y = _tables(om, consts, om.device, dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(om, dy)
        ctx.d2y, ctx.shape = d2y, om.shape
        return y, dy

    @staticmethod
    def backward(ctx, gy, gdy):
        om, dy = ctx.saved_tensors
        terms = []
        if gy is not None:
            terms.append((gy * dy).sum())
        if gdy is not None:
            terms.append((gdy * _SecondDerivative.apply(om, ctx.d2y)).sum())
        return (sum(terms).reshape(ctx.shape) if terms else None), None, None


# the cosmology's fields other than Omega_m, which K8 takes as constants
_CONSTANT_FIELDS = ("Omega_b", "Omega_k", "w0", "wa", "h", "n_s")


def _raw_tables(cosmo, device):
    """(raw tables, dtype) of `cosmo`, differentiable in Omega_m."""
    for name in _CONSTANT_FIELDS:
        v = getattr(cosmo, name)
        if torch.is_tensor(v) and v.requires_grad:
            raise NotImplementedError(
                f"a gradient through the background tables in {name} is not ported: K8 "
                "carries Omega_m's derivatives only (ROADMAP Queue B item 11)")
    consts = tuple(float(getattr(cosmo, k)) for k in ("Omega_k", "w0", "wa"))
    om = cosmo.Omega_m
    if not torch.is_tensor(om):
        return _tables(om, consts, device, torch.float32)[0]
    dtype = torch.float64 if om.dtype == torch.float64 else torch.float32
    return _BackgroundTables.apply(om.reshape(()), consts, dtype)[0]


def _logspace(log10_min, n, device):
    # float32 nodes, as the JAX package's jnp.logspace builds them
    return torch.as_tensor(
        np.power(np.float32(10.0), np.linspace(log10_min, 0.0, n, dtype=np.float32)),
        device=device)


@lru_cache(maxsize=None)
def _nodes(device):
    """The float32 nodes of the growth tables (a) and of the distance
    tables (a, ln a) on `device`, built once per device on the host (so
    that the card's ln a are the CPU's, bit for bit)."""
    atab = _logspace(GROWTH_LOG10_AMIN, GROWTH_STEPS, "cpu")
    adist = _logspace(DIST_LOG10_AMIN, DIST_STEPS, "cpu")
    return tuple(t.to(device) for t in (atab, adist, torch.log(adist)))


class Background(NamedTuple):
    """Growth and distance tables for one cosmology (differentiable).
    `growth_tab` stacks (g, g2, f, f2) on its last axis; `g_tab`, `g2_tab`,
    `f_tab` and `f2_tab` are its columns."""
    cosmo: Cosmology
    a_tab: torch.Tensor
    growth_tab: torch.Tensor
    a_dist: torch.Tensor
    chi_tab: torch.Tensor
    a_chi_tab: torch.Tensor

    @classmethod
    def create(cls, cosmo: Cosmology, device="cpu"):
        device = _device_of(cosmo, device)
        atab, adist, _ = _nodes(device)
        raw = _raw_tables(cosmo, device)
        y1, y2, d1, d2 = raw[:4 * GROWTH_STEPS].reshape(GROWTH_STEPS, 4).unbind(1)
        gtab = y1 / y1[-1]
        g2tab = y2 / y2[-1]
        ftab = d1 / y1[-1] * atab / gtab
        f2tab = d2 / y2[-1] * atab / g2tab

        chitab = raw[4 * GROWTH_STEPS:]
        chitab = chitab[-1] - chitab

        chi_grid = torch.linspace(0.0, CHI_GRID_MAX, CHI_STEPS, device=device)
        a_chi_tab = interp(chi_grid, chitab.flip(0), adist.flip(0))
        return cls(cosmo, atab, torch.stack([gtab, g2tab, ftab, f2tab], -1), adist, chitab,
                   a_chi_tab)

    @property
    def g_tab(self):
        return self.growth_tab[:, 0]

    @property
    def g2_tab(self):
        return self.growth_tab[:, 1]

    @property
    def f_tab(self):
        return self.growth_tab[:, 2]

    @property
    def f2_tab(self):
        return self.growth_tab[:, 3]

    def _a_lookup(self, a, ytab):
        # the growth and distance tables both start at 10^-3 (their node
        # counts differ)
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

    def _growth(self, a):
        """(a2g, a2g2, a2f, a2f2) of `a` from one bracket and one gather of
        the stacked table: the same values, bit for bit, as the four
        lookups."""
        g, g2, f, f2 = self._a_lookup(a, self.growth_tab).unbind(-1)
        return g, g2 * (-3.0 / 7), f, f2

    def a2dg2dg(self, a):
        g, g2, f, f2 = self._growth(a)
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

    def a2chi(self, a):
        """Comoving distance [Mpc/h] at scale factor `a`: the distance table
        on its log-uniform a nodes, clipped at 0."""
        return torch.clamp(self._a_lookup(a, self.chi_tab), min=0.0)

    def chi2a(self, chi):
        return uniform_interp(chi, 0.0, CHI_GRID_MAX / (CHI_STEPS - 1), self.a_chi_tab)
