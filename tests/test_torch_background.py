"""K8 (the background tables with their Omega_m derivatives) on the CPU:
its plain version against the JAX package's tables and derivatives, and
against an independent reference, the step-by-step RK4 loop the port ran
before K8 (kept here), differentiated by autograd in float64.

Inputs and tolerances:
* values against JAX (float32 RK4 steps) at the existing rtol 1e-5 and
  atol 1e-6 of the largest entry: K8 integrates in float64, which moves the
  tables by at most ~5e-6 relative;
* the Omega_m derivative of a weighted sum of the tables against
  `jax.grad` at 1e-4 relative (JAX's float32 steps; measured 2.2e-6), its
  second derivative against `jax.jacfwd(jax.grad)` at 1e-4 (measured
  2.6e-6);
* the raw tables and their first derivatives entry by entry, and their
  second derivatives projected on a random vector, against the loop in
  float64 at 1e-10 of the largest entry.
"""
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops import background as jbg

from montecosmo_tpu_torch.ops import background as tbg

torch.set_num_threads(1)

def _loop_tables(om, Omega_k=0.0, w0=-1.0, wa=0.0):
    """The raw tables (growth states node by node, then chi from a_min) by
    the port's former step-by-step RK4 loop: scalar tensor operations, one
    autograd node each, here in float64 from the same float32 nodes."""
    cosmo = tbg.Cosmology(Omega_c=om - 0.05, Omega_b=0.05, h=0.7, n_s=0.96, sigma8=0.8,
                          Omega_k=Omega_k, w0=w0, wa=wa)

    def rk4(f, y0, ts):
        ys, y = [y0], y0
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

    def derivs(y, a):
        esqr = tbg.Esqr(cosmo, a)
        om_a = cosmo.Omega_m * a**-3 / esqr
        ode_a = cosmo.Omega_de * tbg.f_de(cosmo, a) / esqr
        w = cosmo.w0 + cosmo.wa * (1.0 - a)
        q = (2.0 - (om_a + (1.0 + 3.0 * w) * ode_a) / 2.0) / a
        r = 1.5 * om_a / a**2
        g1, g2, d1, d2 = y
        return (d1, d2, -q * d1 + r * g1, -q * d2 + r * g2 - r * g1**2)

    atab, _, lna = (t.double() for t in tbg._nodes(torch.device("cpu")))
    a0 = atab[0]
    y0 = (a0, -3.0 / 7 * a0**2, torch.ones_like(a0), -6.0 / 7 * a0)
    growth = torch.stack(rk4(derivs, y0, atab), 1).reshape(-1)

    def dchi(y, x):
        a = torch.exp(x)
        return (tbg.RH / (a * torch.sqrt(tbg.Esqr(cosmo, a))),)

    (chi,) = rk4(dchi, (torch.zeros((), dtype=torch.float64),), lna)
    return torch.cat([growth, chi])


@pytest.mark.parametrize("cosmo", [dict(), dict(Omega_k=0.02, w0=-0.9, wa=0.1)])
def test_plain_matches_the_loop_and_its_derivatives(cosmo):
    """K8's plain version against the step-by-step loop in float64: the raw
    tables and their Omega_m derivatives entry by entry (autograd once, one
    batched backward), the second derivatives projected on a random vector
    (autograd twice), at 1e-10 of the largest entry."""
    om = torch.tensor(0.31, dtype=torch.float64, requires_grad=True)
    ref = _loop_tables(om, **cosmo)
    n = ref.shape[0]
    (d1,) = torch.autograd.grad(ref, om, torch.eye(n, dtype=torch.float64),
                                is_grads_batched=True, create_graph=True)
    w = torch.tensor(np.random.default_rng(0).standard_normal(n))
    (d2w,) = torch.autograd.grad((w * d1).sum(), om)
    consts = tuple(cosmo.get(k, v) for k, v in (("Omega_k", 0.0), ("w0", -1.0), ("wa", 0.0)))
    y, dy, d2y = tbg.background_tables_plain(om, *consts, "cpu", torch.float64)
    assert y.shape == (4 * tbg.GROWTH_STEPS + tbg.DIST_STEPS,) == ref.shape
    for got, want in ((y, ref), (dy, d1)):
        torch.testing.assert_close(got, want.detach(), rtol=1e-10,
                                   atol=1e-10 * float(want.detach().abs().max()))
    torch.testing.assert_close((w * d2y).sum(), d2w, rtol=1e-10,
                               atol=1e-10 * float((w.abs() * d2y.abs()).sum()))


TABLES = ("g_tab", "g2_tab", "f_tab", "f2_tab", "chi_tab", "a_chi_tab")
# one random weight per table entry, chi's scaled to order 1
WEIGHTS = {name: np.random.default_rng(i).standard_normal(n).astype(np.float32)
           * (1e-3 if name == "chi_tab" else 1.0)
           for i, (name, n) in enumerate(zip(TABLES, (tbg.GROWTH_STEPS,) * 4 + (
               tbg.DIST_STEPS, tbg.CHI_STEPS)))}


def _close(t, j, rtol, atol_rel):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_rel * max(np.abs(j).max(), 1e-30))


def test_tables_and_omega_derivatives_match_jax():
    """The tables of `Background.create` (float32 Omega_m) against JAX's, and
    the first and second Omega_m derivatives of a weighted sum of every
    table (autograd once and twice through `_BackgroundTables`) against
    `jax.grad` and `jax.jacfwd(jax.grad)`, in one compile."""
    def scalar(bg):
        return sum((getattr(bg, name) * torch.tensor(w)).sum() for name, w in WEIGHTS.items())

    om = torch.tensor(np.float32(0.31), requires_grad=True)
    bt = tbg.Background.create(tbg.get_cosmology(Omega_m=om, sigma8=torch.tensor(0.8)))
    (g,) = torch.autograd.grad(scalar(bt), om, create_graph=True)
    (h,) = torch.autograd.grad(g, om)

    def scalar_j(o):
        bg = jbg.Background.create(jbg.get_cosmology(Omega_m=o, sigma8=0.8))
        tabs = [getattr(bg, name) for name in TABLES]
        return sum((t * WEIGHTS[name]).sum() for name, t in zip(TABLES, tabs)), tabs

    def grad_j(o):
        (_, tabs), g = jax.value_and_grad(scalar_j, has_aux=True)(o)
        return g, (tabs, g)

    hj, (tabs, gj) = jax.jit(jax.jacfwd(grad_j, has_aux=True))(jnp.float32(0.31))
    print(f"Omega_m derivatives vs JAX: first {abs(float(g) / float(gj) - 1):.3e}, "
          f"second {abs(float(h) / float(hj) - 1):.3e} (relative)")
    for name, tab in zip(TABLES, tabs):
        _close(getattr(bt, name), tab, 1e-5, 1e-6)
    _close(g, gj, 1e-4, 0)
    _close(h, hj, 1e-4, 0)


def test_float_cosmology_has_no_graph():
    """A cosmology of floats (`Planck18()`) runs the same path without a
    graph: its raw tables are those of the same cosmology with a float64
    Omega_c tensor, rounded to float32."""
    c = tbg.Planck18()
    bt = tbg.Background.create(c)
    assert not any(getattr(bt, name).requires_grad for name in TABLES)
    raw = tbg._raw_tables(c, "cpu")
    raw64 = tbg._raw_tables(c._replace(Omega_c=torch.tensor(c.Omega_c, dtype=torch.float64)),
                            "cpu")
    assert raw.dtype == torch.float32 and raw64.dtype == torch.float64
    torch.testing.assert_close(raw, raw64.float(), rtol=0, atol=0)


@pytest.mark.parametrize("field", ["w0", "Omega_b", "h"])
def test_gradient_in_another_field_raises(field):
    """Only Omega_m carries a gradient into the tables: a tensor field
    other than it that requires grad raises, never silently drops it."""
    cosmo = tbg.Planck18()
    cosmo = cosmo._replace(**{field: torch.tensor(float(getattr(cosmo, field)),
                                                  requires_grad=True)})
    with pytest.raises(NotImplementedError, match="Omega_m"):
        tbg.Background.create(cosmo)
    # without a gradient the field is a constant
    tbg.Background.create(cosmo._replace(**{field: getattr(cosmo, field).detach()}))
