"""K3's per-axis tables (ops/paint.py::_epilogue_tables), multiplied out as
the CUDA kernel (csrc/nufft_epilogue.cu) multiplies them, against the
plain version's per-element factors, on the CPU: the window deconvolution
scale / (n W(k)) bit for bit (W formed ((1 wx) wy) wz, an IEEE division),
the phases within float32 rounding.  No JAX: the plain version is held
against the JAX package in tests/test_torch_ops.py and test_torch_kaiser.py.
"""
import pytest
import torch

from montecosmo_tpu_torch.ops import paint as tpa
from montecosmo_tpu_torch.ops.hermitian import r2chshape

WINDOWS = [(k, o) for k in ("rectangular", "kaiser_bessel") for o in (1, 2, 3, 4)]


def _multiplied_out(geom):
    """The kernel's arithmetic on the tables: per element the constant
    c = c0 / W and the factor of shift s, exp(i s/n ksum) c."""
    wx, wy, wz, px, py, pz = tpa._epilogue_tables(geom, torch.device("cpu"))
    c0 = torch.tensor(geom.scale / geom.n_shift, dtype=torch.float32)
    w = ((1.0 * wx[:, None, None]) * wy[None, :, None]) * wz[None, None, :]
    c = c0 / w
    phases = [(px[s][:, None, None] * py[s][None, :, None]) * pz[s][None, None, :]
              for s in range(geom.n_shift - 1)]
    return c, [c.to(torch.complex64)] + [p * c for p in phases]


@pytest.mark.parametrize("kernel,order", WINDOWS)
def test_epilogue_tables_multiply_out_to_the_plain_factors(kernel, order):
    """At 32^3 (and an anisotropic 30 x 28 x 26 mesh) with 2 and 3 shifts:
    c equal to the plain version's bit for bit (at the flagship's
    Kaiser-Bessel cutoff W crosses zero inside the grid, where 1/W
    amplifies any difference in W); each shift's factor within 1e-6 of |c|
    element by element; and the forward and backward sums built from them
    within 1e-5 of each element's float32 scale, as the card's check holds
    the kernel."""
    kcut = tpa.optim_kcut(192 / 224) if kernel == "kaiser_bessel" else None
    gen = torch.Generator().manual_seed(order)
    for shape, n_shift in (((32, 32, 32), 2), ((30, 28, 26), 3)):
        geom = tpa.EpilogueGeometry(shape, n_shift, float((7 / 6) ** 3), order, kcut)
        c, factors = _multiplied_out(geom)
        plain = tpa._epilogue_factors(geom, "cpu")
        assert torch.equal(c, plain[0].real)
        for f, p in zip(factors, plain):
            assert float(((f - p).abs() / c.abs()).max()) <= 1e-6
        x = torch.randn((n_shift,) + r2chshape(shape), dtype=torch.complex64, generator=gen)
        fwd = sum(x[s] * f for s, f in enumerate(factors))
        scale = sum(x[s].abs() for s in range(n_shift)) * c.abs()
        assert float(((fwd - tpa._epilogue_math(x, geom, False)).abs() / scale).max()) <= 1e-5
        g = x[0]
        bwd = torch.stack([g * f.conj() for f in factors])
        assert float(((bwd - tpa._epilogue_math(g, geom, True)).abs()
                      / (g.abs() * c.abs())).max()) <= 1e-5
