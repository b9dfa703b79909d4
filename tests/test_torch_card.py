"""The port's kernels against their plain PyTorch versions on an NVIDIA
card (`cuda`-marked: they skip without one), and the particle inputs that
the CPU parity tests share.  Nothing here imports JAX, so on a machine
without it the file runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from montecosmo_tpu_torch.ops import paint as tpa


def _lattice_particles(lattice, stride, H, seed, n_out=20):
    """Lattice-ordered positions with displacements N(0, 1.2 cells) and
    `n_out` outliers displaced beyond the clamp bound H."""
    rng = np.random.default_rng(seed)
    sites = np.stack(np.meshgrid(*[np.arange(l) * s for l, s in zip(lattice, stride)],
                                 indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    disp = 1.2 * rng.standard_normal(sites.shape)
    out = rng.choice(len(sites), n_out, replace=False)
    disp[out] += np.sign(disp[out]) * (H + 1.5)
    w = 1 + 0.3 * rng.standard_normal(len(sites))
    return (sites + disp).astype(np.float32), w.astype(np.float32)


def _with_ties(pos, lattice, stride, rng):
    """`pos` with a quarter of the particles put exactly on their lattice
    sites or half a cell off, per axis: the ties of the odd B-spline orders
    (round half to even) and of the interlace shift of 1/2."""
    sites = np.stack(np.meshgrid(*[np.arange(l) * s for l, s in zip(lattice, stride)],
                                 indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    pos = pos.copy()
    tie = rng.choice(len(pos), len(pos) // 4, replace=False)
    pos[tie] = sites[tie] + rng.choice([-0.5, 0.0, 0.5], (len(tie), 3)).astype(np.float32)
    return pos



@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1/K2/K3 against their plain versions on the card at orders 1-4 of
    the B-spline and Kaiser-Bessel windows, K1/K2 clamped and unclamped, a
    quarter of the particles on ties (skips without one).  max_disp 5 makes
    every NGP window base odd (margin 5 + 2), so a wrong tie origin would
    move the tied particles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1/K2 are CUDA and K3 is Triton")
    dev = torch.device("cuda")
    pos, w = _lattice_particles((16, 16, 16), (2, 2, 2), 5, 15)
    pos = _with_ties(pos, (16, 16, 16), (2, 2, 2), np.random.default_rng(17))
    pos, w = torch.tensor(pos, device=dev), torch.tensor(w, device=dev)
    for kernel, order in [(k, o) for k in ("rectangular", "kaiser_bessel") for o in (1, 2, 3, 4)]:
        for clip in (True, False):
            geom = tpa.cic_geometry((32, 32, 32), 2, (16, 16, 16), 5, clip, order, kernel,
                                    192 / 224)
            ref = tpa.paint_cic_plain(pos, w, geom)
            out = tpa.paint_cic_kernel(pos, w, geom)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
            g = torch.randn(out.shape, device=dev)
            dpos, dw = tpa.paint_cic_adjoint_kernel(pos, w, g, geom)
            rpos, rw = tpa.paint_cic_adjoint_plain(pos, w, g, geom)
            torch.testing.assert_close(dpos, rpos, rtol=1e-5,
                                       atol=1e-5 * float(rpos.abs().max()))
            torch.testing.assert_close(dw, rw, rtol=1e-5, atol=1e-5 * float(rw.abs().max()))
        # K3 element by element, each error over its sum's float32 scale
        # sum_s |F_s| |c(k)| (backward: |g| |c(k)|): at the flagship cutoff
        # the KB transform has a zero in the grid, where 1/W is ~1e7 times
        # its typical value
        kcut = None if kernel == "rectangular" else tpa.optim_kcut(192 / 224)
        eg = tpa.EpilogueGeometry((32, 32, 32), 2, 1.0, order, kcut)
        fk = torch.randn((2, 32, 32, 17), dtype=torch.complex64, device=dev)
        g = torch.randn((32, 32, 17), dtype=torch.complex64, device=dev)
        mag = [f.abs() for f in tpa._epilogue_factors(eg, dev)]
        for out, ref, scale in (
                (tpa.nufft_epilogue_kernel(fk, eg), tpa.nufft_epilogue_plain(fk, eg),
                 sum(m * fk[s].abs() for s, m in enumerate(mag))),
                (tpa.nufft_epilogue_kernel(g, eg, backward=True), tpa._epilogue_math(g, eg, True),
                 torch.stack([m * g.abs() for m in mag]))):
            assert float(((out - ref).abs() / scale).max()) <= 1e-5, (kernel, order)


@pytest.mark.cuda
def test_read_kernels_match_plain_on_card():
    """K4/K5 against their plain versions on the card at orders 1-4 of the
    B-spline and Kaiser-Bessel windows, clamped and unclamped, with ties as
    above, for C = 3 and for C = 6 (two launches of at most 4 channels)
    (skips without one).  K5's mesh gradient
    sums with atomics in run-dependent order, hence the 1e-5 relative
    tolerance on it as on the values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K4/K5 are CUDA")
    dev = torch.device("cuda")
    pos, _ = _lattice_particles((16, 16, 16), (2, 2, 2), 5, 16)
    pos = _with_ties(pos, (16, 16, 16), (2, 2, 2), np.random.default_rng(18))
    pos = torch.tensor(pos, device=dev)
    for C, order, clip, kernel in [(3, o, c, k) for o in (1, 2, 3, 4) for c in (True, False)
                                   for k in ("rectangular", "kaiser_bessel")] + [
            (6, 3, True, "rectangular")]:
        geom = tpa.cic_geometry((32, 32, 32), 1, (16, 16, 16), 5, clip, order, kernel, 1.5)
        mesh = torch.randn((32, 32, 32, C), device=dev)
        ct = torch.randn((pos.shape[0], C), device=dev)
        ref = tpa.read_cic_plain(pos, mesh, geom)
        out = tpa.read_cic_kernel(pos, mesh, geom)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
        dpos, dmesh = tpa.read_cic_adjoint_kernel(pos, mesh, ct, geom)
        rpos, rmesh = tpa.read_cic_adjoint_plain(pos, mesh, ct, geom)
        torch.testing.assert_close(dpos, rpos, rtol=1e-5, atol=1e-5 * float(rpos.abs().max()))
        torch.testing.assert_close(dmesh, rmesh, rtol=1e-5, atol=1e-5 * float(rmesh.abs().max()))
