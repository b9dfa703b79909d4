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
        pytest.skip("needs an NVIDIA card: K1-K3 are CUDA")
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
        # its typical value; 1-3 shifts, a cubic and an anisotropic mesh
        # (rows of z shorter than a warp), with and without deconvolution
        kcut = None if kernel == "rectangular" else tpa.optim_kcut(192 / 224)
        for shape, n_shift, deconv in (((32, 32, 32), 2, order), ((30, 28, 26), 3, order),
                                       ((32, 32, 32), 1, order), ((32, 32, 32), 2, 0)):
            eg = tpa.EpilogueGeometry(shape, n_shift, 1.0, deconv, kcut)
            cshape = tpa.r2chshape(shape)
            fk = torch.randn((n_shift,) + cshape, dtype=torch.complex64, device=dev)
            g = torch.randn(cshape, dtype=torch.complex64, device=dev)
            mag = [f.abs() for f in tpa._epilogue_factors(eg, dev)]
            for out, ref, scale in (
                    (tpa.nufft_epilogue_kernel(fk, eg), tpa.nufft_epilogue_plain(fk, eg),
                     sum(m * fk[s].abs() for s, m in enumerate(mag))),
                    (tpa.nufft_epilogue_kernel(g, eg, backward=True),
                     tpa._epilogue_math(g, eg, True), torch.stack([m * g.abs() for m in mag]))):
                assert float(((out - ref).abs() / scale).max()) <= 1e-5, (kernel, order, shape)


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


@pytest.mark.cuda
def test_tiled_kernels_match_plain_and_atomic_on_card():
    """The lattice-brick K1 and K5 against their plain versions and against
    the atomic kernels on the same inputs, at 32^3 (stride-2 lattice, tiles
    wider than the mesh along z at some orders, margins of 0-2 cells that
    send many particles to device memory) with ties and outliers, at orders 1-4 of
    the B-spline and Kaiser-Bessel windows, K5 at C = 3 and C = 6 (two
    launches of at most 4 channels); the routing of a clamped paint and read
    VJP to them from CIC up and to the atomic kernels at NGP
    (ops/paint.py::TILED_FROM; skips without a card).  Both designs sum with
    atomics in run-dependent order, hence the 1e-5 relative tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tiled K1/K5 are CUDA")
    dev = torch.device("cuda")
    pos, w = _lattice_particles((16, 16, 16), (2, 2, 2), 5, 19)
    pos = _with_ties(pos, (16, 16, 16), (2, 2, 2), np.random.default_rng(20))
    pos, w = torch.tensor(pos, device=dev), torch.tensor(w, device=dev)

    def close(out, ref):
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))

    wider = False
    for kernel, order in [(k, o) for k in ("rectangular", "kaiser_bessel") for o in (1, 2, 3, 4)]:
        geom = tpa.cic_geometry((32, 32, 32), 2, (16, 16, 16), 5, True, order, kernel, 192 / 224)
        wider |= tpa.tile_plan(geom).tile[2] > 32
        out = tpa.paint_cic_tiled_kernel(pos, w, geom)
        close(out, tpa.paint_cic_plain(pos, w, geom))
        close(out, tpa.paint_cic_kernel(pos, w, geom))
        tpa.reset_launches()
        close(tpa.paint_cic(pos, (32, 32, 32), w, 2, (16, 16, 16), 5, True, order, kernel,
                            192 / 224), out)
        k1 = "paint_cic_tiled" if order > 1 else "paint_cic"
        assert tpa.launches_at(order, geom.window) == {k1: 1}
        for C in (3, 6):
            g1 = tpa.cic_geometry((32, 32, 32), 1, (16, 16, 16), 5, True, order, kernel, 1.5)
            mesh = torch.randn((32, 32, 32, C), device=dev)
            ct = torch.randn((pos.shape[0], C), device=dev)
            dpos, dmesh = tpa.read_cic_adjoint_tiled_kernel(pos, mesh, ct, g1)
            for rpos, rmesh in (tpa.read_cic_adjoint_plain(pos, mesh, ct, g1),
                                tpa.read_cic_adjoint_kernel(pos, mesh, ct, g1)):
                close(dpos, rpos)
                close(dmesh, rmesh)
        pr, mr = pos.clone().requires_grad_(True), mesh.clone().requires_grad_(True)
        tpa.reset_launches()
        vals = tpa.read_window(pr, mr, (16, 16, 16), order, kernel, 1.5, 5, True)
        torch.autograd.backward(vals, ct)
        close(pr.grad, tpa.read_cic_adjoint_plain(pos, mesh, ct, g1)[0])
        k4 = "read_cic_tiled" if order > 2 else "read_cic"
        k5 = "read_cic_adjoint_tiled" if order > 1 else "read_cic_adjoint"
        assert tpa.launches_at(order, geom.window) == {k4: 2, k5: 2}
    assert wider


@pytest.mark.cuda
def test_tiled_read_matches_plain_and_per_particle_on_card():
    """The lattice-brick K4 (read) against its plain version and against
    the per-particle kernel on the same inputs, at 32^3 (stride-2 lattice,
    margins of 0-2 cells that send many particles to device memory, boxes
    wider than the mesh) with ties and outliers, at orders 1-4 of the
    B-spline and Kaiser-Bessel windows, at C = 3 and C = 6 (two launches);
    the routing of a clamped read to the tiled K4 from TSC up and of every
    paint's backward to K2, with their launch names (skips without a
    card).  Both designs sum the same corners in another order than the
    plain version, hence the 1e-5 relative tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tiled K4 is CUDA")
    dev = torch.device("cuda")
    pos, w = _lattice_particles((16, 16, 16), (2, 2, 2), 5, 21)
    pos = _with_ties(pos, (16, 16, 16), (2, 2, 2), np.random.default_rng(22))
    pos, w = torch.tensor(pos, device=dev), torch.tensor(w, device=dev)

    def close(out, ref):
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))

    outliers = 0
    for kernel, order in [(k, o) for k in ("rectangular", "kaiser_bessel") for o in (1, 2, 3, 4)]:
        g1 = tpa.cic_geometry((32, 32, 32), 1, (16, 16, 16), 5, True, order, kernel, 1.5)
        for C in (3, 6):
            mesh = torch.randn((32, 32, 32, C), device=dev)
            n_out = torch.zeros(1, dtype=torch.int64, device=dev)
            out = tpa.read_cic_tiled_kernel(pos, mesh, g1, n_out)
            outliers += n_out.item()
            close(out, tpa.read_cic_plain(pos, mesh, g1))
            close(out, tpa.read_cic_kernel(pos, mesh, g1))
        tpa.reset_launches()
        close(tpa.read_window(pos, mesh, (16, 16, 16), order, kernel, 1.5, 5, True), out)
        k4 = "read_cic_tiled" if order > 2 else "read_cic"
        assert tpa.launches_at(order, g1.window) == {k4: 2}
        g2 = tpa.cic_geometry((32, 32, 32), 2, (16, 16, 16), 5, True, order, kernel, 192 / 224)
        grads = torch.randn((2, 32, 32, 32), device=dev)
        rpos, rw = tpa.paint_cic_adjoint_plain(pos, w, grads, g2)
        pr, wr = pos.clone().requires_grad_(True), w.clone().requires_grad_(True)
        tpa.reset_launches()
        meshes = tpa.paint_cic(pr, (32, 32, 32), wr, 2, (16, 16, 16), 5, True, order, kernel,
                               192 / 224)
        torch.autograd.backward(meshes, grads)
        close(pr.grad, rpos)
        close(wr.grad, rw)
        k1 = "paint_cic_tiled" if order > 1 else "paint_cic"
        assert tpa.launches_at(order, g2.window) == {k1: 1, "paint_cic_adjoint": 1}
    assert outliers > 0
