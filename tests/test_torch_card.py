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
    sums in another order than the plain version, hence the 1e-5 relative
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
    (ops/paint.py::TILED_FROM; skips without a card).  Both designs sum in
    another order than the plain version, hence the 1e-5 relative
    tolerance."""
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
def test_paint_kernels_repeat_bit_for_bit_on_card():
    """K1 and K5 in both designs (lattice-brick and atomic, clamped, and the
    atomic one unclamped) give the same mesh bit for bit from launch to
    launch: their atomics add fixed point (csrc/mesh_fixed.cuh).  At the
    B-spline and Kaiser-Bessel orders 1-4, with outliers, and with weights
    and cotangents spanning 12 decades; a non-finite weight makes the
    paint non-finite where it lands (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1/K5 are CUDA")
    dev = torch.device("cuda")
    pos, w = _lattice_particles((16, 16, 16), (2, 2, 2), 2, 21, n_out=400)
    rng = np.random.default_rng(22)
    pos, w = torch.tensor(pos, device=dev), torch.tensor(w, device=dev)
    wide = w * torch.tensor(10.0 ** rng.uniform(-6, 6, w.shape[0]), dtype=torch.float32,
                            device=dev)

    def twice(f, *args):
        a, b = f(*args), f(*args)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for kernel, order in [(k, o) for k in ("rectangular", "kaiser_bessel") for o in (1, 2, 3, 4)]:
        gc = tpa.cic_geometry((32, 32, 32), 2, (16, 16, 16), 2, True, order, kernel, 192 / 224)
        gu = tpa.cic_geometry((32, 32, 32), 2, order=order, kernel_type=kernel,
                              oversamp=192 / 224)
        g1 = tpa.cic_geometry((32, 32, 32), 1, (16, 16, 16), 2, True, order, kernel, 1.5)
        mesh = torch.randn((32, 32, 32, 3), device=dev)
        ct = torch.randn((pos.shape[0], 3), device=dev) * wide[:, None] / w[:, None]
        for weights in (w, wide):
            assert twice(tpa.paint_cic_tiled_kernel, pos, weights, gc), (kernel, order)
            assert twice(tpa.paint_cic_kernel, pos, weights, gc), (kernel, order)
            assert twice(tpa.paint_cic_kernel, pos, weights, gu), (kernel, order)
        assert twice(tpa.read_cic_adjoint_tiled_kernel, pos, mesh, ct, g1), (kernel, order)
        assert twice(tpa.read_cic_adjoint_kernel, pos, mesh, ct, g1), (kernel, order)
        ref = tpa.paint_cic_plain(pos, wide, gc)
        out = tpa.paint_cic_tiled_kernel(pos, wide, gc)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    bad = w.clone()
    bad[5] = float("nan")
    for f in (tpa.paint_cic_tiled_kernel, tpa.paint_cic_kernel):
        out = f(pos, bad, gc)
        assert torch.isnan(out).any() and torch.isfinite(out).sum() > out.numel() // 2


@pytest.mark.cuda
def test_paint_grad_kernels_repeat_bit_for_bit_on_card():
    """K6 in both designs (lattice-brick and per-particle, clamped, and the
    per-particle one unclamped) gives the same meshes bit for bit from
    launch to launch: its corners add fixed point into K1's accumulator
    (csrc/mesh_fixed.cuh).  At B-spline orders 1-4, with ties and outliers,
    for the render's case (2 shifts, C = 1, alpha) and the force read's (C
    = 3, no alpha), with values spanning 12 decades; within 1e-5 of the
    plain version; a non-finite beta makes the meshes non-finite where it
    lands (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K6 is CUDA")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    pos, _ = _lattice_particles((16, 16, 16), (2, 2, 2), 2, 31, n_out=400)
    pos = torch.tensor(_with_ties(pos, (16, 16, 16), (2, 2, 2), np.random.default_rng(32)),
                       device=dev)
    n = pos.shape[0]
    wide = torch.tensor(10.0 ** np.random.default_rng(33).uniform(-6, 6, n), dtype=torch.float32,
                        device=dev)
    for order in (1, 2, 3, 4):
        for S, C in ((2, 1), (1, 3)):
            gc = tpa.cic_geometry((32, 32, 32), S, (16, 16, 16), 2, True, order)
            gu = tpa.cic_geometry((32, 32, 32), S, order=order)
            alpha = torch.randn((n, C), generator=gen, device=dev) if S == 2 else None
            beta = torch.randn((n, C, 3), generator=gen, device=dev) * wide[:, None, None]
            for f, g in ((tpa.paint_cic_grad_tiled_kernel, gc), (tpa.paint_cic_grad_kernel, gc),
                         (tpa.paint_cic_grad_kernel, gu)):
                a, b = f(pos, alpha, beta, g), f(pos, alpha, beta, g)
                assert torch.equal(a, b), (f.__name__, order, S, C)
                ref = tpa.paint_cic_grad_plain(pos, alpha, beta, g)
                torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    bad = beta.clone()
    bad[5, 0, 1] = float("nan")
    for f in (tpa.paint_cic_grad_tiled_kernel, tpa.paint_cic_grad_kernel):
        out = f(pos, None, bad, gc)
        assert torch.isnan(out).any() and torch.isfinite(out).sum() > out.numel() // 2


@pytest.mark.cuda
def test_ap_png_model_gradient_finite_on_card():
    """One value+grad of chip_smoke.py's 5k (a) configuration at 32^3 on the
    card (2LPT, Lagrangian bias, ap_auto=True, png_type='fNL',
    quad-Gaussian, Kaiser preconditioning, float32), every scalar latent
    but s_e2_ 0.3 sigma off the fiducial (fNL off 0, the cosmology off the
    fiducial one that ap_auto maps through): the logpdf and every latent's
    gradient (alpha_iso_, alpha_ap_ and the fNL*_ latents included) are
    finite (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    conf = dict(default_config, final_shape=(32,) * 3, cell_length=1000.0 / 32,
                box_center=(0.0, 0.0, 1500.0), evolution="lpt", a_obs=0.5, curved_sky=False,
                lik_type="quad_gauss", precond="kaiser", ap_auto=True, png_type="fNL")
    model = FieldLevelModel(**conf, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.reparam({k: np.asarray(v) for k, v in model.fiduc.items()}, inv=True)
    params = {k: v if k == "s_e2_" else v + 0.3 for k, v in params.items()}
    params["white_mesh_"] = torch.randn(model.init_shape, generator=gen, device="cuda")
    obs = model.predict(seed=gen, samples=params, hide_samp=False)["count_mesh"]
    leaves = {k: torch.as_tensor(v, device="cuda").clone().requires_grad_(True)
              for k, v in params.items()}
    lp = model.logpdf({**leaves, "count_mesh": obs})
    grads = torch.autograd.grad(lp, list(leaves.values()))
    assert torch.isfinite(lp)
    assert {"alpha_iso_", "alpha_ap_", "fNL_", "fNL_bp_", "fNL_bpd_"} <= set(leaves)
    for k, g in zip(leaves, grads):
        assert torch.isfinite(g).all(), k


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


@pytest.mark.cuda
def test_double_backward_kernels_match_plain_on_card():
    """K6 (paint_cic_grad) and K7 (read_cic_hess) against their plain
    versions on the card at B-spline orders 1-4, clamped and unclamped, with
    ties, for the render's case (2 shifts, C = 1, K6 with alpha) and the
    force read's (1 shift, C = 3; C = 6 in two launches); then one
    Hessian-vector product through each Function chain against autograd
    twice of the plain versions (no ties: the second derivative jumps
    there), 1e-4 of the largest entry (K1's and K6's atomics, three kernels
    deep).  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K6/K7 are CUDA")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    pos0, w = (torch.tensor(a, device=dev) for a in _lattice_particles((16, 16, 16), (2, 2, 2),
                                                                        5, 19))
    pos = torch.tensor(_with_ties(pos0.cpu().numpy(), (16, 16, 16), (2, 2, 2),
                                  np.random.default_rng(20)), device=dev)
    n = pos.shape[0]
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-5,
                                                    atol=1e-5 * float(b.abs().max()) + 1e-30)
    for order in (1, 2, 3, 4):
        for clip in (True, False):
            for S, C in ((2, 1), (1, 3), (1, 6)):
                geom = tpa.cic_geometry((32, 32, 32), S, (16, 16, 16), 5, clip, order)
                alpha = torch.randn((n, C), generator=gen, device=dev) if S == 2 else None
                beta = torch.randn((n, C, 3), generator=gen, device=dev)
                mesh = torch.randn((S, 32, 32, 32, C), generator=gen, device=dev)
                b = torch.randn((n, 3), generator=gen, device=dev)
                close(tpa.paint_cic_grad_kernel(pos, alpha, beta, geom),
                      tpa.paint_cic_grad_plain(pos, alpha, beta, geom))
                for x, y in zip(tpa.read_cic_hess_kernel(pos, mesh, b, geom),
                                tpa.read_cic_hess_plain(pos, mesh, b, geom)):
                    close(x, y)
        geom2 = tpa.cic_geometry((32, 32, 32), 2, (16, 16, 16), 5, True, order)
        geom1 = tpa.cic_geometry((32, 32, 32), 1, (16, 16, 16), 5, True, order)
        G = torch.randn((2, 32, 32, 32), generator=gen, device=dev)
        M = torch.randn((32, 32, 32, 3), generator=gen, device=dev)
        ct = torch.randn((n, 3), generator=gen, device=dev)
        for args, f in (((pos0, w), lambda paint: lambda p, ww: (G * paint(p, ww, geom2) ** 2).sum()),
                        ((pos0, M), lambda read: lambda p, m: (ct * read(p, m, geom1) ** 2).sum())):
            vs = [torch.randn(a.shape, generator=gen, device=dev) for a in args]
            out = []
            for fn in ((tpa._PaintCIC.apply, tpa.paint_cic_plain) if args[1] is w
                       else (tpa._ReadCIC.apply, tpa.read_cic_plain)):
                leaves = [a.clone().requires_grad_(True) for a in args]
                grads = torch.autograd.grad(f(fn)(*leaves), leaves, create_graph=True,
                                            allow_unused=True)
                out.append(torch.autograd.grad(
                    sum((g * v).sum() for g, v in zip(grads, vs) if g is not None), leaves,
                    allow_unused=True))
            for x, y in zip(*out):
                if y is not None:
                    torch.testing.assert_close(x, y, rtol=1e-4,
                                               atol=1e-4 * float(y.abs().max()) + 1e-30)


@pytest.mark.cuda
def test_tiled_double_backward_kernels_match_plain_on_card():
    """The lattice-brick K6 and K7 (`paint_cic_grad_tiled`,
    `read_cic_hess_tiled`) against their plain versions and against the
    per-particle designs on the card, at B-spline orders 1-4, clamped, with
    ties and outliers past the clamp bound, for the render's case (2
    shifts, C = 1, K6 with alpha), the force read's (C = 3) and C = 6 (two
    launches); some particles take the device-memory path (max_disp 5
    against the plans' smaller margins).  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K6/K7 are CUDA")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    pos, _ = _lattice_particles((16, 16, 16), (2, 2, 2), 5, 21)
    pos = torch.tensor(_with_ties(pos, (16, 16, 16), (2, 2, 2), np.random.default_rng(22)),
                       device=dev)
    n = pos.shape[0]
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-5,
                                                    atol=1e-5 * float(b.abs().max()) + 1e-30)
    outliers = 0
    for order in (1, 2, 3, 4):
        for S, C in ((2, 1), (1, 3), (1, 6)):
            geom = tpa.cic_geometry((32, 32, 32), S, (16, 16, 16), 5, True, order)
            alpha = torch.randn((n, C), generator=gen, device=dev) if S == 2 else None
            beta = torch.randn((n, C, 3), generator=gen, device=dev)
            mesh = torch.randn((S, 32, 32, 32, C), generator=gen, device=dev)
            b = torch.randn((n, 3), generator=gen, device=dev)
            n_out = torch.zeros(1, dtype=torch.int64, device=dev)
            ref = tpa.paint_cic_grad_plain(pos, alpha, beta, geom)
            close(tpa.paint_cic_grad_tiled_kernel(pos, alpha, beta, geom, n_out), ref)
            close(tpa.paint_cic_grad_kernel(pos, alpha, beta, geom), ref)
            ref = tpa.read_cic_hess_plain(pos, mesh, b, geom)
            for got in (tpa.read_cic_hess_tiled_kernel(pos, mesh, b, geom, n_out),
                        tpa.read_cic_hess_kernel(pos, mesh, b, geom)):
                for x, y in zip(got, ref):
                    close(x, y)
            outliers += int(n_out.item())
            tpa.reset_launches()
            tpa._paint_grad(pos, alpha, beta, geom)
            tpa._read_hess(pos, mesh, b, geom)
            want = {name + "_tiled" * tpa._tiled(name, geom): -(-C // 4)
                    for name in ("paint_cic_grad", "read_cic_hess")}
            assert tpa.launches_at(order) == want
    assert outliers > 0


@pytest.mark.cuda
def test_background_kernel_matches_plain_on_card():
    """K8 (`background_tables`) against its plain version on the card: the
    raw tables and their first and second Omega_m derivatives for a
    float32 and a float64 Omega_m, flat LCDM and w0waCDM with curvature, at
    1e-6 of each output's largest entry in float32 (the kernel's float64
    results rounded once; the plain version's too) and 1e-12 in float64;
    one launch per `Background.create`, whose tables match the CPU's.
    Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K8 is CUDA")
    from montecosmo_tpu_torch.ops import background as tbg

    dev = torch.device("cuda")
    for consts in ((0.0, -1.0, 0.0), (0.02, -0.9, 0.1)):
        for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
            om = torch.tensor(0.31, dtype=dtype, device=dev)
            got = tbg.background_tables_kernel(om, *consts, dtype)
            ref = tbg.background_tables_plain(om.cpu(), *consts, "cpu", dtype)
            for x, y in zip(got, ref):
                assert x.dtype == dtype
                torch.testing.assert_close(x.cpu(), y, rtol=tol, atol=tol * float(y.abs().max()))
    tpa.reset_launches()
    om = torch.tensor(0.31, device=dev, requires_grad=True)
    cosmo = tbg.get_cosmology(Omega_m=om, sigma8=torch.tensor(0.8, device=dev))
    bg = tbg.Background.create(cosmo)
    assert dict(tpa.LAUNCHES) == {("background_tables", "background", 0): 1}
    bc = tbg.Background.create(tbg.get_cosmology(Omega_m=om.detach().cpu(),
                                                 sigma8=torch.tensor(0.8)))
    for name in ("g_tab", "g2_tab", "f_tab", "f2_tab", "chi_tab", "a_chi_tab"):
        x, y = getattr(bg, name).detach().cpu(), getattr(bc, name)
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6 * float(y.abs().max()))
    (g,) = torch.autograd.grad(bg.g_tab.sum() + bg.chi_tab.sum() * 1e-3, om, create_graph=True)
    (h,) = torch.autograd.grad(g, om)
    omc = om.detach().cpu().requires_grad_(True)
    bc = tbg.Background.create(tbg.get_cosmology(Omega_m=omc, sigma8=torch.tensor(0.8)))
    (gc,) = torch.autograd.grad(bc.g_tab.sum() + bc.chi_tab.sum() * 1e-3, omc,
                                create_graph=True)
    (hc,) = torch.autograd.grad(gc, omc)
    torch.testing.assert_close(g.detach().cpu(), gc.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(h.cpu(), hc, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_segment_sum_kernel_matches_plain_and_repeats_bit_for_bit_on_card():
    """K9 (`segment_sum`) against its plain version in float64 on the card,
    float32 and float64 values, int32 and int64 ids, ids in runs (a light
    cone's) and uniform, some out of range; 1, 2, 8 and 10 columns (10: two
    column chunks) and a table of 7000 x 2 rows (row chunks): within 1e-6
    (float32) and 1e-12 (float64) of the largest sum, and two launches
    equal bit for bit.  Then `take_rows`' backward launches K9 under
    "take_rows" and matches the CPU's.  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K9 is CUDA")
    from montecosmo_tpu_torch.ops import segment as tsg

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n, cols, rows in ((200_000, 1, 82), (300_000, 2, 2047), (100_000, 8, 127),
                          (50_000, 10, 111), (60_000, 2, 7000)):
        for kind in ("runs", "uniform"):
            ids = rng.integers(-2, rows + 2, n)
            ids = np.sort(ids) if kind == "runs" else ids
            src = rng.standard_normal((n, cols)) * 10.0 ** rng.uniform(-2, 2, (n, 1))
            ref = tsg.segment_sum_plain(torch.tensor(src), torch.tensor(ids), rows)
            for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
                for itype in (torch.int32, torch.int64):
                    s = torch.tensor(src, dtype=dtype, device=dev)
                    i = torch.tensor(ids, dtype=itype, device=dev)
                    a = tsg.segment_sum_kernel(s, i, rows)
                    b = tsg.segment_sum_kernel(s, i, rows)
                    torch.cuda.synchronize()
                    assert torch.equal(a, b), (n, cols, rows, kind, dtype, itype)
                    ref_d = tsg.segment_sum_plain(s.double().cpu(), i.cpu(), rows)
                    torch.testing.assert_close(a.double().cpu(), ref_d, rtol=0,
                                               atol=tol * float(ref.abs().max()))
    tpa.reset_launches()
    tab = torch.randn(127, 2, 4, device=dev, requires_grad=True)
    idx = torch.tensor(np.sort(rng.integers(0, 127, 100_000)), device=dev)
    (g,) = torch.autograd.grad((tsg.take_rows(tab, idx) ** 2).sum(), tab)
    assert dict(tpa.LAUNCHES) == {("segment_sum", "take_rows", 0): 1}
    tc = tab.detach().cpu().requires_grad_(True)
    (gc,) = torch.autograd.grad((tsg.take_rows(tc, idx.cpu()) ** 2).sum(), tc)
    torch.testing.assert_close(g.cpu(), gc, rtol=1e-5, atol=1e-5 * float(gc.abs().max()))


@pytest.mark.cuda
def test_cut_sky_register_mask_equals_cpu_on_card():
    """A 32^3-budget cut-sky register (20,000 data, 200,000 randoms in the
    geometry of examples/cutsky_inference.py) built on the card (K1 paints
    the footprint, K1 and K3 the selection and the counts) and on the CPU
    (their plain versions): the footprint masks equal cell for cell, the
    counts and the selection within 1e-5 of their largest value (skips
    without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 and K3 are CUDA")
    from montecosmo_tpu_torch import FieldLevelModel
    from montecosmo_tpu_torch.ops.background import get_cosmology

    def catalog(n, seed):
        rng = np.random.default_rng(seed)
        smin, smax = np.sin(np.deg2rad(-20.0)), np.sin(np.deg2rad(20.0))
        return dict(RA=rng.uniform(150.0, 210.0, n),
                    DEC=np.rad2deg(np.arcsin(rng.uniform(smin, smax, n))),
                    Z=rng.triangular(0.8, 1.0, 1.2, n), WEIGHT=np.ones(n))

    data, rand = catalog(20_000, 0), catalog(200_000, 1)
    cosmo = get_cosmology(Omega_m=0.3138, sigma8=0.8076)
    card, cpu = (FieldLevelModel.register_catalog(32**3, cosmo, data, rand, device=dev)
                 for dev in ("cuda", "cpu"))
    np.testing.assert_array_equal(card["mask_mesh"], cpu["mask_mesh"])
    assert 0.5 < cpu["mask_mesh"].mean() < 1.0
    for k in ("count_mesh", "selec_mesh"):
        np.testing.assert_allclose(card[k], cpu[k], rtol=0,
                                   atol=1e-5 * np.abs(cpu[k]).max(), err_msg=k)


@pytest.mark.cuda
def test_tsit5_on_card_matches_cpu():
    """nbody_tsit5 at 16^3 (tol 1e-3, 3 snapshots from a = 0.1 to 1, grad_fd
    4; each force evaluation K1's unclamped paint and K4's read, atomic
    designs) on the card and on the CPU (their plain versions): the same
    accepted and rejected steps, the states within 1e-4 of their largest
    value (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 and K4 are CUDA")
    from montecosmo_tpu_torch.models.bricks import regular_pos, white2lin, white_noise
    from montecosmo_tpu_torch.ops.background import Background, get_cosmology
    from montecosmo_tpu_torch.ops.pm import nbody_tsit5

    shape, box = (16, 16, 16), (64.0,) * 3
    cosmo = get_cosmology(Omega_m=0.31, sigma8=0.8)
    lin = white2lin(cosmo, white_noise(torch.Generator().manual_seed(0), shape, box), shape, box)
    out, stats = {}, {}
    for dev in ("cuda", "cpu"):
        stats[dev] = {}
        tpa.reset_launches()
        with torch.no_grad():
            out[dev] = nbody_tsit5(Background.create(cosmo, device=dev), lin.to(dev),
                                   regular_pos(shape, device=dev), 0.1, 1.0, tol=1e-3,
                                   snapshots=3, stats=stats[dev])
        if dev == "cuda":
            launched = dict(tpa.LAUNCHES)
    assert stats["cuda"] == stats["cpu"], stats
    assert launched.get(("paint_cic", "bspline", 2), 0) >= stats["cuda"]["force_evaluations"]
    for x, ref in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x.cpu(), ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_bispectrum_sums_match_plain_and_repeat_on_card():
    """K10 (bispectrum_sums) against its plain version on the shells of a
    32^3 local-quadratic field (the default kedges), within 1e-9 of each
    triple's float64 sum of |products| (both sum the same float64
    products, in another order); two launches equal bit for bit; and
    metrics.bispectrum on the card launches it twice (partials, then their
    ordered sum) and equals the CPU's within 1e-4 of max |B| (skips
    without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K10 is CUDA")
    from montecosmo_tpu_torch import metrics as M
    from montecosmo_tpu_torch.ops import bispectrum as BS

    g = torch.randn((32, 32, 32), generator=torch.Generator().manual_seed(3))
    field = g + 0.05 * (g**2 - (g**2).mean())
    F, U, tri, _ = M._bispectrum_inputs(field.cuda(), (64.0,) * 3)
    out = BS.bispectrum_triples_kernel(F, U, tri)
    assert torch.equal(out, BS.bispectrum_triples_kernel(F, U, tri))
    ref, mag = BS.bispectrum_triples_plain(F, U, tri, with_abs=True)
    assert float(((out - ref).abs() / mag).max()) <= 1e-9
    tpa.reset_launches()
    _, t_card, b_card, _ = M.bispectrum(field.cuda(), box_size=(64.0,) * 3)
    assert dict(tpa.LAUNCHES) == {("bispectrum_sums", "partials", 0): 1,
                                  ("bispectrum_sums", "reduce", 0): 1}
    _, t_cpu, b_cpu, _ = M.bispectrum(field, box_size=(64.0,) * 3)
    np.testing.assert_array_equal(t_card, t_cpu)
    torch.testing.assert_close(b_card.cpu(), b_cpu, rtol=0, atol=1e-4 * float(b_cpu.abs().max()))
