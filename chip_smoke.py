"""GPU smoke run of the PyTorch port (montecosmo_tpu_torch) on one card.

    python3 chip_smoke.py            # all phases (what the check runs)
    python3 chip_smoke.py --quick    # phases 1-3b at 32^3 only (kernel build and agreement)
    python3 chip_smoke.py --profile  # also per-layer times and a torch.profiler table

Phases, in order; any failure raises and the script exits non-zero:
  1. a CUDA card is required; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels (nvcc, sm_90a) from the checkout and print the
     build time;
  3. hold K1 (paint), K2 (paint adjoint) and K3 (NUFFT epilogue) against
     their plain PyTorch versions at 32^3 (stride-2 lattice; the tiled
     kernels' margins of 0-2 cells send many particles to device memory,
     and some tiles are wider than the mesh) and at the 128^3 flagship
     shapes (224^3 paint mesh, 11.24M particles): values and gradients,
     with the max relative errors (K3's element by element, forward and
     backward, each timed per call and on the device from the profiler's
     kernel durations), both times and the bound; K1 clamped in both designs, the lattice-brick one and
     the atomic one, each held, timed in turns (other, tiled, tiled,
     other), with the share of corner products that took the tiled
     design's outlier path (device memory) and the design the route
     (ops/paint.py::TILED_FROM) takes; K2 in its one design; at B-spline order
     2 (CIC) clamped to the lattice sites, then at orders 1, 3 and 4 (NGP,
     TSC, PCS), then with the Kaiser-Bessel window of support 1-4 (at the
     flagship render's cutoff optim_kcut(192/224)), clamped and unclamped,
     a quarter of the particles on ties (exactly on their sites or half a
     cell off per axis, odd NGP window bases); grid_sample(mode='nearest')
     of the cotangents is K2's NGP yardstick;
  3b. the same for K4 (C-channel read) and K5 (its adjoint), clamped and
     unclamped, at 32^3 and 224^3 with C = 3, at B-spline orders 2, 1, 3
     and 4 and Kaiser-Bessel supports 1-4, K4 and K5 clamped in both
     designs as K1 and K2 in phase 3; at B-spline order 2 K5 is held
     against autograd of K4's plain version; grid_sample (trilinear, and
     nearest at order 1, on a wrap-padded mesh: the unclamped read) and its
     backward are the B-spline library yardsticks; then K4/K5 on C = 6
     channels (two launches each, both designs);
  4. the golden 32^3 2LPT forward (tests/golden/golden_32.npz) on the card;
  4b. the golden 32^3 BullFrog N-body forward on the card;
  4c. the 32^3 BullFrog light cone (a_obs=None) on the golden white mesh at
     TSC, then NGP and PCS: the card's forward against the CPU's (the same
     port, the same inputs) at phase 4's tolerances (coherence 1 - 1e-3 at
     NGP; there the card with K1/K4/K3, in either design, replaced by their
     plain versions is held at phase 4's against the card, and the CPU with
     the white mesh moved by one ulp is printed); at NGP and PCS also one
     value+grad on the card, whose launches are those orders' counts;
  4d. the 32^3 curved-sky 2LPT light cone with the Kaiser-Bessel window of
     support 4 on the golden white mesh, card against CPU at phase 4's
     tolerances; one value+grad on the card at supports 1-3 (their
     launches); FieldLevelModel(**default_config) (64^3, curved sky, light
     cone) value+grad on the card and on the CPU, finite and agreeing;
  5. the flagship configuration of bench.py (128^3, 2LPT, Lagrangian bias,
     RSD, quad-Gaussian likelihood, Kaiser preconditioning, float32) on the
     card: draw the observation with `predict`, then 2 warm-up and 5 timed
     logpdf value+grad evaluations; print ms/eval, peak memory and the
     launches of its kernels (K1, K2, K3, each in the design the route
     takes), counted from 0 over those 7; then, from one more value+grad,
     the render paint's and its backward's own inputs: quantiles of
     |pos - site| per axis, K1's two designs on them (outlier share, times
     in turns) and K2 on them;
  5b. the same flagship with evolution='nbody' (10 BullFrog steps, force
     paints and reads at 224^3): K1, K2, K3, K4 and K5 must each launch in
     the design the route takes at CIC; then K5's and K4's inputs at the
     last step, as 5 does for K1 and K2;
  5c. the same N-body flagship on the light cone (a_obs=None) at TSC
     (paint_order=3): K1-K5 must each launch at order 3 (K1, K4 and K5
     tiled); then K5's and K4's inputs at the last step, as 5b; then the
     backward of every table gather of one more value+grad, by call site
     with its device ms (`table_backwards`), and the lookups that lpt and
     chi2a make on the flagship's own 11.24M scale factors in the parent's
     form, this port's and by advanced indexing, in turns (`lookup_forms`);
  5d. the 2LPT flagship on the curved sky and the light cone (curved_sky=True,
     a_obs=None) with the Kaiser-Bessel window of support 4: K1 (tiled), K2
     and K3 must each launch at Kaiser-Bessel support 4; then its table
     backwards and lookup forms, as 5c;
  6. last lines: the kernels JSON (one row per kernel, window and order;
     launches from phase 5b at CIC, 5c at TSC, 4c at NGP and PCS, 5d at
     Kaiser-Bessel 4, 4d at Kaiser-Bessel 1-3; K4/K5 run on no
     Kaiser-Bessel path of the model, 0; the rows of K1, K2, K4 and K5 are
     the design the route takes (`design`, its source and time, the
     launches it made), with `tiled_ms` and `atomic_ms` (K1, K5) or
     `gather_ms` (K4; K2's one design) the designs' times on the same
     inputs, the tiled design's `outlier_share` and source, at CIC the
     flagship measurements of 5/5b and at TSC those of 5c), then
     {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
QUICK = "--quick" in sys.argv
TOL = 1e-5  # max |kernel - plain| / max |plain|: float32 sums in another order
# (K1's and K5's atomics add in a run-dependent order; the same bound holds)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
ORDERS = (2, 1, 3, 4)      # window orders: CIC (the earlier rows) first
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
KB = "kaiser_bessel"
KB_OVERSAMP = 192 / 224    # the flagship render's window factor (nufft, 192^3 init, 224^3 paint)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of fn() in ms (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def turns(other, tiled, reps):
    """(other ms, tiled ms): the two designs of a kernel (per-particle or
    atomic, and lattice-brick) timed on the same inputs in turns, other,
    tiled, tiled, other, `reps` launches of each in all."""
    n = max(1, reps // 2)
    a0, t0, t1, a1 = (cuda_ms(f, n) for f in (other, tiled, tiled, other))
    return (a0 + a1) / 2, (t0 + t1) / 2


# the particle kernels' designs: (lattice-brick wrapper or None, per-particle
# or atomic wrapper, plain version) by row name
def designs(P):
    return {"paint_cic": (P.paint_cic_tiled_kernel, P.paint_cic_kernel, P.paint_cic_plain),
            "paint_cic_adjoint": (None, P.paint_cic_adjoint_kernel, P.paint_cic_adjoint_plain),
            "read_cic": (P.read_cic_tiled_kernel, P.read_cic_kernel, P.read_cic_plain),
            "read_cic_adjoint": (P.read_cic_adjoint_tiled_kernel, P.read_cic_adjoint_kernel,
                                 P.read_cic_adjoint_plain)}


# what the JSON calls each kernel's second design
OTHER = {"paint_cic": "atomic", "paint_cic_adjoint": "gather", "read_cic": "gather",
         "read_cic_adjoint": "atomic"}


def routed(P, name, geom):
    """The design the route (ops/paint.py::TILED_FROM) takes for `name`."""
    return "tiled" if P._tiled(name, geom) else OTHER[name]


def err_of(out, ref):
    """(max_abs_err, max_rel_err) of one output or of a pair."""
    if isinstance(out, tuple):
        return rel_err_pair(out[0], ref[0], out[1], ref[1])
    return rel_err(out, ref)


def each_design(P, name, args, geom, ref, reps, tag, share_of):
    """The designs of `name` on the same inputs: each held against the
    plain version's `ref` at TOL, both timed in turns; the tiled design's
    outlier share (its count over `share_of` corner products).  Returns the
    JSON row's design keys."""
    tiled, other, _ = designs(P)[name]
    if tiled is None:  # one design
        e_o = err_of(other(*args, geom), ref)
        t_o = cuda_ms(lambda: other(*args, geom), reps)
        log(f"# {tag} {name} {OTHER[name]} max_rel_err {e_o[1]:.3e}, {t_o:.3f} ms")
        assert e_o[1] <= TOL, f"{name} ({tag}) disagrees with its plain version"
        return {"design": OTHER[name], f"{OTHER[name]}_ms": t_o, "_err": e_o, "_ms": t_o}
    n_out = torch.zeros(1, dtype=torch.int64, device=args[0].device)
    e_t = err_of(tiled(*args, geom, n_out), ref)
    share = n_out.item() / share_of
    e_o = err_of(other(*args, geom), ref)
    t_o, t_t = turns(lambda: other(*args, geom), lambda: tiled(*args, geom), reps)
    design = routed(P, name, geom)
    log(f"# {tag} {name} tiled {plan_of(P, name, geom, args)}: outlier "
        f"share {share:.4e} of the corner products, max_rel_err {e_t[1]:.3e}, {t_t:.3f} ms; "
        f"{OTHER[name]} max_rel_err {e_o[1]:.3e}, {t_o:.3f} ms; route: {design}")
    assert max(e_t[1], e_o[1]) <= TOL, f"{name} ({tag}) disagrees with its plain version"
    return {"design": design, "tiled_ms": t_t, f"{OTHER[name]}_ms": t_o, "outlier_share": share,
            "_err": e_t if design == "tiled" else e_o, "_ms": t_t if design == "tiled" else t_o}


def plan_of(P, name, geom, args):
    """The tile plan of `name`'s tiled design on these inputs: K1 one
    channel, K4/K5 the mesh's channels; a read tile for K4, a paint tile
    for K1 and K5."""
    channels = 1 if name == "paint_cic" else args[1].shape[-1]
    return P.tile_plan(geom, channels, "read" if name == "read_cic" else "paint")


def bound(n_bytes, n_flop):
    """(least ms on the card, what bounds it): bytes moved (each input read
    once, each output written once) over the memory rate, or float32
    operations over the peak rate, whichever is larger."""
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S * 1e3, n_flop / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def rel_err(a, b):
    a, b = torch.view_as_real(a) if a.is_complex() else a, torch.view_as_real(b) if b.is_complex() else b
    err = float((a - b).abs().max())
    # an NGP position gradient is exactly 0 in both: its relative error is 0
    return err, err / max(float(b.abs().max()), 1e-30)


def elem_err(a, b, scale):
    """(max |a - b|, max |a - b| / scale) element by element."""
    d = (a - b).abs()
    return float(d.max()), float((d / scale).max())


# ----------------------------------------------------------------- phase 1
def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


# ----------------------------------------------------------------- phase 2
def phase_build():
    from montecosmo_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.cuda_library(rebuild=True)
    wall = time.perf_counter() - t0
    log(f"# build: nvcc {_kernels.BUILD_INFO['seconds']:.2f} s, load {wall:.2f} s (sm_90a)")
    for line in _kernels.BUILD_INFO["log"].splitlines():
        if "Compiling entry function" in line:
            log(f"#   ptxas: {line.split('function')[-1].strip()}")
        if "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")


# ----------------------------------------------------------------- phase 3
def _particles(lattice, stride, H, gen, device, ties=False):
    """Lattice-ordered positions: sites + N(0, 2.5 cells), 1% pushed past H;
    with `ties`, a quarter of the others exactly on their sites or half a
    cell off per axis (the round-half-to-even ties of the odd orders, and of
    the NGP window base, odd at the H used here: margin H + 2)."""
    from montecosmo_tpu_torch.ops.paint import _sites, cic_geometry

    geom = cic_geometry(tuple(l * s for l, s in zip(lattice, stride)), 2, lattice, H, True)
    sites = _sites(geom, device)
    P = sites.shape[0]
    disp = 2.5 * torch.randn((P, 3), generator=gen, device=device)
    out = torch.rand((P, 1), generator=gen, device=device) < 0.01
    disp = torch.where(out, torch.sign(disp) * (H + 3.0) + disp, disp)
    if ties:
        tie = (torch.rand((P, 1), generator=gen, device=device) < 0.25) & ~out
        half = 0.5 * torch.randint(-1, 2, (P, 3), generator=gen, device=device).float()
        disp = torch.where(tie, half, disp)
    w = 1 + 0.3 * torch.randn(P, generator=gen, device=device)
    return geom, (sites + disp).contiguous(), w.contiguous()


def rel_err_pair(a, ref_a, b, ref_b):
    """Worst (max_abs_err, max_rel_err) of two outputs."""
    ea, eb = rel_err(a, ref_a), rel_err(b, ref_b)
    return max(ea[0], eb[0]), max(ea[1], eb[1])


def ops_scale(order):
    """Operations of an order-`order` kernel per operation of its order-2
    (CIC) version: the P^3 corners, each an atomic or a gather with its
    weights."""
    return order**3 / 8


def _suffix(order, kernel):
    """Row-name suffix: none at CIC, `_order{P}` at the other B-splines,
    `_kb_order{P}` for the Kaiser-Bessel window."""
    if kernel == KB:
        return f"_kb_order{order}"
    return "" if order == 2 else f"_order{order}"


def check_kernels(lattice, stride, H, tag, reps, order=2, kernel="rectangular"):
    """K1, K2 at `order` of `kernel` (clamped to the sites and, except at
    B-spline CIC, also unclamped), and K3 deconvolving at `order`."""
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # ties but at B-spline CIC, whose inputs stay as they were
    kb = kernel == KB
    plain_cic = order == 2 and not kb
    geom, pos, w = _particles(lattice, stride, H, gen, dev, ties=not plain_cic)
    geom = P.cic_geometry(geom.shape, 2, lattice, H, True, order, kernel, KB_OVERSAMP)
    res = {}
    sfx = _suffix(order, kernel)

    # K1 forward in both designs (the lattice-brick one and the atomic one)
    # against the plain version, timed in turns, the row the design the
    # route takes at this order; K2 adjoint in its one design
    ref = P.paint_cic_plain(pos, w, geom)
    n_corner = geom.n_shift * pos.shape[0] * order**3
    d1 = each_design(P, "paint_cic", (pos, w), geom, ref, reps, f"{tag}{sfx}", n_corner)
    t_p1 = cuda_ms(lambda: P.paint_cic_plain(pos, w, geom), max(2, reps // 5))
    # K2 adjoint: against autograd of the plain paint at B-spline CIC; else
    # against K2's plain version (held against autograd on the CPU, lighter
    # on memory than autograd through order^3 corners, and at the support
    # edge of a tied Kaiser-Bessel window the finite limit)
    g = torch.randn(ref.shape, generator=gen, device=dev)
    if plain_cic:
        pr, wr = pos.clone().requires_grad_(True), w.clone().requires_grad_(True)
        rpos, rw = torch.autograd.grad((P.paint_cic_plain(pr, wr, geom) * g).sum(), (pr, wr))
    else:
        rpos, rw = P.paint_cic_adjoint_plain(pos, w, g, geom)
    d2 = each_design(P, "paint_cic_adjoint", (pos, w, g), geom, (rpos, rw), reps,
                      f"{tag}{sfx}", n_corner)
    t_p2 = cuda_ms(lambda: P.paint_cic_adjoint_plain(pos, w, g, geom), max(2, reps // 5))
    lib2 = None
    if not plain_cic:
        geom_u = P.cic_geometry(geom.shape, 2, order=order, kernel_type=kernel,
                                oversamp=KB_OVERSAMP)
        e1u = rel_err(P.paint_cic_kernel(pos, w, geom_u), P.paint_cic_plain(pos, w, geom_u))
        rpos, rw = P.paint_cic_adjoint_plain(pos, w, g, geom_u)
        dpk, dwk = P.paint_cic_adjoint_kernel(pos, w, g, geom_u)
        e2u = rel_err_pair(dpk, rpos, dwk, rw)
        log(f"# {tag} {kernel} order {order} unclamped: paint_cic max_rel_err {e1u[1]:.3e}, "
            f"paint_cic_adjoint max_rel_err {e2u[1]:.3e}; kernel "
            f"{cuda_ms(lambda: P.paint_cic_kernel(pos, w, geom_u), reps):.3f} ms, adjoint "
            f"{cuda_ms(lambda: P.paint_cic_adjoint_kernel(pos, w, g, geom_u), reps):.3f} ms")
        assert max(e1u[1], e2u[1]) <= TOL, f"unclamped {kernel} {order} disagrees at {tag}"
        if order == 1 and not kb:
            lib2 = _nearest_paint_adjoint(pos, g, dwk, tag, reps)
    # K3 forward and backward
    k3, t_k3, t_p3, d3 = check_epilogue(geom.shape, order, geom.kcut, gen, reps, f"{tag}{sfx}")
    cshape = (2,) + P.r2chshape(geom.shape)

    # bounds: bytes of the inputs read once and outputs written once;
    # operations counted per particle (or rfft cell) from the kernel source
    # (K3: 20 a cell at 2 shifts, its window and phase tabulated per axis);
    # the Kaiser-Bessel weights' Bessel evaluations are counted as no
    # operations (their library count is not known here), so at KB the
    # bound is a lower one
    n_p, n_s, n_c = pos.shape[0], geom.n_shift, int(np.prod(geom.shape))
    n_k = int(np.prod(cshape))
    b1 = bound(16 * n_p + 4 * n_s * n_c, n_s * n_p * 50 * ops_scale(order))
    b2 = bound(16 * n_p + 4 * n_s * n_c + 16 * n_p, n_s * n_p * 150 * ops_scale(order))
    b3 = bound(8 * n_k + 8 * n_k // n_s, 20 * n_k)
    for name, (ea, er), tk, tp, (bm, bb), lib in (
            ("paint_cic", d1.pop("_err"), d1.pop("_ms"), t_p1, b1, None),
            ("paint_cic_adjoint", d2.pop("_err"), d2.pop("_ms"), t_p2, b2, lib2),
            ("nufft_epilogue", k3, t_k3, t_p3, b3, None)):
        kind = " (element by element)" if name == "nufft_epilogue" else ""
        log(f"# {tag} {name + sfx:25s} max_abs_err {ea:.3e} max_rel_err {er:.3e}{kind}  "
            f"kernel {tk:.3f} ms  plain {tp:.3f} ms  bound {bm:.4f} ms ({bb})  library {lib} ms")
        assert er <= TOL, f"{name}{sfx} disagrees with its plain version at {tag}: {er:.3e} > {TOL}"
        res[name + sfx] = {"max_abs_err": ea, "ms": tk, "plain_ms": tp, "bound_ms": bm,
                           "bound_by": bb, "library_ms": lib}
    res["paint_cic" + sfx] |= d1
    res["paint_cic_adjoint" + sfx] |= d2
    res["nufft_epilogue" + sfx] |= d3
    return res


def check_epilogue(shape, order, kcut, gen, reps, tag):
    """K3 at the paint mesh `shape`, 2 shifts, deconvolving the window of
    `order` (the Kaiser-Bessel one with `kcut`, else the B-spline), forward
    and backward against the plain version element by element, and timed.
    Returns ((max_abs_err, max_rel_err), kernel ms, plain ms, the row's
    device and backward times)."""
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.ops.hermitian import r2chshape

    dev = torch.device("cuda")
    eg = P.EpilogueGeometry(shape, 2, float((7 / 6) ** 3), order, kcut)
    cshape = (2,) + r2chshape(shape)
    fk = randc(cshape, gen)
    out = P.nufft_epilogue_kernel(fk, eg)
    fr = fk.clone().requires_grad_(True)
    plain = P.nufft_epilogue_plain(fr, eg)
    gc = randc(plain.shape, gen)
    # a real loss L = Re<gc, out>: torch's gradient convention for complex z
    (gref,) = torch.autograd.grad((torch.view_as_real(plain) * torch.view_as_real(gc)).sum(), fr)
    gk = P.nufft_epilogue_kernel(gc, eg, backward=True)
    # K3 element by element, each error over the float32 scale of that
    # element's sum, sum_s |F_s| |c(k)| (the backward's one term |g| |c(k)|),
    # c(k) = scale / (n W(k)): near a zero of the KB window's transform 1/W
    # is ~1e9 times its typical value, and an error over max|plain| would
    # see only those modes
    mag = [f.abs() for f in P._epilogue_factors(eg, dev)]
    e_f = elem_err(out, plain.detach(), sum(m * fk[s].abs() for s, m in enumerate(mag)))
    e_b = elem_err(gk, gref, torch.stack([m * gc.abs() for m in mag]))
    log(f"# {tag} nufft_epilogue: over max|plain|: forward "
        f"{rel_err(out, plain.detach())[1]:.3e}, backward {rel_err(gk, gref)[1]:.3e}; "
        f"max|plain| {float(plain.detach().abs().max()):.3e}")
    k3 = (max(e_f[0], e_b[0]), max(e_f[1], e_b[1]))
    # each call timed with CUDA events (the wrapper's host work included),
    # and the kernel alone from the profiler's own durations, on inputs
    # taken in turn from sets that with their outputs hold twice the L2, so
    # that no launch finds its bytes in L2 from the one before
    per_set = 8 * (fk.numel() + gc.numel())
    n_sets = max(3, -(-2 * l2_bytes() // per_set))
    fsets = [fk] + [randc(cshape, gen) for _ in range(n_sets - 1)]
    bsets = [gc] + [randc(gc.shape, gen) for _ in range(n_sets - 1)]
    fwd = l2_cold(lambda x: P.nufft_epilogue_kernel(x, eg), fsets)
    bwd = l2_cold(lambda x: P.nufft_epilogue_kernel(x, eg, backward=True), bsets)
    t_k3 = cuda_ms(fwd, reps)
    row = {"device_ms": device_ms(fwd, reps, "nufft_epilogue"),
           "backward_ms": cuda_ms(bwd, reps),
           "backward_device_ms": device_ms(bwd, reps, "nufft_epilogue"), "l2_sets": n_sets}
    log(f"# {tag} nufft_epilogue ({n_sets} input sets, L2 {l2_bytes()} B): forward "
        f"{t_k3:.4f} ms a call, {row['device_ms']} ms on the device; backward "
        f"{row['backward_ms']:.4f} / {row['backward_device_ms']} ms")
    t_p3 = cuda_ms(l2_cold(lambda x: P.nufft_epilogue_plain(x, eg), fsets), reps)
    return k3, t_k3, t_p3, row


def l2_bytes():
    """The card's L2 cache in bytes (50 MiB, an H100's, if torch does not say)."""
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) or 50 * 2**20


def randc(shape, gen):
    """Standard complex normal values on the card."""
    return torch.complex(torch.randn(shape, generator=gen, device="cuda"),
                         torch.randn(shape, generator=gen, device="cuda"))


def l2_cold(call, inputs):
    """fn() that runs call(x) on the next of `inputs` in turn and keeps each
    output until its slot comes round again, so that consecutive launches
    share no input and write no block the one before just wrote."""
    outs, turn = [None] * len(inputs), [0]

    def fn():
        j = turn[0] % len(inputs)
        turn[0] += 1
        outs[j] = call(inputs[j])
    return fn


def device_ms(fn, reps, name):
    """Mean device time of one kernel whose name holds `name`, from
    torch.profiler's own kernel durations over `reps` calls of fn() (over
    the kernels it recorded: a profile may drop some of its device events);
    None ("not measured") if it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and name in e.key]
    count = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / count if count else None


def _nearest_paint_adjoint(pos, g, dw_unclamped, tag, reps):
    """K2's library yardstick at NGP, timed: one grid_sample(mode='nearest')
    batched over the S shifts reads each cotangent mesh at its shifted
    positions, summed over the shifts (K2's weight gradient, unclamped; its
    position gradient is 0, as K2's).  Its tie rule is not K2's (see
    `check_read_kernels`), so the error is printed and not held."""
    import torch.nn.functional as F

    S = g.shape[0]
    inps, grids = zip(*(_grid_sample_read(pos + s / S, g[s][..., None]) for s in range(S)))
    inp, grid = torch.cat(inps), torch.cat(grids)

    def read():
        return F.grid_sample(inp, grid, mode="nearest", padding_mode="border",
                             align_corners=True).sum(0)

    e = rel_err(read().reshape(-1), dw_unclamped)
    ms = cuda_ms(read, reps)
    log(f"# {tag} grid_sample (nearest) of the cotangents vs K2_order1 unclamped: "
        f"max_rel_err {e[1]:.3e}, share of particles that differ "
        f"{float((read().reshape(-1) != dw_unclamped).float().mean()):.3e}; {ms:.3f} ms")
    return ms


# ---------------------------------------------------------------- phase 3b
def _grid_sample_read(pos, mesh):
    """The unclamped CIC (or, with mode='nearest', NGP) read as one torch
    call: grid_sample (align_corners=True) on the mesh wrap-padded by one
    cell, channels first.  Returns (input, grid) prepared outside the timed
    call."""
    n = torch.tensor(mesh.shape[:3], device=pos.device, dtype=pos.dtype)
    padded = torch.cat([mesh, mesh[:1]], 0)
    padded = torch.cat([padded, padded[:, :1]], 1)
    padded = torch.cat([padded, padded[:, :, :1]], 2)
    inp = padded.permute(3, 0, 1, 2)[None].contiguous()
    # grid's last axis is (W, H, D) = (z, y, x); index i -> -1 + 2 i / n
    grid = (2 * torch.remainder(pos, n) / n - 1).flip(-1)
    return inp, grid.reshape(1, -1, 1, 1, 3).contiguous()


def check_read_kernels(lattice, stride, H, tag, reps, order=2, kernel="rectangular"):
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    kb = kernel == KB
    plain_cic = order == 2 and not kb
    geom_c, pos, _ = _particles(lattice, stride, H, gen, dev, ties=not plain_cic)
    geom_c = P.cic_geometry(geom_c.shape, 1, lattice, H, True, order, kernel, KB_OVERSAMP)
    geom_u = P.cic_geometry(geom_c.shape, 1, order=order, kernel_type=kernel,
                            oversamp=KB_OVERSAMP)
    sfx = _suffix(order, kernel)
    C = 3
    mesh = torch.randn(geom_c.shape + (C,), generator=gen, device=dev)
    ct = torch.randn((pos.shape[0], C), generator=gen, device=dev)
    out, rows = {}, {}
    for kind, geom in (("clamped", geom_c), ("unclamped", geom_u)):
        ref4 = P.read_cic_plain(pos, mesh, geom)
        if plain_cic:
            pr, mr = pos.clone().requires_grad_(True), mesh.clone().requires_grad_(True)
            rpos, rmesh = torch.autograd.grad((P.read_cic_plain(pr, mr, geom) * ct).sum(),
                                              (pr, mr))
        else:  # K5's plain version, as for K2 in phase 3
            rpos, rmesh = P.read_cic_adjoint_plain(pos, mesh, ct, geom)
        if kind == "unclamped":
            k4 = rel_err(P.read_cic_kernel(pos, mesh, geom), ref4)
            dpos, dmesh = P.read_cic_adjoint_kernel(pos, mesh, ct, geom)
            k5 = rel_err_pair(dpos, rpos, dmesh, rmesh)
            t4 = cuda_ms(lambda: P.read_cic_kernel(pos, mesh, geom), reps)
            t5 = cuda_ms(lambda: P.read_cic_adjoint_kernel(pos, mesh, ct, geom), reps)
        else:
            # both designs of K4 and K5 against the plain versions, timed in
            # turns; the clamped row is the design the route takes
            n_corner = pos.shape[0] * order**3
            rows["read_cic"] = each_design(P, "read_cic", (pos, mesh), geom, ref4, reps,
                                            f"{tag}{sfx}", n_corner)
            rows["read_cic_adjoint"] = each_design(P, "read_cic_adjoint", (pos, mesh, ct), geom,
                                                    (rpos, rmesh), reps, f"{tag}{sfx}", n_corner)
            (k4, t4), (k5, t5) = ((rows[n].pop("_err"), rows[n].pop("_ms"))
                                  for n in ("read_cic", "read_cic_adjoint"))
        t = {"read_cic": (t4, cuda_ms(lambda: P.read_cic_plain(pos, mesh, geom), max(2, reps // 5))),
             "read_cic_adjoint": (
                 t5, cuda_ms(lambda: P.read_cic_adjoint_plain(pos, mesh, ct, geom), max(2, reps // 5)))}
        out[kind] = {"read_cic": (k4, *t["read_cic"]),
                     "read_cic_adjoint": (k5, *t["read_cic_adjoint"])}

    # library yardstick: grid_sample forward (= K4 unclamped) and its
    # backward (= K5 unclamped: the paint of the cotangent and d/dpos,
    # which at NGP is 0 in both) at CIC and, with mode='nearest', at NGP
    # (it rounds half to even the coordinate it rebuilds from the normalised
    # grid, so ties may go the other way); none at TSC and PCS
    import torch.nn.functional as F

    lib = {"read_cic": None, "read_cic_adjoint": None}
    if order in (1, 2) and not kb:
        inp, grid = _grid_sample_read(pos, mesh)
        inp.requires_grad_(True)
        grid.requires_grad_(True)
        mode = "bilinear" if order == 2 else "nearest"
        sample = lambda: F.grid_sample(inp, grid, mode=mode, padding_mode="border",
                                       align_corners=True)

        def forward_only():
            with torch.no_grad():
                return sample()

        ref = P.read_cic_kernel(pos, mesh, geom_u)
        gs = sample()
        e_gs = rel_err(gs.detach().reshape(C, -1).T, ref)
        lib["read_cic"] = cuda_ms(forward_only, reps)
        gct = ct.T.reshape(gs.shape).contiguous()
        lib["read_cic_adjoint"] = cuda_ms(
            lambda: torch.autograd.grad(gs, (inp, grid), gct, retain_graph=True), reps)
        log(f"# {tag} grid_sample ({mode}) vs K4{sfx} unclamped: max_rel_err {e_gs[1]:.3e}; "
            f"fwd {lib['read_cic']:.3f} ms, bwd {lib['read_cic_adjoint']:.3f} ms")

    n_p, n_c = pos.shape[0], int(np.prod(geom_c.shape)) * C
    k = ops_scale(order)
    # as K1/K2's: the Kaiser-Bessel Bessel evaluations count no operations
    bounds = {"read_cic": bound(12 * n_p + 4 * n_c + 4 * C * n_p, (25 + 16 * C) * k * n_p),
              "read_cic_adjoint": bound(12 * n_p + 4 * n_c + 4 * C * n_p + 4 * n_c + 12 * n_p,
                                        (120 + 64 * C) * k * n_p)}
    res = {}
    for name in ("read_cic", "read_cic_adjoint"):
        bm, bb = bounds[name]
        for kind in ("clamped", "unclamped"):
            (ea, er), tk, tp = out[kind][name]
            log(f"# {tag} {name + sfx:25s} {kind:9s} max_abs_err {ea:.3e} max_rel_err {er:.3e}  "
                f"kernel {tk:.3f} ms  plain {tp:.3f} ms  bound {bm:.4f} ms ({bb})  "
                f"library {lib[name]} ms")
            assert er <= TOL, f"{name}{sfx} ({kind}) disagrees with its plain version at {tag}"
        (ea, _), tk, tp = out["clamped"][name]
        res[name + sfx] = {"max_abs_err": ea, "ms": tk, "plain_ms": tp, "bound_ms": bm,
                           "bound_by": bb, "library_ms": lib[name]} | rows[name]
    return res


def check_wide_read():
    """K4/K5 wrappers on C = 6 channels (two launches of at most 4), both
    designs of each, against their plain versions, 32^3 clamped TSC with
    ties."""
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    geom, pos, _ = _particles((16, 16, 16), (2, 2, 2), 5, gen, dev, ties=True)
    geom = P.cic_geometry(geom.shape, 1, (16, 16, 16), 5, True, 3)
    mesh = torch.randn(geom.shape + (6,), generator=gen, device=dev)
    ct = torch.randn((pos.shape[0], 6), generator=gen, device=dev)
    ref = P.read_cic_plain(pos, mesh, geom)
    e4, e4t = (rel_err(k(pos, mesh, geom), ref) for k in (P.read_cic_kernel, P.read_cic_tiled_kernel))
    rpos, rmesh = P.read_cic_adjoint_plain(pos, mesh, ct, geom)
    e5, e5t = (rel_err_pair(dpos, rpos, dmesh, rmesh) for dpos, dmesh in (
        P.read_cic_adjoint_kernel(pos, mesh, ct, geom),
        P.read_cic_adjoint_tiled_kernel(pos, mesh, ct, geom)))
    log(f"# 32^3 C = 6 read (2 launches each): read_cic max_rel_err {e4[1]:.3e} (tiled "
        f"{e4t[1]:.3e}), read_cic_adjoint max_rel_err {e5[1]:.3e} (tiled {e5t[1]:.3e})")
    assert max(e4[1], e4t[1], e5[1], e5t[1]) <= TOL, "the 6-channel read disagrees with its plain version"


WINDOWS = [(k, o) for k in ("rectangular", KB) for o in ORDERS]


def phase_kernels():
    for kernel, order in WINDOWS:  # max_disp 5: odd NGP window bases (9 at 224^3)
        check_kernels((16, 16, 16), (2, 2, 2), 5, "32^3", 20, order, kernel)
        check_read_kernels((16, 16, 16), (2, 2, 2), 5, "32^3", 20, order, kernel)
    check_wide_read()
    if QUICK:
        return None
    res = {}
    for kernel, order in WINDOWS:
        res |= check_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", 10, order, kernel)
        res |= check_read_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", 10, order, kernel)
    return res


# ----------------------------------------------------------------- phase 4
def _transfer_coherence(mesh0, mesh1, box):
    """Monopole transfer sqrt(P1/P0) and coherence P01/sqrt(P0 P1) in k
    bins of sqrt(3) k_fund up to the axis Nyquist."""
    shape = mesh0.shape
    f0, f1 = np.fft.rfftn(mesh0), np.fft.rfftn(mesh1)
    ks = [np.fft.fftfreq(n) * 2 * np.pi * n / box for n in shape[:-1]]
    ks.append(np.fft.rfftfreq(shape[-1]) * 2 * np.pi * shape[-1] / box)
    kmesh = np.sqrt(ks[0][:, None, None]**2 + ks[1][None, :, None]**2 + ks[2][None, None, :]**2)
    mult = np.full(kmesh.shape, 2.0)
    mult[..., 0] = mult[..., -1] = 1.0
    kmax = np.pi * min(shape) / box
    n_edges = max(int(kmax / (3**0.5 * 2 * np.pi / box)), 1)
    kedges = np.linspace(0.0, kmax, n_edges, endpoint=False) + kmax / n_edges / 2
    seg = np.searchsorted(kedges, kmesh.ravel(), side="right") - 1
    ok = (seg >= 0) & (seg < len(kedges) - 1)
    binsum = lambda x: np.bincount(seg[ok], (mult.ravel() * x.ravel())[ok], len(kedges) - 1)
    p0, p1 = binsum(np.abs(f0)**2), binsum(np.abs(f1)**2)
    cross = f0 * np.conj(f1)
    p01 = np.hypot(binsum(cross.real), binsum(cross.imag))
    return np.sqrt(p1 / p0), p01 / np.sqrt(p0 * p1)


def golden_predict(device, evolution, ulp=False, **updates):
    """The golden 32^3 configuration (tests/test_golden_bundle.py) with
    `updates`, on `device`: (model, params, gxy_mesh) on the golden white
    mesh (with `ulp`, every value moved up by one float32 ulp)."""
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    g = np.load(ROOT / "tests" / "golden" / "golden_32.npz")
    conf = dict(default_config)
    conf.update(final_shape=(32, 32, 32), cell_length=1000.0 / 32, evolution=evolution,
                lpt_order=2, a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 2000.0),
                ap_auto=None, lik_type="quad_gauss", precond="real")
    conf.update(updates)
    m = FieldLevelModel(**conf, device=device)
    fid = {k: np.asarray(v) for k, v in m.fiduc.items()}
    fid |= {"b1": 0.5, "b2": 0.3, "bs2": -0.2, "b3": 0.1, "bds2": 0.1, "bs3": -0.05,
            "bn2": 0.05, "bnpar": 0.2}
    p = m.reparam(fid, inv=True)
    p["white_mesh_"] = torch.as_tensor(g["white"], device=device)
    if ulp:
        p["white_mesh_"] = torch.nextafter(p["white_mesh_"], torch.tensor(np.inf, device=device))
    pred = m.predict(seed=1, samples=p, hide_base=False, hide_det=False, hide_samp=False)
    return m, p, pred


def check_transfer(gxy, ref, what, coh_limit=1e-5, hold=True):
    """Phase 4's tolerances: transfer within 2e-3, coherence above 1 - 1e-5
    (or 1 - `coh_limit`); without `hold`, only printed."""
    trans, coh = _transfer_coherence(gxy - 1.0, ref - 1.0, 1000.0)
    dt, dc = float(np.abs(trans - 1).max()), float(1 - coh.min())
    log(f"# {what}: max|transfer-1| {dt:.3e} (limit 2e-3), 1-min coherence {dc:.3e} "
        f"(limit {coh_limit:.0e}), max|difference| {np.abs(gxy - ref).max():.3e}")
    if hold:
        assert np.all(np.isfinite(gxy)) and gxy.shape == ref.shape
        assert dt <= 2e-3 and dc < coh_limit, f"{what}: disagrees"


def phase_golden(evolution):
    g = np.load(ROOT / "tests" / "golden" / "golden_32.npz")
    _, _, pred = golden_predict("cuda", evolution)
    check_transfer(pred["gxy_mesh"].cpu().numpy(), g[f"gxy_{evolution}"],
                   f"golden 32^3 {evolution} on the card")


def ngp_witnesses(lc, dev="cuda"):
    """What moves the NGP light cone between the card and the CPU.  The
    forward runs on the card, on the CPU, on the card with K1, K4 and K3
    replaced by their plain versions, and on the CPU with the white mesh
    moved by one ulp; for the pairs, the largest and mean differences of the
    final particle positions and of the positions the render paints (paint
    cells), the expected number of particles that cross an NGP cell edge
    (shifts x sum of |difference| per axis, edges one cell apart), and the
    transfer/coherence: held at phase 4's tolerances for the kernels against
    their plain versions on the card, printed for the others."""
    from montecosmo_tpu_torch.models import model as M
    from montecosmo_tpu_torch.ops import paint as P

    names = ("paint_cic_kernel", "paint_cic_tiled_kernel", "read_cic_kernel",
             "read_cic_tiled_kernel", "nufft_epilogue_kernel")
    nufft, kernels = M.nufft, {n: getattr(P, n) for n in names}

    def run(device, plain=False, ulp=False):
        seen = []

        def capture(pos, final_shape, paint_shape, **kw):
            ratio = torch.tensor(np.divide(paint_shape, final_shape), dtype=pos.dtype)
            seen.append((pos.detach().cpu() * ratio, kw["interlace_order"]))
            return nufft(pos, final_shape, paint_shape, **kw)

        M.nufft = capture
        if plain:
            P.paint_cic_kernel = P.paint_cic_tiled_kernel = P.paint_cic_plain
            P.read_cic_kernel = P.read_cic_tiled_kernel = P.read_cic_plain
            P.nufft_epilogue_kernel = lambda x, g, backward=False: P._epilogue_math(x, g, backward)
        try:
            _, _, pred = golden_predict(device, "nbody", ulp=ulp, **lc)
        finally:
            M.nufft = nufft
            for n, f in kernels.items():
                setattr(P, n, f)
        return pred["gxy_mesh"].cpu().numpy(), pred["nbody_ptcl"][0].cpu(), *seen[0]

    card, cpu = run(dev), run("cpu")
    for what, a, b, hold in (("card vs CPU", card, cpu, False),
                             ("card, kernels vs plain versions", card, run(dev, plain=True), True),
                             ("CPU, white mesh +1 ulp vs as is", run("cpu", ulp=True), cpu, False)):
        d_evol, d_paint = (a[1] - b[1]).abs(), (a[2] - b[2]).abs()
        log(f"# NGP witness, {what}: final positions max|difference| {float(d_evol.max()):.3e} "
            f"mean {float(d_evol.mean()):.3e} (evol cells); painted positions max "
            f"{float(d_paint.max()):.3e} mean {float(d_paint.mean()):.3e} (paint cells), "
            f"expected edge crossings {a[3] * float(d_paint.sum()):.2f}")
        check_transfer(a[0], b[0], f"NGP witness, {what}", 1e-5 if hold else 1e-3, hold)


def phase_lightcone_32(order):
    """The 32^3 N-body light cone at B-spline `order`, on the card against
    the CPU; at orders other than TSC (whose launches phase 5c counts) also
    one value+grad on the card, counted from 0.  Returns its launches."""
    lc = dict(a_obs=None, paint_order=order)
    m, p, pred = golden_predict("cuda", "nbody", **lc)
    _, _, ref = golden_predict("cpu", "nbody", **lc)
    # NGP is discontinuous: where the card's arithmetic puts a particle on
    # the other side of a cell edge than the CPU's, its whole weight moves
    # (measured 1 - coherence 2.6e-4 at 32^3, from ~1.5 expected crossings),
    # so the NGP coherence bound is 1e-3; the smooth orders keep phase 4's.
    # `ngp_witnesses` shows the kernels take no part in it
    check_transfer(pred["gxy_mesh"].cpu().numpy(), ref["gxy_mesh"].numpy(),
                   f"32^3 N-body light cone at order {order}, card vs CPU",
                   1e-3 if order == 1 else 1e-5)
    if order == 1:
        ngp_witnesses(lc)
    if order == 3:
        return {}
    lp, launches = _value_and_grad_launches(m, p, {"count_mesh": pred["count_mesh"]}, "bspline")
    log(f"# 32^3 light cone order {order} value+grad on the card: logpdf {lp:.6e}; "
        f"launches at order {order} {launches}")
    missing = [k for k in path_kernels(order, True) if not launches.get(k)]
    assert not missing, f"order-{order} kernels of the light cone never ran: {missing}"
    return launches


def _value_and_grad_launches(m, p, obs, window):
    """One logpdf value+grad of `m` on the card, counted from 0: (logpdf,
    launches at the model's order of `window`)."""
    from montecosmo_tpu_torch.ops import paint as P

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    P.reset_launches()
    lp = m.logpdf({**leaves, **obs})
    lp.backward()
    torch.cuda.synchronize()
    assert np.isfinite(lp.item()) and all(bool(torch.isfinite(v.grad).all())
                                          for v in leaves.values()), "non-finite logpdf or gradient"
    return lp.item(), P.launches_at(m.paint_order, window)


def phase_curved_32():
    """Phase 4d: the 32^3 curved-sky 2LPT light cone with the Kaiser-Bessel
    window of support 4 on the golden white mesh, card against CPU at phase
    4's tolerances; one value+grad on the card at supports 1-3, whose
    launches are those supports' counts (4's come from phase 5d); then the
    JAX package's own default configuration (64^3, curved sky, light cone,
    observer at the box center) on the card and on the CPU.  Returns the
    launches at supports 1-3."""
    lc = dict(a_obs=None, curved_sky=True, kernel_type=KB)
    m, p, pred = golden_predict("cuda", "lpt", paint_order=4, **lc)
    _, _, ref = golden_predict("cpu", "lpt", paint_order=4, **lc)
    check_transfer(pred["gxy_mesh"].cpu().numpy(), ref["gxy_mesh"].numpy(),
                   "32^3 curved-sky 2LPT light cone, Kaiser-Bessel support 4, card vs CPU")
    launches = {}
    for order in (1, 2, 3):
        m, p, pred = golden_predict("cuda", "lpt", paint_order=order, **lc)
        lp, launches[order] = _value_and_grad_launches(
            m, p, {"count_mesh": pred["count_mesh"]}, "kb")
        log(f"# 32^3 curved-sky light cone, Kaiser-Bessel support {order}, value+grad on the "
            f"card: logpdf {lp:.6e}; launches {launches[order]}")
        missing = [k for k in path_kernels(order) if not launches[order].get(k)]
        assert not missing, f"Kaiser-Bessel support-{order} kernels never ran: {missing}"
    default_config_both()
    return launches


def default_config_both():
    """FieldLevelModel(**default_config) value+grad on the card and on the
    CPU, from one white mesh and the card's count mesh: both finite, the
    logpdfs within 1e-4 relative (float32 sums of ~10^6 terms in another
    order)."""
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    white, obs, lps = None, None, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = FieldLevelModel(**default_config, device=dev)
        p = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
        if white is None:
            white = np.random.default_rng(0).standard_normal(m.init_shape).astype(np.float32)
        p["white_mesh_"] = torch.as_tensor(white, device=dev)
        if obs is None:
            obs = m.predict(seed=1, samples=p, hide_samp=False)["count_mesh"]
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        lp = m.logpdf({**leaves, "count_mesh": obs.to(dev)})
        lp.backward()
        lps[dev] = lp.item()
        assert np.isfinite(lps[dev]) and all(bool(torch.isfinite(v.grad).all())
                                             for v in leaves.values()), f"default_config on {dev}"
        log(f"# default_config ({m.final_shape} final, curved sky {m.curved_sky}, a_obs "
            f"{m.a_obs}, box_center {m.box_center.tolist()}) value+grad on {dev}: logpdf "
            f"{lps[dev]:.6e}, {time.perf_counter() - t0:.2f} s with set-up")
    rel = abs(lps["cuda"] - lps["cpu"]) / abs(lps["cpu"])
    log(f"# default_config logpdf, card vs CPU: relative difference {rel:.3e} (limit 1e-4)")
    assert rel <= 1e-4, "default_config: the card and the CPU disagree"


# ----------------------------------------------------------------- phase 5
def bench_model(final=128, evolution="lpt", **updates):
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=500.0 * 2 / final, evolution=evolution,
                lpt_order=2, a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 1500.0),
                lik_type="quad_gauss", precond="kaiser", paint_method="auto")
    conf.update(updates)
    return FieldLevelModel(**conf, device="cuda")


def phase_bench(evolution, kernels, tag=None, capture=None, lookups=False, **updates):
    """The flagship value+grad with `evolution` and the config `updates`;
    every kernel in `kernels` must launch at the model's paint order and
    window.  Returns the launch counts of the 7 evaluations there; with
    `capture` ("paint" or "read"), also what `flagship_inputs` measures.
    With `lookups` (the light cones), also the table gathers' backwards of
    one more value+grad by call site (`table_backwards`) and the lookup
    forms on the flagship's own scale factors (`lookup_forms`)."""
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.ops.background import Background, get_cosmology

    t0 = time.perf_counter()
    m = bench_model(evolution=evolution, **updates)
    tag = tag or evolution
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    params["white_mesh_"] = torch.randn(m.init_shape, generator=gen, device="cuda")
    obs = {"count_mesh": m.predict(seed=gen, samples=params, hide_base=False, hide_det=False,
                                   hide_samp=False)["count_mesh"]}
    torch.cuda.synchronize()
    log(f"# bench model ({tag}): final {m.final_shape} init {m.init_shape} "
        f"evol {m.evol_shape} paint {m.paint_shape} steps "
        f"{m.nbody_n_steps if evolution == 'nbody' else 0} "
        f"particles {int(np.prod(m.ptcl_shape))} max_disp {m.max_disp} "
        f"lattice {m.paint_lattice} rbins {m.n_rbins} a_obs {m.a_obs} curved_sky "
        f"{m.curved_sky} paint_order {m.paint_order} kernel_type {m.kernel_type}; set-up "
        f"{time.perf_counter() - t0:.2f} s")

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    def value_and_grad():
        for v in leaves.values():
            v.grad = None
        lp = m.logpdf({**leaves, **obs})
        lp.backward()
        return lp

    P.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        value_and_grad()
    torch.cuda.synchronize()
    times, values = [], []
    for _ in range(5):
        t = time.perf_counter()
        lp = value_and_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        values.append(lp.item())
    window = "kb" if m.kernel_type == KB else "bspline"
    launches = P.launches_at(m.paint_order, window)
    peak = torch.cuda.max_memory_allocated()
    grads_ok = all(bool(torch.isfinite(v.grad).all()) for v in leaves.values())
    log(f"# bench ({tag}) value+grad: ms/eval {[round(1e3 * t, 3) for t in times]} "
        f"mean {1e3 * np.mean(times):.3f} median {1e3 * np.median(times):.3f}; "
        f"evals/s {1 / np.median(times):.4f} (median); logpdf {values[-1]:.6e}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches in 7 evals {launches}")
    assert np.all(np.isfinite(values)) and grads_ok, "non-finite logpdf or gradient"
    log(f"# ({tag}) launches per value+grad at {window} order {m.paint_order}: "
        f"{ {k: v / 7 for k, v in launches.items()} }")
    missing = [k for k in kernels if not launches.get(k)]
    assert not missing, f"kernels of the {tag} path never ran: {missing} ({launches})"
    captured = flagship_inputs(tag, value_and_grad, capture) if capture else None
    if lookups:
        table_backwards(m, leaves, obs, tag)
        lookup_forms(m, tag)

    # share of the background RK4 tables: the same evaluations with the
    # tables built once, outside the timed loop (the timing changes, the
    # gradient w.r.t. Omega_m and sigma8 through the tables is dropped)
    fixed = Background.create(get_cosmology(Omega_m=float(m.cosmo_fid.Omega_m),
                                            sigma8=float(m.cosmo_fid.sigma8)), "cuda")
    create = Background.__dict__["create"]
    Background.create = classmethod(lambda cls, cosmo, device="cpu": fixed)
    try:
        t_fixed = []
        for _ in range(2):
            value_and_grad()
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            value_and_grad()
            torch.cuda.synchronize()
            t_fixed.append(time.perf_counter() - t)
    finally:
        Background.create = create
    share = 1 - np.median(t_fixed) / np.median(times)
    log(f"# ({tag}) with the background tables held fixed: ms/eval "
        f"{[round(1e3 * t, 3) for t in t_fixed]} median {1e3 * np.median(t_fixed):.3f}; "
        f"the RK4 tables take {100 * share:.1f}% of an evaluation (median to median)")
    if "--profile" in sys.argv:
        # profiled after every timed phase: a profiler session slows the
        # host's launches in the evaluations timed after it
        PROFILES.append(lambda: (log(f"# --- profile ({tag})"),
                                 layer_times(m, value_and_grad),
                                 profile_eval(value_and_grad, np.mean(times))))
    return (launches, captured) if capture else launches


# ------------------------------------------------------------ table lookups
GATHER_BACKWARDS = ("IndexBackward0", "IndexSelectBackward0")


def gather_nodes(root):
    """The gather-backward nodes of the autograd graph under `root`, with
    the gathered tensor's shape and the number of indices."""
    seen, stack, found = set(), [root], []
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if type(f).__name__ in GATHER_BACKWARDS:
            idx = getattr(f, "_saved_indices", None) or [getattr(f, "_saved_index", None)]
            found.append((f, tuple(getattr(f, "_saved_self_sym_sizes", ())),
                          sum(t.numel() for t in idx if t is not None)))
        stack.extend(nf for nf, _ in f.next_functions)
    return found


def call_site(node):
    """The port's frames of the forward call that made `node` (anomaly
    mode's traceback), innermost lookup first: 'interp.py:30 <- ...'."""
    tb = node.metadata.get("traceback_", "")
    tb = tb if isinstance(tb, str) else "".join(tb)
    frames = [ln.strip() for ln in tb.splitlines()
              if ln.strip().startswith("File") and "montecosmo_tpu_torch" in ln]
    short = [f"{f.split('/')[-1].split(chr(34))[0]}:{f.split('line ')[1].split(',')[0]}"
             f" {f.split(' in ')[-1]}" for f in frames]
    return " <- ".join(short[::-1][:5])


def table_backwards(m, leaves, obs, tag):
    """One value+grad of the flagship with the backward of every table
    gather timed on the card: the graph is built in anomaly mode (which
    keeps each node's forward stack), walked for its gather-backward nodes,
    and each is bracketed by CUDA events recorded by a pre-hook and a hook.
    Prints them by call site; returns (count, device ms) over all of them."""
    for v in leaves.values():
        v.grad = None
    with torch.autograd.detect_anomaly(check_nan=False):
        lp = m.logpdf({**leaves, **obs})
    nodes = gather_nodes(lp.grad_fn)
    timed = []
    for node, src, n_idx in nodes:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        node.register_prehook(lambda grads, e=t0: e.record())
        node.register_hook(lambda grads_in, grads_out, e=t1: e.record())
        timed.append((call_site(node), type(node).__name__, src, n_idx, t0, t1))
    lp.backward()
    torch.cuda.synchronize()
    total = 0.0
    for site, kind, src, n_idx, t0, t1 in sorted(timed, key=lambda r: r[0]):
        ms = t0.elapsed_time(t1)
        total += ms
        log(f"# ({tag}) table backward {kind} table {src} queries {n_idx}: {ms:.3f} ms at {site}")
    log(f"# ({tag}) table backwards of one value+grad: {len(timed)} nodes, {total:.3f} ms "
        f"of device time (events around each node)")
    return len(timed), total


def parent_uniform_interp(x, x0, dx, ytab, left=None, right=None, logx=False, xtab=None):
    """The port's lookup before the stacked-pair gather, for timing only:
    a 1-D table's ytab[i] and ytab[i + 1] gathered apart, and the node
    pairs likewise.  The same values as ops/interp.py::uniform_interp."""
    from montecosmo_tpu_torch.ops import interp as I

    n = ytab.shape[0]
    x = torch.as_tensor(x, dtype=ytab.dtype, device=ytab.device)
    xq = torch.log(torch.clamp(x, min=I._TINY)) if logx else x
    t = (xq - x0) / dx
    i = torch.clamp(torch.floor(t).long(), 0, n - 2)
    lo, hi = ytab[i], ytab[i + 1]
    if xtab is not None:
        x_lo, inv = I._node_pairs(xtab, x.device).unbind(1)
        frac = (x - x_lo[i]) * inv[i]
    else:
        frac = t - i
    y = lo + frac * (hi - lo)
    below = t < 0
    if logx:
        below = below | (x <= 0)
    y = torch.where(below, ytab[0] if left is None else torch.as_tensor(left, dtype=y.dtype), y)
    return torch.where(t > (n - 1), ytab[-1] if right is None else torch.as_tensor(
        right, dtype=y.dtype), y)


def rows_indexing(tab, i):
    """tab[i] by advanced indexing, for timing only: its backward is the
    sort-based index_put_, where ops/interp.py::take_rows takes index_select
    (whose backward is index_add_)."""
    return tab[i]


def lookup_forms(m, tag, reps=2):
    """The flagship's own per-particle scale factors (chi2a at the
    Lagrangian positions, as evolve takes them) through what lpt and
    chi2a look up, forward and backward to the tables (cotangents drawn
    once), in three forms timed in turns: the parent's (lpt: a2g, a2g2 and
    a2dg2dg's four lookups, each table gathered apart at i and i + 1), this
    port's (one gather of the stacked (n-1, 2, 4) pairs through
    index_select), and the same by advanced indexing.  Values agree bit for
    bit across the forms; each form's table gradient is held against the
    same lookup in float64.  Returns the ms by form."""
    from montecosmo_tpu_torch.models.bricks import los_scalefactor_pos, regular_pos
    from montecosmo_tpu_torch.ops import background as B, interp as I
    from montecosmo_tpu_torch.utils.safe import safe_div

    dev = torch.device(m.device)
    bg = B.Background.create(B.get_cosmology(Omega_m=float(m.cosmo_fid.Omega_m),
                                             sigma8=float(m.cosmo_fid.sigma8)), dev)
    bg = bg._replace(growth_tab=bg.growth_tab.detach().requires_grad_(True),
                     a_chi_tab=bg.a_chi_tab.detach().requires_grad_(True))
    pos = regular_pos(m.evol_shape, m.ptcl_shape, dev)
    seen, chi2a = [], B.Background.chi2a
    B.Background.chi2a = lambda self, chi: seen.append(chi.detach()) or chi2a(self, chi)
    try:
        _, a = los_scalefactor_pos(pos, m.box_center, m.box_rot, m.box_size, m.evol_shape, bg,
                                   None, m.curved_sky)
    finally:
        B.Background.chi2a = chi2a
    a, chi = a.detach(), seen[0]
    nodes = np.logspace(B.GROWTH_LOG10_AMIN, 0.0, bg.growth_tab.shape[0])
    x0 = float(np.log(nodes[0]))
    dx = float((np.log(nodes[-1]) - x0) / (nodes.size - 1))
    chi_dx = B.CHI_GRID_MAX / (B.CHI_STEPS - 1)

    def parent_growth():
        look = lambda col: parent_uniform_interp(a, x0, dx, bg.growth_tab[:, col], logx=True,
                                                 xtab=nodes)
        g, g2 = look(0), look(1) * (-3.0 / 7)
        gg, gg2, f, f2 = look(0), look(1) * (-3.0 / 7), look(2), look(3)
        return g, g2, safe_div(gg2 * f2, gg * f)

    def port_growth():
        g, g2, f, f2 = bg._growth(a)
        return g, g2, safe_div(g2 * f2, g * f)

    forms = {"parent": (parent_growth, lambda: parent_uniform_interp(chi, 0.0, chi_dx,
                                                                      bg.a_chi_tab)),
             "port": (port_growth, lambda: bg.chi2a(chi)),
             "indexing": (port_growth, lambda: bg.chi2a(chi))}
    gen = torch.Generator(device=dev).manual_seed(3)
    cot = [torch.randn(a.shape, generator=gen, device=dev) for _ in range(3)]
    # the table gradient of float32 sums of ~10^6 cotangents into a few
    # rows: each form's error against the same lookup in float64
    tab64 = bg.growth_tab.detach().double().requires_grad_(True)
    g, g2, f, f2 = bg._replace(growth_tab=tab64)._growth(a.double())
    (ref,) = torch.autograd.grad((g, g2, safe_div(g2 * f2, g * f)), tab64,
                                 [c.double() for c in cot])
    rows = I.take_rows
    out, ms = {}, {}
    try:
        for form, (growth, chi2a) in forms.items():
            I.take_rows = rows_indexing if form == "indexing" else rows
            vals = growth()
            (grad,) = torch.autograd.grad(vals, bg.growth_tab, cot)
            out[form] = (vals, chi2a())
            if form != "parent":
                assert all(torch.equal(u, v) for u, v in zip(vals, out["parent"][0])), form
                assert torch.equal(out[form][1], out["parent"][1]), form
            err = rel_err(grad.double(), ref)[1]
            log(f"# ({tag}) {form} lookups: table gradient max_rel_err {err:.3e} against "
                f"float64 (limit 1e-3)")
            assert err <= 1e-3, f"{form} lookups: table gradient"
        for what, k in (("growth", 0), ("chi2a", 1)):
            def run(form, k=k):
                I.take_rows = rows_indexing if form == "indexing" else rows
                f = forms[form][k]
                leaf = bg.growth_tab if k == 0 else bg.a_chi_tab
                vals = f()
                vals = vals if isinstance(vals, tuple) else (vals,)
                return torch.autograd.grad(vals, leaf, cot[:len(vals)])
            order = ("parent", "port", "indexing")
            t = {f: [] for f in order}
            for f in order + order[::-1]:
                t[f].append(cuda_ms(lambda f=f: run(f), reps, warmup=1))
            ms[what] = {f: float(np.mean(v)) for f, v in t.items()}
            log(f"# ({tag}) {what} lookups of {a.numel()} queries, forward + backward to the "
                f"table, in turns: " + ", ".join(f"{f} {v:.3f} ms" for f, v in ms[what].items()))
    finally:
        I.take_rows = rows
    return ms


# the kernels whose inputs each flagship capture records: the 2LPT render's
# paint and its backward; the N-body force read's VJP at the last step (the
# first K5 of the backward) and that step's read (the last K4 before it)
CAPTURES = {"paint": ("paint_cic", "paint_cic_adjoint"), "read": ("read_cic_adjoint", "read_cic")}


def flagship_inputs(tag, value_and_grad, which):
    """The flagship's own inputs of the kernels CAPTURES[which] names,
    recorded from one more value+grad through whichever design the route
    calls: the per-axis quantiles of |pos - site| in cells, the tiled
    design's outlier share, and each design on them, held against the
    plain version and timed (`each_design`).  Returns each kernel's JSON
    extras."""
    from montecosmo_tpu_torch.ops import paint as P

    names = CAPTURES[which]
    seen, saved = {}, {}

    def recorder(name, f):
        def record(*args):
            first_k5 = "read_cic_adjoint" in seen
            if name in ("paint_cic", "paint_cic_adjoint") or (
                    name == "read_cic_adjoint" and not first_k5) or (
                    name == "read_cic" and not first_k5):
                seen[name] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return f(*args)
        return record

    for name in names:
        for f in filter(None, designs(P)[name][:2]):
            saved[f.__name__] = f
            setattr(P, f.__name__, recorder(name, f))
    try:
        value_and_grad()
    finally:
        for n, f in saved.items():
            setattr(P, n, f)
    torch.cuda.synchronize()
    extras = {}
    for name in names:
        args, geom = seen[name][:-1], seen[name][-1]
        pos = args[0]
        d = (pos - P._sites(geom, pos.device)).abs()
        q = torch.tensor([0.5, 0.99, 0.999, 1.0], device=pos.device)
        quant = [[round(float(v), 4) for v in torch.quantile(d[:, a], q)] for a in range(3)]
        ref = designs(P)[name][2](*args, geom)
        row = each_design(P, name, args, geom, ref, 10, f"({tag}) the flagship's {name} inputs",
                           geom.n_shift * pos.shape[0] * geom.order**3)
        log(f"# ({tag}) the flagship's {name} inputs: |pos - site| quantiles 50/99/99.9/100% "
            f"per axis (cells) {quant}")
        row.pop("_err")
        extras[name] = {"flagship_ms": row.pop("_ms"), "flagship_disp_quantiles": quant}
        extras[name] |= {f"flagship_{k}": v for k, v in row.items() if k != "design"}
    return extras


def layer_times(m, fn, reps=3):
    """Forward wall time of prior / evolve / likelihood, and of the backward
    pass, inside value+grad evaluations (host clock, synchronized)."""
    acc = {}
    orig = {n: getattr(m, n) for n in ("prior", "evolve", "likelihood")}

    def timed(name, f):
        def g(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
            return out
        return g

    for n, f in orig.items():
        setattr(m, n, timed(n, f))
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        acc["total"] = acc.get("total", 0.0) + time.perf_counter() - t
    for n in orig:
        delattr(m, n)
    acc["log-probs+backward"] = acc["total"] - sum(acc[n] for n in orig)
    log("# layers (ms per value+grad; forward passes, then the rest): "
        + ", ".join(f"{k} {1e3 * v / reps:.1f}" for k, v in acc.items()))


def profile_eval(fn, eval_s):
    """Device time by kernel name for one evaluation."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"# profiler: device busy {busy_ms:.1f} ms per evaluation = "
        f"{100 * busy_ms / (1e3 * eval_s):.1f}% of the unprofiled {1e3 * eval_s:.1f} ms; "
        f"{launches} device kernels")
    for tag in ("paint_cic_tiled_kernel", "paint_cic_forward_kernel", "paint_cic_adjoint_kernel",
                "read_cic_forward_kernel", "read_cic_tiled_kernel", "read_cic_adjoint_tiled_kernel",
                "read_cic_adjoint_kernel", "nufft_epilogue", "indexing_backward", "indexFunc"):
        ms = sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
        log(f"# profiler: kernels named *{tag}* {ms:.3f} ms = "
            f"{100 * ms / max(busy_ms, 1e-9):.2f}% of device time")
    log(table)


# ----------------------------------------------------------------- main
CSRC = "montecosmo_tpu_torch/csrc/"
# route, the lattice-brick design's source, the other design's, what it
# replaces; a row's source is that of the design the route takes
SOURCES = {
    "paint_cic": ("cuda", CSRC + "paint_tiled.cu", CSRC + "paint_cic.cu",
                  "montecosmo_tpu/ops/paint_window.py:240"),
    "paint_cic_adjoint": ("cuda", None, CSRC + "paint_cic.cu",
                          "montecosmo_tpu/ops/paint_window.py:180"),
    "nufft_epilogue": ("cuda", None, CSRC + "nufft_epilogue.cu",
                       "montecosmo_tpu/ops/paint.py:192"),
    "read_cic": ("cuda", CSRC + "read_tiled.cu", CSRC + "paint_cic.cu",
                 "montecosmo_tpu/ops/paint_window.py:330"),
    "read_cic_adjoint": ("cuda", CSRC + "paint_tiled.cu", CSRC + "paint_cic.cu",
                         "montecosmo_tpu/ops/paint_window.py:395"),
}
# at orders 1, 3 and 4 K1 and K2 replace the deleted Pallas window kernels
# (git show d9c3c2e^:montecosmo_tpu/ops/paint_window_pallas.py)
WINDOW_PALLAS = {"paint_cic": "d9c3c2e^:montecosmo_tpu/ops/paint_window_pallas.py:52",
                 "paint_cic_adjoint": "d9c3c2e^:montecosmo_tpu/ops/paint_window_pallas.py:165"}
# the Kaiser-Bessel windows, which that Pallas kernel handed back to XLA
# (its :98-102): the XLA window weights, the read's, and the deconvolution
KB_REPLACES = {"paint_cic": "montecosmo_tpu/ops/paint_window.py:54",
               "paint_cic_adjoint": "montecosmo_tpu/ops/paint_window.py:54",
               "nufft_epilogue": "montecosmo_tpu/ops/fourier.py:238",
               "read_cic": "montecosmo_tpu/ops/paint_window.py:378",
               "read_cic_adjoint": "montecosmo_tpu/ops/paint_window.py:395"}


def path_name(name, order):
    """The launch count's name of kernel `name` on the model paths at
    `order`: every model paint and force read is clamped to the lattice,
    so the route (ops/paint.py::TILED_FROM) picks the design by order (K3
    has one)."""
    from montecosmo_tpu_torch.ops import paint as P

    geom = P.cic_geometry((8, 8, 8), 2, (8, 8, 8), 2, True, order)
    return name + "_tiled" if P._tiled(name, geom) else name


def path_kernels(order, nbody=False):
    """The kernels that must launch at `order` on the 2LPT paths (K1, K2,
    K3) or, with `nbody`, the N-body ones (also K4, K5), by launch name."""
    names = ("paint_cic", "paint_cic_adjoint", "nufft_epilogue")
    names += ("read_cic", "read_cic_adjoint") if nbody else ()
    return tuple(path_name(n, order) for n in names)


PROFILES = []


T0 = time.perf_counter()


def done(phase):
    log(f"# phase {phase} done at {time.perf_counter() - T0:.1f} s")


def main():
    phase_device()
    phase_build()
    done("2")
    res = phase_kernels()
    done("3/3b")
    if QUICK:
        log("# quick run: phases 4-6 skipped")
        return
    phase_golden("lpt")
    phase_golden("nbody")
    done("4/4b")
    launches = {("rectangular", order): phase_lightcone_32(order) for order in (3, 1, 4)}
    done("4c")
    launches |= {(KB, order): n for order, n in phase_curved_32().items()}
    done("4d")
    # the flagships' own inputs by B-spline order: CIC from 5 and 5b, TSC from 5c
    flagship = {2: phase_bench("lpt", path_kernels(2), capture="paint")[1]}
    done("5")
    launches["rectangular", 2], flagship_read = phase_bench("nbody", path_kernels(2, True),
                                                            capture="read")
    flagship[2] |= flagship_read
    done("5b")
    launches["rectangular", 3], flagship[3] = phase_bench(
        "nbody", path_kernels(3, True), "nbody light cone, TSC", capture="read", lookups=True,
        a_obs=None, paint_order=3)
    done("5c")
    # the flagship on the JAX package's default sky: curved, the light cone
    launches[KB, 4] = phase_bench("lpt", path_kernels(4), "curved-sky light cone, Kaiser-Bessel 4",
                                  lookups=True, a_obs=None, curved_sky=True, kernel_type=KB,
                                  paint_order=4)
    done("5d")
    for run in PROFILES:
        run()
    kernels = []
    for kernel, order in WINDOWS:
        sfx = _suffix(order, kernel)
        for n, (r, tiled, other, rep) in SOURCES.items():
            if kernel == KB:
                rep = KB_REPLACES[n]
            elif order != 2:
                rep = WINDOW_PALLAS.get(n, rep)
            tiled_path = path_name(n, order).endswith("_tiled")
            src = {"source": tiled if tiled_path else other}
            if tiled:
                src["tiled_source"] = tiled
            kernels.append({"name": n + sfx, "route": r, **src, "replaces": rep,
                            "window": "kb" if kernel == KB else "bspline", "order": order,
                            "launches": launches[kernel, order].get(path_name(n, order), 0),
                            **res[n + sfx]})
            if kernel != KB and n in flagship.get(order, {}):
                kernels[-1] |= flagship[order][n]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
