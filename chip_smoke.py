"""GPU smoke run of the PyTorch port (montecosmo_tpu_torch) on one card.

    python3 chip_smoke.py            # all phases (what the check runs)
    python3 chip_smoke.py --quick    # phases 1-3b at 32^3 only (kernel build and agreement)
    python3 chip_smoke.py --profile  # also per-layer times and a torch.profiler table

Phases, in order; any failure raises and the script exits non-zero:
  1. a CUDA card is required; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels (nvcc, sm_90a) from the checkout and print the
     build time;
  3. hold K1 (paint), K2 (paint adjoint) and K3 (NUFFT epilogue) against
     their plain PyTorch versions at 32^3 and at the 128^3 flagship shapes
     (224^3 paint mesh, 11.24M particles): values and gradients, with the
     max relative errors, both times and the bound;
  3b. the same for K4 (C-channel CIC read) and K5 (its adjoint), clamped to
     the lattice sites and unclamped, at 32^3 and 224^3 with C = 3; K5 is
     held against autograd of K4's plain version; grid_sample (trilinear
     on a wrap-padded mesh, the unclamped read) is their library yardstick;
  4. the golden 32^3 2LPT forward (tests/golden/golden_32.npz) on the card;
  4b. the golden 32^3 BullFrog N-body forward on the card;
  5. the flagship configuration of bench.py (128^3, 2LPT, Lagrangian bias,
     RSD, quad-Gaussian likelihood, Kaiser preconditioning, float32) on the
     card: draw the observation with `predict`, then 2 warm-up and 5 timed
     logpdf value+grad evaluations; print ms/eval, peak memory and the
     launches of its kernels (K1, K2, K3), counted from 0 over those 7;
  5b. the same flagship with evolution='nbody' (10 BullFrog steps, force
     paints and reads at 224^3): K1, K2, K3, K4 and K5 must each launch;
  6. last lines: the kernels JSON (launches from phase 5b), then
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
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores


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


def bound(n_bytes, n_flop):
    """(least ms on the card, what bounds it): bytes moved (each input read
    once, each output written once) over the memory rate, or float32
    operations over the peak rate, whichever is larger."""
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S * 1e3, n_flop / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def rel_err(a, b):
    a, b = torch.view_as_real(a) if a.is_complex() else a, torch.view_as_real(b) if b.is_complex() else b
    err = float((a - b).abs().max())
    return err, err / float(b.abs().max())


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
        if "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")


# ----------------------------------------------------------------- phase 3
def _particles(lattice, stride, H, gen, device):
    """Lattice-ordered positions: sites + N(0, 2.5 cells), 1% pushed past H."""
    from montecosmo_tpu_torch.ops.paint import _sites, cic_geometry

    geom = cic_geometry(tuple(l * s for l, s in zip(lattice, stride)), 2, lattice, H, True)
    sites = _sites(geom, device)
    P = sites.shape[0]
    disp = 2.5 * torch.randn((P, 3), generator=gen, device=device)
    out = torch.rand((P, 1), generator=gen, device=device) < 0.01
    disp = torch.where(out, torch.sign(disp) * (H + 3.0) + disp, disp)
    w = 1 + 0.3 * torch.randn(P, generator=gen, device=device)
    return geom, (sites + disp).contiguous(), w.contiguous()


def check_kernels(lattice, stride, H, tag, reps):
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    geom, pos, w = _particles(lattice, stride, H, gen, dev)
    res = {}

    # K1 forward
    ker = P.paint_cic_kernel(pos, w, geom)
    ref = P.paint_cic_plain(pos, w, geom)
    k1 = rel_err(ker, ref)
    t_k1 = cuda_ms(lambda: P.paint_cic_kernel(pos, w, geom), reps)
    t_p1 = cuda_ms(lambda: P.paint_cic_plain(pos, w, geom), max(2, reps // 5))
    # K2 adjoint against autograd of the plain paint
    g = torch.randn(ker.shape, generator=gen, device=dev)
    dpos, dw = P.paint_cic_adjoint_kernel(pos, w, g, geom)
    pr, wr = pos.clone().requires_grad_(True), w.clone().requires_grad_(True)
    rpos, rw = torch.autograd.grad((P.paint_cic_plain(pr, wr, geom) * g).sum(), (pr, wr))
    e_pos, e_w = rel_err(dpos, rpos), rel_err(dw, rw)
    k2 = (max(e_pos[0], e_w[0]), max(e_pos[1], e_w[1]))
    t_k2 = cuda_ms(lambda: P.paint_cic_adjoint_kernel(pos, w, g, geom), reps)
    t_p2 = cuda_ms(lambda: P.paint_cic_adjoint_plain(pos, w, g, geom), max(2, reps // 5))
    # K3 forward and backward
    from montecosmo_tpu_torch.ops.hermitian import r2chshape

    eg = P.EpilogueGeometry(geom.shape, 2, float((7 / 6) ** 3), 2)
    cshape = (2,) + r2chshape(geom.shape)
    fk = torch.complex(torch.randn(cshape, generator=gen, device=dev),
                       torch.randn(cshape, generator=gen, device=dev))
    out = P.nufft_epilogue_kernel(fk, eg)
    fr = fk.clone().requires_grad_(True)
    plain = P.nufft_epilogue_plain(fr, eg)
    gc = torch.complex(torch.randn(plain.shape, generator=gen, device=dev),
                       torch.randn(plain.shape, generator=gen, device=dev))
    # a real loss L = Re<gc, out>: torch's gradient convention for complex z
    (gref,) = torch.autograd.grad((torch.view_as_real(plain) * torch.view_as_real(gc)).sum(), fr)
    gk = P.nufft_epilogue_kernel(gc, eg, backward=True)
    e_f, e_b = rel_err(out, plain.detach()), rel_err(gk, gref)
    k3 = (max(e_f[0], e_b[0]), max(e_f[1], e_b[1]))
    t_k3 = cuda_ms(lambda: P.nufft_epilogue_kernel(fk, eg), reps)
    t_p3 = cuda_ms(lambda: P.nufft_epilogue_plain(fk, eg), reps)

    # bounds: bytes of the inputs read once and outputs written once;
    # operations counted per particle (or rfft cell) from the kernel source
    n_p, n_s, n_c = pos.shape[0], geom.n_shift, int(np.prod(geom.shape))
    n_k = int(np.prod(cshape))
    b1 = bound(16 * n_p + 4 * n_s * n_c, 50 * n_s * n_p)
    b2 = bound(16 * n_p + 4 * n_s * n_c + 16 * n_p, 150 * n_s * n_p)
    b3 = bound(8 * n_k + 8 * n_k // n_s, 10 * n_k)
    for name, (ea, er), tk, tp, (bm, bb) in (("paint_cic", k1, t_k1, t_p1, b1),
                                             ("paint_cic_adjoint", k2, t_k2, t_p2, b2),
                                             ("nufft_epilogue", k3, t_k3, t_p3, b3)):
        log(f"# {tag} {name:18s} max_abs_err {ea:.3e} max_rel_err {er:.3e}  "
            f"kernel {tk:.3f} ms  plain {tp:.3f} ms  bound {bm:.4f} ms ({bb})")
        assert er <= TOL, f"{name} disagrees with its plain version at {tag}: {er:.3e} > {TOL}"
        res[name] = {"max_abs_err": ea, "ms": tk, "plain_ms": tp, "bound_ms": bm,
                     "bound_by": bb, "library_ms": None}
    return res


# ---------------------------------------------------------------- phase 3b
def _grid_sample_read(pos, mesh):
    """The unclamped CIC read as one torch call: trilinear grid_sample
    (align_corners=True) on the mesh wrap-padded by one cell, channels
    first.  Returns (input, grid) prepared outside the timed call."""
    n = torch.tensor(mesh.shape[:3], device=pos.device, dtype=pos.dtype)
    padded = torch.cat([mesh, mesh[:1]], 0)
    padded = torch.cat([padded, padded[:, :1]], 1)
    padded = torch.cat([padded, padded[:, :, :1]], 2)
    inp = padded.permute(3, 0, 1, 2)[None].contiguous()
    # grid's last axis is (W, H, D) = (z, y, x); index i -> -1 + 2 i / n
    grid = (2 * torch.remainder(pos, n) / n - 1).flip(-1)
    return inp, grid.reshape(1, -1, 1, 1, 3).contiguous()


def check_read_kernels(lattice, stride, H, tag, reps):
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    geom_c, pos, _ = _particles(lattice, stride, H, gen, dev)
    geom_c = P.cic_geometry(geom_c.shape, 1, lattice, H, True)
    geom_u = P.cic_geometry(geom_c.shape, 1)
    C = 3
    mesh = torch.randn(geom_c.shape + (C,), generator=gen, device=dev)
    ct = torch.randn((pos.shape[0], C), generator=gen, device=dev)
    out = {}
    for kind, geom in (("clamped", geom_c), ("unclamped", geom_u)):
        k4 = rel_err(P.read_cic_kernel(pos, mesh, geom), P.read_cic_plain(pos, mesh, geom))
        dpos, dmesh = P.read_cic_adjoint_kernel(pos, mesh, ct, geom)
        pr, mr = pos.clone().requires_grad_(True), mesh.clone().requires_grad_(True)
        rpos, rmesh = torch.autograd.grad((P.read_cic_plain(pr, mr, geom) * ct).sum(), (pr, mr))
        e_pos, e_mesh = rel_err(dpos, rpos), rel_err(dmesh, rmesh)
        k5 = (max(e_pos[0], e_mesh[0]), max(e_pos[1], e_mesh[1]))
        t = {"read_cic": (cuda_ms(lambda: P.read_cic_kernel(pos, mesh, geom), reps),
                          cuda_ms(lambda: P.read_cic_plain(pos, mesh, geom), max(2, reps // 5))),
             "read_cic_adjoint": (
                 cuda_ms(lambda: P.read_cic_adjoint_kernel(pos, mesh, ct, geom), reps),
                 cuda_ms(lambda: P.read_cic_adjoint_plain(pos, mesh, ct, geom), max(2, reps // 5)))}
        out[kind] = {"read_cic": (k4, *t["read_cic"]),
                     "read_cic_adjoint": (k5, *t["read_cic_adjoint"])}

    # library yardstick: grid_sample forward (= K4 unclamped) and its
    # backward (= K5 unclamped: the paint of the cotangent and d/dpos)
    import torch.nn.functional as F

    inp, grid = _grid_sample_read(pos, mesh)
    inp.requires_grad_(True)
    grid.requires_grad_(True)
    sample = lambda: F.grid_sample(inp, grid, mode="bilinear", padding_mode="border",
                                   align_corners=True)

    def forward_only():
        with torch.no_grad():
            return sample()

    ref = P.read_cic_kernel(pos, mesh, geom_u)
    gs = sample()
    e_gs = rel_err(gs.detach().reshape(C, -1).T, ref)
    gct = ct.T.reshape(gs.shape).contiguous()
    lib = {"read_cic": cuda_ms(forward_only, reps),
           "read_cic_adjoint": cuda_ms(
               lambda: torch.autograd.grad(gs, (inp, grid), gct, retain_graph=True), reps)}
    log(f"# {tag} grid_sample vs K4 unclamped: max_rel_err {e_gs[1]:.3e}; "
        f"fwd {lib['read_cic']:.3f} ms, bwd {lib['read_cic_adjoint']:.3f} ms")

    n_p, n_c = pos.shape[0], int(np.prod(geom_c.shape)) * C
    bounds = {"read_cic": bound(12 * n_p + 4 * n_c + 4 * C * n_p, (25 + 16 * C) * n_p),
              "read_cic_adjoint": bound(12 * n_p + 4 * n_c + 4 * C * n_p + 4 * n_c + 12 * n_p,
                                        (120 + 64 * C) * n_p)}
    res = {}
    for name in ("read_cic", "read_cic_adjoint"):
        bm, bb = bounds[name]
        for kind in ("clamped", "unclamped"):
            (ea, er), tk, tp = out[kind][name]
            log(f"# {tag} {name:18s} {kind:9s} max_abs_err {ea:.3e} max_rel_err {er:.3e}  "
                f"kernel {tk:.3f} ms  plain {tp:.3f} ms  bound {bm:.4f} ms ({bb})  "
                f"library {lib[name]:.3f} ms")
            assert er <= TOL, f"{name} ({kind}) disagrees with its plain version at {tag}"
        (ea, _), tk, tp = out["clamped"][name]
        res[name] = {"max_abs_err": ea, "ms": tk, "plain_ms": tp, "bound_ms": bm,
                     "bound_by": bb, "library_ms": lib[name]}
    return res


def phase_kernels():
    check_kernels((16, 16, 16), (2, 2, 2), 4, "32^3", reps=20)
    check_read_kernels((16, 16, 16), (2, 2, 2), 4, "32^3", reps=20)
    if QUICK:
        return None
    return {**check_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", reps=10),
            **check_read_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", reps=10)}


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


def phase_golden(evolution):
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    g = np.load(ROOT / "tests" / "golden" / "golden_32.npz")
    conf = dict(default_config)
    conf.update(final_shape=(32, 32, 32), cell_length=1000.0 / 32, evolution=evolution,
                lpt_order=2, a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 2000.0),
                ap_auto=None, lik_type="quad_gauss", precond="real")
    m = FieldLevelModel(**conf, device="cuda")
    fid = {k: np.asarray(v) for k, v in m.fiduc.items()}
    fid |= {"b1": 0.5, "b2": 0.3, "bs2": -0.2, "b3": 0.1, "bds2": 0.1, "bs3": -0.05,
            "bn2": 0.05, "bnpar": 0.2}
    p = m.reparam(fid, inv=True)
    p["white_mesh_"] = torch.as_tensor(g["white"], device="cuda")
    gxy = m.predict(seed=1, samples=p, hide_base=False, hide_det=False,
                    hide_samp=False)["gxy_mesh"].cpu().numpy()
    ref = g[f"gxy_{evolution}"]
    trans, coh = _transfer_coherence(gxy - 1.0, ref - 1.0, 1000.0)
    dt, dc = float(np.abs(trans - 1).max()), float(1 - coh.min())
    log(f"# golden 32^3 {evolution} on the card: max|transfer-1| {dt:.3e} (limit 2e-3), "
        f"1-min coherence {dc:.3e} (limit 1e-5), max|gxy-golden| {np.abs(gxy - ref).max():.3e}")
    assert np.all(np.isfinite(gxy)) and gxy.shape == ref.shape
    assert dt <= 2e-3 and dc < 1e-5, f"golden 32^3 {evolution} forward disagrees on the card"


# ----------------------------------------------------------------- phase 5
def bench_model(final=128, evolution="lpt"):
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=500.0 * 2 / final, evolution=evolution,
                lpt_order=2, a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 1500.0),
                lik_type="quad_gauss", precond="kaiser", paint_method="auto")
    return FieldLevelModel(**conf, device="cuda")


def phase_bench(evolution, kernels):
    """The flagship value+grad with `evolution`; every kernel in `kernels`
    must launch.  Returns the launch counts of the 7 evaluations."""
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.ops.background import Background, get_cosmology

    t0 = time.perf_counter()
    m = bench_model(evolution=evolution)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    params["white_mesh_"] = torch.randn(m.init_shape, generator=gen, device="cuda")
    obs = {"count_mesh": m.predict(seed=gen, samples=params, hide_base=False, hide_det=False,
                                   hide_samp=False)["count_mesh"]}
    torch.cuda.synchronize()
    log(f"# bench model ({evolution}): final {m.final_shape} init {m.init_shape} "
        f"evol {m.evol_shape} paint {m.paint_shape} steps "
        f"{m.nbody_n_steps if evolution == 'nbody' else 0} "
        f"particles {int(np.prod(m.ptcl_shape))} max_disp {m.max_disp} "
        f"lattice {m.paint_lattice} rbins {m.n_rbins}; set-up {time.perf_counter() - t0:.2f} s")

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
    launches = dict(P.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    grads_ok = all(bool(torch.isfinite(v.grad).all()) for v in leaves.values())
    log(f"# bench ({evolution}) value+grad: ms/eval {[round(1e3 * t, 3) for t in times]} "
        f"mean {1e3 * np.mean(times):.3f} median {1e3 * np.median(times):.3f}; "
        f"evals/s {1 / np.median(times):.4f} (median); logpdf {values[-1]:.6e}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches in 7 evals {launches}")
    assert np.all(np.isfinite(values)) and grads_ok, "non-finite logpdf or gradient"
    log(f"# ({evolution}) launches per value+grad: "
        f"{ {k: v / 7 for k, v in launches.items()} }")
    missing = [k for k in kernels if launches[k] == 0]
    assert not missing, f"kernels of the {evolution} path never ran: {missing} ({launches})"

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
    log(f"# ({evolution}) with the background tables held fixed: ms/eval "
        f"{[round(1e3 * t, 3) for t in t_fixed]} median {1e3 * np.median(t_fixed):.3f}; "
        f"the RK4 tables take {100 * share:.1f}% of an evaluation (median to median)")
    if "--profile" in sys.argv:
        # profiled after every timed phase: a profiler session slows the
        # host's launches in the evaluations timed after it
        PROFILES.append(lambda: (log(f"# --- profile ({evolution})"),
                                 layer_times(m, value_and_grad),
                                 profile_eval(value_and_grad, np.mean(times))))
    return launches


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
    for tag in ("paint_cic", "read_cic", "nufft_epilogue"):
        ms = sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
        log(f"# profiler: kernels named *{tag}* {ms:.3f} ms = "
            f"{100 * ms / max(busy_ms, 1e-9):.2f}% of device time")
    log(table)


# ----------------------------------------------------------------- main
SOURCES = {
    "paint_cic": ("cuda", "montecosmo_tpu_torch/csrc/paint_cic.cu",
                  "montecosmo_tpu/ops/paint_window.py:240"),
    "paint_cic_adjoint": ("cuda", "montecosmo_tpu_torch/csrc/paint_cic.cu",
                          "montecosmo_tpu/ops/paint_window.py:180"),
    "nufft_epilogue": ("triton", "montecosmo_tpu_torch/csrc/nufft_epilogue.py",
                       "montecosmo_tpu/ops/paint.py:192"),
    "read_cic": ("cuda", "montecosmo_tpu_torch/csrc/paint_cic.cu",
                 "montecosmo_tpu/ops/paint_window.py:330"),
    "read_cic_adjoint": ("cuda", "montecosmo_tpu_torch/csrc/paint_cic.cu",
                         "montecosmo_tpu/ops/paint_window.py:395"),
}
LPT_KERNELS = ("paint_cic", "paint_cic_adjoint", "nufft_epilogue")
PROFILES = []


def main():
    phase_device()
    phase_build()
    res = phase_kernels()
    if QUICK:
        log("# quick run: phases 4-6 skipped")
        return
    phase_golden("lpt")
    phase_golden("nbody")
    phase_bench("lpt", LPT_KERNELS)
    launches = phase_bench("nbody", tuple(SOURCES))
    for run in PROFILES:
        run()
    kernels = [{"name": n, "route": r, "source": s, "replaces": rep, "launches": launches[n],
                **res[n]} for n, (r, s, rep) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
