"""GPU smoke run of the PyTorch port (montecosmo_tpu_torch) on one card.

    python3 chip_smoke.py            # all phases (what the check runs)
    python3 chip_smoke.py --quick    # phases 1-3c at 32^3 only (kernel build and agreement)
    python3 chip_smoke.py --profile  # also per-layer times and a torch.profiler table

Phases, in order; any failure raises and the script exits non-zero:
  1. a CUDA card is required; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels (nvcc, sm_90a) from the checkout and print the
     build time;
  3. K8 (background_tables, csrc/background_rk4.cu) against its plain
     version (the raw tables and both Omega_m derivatives, float32 and
     float64 Omega_m) within K8_TOL, timed, its bound the growth's 127
     dependent steps times one step's FP64 chain counted from its SASS
     times a dependent FP64 FMA's latency timed on the card; a
     Background.create and its gradient on the card and the host; then
     hold K1 (paint), K2 (paint adjoint) and K3 (NUFFT epilogue) against
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
     (ops/paint.py::TILED_FROM) takes, two launches of each design equal
     bit for bit, and the routed design's fixed-point mesh sum timed in
     turns against the float atomics it replaced; K2 in its one design
     (also bit for bit twice); at B-spline order
     2 (CIC) clamped to the lattice sites, then at orders 1, 3 and 4 (NGP,
     TSC, PCS), then with the Kaiser-Bessel window of support 1-4 (at the
     flagship render's cutoff optim_kcut(192/224)), clamped and unclamped,
     a quarter of the particles on ties (exactly on their sites or half a
     cell off per axis, odd NGP window bases); grid_sample(mode='nearest')
     of the cotangents is K2's NGP and KB support 1 yardstick, its
     backward K1's (one call for both interlace shifts);
  3b. the same for K4 (C-channel read) and K5 (its adjoint), clamped and
     unclamped, at 32^3 and 224^3 with C = 3, at B-spline orders 2, 1, 3
     and 4 and Kaiser-Bessel supports 1-4, K4 and K5 clamped in both
     designs as K1 and K2 in phase 3; at B-spline order 2 K5 is held
     against autograd of K4's plain version; grid_sample (trilinear, and
     nearest at order 1, on a wrap-padded mesh: the unclamped read) and its
     backward are the library yardsticks (nearest also at Kaiser-Bessel
     support 1); then K4/K5 on C = 6
     channels (two launches each, both designs);
  3d. K9 (segment_sum, csrc/segment_sum.cu) at each of its call sites'
     shapes (the light cone's chi2a and growth lookups, the P(k) lookup of
     white2lin, the radial counts, the power spectrum's auto and cross
     binning), with the site's own ids and with uniform ids, against its
     plain version in float64 (K9_TOL), two launches equal bit for bit, a
     float64 call, its device launches a call counted in a CUDA graph of
     one call (at most two); timed in turns against index_add_ and
     index_put_(accumulate=True), with its device time and host time a
     call (calls queued behind a spin kernel), its plain version's time
     and its bound;
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
  4e. 2 MCLMC kernel steps of the golden 32^3 2LPT model, conditioned on
     its counts, from one state with the same draws on the card and on the
     CPU: positions and logdensities within 1e-4;
  5. the flagship configuration of bench.py (128^3, 2LPT, Lagrangian bias,
     RSD, quad-Gaussian likelihood, Kaiser preconditioning, float32) on the
     card: draw the observation with `predict`, then 2 warm-up and 5 timed
     logpdf value+grad evaluations; print ms/eval, peak memory and the
     launches of its kernels (K1, K2, K3, each in the design the route
     takes, and K8), counted from 0 over those 7; the same with the
     background tables held fixed; then, from one more value+grad,
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
     with its device ms (`table_backwards`: K9 for every take_rows, no
     index_add_ left), K9 against its plain version in float64 on those
     backwards' own cotangents, column by column (`k9_on_cotangents`), and
     ROADMAP Queue C 1's witness (`gradient_witness`: two value+grads from
     the same inputs, whose Omega_m and sigma8 gradients must be equal bit
     for bit);
  5d. the 2LPT flagship on the curved sky and the light cone (curved_sky=True,
     a_obs=None) with the Kaiser-Bessel window of support 4: K1 (tiled), K2
     and K3 must each launch at Kaiser-Bessel support 4; then its table
     backwards and the witness, as 5c;
  5h. the Kaiser flagship (bench.py's configuration with evolution='kaiser')
     in its three regimes, flat sky at a_obs 0.5, the flat-sky light cone
     and the curved-sky light cone: each first at 32^3 on the golden white
     mesh, card against CPU at phase 4's tolerances, then timed as 5, with
     all 5 values, peak memory and K8/K9 launches;
  5i. lik_type poisson, fourier_gauss, two_quad_gauss and shash, then
     observable='powspec' (poles 0, 2, 4), at the Kaiser flat-sky flagship:
     a predict draw, the model conditioned on it, 1 warm-up and 3 timed
     value+grads, finite; powspec launches K9's forward;
  5j. the 2LPT flagship with bias_type='eulerian': K1, K2 and K3 must
     launch in the designs the route takes; timed as 5;
  3c. (after 3b) K6 `paint_cic_grad` and K7 `read_cic_hess` (the double
     backward) against their plain versions at 32^3 and 224^3, B-spline
     orders 1-4, clamped and unclamped, the render's case (2 shifts, C =
     1) and the force read's (C = 3); clamped, both designs of each (K6
     lattice-brick in csrc/paint_tiled.cu and atomic in paint_hess.cu, K7
     lattice-brick in read_tiled.cu and per-particle in paint_hess.cu),
     held and timed in turns, with the route's design and the bounds, two
     launches of every design (unclamped K6 too) equal bit for bit (K6
     adds into K1's fixed-point accumulator), and the routed K6's
     fixed-point sum timed in turns against the float atomics; then
     one Hessian-vector product of a scalar functional through
     each pair's Function chain (K1 -> K2, K4 -> K5, K3) against autograd
     twice of the plain versions (at 224^3 at CIC), HVP_TOL;
  4f. (after 4e) the golden 32^3 2LPT and N-body models conditioned on the
     CPU's counts: the Hessian of the logpdf in (Omega_m_, b1_, sigma8_),
     card against CPU within 1e-4 of its largest entry, finite and nonzero,
     K6 and K7 launched;
  4g. (after 4f) the three AP/PNG configurations of 5k at 32^3 on the
     golden white mesh, card against CPU at phase 4's tolerances, every
     latent's gradient finite;
  5e. the sampler loop of run/infer.py at the 2LPT flagship (7.08M
     dimensions): field warmup, full warmup (diagonal mass), MCLMC run, MAMS
     warmup and run (SAMPLER_STEPS), each McLachlan step timed; finite
     chains, n_evals as the JAX package counts them, and K1, K2, K3 launched
     phase 5's count per value+grad times the value+grads made; the same 2
     steps twice from one seed, equal bit for bit;
  5f. the NUTS path of run/infer.py --sampler nuts at the same flagship:
     the blocked full warmup (bracketed step sizes, window adaptation; no
     Laplace seed: rest_ has 97 > 64 dimensions), NUTS-within-Gibbs sweeps
     (NUTS_CUTS), every transition timed with its depth and value+grads,
     n_evals and launches per value+grad asserted; then, each timed with
     its peak memory and launches, the Laplace seed of (Omega_m_, b1_,
     sigma8_) at the Kaiser start, the same Hessian with the background
     tables fixed (K6's and K7's own inputs captured in one more HVP
     column, both designs held and timed on them), the Hutchinson marginal
     covariance given white_mesh_, and one
     HVP column of the N-body flagship in Omega_m_ (K6/K7 on both, K4/K5's
     double backward on the N-body one); the Laplace seed and the N-body
     column each again from the same inputs, equal bit for bit;
  5g. one 2LPT flagship value+grad profiled: device kernels launched and
     device busy; 3 more timed;
  5l. (after 5k) the registered-survey campaign: cut-sky catalogs in the
     geometry of examples/cutsky_inference.py (2M data, 20M randoms,
     seeded numpy); at 32^3 (200,000 data, 1M randoms) the register built on
     the card and on the CPU, footprint masks equal cell for cell, selection
     and counts within TOL, the two registers' models' logpdfs within 1e-4;
     then the 128^3-budget register on the card (K1 and K3 launches, build
     ms, count conservation), npsave'd, the campaign's value+grad timed, the
     CLI's campaign (--self-data, 2 chains, MCLMC: field and full warmups of
     8 steps, 2 runs of 4 samples thinned by 2) and its resume with 3 runs
     (both warmups loaded, run 3 only), finite chains, ESS and r-hat, every
     McLachlan step timed, peak memory, K1/K2/K3/K8/K9 launched;
  5m. (after 5l) the N-body remainder: at 32^3 lpt_fpm, nbody_bf_scan, a
     16-step nbody_rk4 and nbody_tsit5 (tol 1e-3, 3 snapshots), grad_fd 4,
     on the card and on the CPU (positions within 1e-3 cells, Tsit5 1e-2,
     its step counts printed); at 128^3 (2,097,152 particles) Tsit5 at tol
     1e-4 from a = 0.05 to 0.5 against RK4 with 64 steps (held in Tsit5's
     own error norm, at most its accepted steps) and RK4 64 against 128
     (2e-3 cells), each
     timed, ms and K1/K4 launches per force evaluation; a value+grad
     through Tsit5 (tol 1e-2, 24 attempts) finite, timed, with K2/K5
     launches and peak memory; `python -m montecosmo_tpu_torch.accuracy
     --final 128 --f64-final 32` in a subprocess (exit code asserted, its
     lines and kernel launches printed); the verify drive on the port:
     `register synthetic` at the 128^3 cell budget from a 256^3-particle
     mock (count conservation 1e-4, ms, K1/K3 launches), its model's
     value+grad, then the SKILL drive's Kaiser campaign on a 512-cell
     synthetic register, with the CLI's default observed sites (finite
     logdensity);
  5n. (after 5m) the analysis layer: K10 (bispectrum_sums,
     csrc/bispectrum.cu) against its plain version on the local-quadratic
     field's shells at 32^3 and 128^3 (the default kedges: 35 bins, 4,347
     triples at 128^3) within K10_TOL of each triple's sum of |products|,
     two launches bit for bit, and at 256^3 (72 bins, 34,343 triples) on 64
     triples drawn from a seed; K10, the plain version and the library
     FP32 GEMM form timed; metrics.bispectrum card against CPU at 32^3 (the
     same triples and gate, B within BISPECTRUM_TOL); the main path, a
     128^3 metrics.bispectrum, its K10 launches counted from 0; on 5l's
     campaign (kept with 5m's in one temporary directory) make_logdf_mesh
     on the card (K1, K3, K8, K9 counted from 0; each chain's last sample
     of run 1, logpdf/logcdf meshes card against CPU within 1e-4 over the
     cells that 5l holds); on 5m's SKILL campaign make_logdf_mesh, run
     1's samples card against CPU within 1e-4 over every cell;
     compare_chains on each; on 5m's chains bdec.qbci and sci card
     against CPU within 1e-6 with integer weights and with the draws'
     density weights in float64 and float32, and a seeded witness (4,096
     sets of 16 and 64 draws at three weight spreads) in both, every set;
     the figures skipped for want of matplotlib;
  5k. (after 5g) the AP and PNG flagships at bench.py's widths: 2LPT with
     Lagrangian bias, ap_auto=True and png_type='fNL'; the Kaiser flat-sky
     light cone with ap_auto=False (the Kaiser mesh read at the particle
     lattice, remapped by the `ap` latents, re-painted through nufft);
     2LPT with Eulerian bias and png_type='bias' (phi advected with the
     matter): each timed as 5, every latent's gradient finite (alpha_iso_,
     alpha_ap_, the fNL*_ ones), peak memory, one value+grad profiled
     (device kernels, busy share), K1, K2, K3, K8 and K9 launched;
  6. last lines: the kernels JSON (one row per kernel, window and order;
     launches from phase 5b at CIC, 5c at TSC, 4c at NGP and PCS, 5d at
     Kaiser-Bessel 4, 4d at Kaiser-Bessel 1-3; K4/K5 run on no
     Kaiser-Bessel path of the model, 0; the rows of K1, K2, K4 and K5 are
     the design the route takes (`design`, its source and time, the
     launches it made), with `tiled_ms` and `atomic_ms` (K1, K5) or
     `gather_ms` (K4; K2's one design) the designs' times on the same
     inputs, the tiled design's `outlier_share` and source, at CIC the
     flagship measurements of 5/5b and at TSC those of 5c; K6 and K7 per
     order, both designs' times and the route's, launches and HVP times
     from 5f at CIC with the flagship-input times, and K6's fixed-point and
     float-atomic times; the CIC rows of K1, K2 and K3 and the K8 row also
     with their launches per value+grad in each 5k flagship; the CIC rows of
     K1 and K3 with their launches in one 5l register (`launches_register`)
     and its build ms; the CIC rows of K1, K2, K4 and K5, K8 and K9 with
     their launches on 5m's path (`launches_nbody_remainder`: per force
     evaluation and per accepted step of Tsit5 and RK4 at 128^3, in a
     value+grad through Tsit5, in the accuracy report, K1 in the synthetic
     register); K10 at 128^3 with its launches on 5n's main path and its
     32^3 and 256^3 rows (`at`); K8 with its
     launches in phase 5's 2LPT run and 5g's counts; K9 with its launches in phase 5's
     2LPT run and per value+grad in every flagship, its times at the chi2a
     site, index_add_ as its library time and index_put_(accumulate) beside
     it, every site's row, and 5i's times), then
     {"ok": true, "device": {...}}.
"""
import ctypes
import json
import subprocess
import tempfile
from collections import Counter
from contextlib import contextmanager
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
QUICK = "--quick" in sys.argv
TOL = 1e-5  # max |kernel - plain| / max |plain|: float32 sums in another order
# (K1's and K5's in fixed point, rounded once; the same bound holds)
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


def queued_ms(fn, reps=20):
    """(device ms, host ms) of one call of fn(): `reps` calls queued behind
    a spin kernel that holds the stream until the host has queued them all,
    so that CUDA events around them time the card's work back to back with
    no wait for the host; the host's time to queue a call beside it.  The
    spin grows until it outlasts the queueing."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(5):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host = 1e3 * (time.perf_counter() - t)
        e2.record()
        torch.cuda.synchronize()
        if e0.elapsed_time(e1) > host:
            return e1.elapsed_time(e2) / reps, host / reps
        cycles *= 4
    raise AssertionError("the host never queued its calls within the spin")


def graph_launches(fn):
    """The device launches of one call of fn() (kernels, memsets and
    copies), counted in a CUDA graph captured from that call
    (cuGraphGetNodes), and the graph's nodes by type."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds, kind = Counter(), ctypes.c_int()
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds[kind.value] += 1
    g.reset()
    names = {0: "kernel", 1: "copy", 2: "memset"}
    return sum(kinds[k] for k in names), {names.get(k, f"type {k}"): c for k, c in kinds.items()}


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
                                 P.read_cic_adjoint_plain),
            "paint_cic_grad": (P.paint_cic_grad_tiled_kernel, P.paint_cic_grad_kernel,
                               P.paint_cic_grad_plain),
            "read_cic_hess": (P.read_cic_hess_tiled_kernel, P.read_cic_hess_kernel,
                              P.read_cic_hess_plain)}


# what the JSON calls each kernel's second design
OTHER = {"paint_cic": "atomic", "paint_cic_adjoint": "gather", "read_cic": "gather",
         "read_cic_adjoint": "atomic", "paint_cic_grad": "atomic", "read_cic_hess": "gather"}


def routed(P, name, geom):
    """The design the route (ops/paint.py::TILED_FROM) takes for `name`."""
    return "tiled" if P._tiled(name, geom) else OTHER[name]


def err_of(out, ref):
    """(max_abs_err, max_rel_err) of one output or of a pair."""
    if isinstance(out, tuple):
        return rel_err_pair(out[0], ref[0], out[1], ref[1])
    return rel_err(out, ref)


# the particle kernels whose every design must give the same output bit for
# bit from launch to launch (K1, K5 and K6 sum in fixed point; K2, K4 and
# K7 gather)
BIT_FOR_BIT = ("paint_cic", "paint_cic_adjoint", "read_cic", "read_cic_adjoint",
               "paint_cic_grad", "read_cic_hess")


# K1's, K5's and K6's inner launchers, whose `fixed=False` adds floats with
# atomics in a run-dependent order
FIXED_POINT = {"paint_cic": "_paint_cic", "read_cic_adjoint": "_read_cic_adjoint",
               "paint_cic_grad": "_paint_cic_grad"}


def same_twice(fn):
    """Whether two calls of `fn` return outputs equal bit for bit."""
    a, b = fn(), fn()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def each_design(P, name, args, geom, ref, reps, tag, share_of):
    """The designs of `name` on the same inputs: each held against the
    plain version's `ref` at TOL, both timed in turns; the tiled design's
    outlier share (its count over `share_of` corner products); for the
    BIT_FOR_BIT kernels, two launches of each design equal bit for bit.
    Returns the JSON row's design keys."""
    tiled, other, _ = designs(P)[name]
    if name in BIT_FOR_BIT:
        same = {d: same_twice(lambda f=f: f(*args, geom))
                for d, f in (("tiled", tiled), (OTHER[name], other)) if f is not None}
        log(f"# {tag} {name}: two launches equal bit for bit {same}")
        assert all(same.values()), f"{name} ({tag}): two launches differ {same}"
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
    row = {"design": design, "tiled_ms": t_t, f"{OTHER[name]}_ms": t_o, "outlier_share": share,
           "_err": e_t if design == "tiled" else e_o, "_ms": t_t if design == "tiled" else t_o}
    if name in FIXED_POINT:
        # the cost of the fixed-point mesh sum: the routed design with its
        # accumulator and with float atomics, in turns
        inner = getattr(P, FIXED_POINT[name])
        t_float, t_fixed = turns(lambda: inner(*args, geom, design == "tiled", fixed=False),
                                 lambda: inner(*args, geom, design == "tiled"), reps)
        log(f"# {tag} {name} {design}: fixed-point mesh sum {t_fixed:.3f} ms, float atomics "
            f"{t_float:.3f} ms (in turns)")
        row |= {"fixed_point_ms": t_fixed, "float_atomics_ms": t_float}
    return row


def plan_of(P, name, geom, args):
    """The tile plan of `name`'s tiled design on these inputs: K1 one
    channel, K4/K5 the mesh's channels, K6 beta's, K7 the meshes' times the
    shifts; a read tile for K4 and K7, a paint tile for K1, K5 and K6."""
    if name == "paint_cic_grad":
        return P.tile_plan(geom, args[2].shape[1])
    if name == "read_cic_hess":
        return P.tile_plan(geom, geom.n_shift * args[1].shape[-1], "read")
    channels = 1 if name == "paint_cic" else args[1].shape[-1]
    return P.tile_plan(geom, channels, "read" if name == "read_cic" else "paint")


def bound(n_bytes, n_flop):
    """(least ms on the card, what bounds it): bytes moved (each input read
    once, each output written once) over the memory rate, or float32
    operations over their peak rate, whichever is larger."""
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
    lib1 = lib2 = None
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
        if order == 1:  # NGP, and Kaiser-Bessel support 1 (one-hot when clamped)
            lib1 = _nearest_paint(pos, w, geom_u, tag, reps)
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
            ("paint_cic", d1.pop("_err"), d1.pop("_ms"), t_p1, b1, lib1),
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


def device_ms(fn, reps, name, sessions=3):
    """Mean device time of one kernel whose name holds `name`, from
    torch.profiler's own kernel durations over `reps` calls of fn() (over
    the kernels it recorded: a profile may drop some of its device events,
    and one that recorded none is taken again, up to `sessions` times);
    None ("not measured") if none recorded any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and name in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / 1e3 / count
    return None


def _nearest_paint(pos, w, geom, tag, reps):
    """K1's library yardstick at NGP (and Kaiser-Bessel support 1), timed:
    the backward of one grid_sample(mode='nearest') with respect to its
    input, batched over the S interlace shifts: the weights painted at the
    shifted positions onto the wrap-padded mesh, once per shift.  The
    padding's plane is not folded back and the tie rule is not K1's, so
    the result is not held."""
    import torch.nn.functional as F

    S = geom.n_shift
    zero = torch.zeros(tuple(geom.shape) + (1,), device=pos.device)
    inps, grids = zip(*(_grid_sample_read(pos + s / S, zero) for s in range(S)))
    inp, grid = torch.cat(inps).requires_grad_(True), torch.cat(grids)
    out = F.grid_sample(inp, grid, mode="nearest", padding_mode="border", align_corners=True)
    ct = w.reshape(1, 1, -1, 1, 1).expand(out.shape).contiguous()
    ms = cuda_ms(lambda: torch.autograd.grad(out, inp, ct, retain_graph=True), reps)
    log(f"# {tag} grid_sample (nearest) backward, the paint of {S} shifts: {ms:.3f} ms")
    return ms


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
    if order == 1 or (order == 2 and not kb):  # Kaiser-Bessel support 1: nearest
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


# ---------------------------------------------------------------- phase 3c
HVP_TOL = 1e-4  # max |chain - plain| / max |plain| of one Hessian-vector
# product: three kernels' float32 sums against autograd twice through the
# plain versions


def check_hess_kernels(lattice, stride, H, tag, reps, order):
    """Phase 3c: K6 (paint_cic_grad) and K7 (read_cic_hess) at B-spline
    `order`, clamped and unclamped, against their plain versions: the
    render's case (2 shifts, C = 1, K6 with alpha) and the force read's (1
    shift, C = 3, K6 without); clamped, both designs (lattice-brick and
    per-particle), held and timed in turns (`each_design`), the render's
    case the row's.  Returns the rows of the kernels JSON."""
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    geom0, pos, w = _particles(lattice, stride, H, gen, dev, ties=order != 2)
    sfx = _suffix(order, "rectangular")
    n_p, n_c = pos.shape[0], int(np.prod(geom0.shape))
    errs, res, rows = {"paint_cic_grad": [], "read_cic_hess": []}, {}, {}
    for clip in (True, False):
        for S, C in ((2, 1), (1, 3)):
            geom = P.cic_geometry(geom0.shape, S, lattice, H, clip, order)
            alpha = torch.randn((n_p, C), generator=gen, device=dev) if S == 2 else None
            beta = torch.randn((n_p, C, 3), generator=gen, device=dev)
            mesh = torch.randn((S,) + geom.shape + (C,), generator=gen, device=dev)
            b = torch.randn((n_p, 3), generator=gen, device=dev)
            args = {"paint_cic_grad": (pos, alpha, beta), "read_cic_hess": (pos, mesh, b)}
            case = f"{tag} order {order} {'clamped' if clip else 'unclamped'} S {S} C {C}"
            for name, a in args.items():
                tiled, other, plain = designs(P)[name]
                ref = plain(*a, geom)
                if clip:
                    row = each_design(P, name, a, geom, ref, reps, case, S * n_p * order**3)
                    errs[name].append(row["_err"])
                    if S == 2:
                        rows[name] = row | {"_plain_ms": cuda_ms(lambda: plain(*a, geom),
                                                                 max(2, reps // 5))}
                else:
                    e = err_of(other(*a, geom), ref)
                    errs[name].append(e)
                    same = same_twice(lambda: other(*a, geom))
                    log(f"# {case} {name} {OTHER[name]} max_rel_err {e[1]:.3e}; two launches "
                        f"equal bit for bit {same}")
                    assert e[1] <= TOL, f"{name} ({case}) disagrees with its plain version"
                    assert same, f"{name} ({case}): two launches differ"
                del ref
    # bounds (render's case, S = 2, C = 1): bytes of the inputs read once and
    # outputs written once; the least arithmetic of a particle's shift (an
    # FMA as 2 operations): the window set-up (30); per (i, j) its
    # channel-free factors and per channel their combinations (K6: 3 and 6,
    # a corner's alpha W + beta . grad W being A_ij w_k + B_ij d_k; K7: 18
    # and 18, g and H_W b being sums over (i, j) of the z-sums of M against
    # w_k, d_k and d2_k); per corner and channel one FMA (K6) or three (K7,
    # those z-sums)
    corners, columns, S, C = order**3, order**2, 2, 1
    bounds = {"paint_cic_grad": bound(12 * n_p + 16 * C * n_p + 4 * S * n_c * C,
                                      S * n_p * (30 + columns * (3 + 6 * C) + corners * 2 * C)),
              "read_cic_hess": bound(24 * n_p + 4 * S * n_c * C + 24 * C * n_p,
                                     S * n_p * (30 + columns * 18 * (1 + C) + corners * 6 * C))}
    for name in ("paint_cic_grad", "read_cic_hess"):
        row = rows[name]
        ea, er = max(e[0] for e in errs[name]), max(e[1] for e in errs[name])
        tk, tp, (bm, bb) = row.pop("_ms"), row.pop("_plain_ms"), bounds[name]
        row.pop("_err")
        log(f"# {tag} {name + sfx:25s} max_abs_err {ea:.3e} max_rel_err {er:.3e}  kernel "
            f"({row['design']}) {tk:.3f} ms  plain {tp:.3f} ms  bound {bm:.4f} ms ({bb})  "
            f"library None ms")
        assert er <= TOL, f"{name}{sfx} disagrees with its plain version at {tag}: {er:.3e}"
        res[name + sfx] = {"max_abs_err": ea, "ms": tk, "plain_ms": tp, "bound_ms": bm,
                           "bound_by": bb, "library_ms": None, **row}
    if tag == "32^3" or order == 2:  # autograd twice of a plain PCS at 224^3: > 80 GB
        check_hvp_chain(lattice, stride, H, tag, order, gen)
    return res


def _hvp(f, args, vs):
    """The Hessian-vector product of the scalar f(*args) in the direction
    `vs`, reverse over reverse (a None gradient as 0)."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    grads = torch.autograd.grad(f(*leaves), leaves, create_graph=True, allow_unused=True)
    dot = sum((g * v).sum().real for g, v in zip(grads, vs) if g is not None)
    out = torch.autograd.grad(dot, leaves, allow_unused=True)
    return [torch.zeros_like(a) if o is None else o for a, o in zip(leaves, out)]


def check_hvp_chain(lattice, stride, H, tag, order, gen):
    """One Hessian-vector product of a scalar functional of each pair's
    output through the Function chain (K1 -> K2 -> K6/K7; K4 -> K5 ->
    K6/K7/K4/K5; K3 -> K3), against the same through autograd twice of
    the plain versions, at HVP_TOL; the launches of the chain's HVPs.  No
    particle on a tie: there the window's second derivative jumps, and the
    plain versions' autograd takes the other side of it."""
    from montecosmo_tpu_torch.ops import paint as P

    dev = torch.device("cuda")
    geom0, pos, w = _particles(lattice, stride, H, gen, dev)
    shape = geom0.shape
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    geom2 = P.cic_geometry(shape, 2, lattice, H, True, order)
    geom1 = P.cic_geometry(shape, 1, lattice, H, True, order)
    G, D = rn(2, *shape), rn(2, *shape)
    mesh, ct, E = rn(*shape, 3), rn(pos.shape[0], 3), rn(pos.shape[0], 3)

    def quad(x, lin, sq):
        return (lin * x).sum() + 0.5 * (sq * x * x).sum()

    pairs = {
        "K1->K2": ((pos, w), lambda paint: lambda p, ww: quad(paint(p, ww, geom2), G, D),
                   lambda p, ww, g: P._PaintCIC.apply(p, ww, g), P.paint_cic_plain),
        "K4->K5": ((pos, mesh), lambda read: lambda p, m: quad(read(p, m, geom1), ct, E),
                   lambda p, m, g: P._ReadCIC.apply(p, m, g), P.read_cic_plain)}
    errs = {}
    P.reset_launches()
    for name, (args, fn, chain, plain) in pairs.items():
        vs = [rn(*a.shape) for a in args]
        got, ref = _hvp(fn(chain), args, vs), _hvp(fn(plain), args, vs)
        errs[name] = max(rel_err(a, b)[1] for a, b in zip(got, ref))
    launches = P.launches_at(order)
    eg = P.EpilogueGeometry(shape, 2, float((7 / 6) ** 3), order, None)
    fk, c, d = randc((2,) + P.r2chshape(shape), gen), randc(P.r2chshape(shape), gen), rn(
        *P.r2chshape(shape))
    k3 = lambda epi: lambda x: (torch.view_as_real(epi(x)) * torch.view_as_real(c)).sum() + (
        0.5 * d * epi(x).abs() ** 2).sum()
    v = randc(fk.shape, gen)
    got = _hvp(k3(lambda x: P._NufftEpilogue.apply(x, eg)), (fk,), (v.conj(),))[0]
    ref = _hvp(k3(lambda x: P._epilogue_math(x, eg, False)), (fk,), (v.conj(),))[0]
    errs["K3"] = rel_err(got, ref)[1]
    log(f"# {tag} order {order} double backward, chain vs plain (max_rel_err, limit "
        f"{HVP_TOL:.0e}): {errs}; launches of the K1/K4 HVPs {launches}")
    assert max(errs.values()) <= HVP_TOL, f"{tag} order {order}: a double backward disagrees"
    missing = [k for k in hess_names(order) if not launches.get(k)]
    assert not missing, f"the double backward never launched {missing}"


# ------------------------------------------------------------ phase 3 (K8)
# max |K8 - plain| / max |plain| of each output: the same float64
# arithmetic (the card's pow, exp and sqrt round otherwise), rounded once
# to the output type
K8_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def growth_chain_depth():
    """The FP64 operations on the longest dependency path of one growth
    step of K8, counted from the SASS of csrc/background_rk4.cu (built alone
    to a cubin, `cuobjdump -sass`): in background_tables_kernel<float>, the
    loop (a backward branch) with the most FP64 operations among those that
    store; each DFMA, DMUL or DADD one link of the path through the
    registers it reads and writes (a 64-bit operand a register pair)."""
    import re
    from montecosmo_tpu_torch.ops import _kernels

    nvcc = _kernels.nvcc_path()
    cubin = _kernels.BUILD / "background_rk4.cubin"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", str(cubin), str(_kernels.CSRC / "background_rk4.cu")],
                   check=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    cubin.unlink()
    func = sass.split("Function : ")
    func = next(f for f in func if f.split("\n")[0].find("background_tables_kernelIf") >= 0)
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s*([^;]*);", func)]
    where = {a: i for i, (a, _) in enumerate(ins)}
    fp64 = re.compile(r"D(FMA|MUL|ADD)\b")
    loops = []
    for i, (a, t) in enumerate(ins):
        m = re.search(r"BRA\s+0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            body = [x for _, x in ins[where[int(m.group(1), 16)]:i + 1]]
            if any(x.startswith("STG") or " STG" in x for x in body):
                loops.append((sum(bool(fp64.search(x)) for x in body), body))
    _, body = max(loops, key=lambda lb: lb[0])
    depth, longest = {}, 0
    for t in body:
        t = re.sub(r"^@!?P\w+\s+", "", t)
        op = t.split()[0]
        regs = [int(r) for r in re.findall(r"(?<![\w.])[-|]*R(\d+)", t)]
        if not regs or op.startswith(("ST", "BRA", "ISETP")):
            continue
        wide = op.startswith("D") or ".64" in op
        srcs = {r + k for r in regs[1:] for k in ((0, 1) if wide else (0,))}
        d = max((depth.get(r, 0) for r in srcs), default=0) + bool(fp64.match(op))
        for k in (0, 1) if wide else (0,):
            depth[regs[0] + k] = d
        longest = max(longest, d)
    return longest


def check_background(reps):
    """Phase 3 (K8): `background_tables` against its plain version on the
    card (the tables and both Omega_m derivatives, float32 and float64
    Omega_m, flat LCDM and w0waCDM with curvature) within K8_TOL; its time,
    the plain version's on the card, and its bound: the growth's 127
    dependent steps times the FP64 operations on one step's longest path
    (`growth_chain_depth`) times the latency of a dependent FP64 FMA, timed
    here (`fp64_chain`).  Then a `Background.create` with its Omega_m
    gradient on the card and on the host.  Returns the row of the kernels
    JSON."""
    from montecosmo_tpu_torch.ops import _kernels, background as B

    dev = torch.device("cuda")
    errs = []
    for dtype in (torch.float32, torch.float64):
        for consts in ((0.0, -1.0, 0.0), (0.02, -0.9, 0.1)):
            om = torch.tensor(0.31, dtype=dtype, device=dev)
            got = B.background_tables_kernel(om, *consts, dtype)
            ref = B.background_tables_plain(om, *consts, dev, dtype)
            e = [rel_err(x, y) for x, y in zip(got, ref)]
            log(f"# K8 background_tables {dtype} (Omega_k, w0, wa) {consts}: max_rel_err "
                f"(tables, d/dOmega_m, d2/dOmega_m2) {[f'{r:.3e}' for _, r in e]} (limit "
                f"{K8_TOL[dtype]:.0e})")
            assert max(r for _, r in e) <= K8_TOL[dtype], "K8 disagrees with its plain version"
            errs += e if dtype == torch.float32 else []
    om = torch.tensor(0.31, device=dev)
    t_k = cuda_ms(lambda: B.background_tables_kernel(om, 0.0, -1.0, 0.0), reps)
    t_p = cuda_ms(lambda: B.background_tables_plain(om, 0.0, -1.0, 0.0, dev), 3, 1)
    lib, n = _kernels.cuda_library(), 1 << 22
    out = torch.empty(1, dtype=torch.float64, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    lat = cuda_ms(lambda: lib.fp64_chain(ctypes.c_longlong(n), ctypes.c_double(0.5),
                                         ctypes.c_void_p(out.data_ptr()), stream), 3, 1) / n
    depth = growth_chain_depth()
    bm = (B.GROWTH_STEPS - 1) * depth * lat
    ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
    log(f"# K8 background_tables max_abs_err {ea:.3e} max_rel_err {er:.3e}  kernel {t_k:.4f} ms  "
        f"plain (on the card) {t_p:.3f} ms  bound {bm:.4f} ms (operations: "
        f"{B.GROWTH_STEPS - 1} steps x {depth} dependent FP64 operations, counted from the "
        f"SASS, x {lat * 1e6:.3f} ns a dependent FP64 FMA, timed)  library None ms")

    def create_and_grad(create, device):
        o = torch.tensor(0.31, device=device, requires_grad=True)
        bg = create(B.get_cosmology(Omega_m=o, sigma8=torch.tensor(0.8, device=device)), device)
        (g,) = torch.autograd.grad(bg.growth_tab.sum() + bg.a_chi_tab.sum(), o)
        return g

    walls = {}
    for device, n_rep in (("cuda", 10), ("cpu", 3)):
        create_and_grad(B.Background.create, device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_rep):
            g = create_and_grad(B.Background.create, device)
        torch.cuda.synchronize()
        walls[device, "K8"] = (1e3 * (time.perf_counter() - t) / n_rep, float(g))
    log(f"# K8 Background.create + its Omega_m gradient, wall ms (d/dOmega_m of the tables' "
        f"sum): {[(d, w, round(ms, 3), f'{g:.6e}') for (d, w), (ms, g) in walls.items()]} "
        f"(on the host CPU K8's plain version runs)")
    return {"background_tables": {"max_abs_err": ea, "ms": t_k, "plain_ms": t_p, "bound_ms": bm,
                                  "bound_by": "operations", "library_ms": None,
                                  "chain_fp64_ops": depth, "fp64_fma_latency_ns": lat * 1e6,
                                  "create_and_grad_wall_ms": {
                                      f"{w} ({d})": ms for (d, w), (ms, _) in walls.items()}}}


# ----------------------------------------------------------- phase 3d (K9)
# max |K9 - plain| / max |plain|: the plain version in float64 on the same
# float32 inputs; K9 sums each run in float64, adds it once in fixed point
# at its CTA's scale (quantum 2^-62 of the CTA's max |src| times its
# queries), sums the CTAs' float64 partials and rounds to float32 once
K9_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
INDEX_BYTES = 8  # the model's ids are int64
# K9's call times before its redesign, by site (the site's own ids,
# uniform ids), as PERF.md records them (one NVIDIA H100 80GB HBM3, 700 W,
# this script's phase 3d then): printed beside this run's in 3d's log
# lines, never in the kernels line (tools/k9_turns.py times both designs
# in one run)
K9_RECORDED_BEFORE = {"chi2a": (0.2653, 0.2633), "growth": (0.5509, 0.9067),
                      "P(k)": (0.0833, 0.0846), "radial counts": (0.0480, 0.0458),
                      "spectrum": (0.0521, 0.0601), "cross spectrum": (0.0688, 0.0709)}


def _k9_ids(where, kind, n, rows, gen):
    """The ids of K9's call site `where`, in the order the model makes them
    ("runs": lattice or rfft order, the light cone's runs of equal rows) or
    drawn uniformly in [0, rows)."""
    from montecosmo_tpu_torch.metrics import spectrum_plan
    from montecosmo_tpu_torch.ops import background as B

    if kind == "uniform":
        return torch.randint(0, rows, (n,), generator=gen, device="cuda")
    if where in ("chi2a", "growth"):
        # the flagship's light cone: each particle of the 224^3 lattice at
        # its distance along the line of sight, 1000-2000 Mpc/h
        z = 1000.0 + torch.arange(224, device="cuda", dtype=torch.float32) * (1000.0 / 224)
        chi = z.repeat(224 * 224)
        if where == "chi2a":
            return torch.floor(chi / (B.CHI_GRID_MAX / (B.CHI_STEPS - 1))).long()
        bg = B.Background.create(B.get_cosmology(Omega_m=0.3111, sigma8=0.8102), "cuda")
        a = bg.chi2a(chi)
        x0, dx = np.log(10.0 ** B.GROWTH_LOG10_AMIN), -np.log(10.0 ** B.GROWTH_LOG10_AMIN) / (
            B.GROWTH_STEPS - 1)
        return torch.clamp(torch.floor((torch.log(a) - x0) / dx).long(), 0, rows - 1)
    if where == "P(k)":
        from montecosmo_tpu_torch.ops.fourier import rfftk

        kvec = rfftk((192,) * 3, (1000.0,) * 3, "cuda")
        k = (sum(ki**2 for ki in kvec) ** 0.5).reshape(-1)
        t = (torch.log(torch.clamp(k, min=1e-30)) - np.log(1e-4)) / (np.log(1e5) / 255)
        return torch.clamp(torch.floor(t).long(), 0, rows - 1)
    if where == "radial counts":
        r = (1000.0 + (torch.arange(128, device="cuda") + 0.5) * (1000.0 / 128)).repeat(128 * 128)
        edges = torch.linspace(1000.0, 2000.0, rows + 1, device="cuda")
        return torch.clamp(torch.searchsorted(edges, r) - 1, 0, rows - 1)
    plan = spectrum_plan((128,) * 3, (1000.0,) * 3, None, (0, 2, 4), False, (0.0, 0.0, 1.0))
    return torch.as_tensor(plan["seg"], device="cuda").long()


# K9's call sites on the model paths: (N queries, R rows, C columns)
K9_SHAPES = {"chi2a": (11_239_424, 2047, 2), "growth": (11_239_424, 127, 8),
             "P(k)": (3_575_808, 255, 2), "radial counts": (2_097_152, 73, 1),
             "spectrum": (1_064_960, 36, 3), "cross spectrum": (1_064_960, 36, 6)}


def check_segment_sum(quick=False):
    """Phase 3d: K9 (`segment_sum`, csrc/segment_sum.cu) at each call site's
    shape (K9_SHAPES), with the site's own ids (runs) and uniform ids:
    against its plain version in float64 on the same inputs (K9_TOL), two
    launches equal bit for bit, a float64 call at the chi2a shape, and the
    device launches of one call counted in a CUDA graph of it (at most
    two: no fill, no second pass); then, unless `quick`, K9, `index_add_`
    (the port's lookup backward before K9) and
    `index_put_(accumulate=True)` (the sort-based sum) timed in turns on
    the same float32 inputs, K9's device time and host time a call
    (`queued_ms`), the plain version's time, the call's time before the
    redesign as PERF.md records it (K9_RECORDED_BEFORE, in the log line
    only), and the bound: the bytes of
    the inputs read once (N C float32 values and N int64 ids) and the
    output written once, over the memory rate (K9 also writes and reads
    back each CTA's float64 partials of the rows it touched; at most that
    is printed beside it).  Returns the JSON row (its times at the chi2a
    site with runs) and the per-site extras."""
    from montecosmo_tpu_torch.ops import segment as S

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sites, worst = {}, (0.0, 0.0)
    for where, (n, rows, cols) in K9_SHAPES.items():
        plan = S.segment_plan(n, rows, cols, sms)
        for kind in ("runs", "uniform"):
            idx = _k9_ids(where, kind, n, rows, gen)
            assert idx.shape == (n,) and int(idx.min()) >= 0 and int(idx.max()) < rows
            src = torch.randn(n, cols, generator=gen, device="cuda")
            a = S.segment_sum_kernel(src, idx, rows)
            b = S.segment_sum_kernel(src, idx, rows)
            ref = S.segment_sum_plain(src.double(), idx, rows)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            ea, er = rel_err(a.double(), ref)
            worst = max(worst, (ea, er), key=lambda e: e[1])
            k9 = lambda: S.segment_sum_kernel(src, idx, rows)
            launches, nodes = graph_launches(k9)
            row = {"max_abs_err": ea, "max_rel_err": er, "bit_for_bit": same,
                   "run_length": n / max(1, int((idx[1:] != idx[:-1]).sum()) + 1),
                   "launches_per_call": launches, "graph_nodes": nodes,
                   "plan_launches": plan["launches"], "ctas": plan["ctas"],
                   "warps_per_cta": S.WARPS}
            assert launches <= 2, f"K9 ({where}, {kind}) makes {launches} device launches a call"
            assert same, f"K9 ({where}, {kind}): two launches differ"
            assert er <= K9_TOL[torch.float32], f"K9 ({where}, {kind}) disagrees: {er:.3e}"
            if where == "chi2a" and kind == "runs":
                a64 = S.segment_sum_kernel(src.double(), idx, rows)
                e64 = rel_err(a64, ref)[1]
                row["float64_max_rel_err"] = e64
                assert e64 <= K9_TOL[torch.float64], f"K9 float64 disagrees: {e64:.3e}"
                assert torch.equal(a64, S.segment_sum_kernel(src.double(), idx, rows))
            if not quick:
                add = lambda: torch.zeros(rows, cols, device="cuda").index_add_(0, idx, src)
                put = lambda: torch.zeros(rows, cols, device="cuda").index_put_(
                    (idx,), src, accumulate=True)
                t = [cuda_ms(f, r, 1) for f, r in ((k9, 10), (add, 10), (put, 2), (put, 2),
                                                    (add, 10), (k9, 10))]
                row |= {"ms": (t[0] + t[5]) / 2, "index_add_ms": (t[1] + t[4]) / 2,
                        "index_put_accumulate_ms": (t[2] + t[3]) / 2,
                        "plain_ms": cuda_ms(lambda: S.segment_sum_plain(src, idx, rows), 10, 1)}
                row["device_ms"], row["host_ms"] = queued_ms(k9)
                n_bytes = n * (4 * cols + INDEX_BYTES) + 4 * rows * cols
                row["bound_ms"], row["bound_by"] = bound(n_bytes, 0)
                # besides: each CTA's float64 partials of every row written
                # and read back, at most
                row["bytes_with_partials"] = n_bytes + 16 * plan["scratch"]
            sites[f"{where} ({kind})"] = row
            log(f"# 3d K9 segment_sum {where} ({kind} ids, mean run {row['run_length']:.2f}): "
                f"N {n} R {rows} C {cols}: max_rel_err {er:.3e} (limit "
                f"{K9_TOL[torch.float32]:.0e}), bit for bit {same}; {launches} device "
                f"launch(es) a call (a CUDA graph of one call: {nodes}; the plan's "
                f"{plan['launches']}), {plan['ctas']} CTAs of {S.WARPS} warps"
                + (f", float64 {row['float64_max_rel_err']:.3e}" if "float64_max_rel_err" in row
                   else "")
                + ("" if quick else
                   f"; K9 {row['ms']:.4f} ms a call (before its redesign, as recorded: "
                   f"{K9_RECORDED_BEFORE[where][kind == 'uniform']:.4f} ms), device "
                   f"{row['device_ms']:.4f} ms, host {row['host_ms']:.4f} ms (queued), "
                   f"index_add_ {row['index_add_ms']:.4f} ms, "
                   f"index_put_(accumulate) {row['index_put_accumulate_ms']:.4f} ms, plain "
                   f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes; with K9's "
                   f"own partials at most {row['bytes_with_partials'] / HBM_BYTES_PER_S * 1e3:.4f}"
                   f" ms), the call {row['ms'] / row['bound_ms']:.2f}x the bound"))
            del src, idx, a, b, ref
    head = sites["chi2a (runs)"]
    res = {"max_abs_err": worst[0], "max_rel_err": worst[1], "sites": sites}
    if not quick:
        res |= {k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
        res |= {"library_ms": head["index_add_ms"],
                "index_put_accumulate_ms": head["index_put_accumulate_ms"]}
    return res


WINDOWS = [(k, o) for k in ("rectangular", KB) for o in ORDERS]


def phase_kernels():
    res = check_background(50)
    res["segment_sum"] = check_segment_sum(QUICK)
    for kernel, order in WINDOWS:  # max_disp 5: odd NGP window bases (9 at 224^3)
        check_kernels((16, 16, 16), (2, 2, 2), 5, "32^3", 20, order, kernel)
        check_read_kernels((16, 16, 16), (2, 2, 2), 5, "32^3", 20, order, kernel)
    check_wide_read()
    for order in ORDERS:
        check_hess_kernels((16, 16, 16), (2, 2, 2), 5, "32^3", 20, order)
    if QUICK:
        return None
    for kernel, order in WINDOWS:
        res |= check_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", 10, order, kernel)
        res |= check_read_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", 10, order, kernel)
    for order in ORDERS:
        res |= check_hess_kernels((224, 224, 224), (1, 1, 1), 9, "224^3", 10, order)
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


def golden_predict(device, evolution, ulp=False, off_fiducial=False, **updates):
    """The golden 32^3 configuration (tests/test_golden_bundle.py) with
    `updates`, on `device`: (model, params, gxy_mesh) on the golden white
    mesh (with `ulp`, every value moved up by one float32 ulp).  With
    `off_fiducial`, every scalar latent but s_e2_ is moved 0.3 sigma off
    the fiducial, as the CPU model parity tests move theirs: fNL off 0, the
    AP alphas off 1 and the cosmology off the fiducial one that ap_auto
    maps through."""
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
    if off_fiducial:
        p = {k: v if k == "s_e2_" else v + 0.3 for k, v in p.items()}
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


def _conditioned(m):
    """Condition `m` on its counts and block it, as the full warmup does."""
    m.reset()
    m.substitute(m.obs_data(), from_base=True)
    m.block()


def phase_sampler_32():
    """Phase 4e: 2 MCLMC kernel steps of the golden 32^3 2LPT model,
    conditioned on the CPU's counts and blocked, from one state (the golden
    white mesh) with the same momentum and refresh draws, on the card and on
    the CPU: positions (the flat vector, over its largest value) and
    logdensities within phase 4's logpdf tolerance, 1e-4 relative."""
    from montecosmo_tpu_torch.samplers import mclmc as S

    rng = np.random.default_rng(0)
    states, obs, draws = {}, None, None
    for dev in ("cpu", "cuda"):
        m, p, pred = golden_predict(dev, "lpt")
        if obs is None:
            obs = pred["count_mesh"].cpu()
        m.count_mesh = obs.to(dev)
        _conditioned(m)
        d = sum(v.numel() for v in p.values())
        if draws is None:
            draws = rng.standard_normal((3, d)).astype(np.float32)
        u0, noise = (torch.as_tensor(x, device=dev) for x in (draws[0], draws[1:]))
        state = S.mclmc_init(p, m.logpdf, u0)
        kernel = S.mclmc_kernel(m.logpdf, 1.0)
        for row in noise:
            state, _ = kernel(row, state, d**0.5, 2.0)
        states[dev] = state
    card, cpu = states["cuda"], states["cpu"]
    lp_rel = abs(card.logdensity.item() - cpu.logdensity.item()) / abs(cpu.logdensity.item())
    # the positions as the sampler holds them, one flat vector
    x_card, x_cpu = S._ravel(card.position)[0].cpu(), S._ravel(cpu.position)[0]
    pos_rel = float((x_card - x_cpu).abs().max() / x_cpu.abs().max())
    worst = {k: float((card.position[k].cpu() - v).abs().max()) for k, v in cpu.position.items()}
    log(f"# 32^3 MCLMC, 2 kernel steps (eps 2, L sqrt(d), d {d}), card vs CPU: logdensity "
        f"{card.logdensity.item():.6e} vs {cpu.logdensity.item():.6e}, relative {lp_rel:.3e}; "
        f"positions max|difference| / max|value| {pos_rel:.3e} (limits 1e-4); largest "
        f"differences by latent {sorted(worst.items(), key=lambda kv: -kv[1])[:4]}")
    assert all(bool(torch.isfinite(v).all()) for v in card.position.values())
    assert lp_rel <= 1e-4 and pos_rel <= 1e-4, "the 32^3 sampler steps: card and CPU disagree"


# ---------------------------------------------------------------- phase 4f
HESS_KEYS = ("Omega_m_", "b1_", "sigma8_")


def scalar_hessian(m, p, obs):
    """The Hessian of m.logpdf in the scalar latents HESS_KEYS (the others
    at `p`, conditioned on `obs`): the port's `script.block_hessian`, one
    Hessian-vector product a column."""
    from montecosmo_tpu_torch.script import block_hessian

    others = {**{k: v for k, v in p.items() if k not in HESS_KEYS}, **obs}
    return block_hessian(m.logpdf, {k: p[k] for k in HESS_KEYS}, others)


def phase_hessian_32(evolution):
    """Phase 4f: the golden 32^3 model (`evolution`), conditioned on the CPU's
    counts, its logpdf's Hessian in {Omega_m_, b1_, sigma8_} on the card and
    on the CPU: finite, nonzero, within 1e-4 of the largest entry (float32
    value+grads in another order, differentiated once more).  Returns the
    card's launches (K6 and K7 must run)."""
    from montecosmo_tpu_torch.ops import paint as P

    hess, obs, launches = {}, None, None
    for dev in ("cpu", "cuda"):
        m, p, pred = golden_predict(dev, evolution)
        if obs is None:
            obs = pred["count_mesh"].cpu()
        P.reset_launches()
        t0 = time.perf_counter()
        hess[dev] = scalar_hessian(m, p, {"count_mesh": obs.to(dev)}).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = P.launches_at(m.paint_order)
        log(f"# 4f 32^3 {evolution} Hessian on {dev} ({time.perf_counter() - t0:.2f} s): "
            f"{hess[dev].tolist()}")
    rel = float((hess["cuda"] - hess["cpu"]).abs().max() / hess["cpu"].abs().max())
    log(f"# 4f 32^3 {evolution} Hessian in {HESS_KEYS}, card vs CPU: max|difference| / "
        f"max|entry| {rel:.3e} (limit 1e-4); card launches {launches}")
    assert bool(torch.isfinite(hess["cuda"]).all()) and float(hess["cuda"].abs().max()) > 1e-3
    assert rel <= 1e-4, f"4f: the {evolution} Hessian disagrees between the card and the CPU"
    missing = [k for k in hess_names(m.paint_order) if not launches.get(k)]
    assert not missing, f"4f: {missing} never launched"
    return launches


# ----------------------------------------------------------------- phase 5
def bench_model(final=128, evolution="lpt", **updates):
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=500.0 * 2 / final, evolution=evolution,
                lpt_order=2, a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 1500.0),
                lik_type="quad_gauss", precond="kaiser", paint_method="auto")
    conf.update(updates)
    return FieldLevelModel(**conf, device="cuda")


@contextmanager
def fixed_tables(m):
    """Every evaluation inside builds no RK4 background tables: it takes
    the tables of `m`'s fiducial cosmology, built once here (the timing
    changes; the gradient through the tables w.r.t. Omega_m and sigma8 is
    dropped)."""
    from montecosmo_tpu_torch.ops.background import Background, get_cosmology

    fixed = Background.create(get_cosmology(Omega_m=float(m.cosmo_fid.Omega_m),
                                            sigma8=float(m.cosmo_fid.sigma8)), "cuda")
    create = Background.__dict__["create"]
    Background.create = classmethod(lambda cls, cosmo, device="cpu": fixed)
    try:
        yield
    finally:
        Background.create = create


def flagship(evolution="lpt", **updates):
    """The flagship model with `evolution` and the config `updates`, its
    latents at the fiducial with a random white mesh (leaves that require
    grad), the observation drawn with `predict`, and a closure making one
    logpdf value+grad."""
    m = bench_model(evolution=evolution, **updates)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    params["white_mesh_"] = torch.randn(m.init_shape, generator=gen, device="cuda")
    obs = {"count_mesh": m.predict(seed=gen, samples=params, hide_base=False, hide_det=False,
                                   hide_samp=False)["count_mesh"]}
    torch.cuda.synchronize()
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    def value_and_grad():
        for v in leaves.values():
            v.grad = None
        lp = m.logpdf({**leaves, **obs})
        lp.backward()
        return lp

    return m, leaves, obs, value_and_grad


# K8's and K9's launches in each flagship's 7 timed value+grads (phase 5),
# by tag (K9's by caller: "take_rows", a lookup's backward; "segment_sum",
# the power spectrum's binning)
K8_LAUNCHES, K9_LAUNCHES = {}, {}
# (device kernels, device-busy ms, median wall ms) of a profiled value+grad
# by tag (phase_bench's `profile`)
PROFILED = {}


def k9_launches():
    """K9's launches since the last reset, by caller."""
    from montecosmo_tpu_torch.ops import paint as P

    return {w: n for (k, w, o), n in P.LAUNCHES.items() if k == "segment_sum"}


def phase_bench(evolution, kernels, tag=None, capture=None, lookups=False, latents=(),
                profile=False, **updates):
    """The flagship value+grad with `evolution` and the config `updates`;
    every kernel in `kernels` must launch at the model's paint order and
    window, K8 and K9 (every lookup's backward) at every evaluation.
    Returns the launch counts of the 7 evaluations there; with `capture`
    ("paint" or "read"), also what `flagship_inputs` measures.  With
    `lookups` (the light cones), also the table gathers' backwards of one
    more value+grad by call site (`table_backwards`) and the determinism
    witness (`gradient_witness`).  Every name in `latents` must be a latent
    with a finite gradient.  With `profile`, one more value+grad profiled:
    its device kernels and device-busy ms (`PROFILED[tag]`)."""
    from montecosmo_tpu_torch.ops import paint as P

    t0 = time.perf_counter()
    m, leaves, obs, value_and_grad = flagship(evolution, **updates)
    missing = [k for k in latents if k not in leaves]
    assert not missing, f"({tag or evolution}) latents {missing} are not sampled"
    tag = tag or evolution
    log(f"# bench model ({tag}): final {m.final_shape} init {m.init_shape} "
        f"evol {m.evol_shape} paint {m.paint_shape} steps "
        f"{m.nbody_n_steps if evolution == 'nbody' else 0} "
        f"particles {int(np.prod(m.ptcl_shape))} max_disp {m.max_disp} "
        f"lattice {m.paint_lattice} rbins {m.n_rbins} a_obs {m.a_obs} curved_sky "
        f"{m.curved_sky} paint_order {m.paint_order} kernel_type {m.kernel_type}; set-up "
        f"{time.perf_counter() - t0:.2f} s")

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
        f"evals/s {1 / np.median(times):.4f} (median); logpdf of the 5 {values}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches in 7 evals {launches}")
    assert np.all(np.isfinite(values)) and grads_ok, "non-finite logpdf or gradient"
    k8 = P.LAUNCHES["background_tables", "background", 0]
    K8_LAUNCHES[tag], K9_LAUNCHES[tag] = k8, k9_launches()
    log(f"# ({tag}) launches per value+grad at {window} order {m.paint_order}: "
        f"{ {k: v / 7 for k, v in launches.items()} }; K8 background_tables {k8 / 7}; "
        f"K9 segment_sum { {w: n / 7 for w, n in K9_LAUNCHES[tag].items()} }")
    assert k8 >= 7, f"K8 never ran on the {tag} path ({k8} launches in 7 value+grads)"
    assert K9_LAUNCHES[tag].get("take_rows", 0) >= 7, f"K9 never ran on the {tag} path"
    missing = [k for k in kernels if not launches.get(k)]
    assert not missing, f"kernels of the {tag} path never ran: {missing} ({launches})"
    captured = flagship_inputs(tag, value_and_grad, capture) if capture else None
    if lookups:
        table_backwards(m, leaves, obs, tag)
        gradient_witness(leaves, value_and_grad, tag)

    # share of the background RK4 tables: the same evaluations with the
    # tables built once, outside the timed loop
    with fixed_tables(m):
        t_fixed = []
        for _ in range(2):
            value_and_grad()
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            value_and_grad()
            torch.cuda.synchronize()
            t_fixed.append(time.perf_counter() - t)
    share = 1 - np.median(t_fixed) / np.median(times)
    log(f"# ({tag}) with the background tables held fixed: ms/eval "
        f"{[round(1e3 * t, 3) for t in t_fixed]} median {1e3 * np.median(t_fixed):.3f}; "
        f"the RK4 tables take {100 * share:.1f}% of an evaluation (median to median)")
    if profile:
        n, busy = profiled_kernels(value_and_grad)
        PROFILED[tag] = (n, busy, 1e3 * float(np.median(times)))
        log(f"# ({tag}) one value+grad profiled: {n} device kernels, device busy {busy:.3f} ms "
            f"= {100 * busy / (1e3 * np.median(times)):.1f}% of the median wall")
    if "--profile" in sys.argv:
        # profiled after every timed phase: a profiler session slows the
        # host's launches in the evaluations timed after it
        PROFILES.append(lambda: (log(f"# --- profile ({tag})"),
                                 layer_times(m, value_and_grad),
                                 profile_eval(value_and_grad, np.mean(times)),
                                 fixed_profile(m, value_and_grad, np.median(t_fixed), tag)))
    return (launches, captured) if capture else launches


# ------------------------------------------------------------ table lookups
# the gather backwards: K9's (`take_rows`), advanced indexing's (the sort-based
# `index_put_`) and `index_select`'s (`index_add_`, none left on the paths)
GATHER_BACKWARDS = ("_TakeRowsBackward", "IndexBackward0", "IndexSelectBackward0")


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
            idx = (f.saved_tensors if type(f).__name__ == "_TakeRowsBackward" else
                   getattr(f, "_saved_indices", None) or [getattr(f, "_saved_index", None)])
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
    Prints them by call site (K9 for `take_rows`); asserts that none is
    `index_add_` (IndexSelectBackward0); returns (count, device ms) over
    all of them."""
    for v in leaves.values():
        v.grad = None
    with torch.autograd.detect_anomaly(check_nan=False):
        lp = m.logpdf({**leaves, **obs})
    nodes = gather_nodes(lp.grad_fn)
    timed, cotangents = [], []
    for node, src, n_idx in nodes:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if type(node).__name__ == "_TakeRowsBackward":
            # registered first: the copy is made before t0 is recorded
            node.register_prehook(lambda grads, n=node: cotangents.append(
                (call_site(n), grads[0].detach().clone(), n.saved_tensors[0], n.rows)))
        node.register_prehook(lambda grads, e=t0: e.record())
        node.register_hook(lambda grads_in, grads_out, e=t1: e.record())
        timed.append((call_site(node), type(node).__name__, src, n_idx, t0, t1))
    lp.backward()
    torch.cuda.synchronize()
    total = 0.0
    names = {"_TakeRowsBackward": "K9 segment_sum", "IndexBackward0": "index_put_ (sorted)",
             "IndexSelectBackward0": "index_add_"}
    for site, kind, src, n_idx, t0, t1 in sorted(timed, key=lambda r: r[0]):
        ms = t0.elapsed_time(t1)
        total += ms
        log(f"# ({tag}) table backward {names[kind]} table {src} queries {n_idx}: {ms:.3f} ms "
            f"at {site}")
    log(f"# ({tag}) table backwards of one value+grad: {len(timed)} nodes, {total:.3f} ms "
        f"of device time (events around each node)")
    assert not any(kind == "IndexSelectBackward0" for _, kind, *_ in timed), \
        f"({tag}) a table backward still runs index_add_"
    k9_on_cotangents(cotangents, tag)
    return len(timed), total


# K9 on each light cone's own lookup cotangents, by tag: the largest error
# per column over the column's own largest |sum| (`k9_on_cotangents`), held
# at the level of the sort-based sum (advanced indexing's backward)
K9_PATH, K9_PATH_TOL = {}, 5.1e-6


def k9_on_cotangents(cotangents, tag):
    """K9 against its plain version in float64 on the cotangents and ids
    that the path's table gathers received (captured by `table_backwards`):
    per column (a table channel), max |K9 - plain| over that column's own
    largest |sum|, so that a column whose sums are much smaller than the
    others' is held in its own terms; columns that sum to 0 are skipped."""
    from montecosmo_tpu_torch.ops import segment as S

    worst = {}
    for site, g, idx, rows in cotangents:
        src = g.reshape(g.shape[0], -1)
        k9 = S.segment_sum_kernel(src, idx, rows).double()
        ref = S.segment_sum_plain(src.double(), idx, rows)
        scale = ref.abs().amax(0)
        live = scale > 0
        err = ((k9 - ref).abs().amax(0)[live] / scale[live]).tolist()
        worst[site] = max(err, default=0.0)
        log(f"# ({tag}) K9 on the path's cotangent at {site}: N {src.shape[0]} R {rows} C "
            f"{src.shape[1]} ({src.dtype}); per-column max_rel_err "
            f"{[f'{e:.3e}' for e in err]} (columns summing to 0: {int((~live).sum())})")
        assert worst[site] <= K9_PATH_TOL, f"({tag}) K9 disagrees at {site}"
    K9_PATH[tag] = worst
    log(f"# ({tag}) K9 on the path's cotangents: largest per-column error "
        f"{max(worst.values(), default=0.0):.3e} over {len(worst)} lookups")


def gradient_witness(leaves, value_and_grad, tag, keys=("Omega_m_", "sigma8_")):
    """ROADMAP Queue C 1's witness: one value+grad made twice from the same
    inputs, every kernel run anew (K1's and K5's meshes and K9's table
    gradients sum in fixed point): the Omega_m and sigma8 gradients must be
    equal bit for bit (every latent's is printed).  Returns the largest
    difference of each."""
    def grads():
        value_and_grad()
        torch.cuda.synchronize()
        return {k: v.grad.detach().clone() for k, v in leaves.items()}

    runs = [grads(), grads()]
    same = {k: torch.equal(runs[0][k], runs[1][k]) for k in runs[0]}
    diff = {k: float((runs[0][k] - runs[1][k]).abs().max()) for k in keys}
    log(f"# ({tag}) witness, two value+grads: {keys} gradients "
        f"{[runs[0][k].item() for k in keys]} / {[runs[1][k].item() for k in keys]}, largest "
        f"difference {diff}; equal bit for bit {[k for k, v in same.items() if v]}, different "
        f"{[k for k, v in same.items() if not v]}")
    assert all(same[k] for k in keys), f"({tag}) the {keys} gradients are not reproducible"
    return diff


# ---------------------------------------------------------- phases 5h-5j
# the Kaiser flagship's three regimes (5h): bench.py's configuration with
# evolution='kaiser'
KAISER_REGIMES = {"flat sky, a_obs 0.5": dict(a_obs=0.5, curved_sky=False),
                  "flat-sky light cone": dict(a_obs=None, curved_sky=False),
                  "curved-sky light cone": dict(a_obs=None, curved_sky=True)}


def card_vs_cpu_32(what, evolution, off_fiducial=False, **updates):
    """The golden 32^3 configuration with `evolution` and `updates` on the
    golden white mesh (its latents `off_fiducial` where asked), card
    against CPU at phase 4's tolerances: the galaxy mesh (transfer,
    coherence) and the logpdf on the card's counts (1e-4 relative); every
    latent's gradient finite on both."""
    preds, lps = {}, {}
    for dev in ("cuda", "cpu"):
        m, p, preds[dev] = golden_predict(dev, evolution, off_fiducial=off_fiducial, **updates)
        if off_fiducial and dev == "cpu":
            base = m.reparam({k: v for k, v in p.items() if k != "white_mesh_"})
            log(f"# {what}: off the fiducial, " + ", ".join(
                f"{k} {float(base[k]):.4g}" for k in ("Omega_m", "fNL", "alpha_iso", "alpha_ap",
                                                     "fNL_bp", "fNL_bpd") if k in base))
        obs = preds["cuda"]["count_mesh"].to(dev)
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        lp = m.logpdf({**leaves, "count_mesh": obs})
        lp.backward()
        lps[dev] = (lp.item(), leaves["Omega_m_"].grad.item(), leaves["sigma8_"].grad.item())
        assert all(bool(torch.isfinite(v.grad).all()) for v in leaves.values()), (what, dev)
    check_transfer(preds["cuda"]["gxy_mesh"].cpu().numpy(), preds["cpu"]["gxy_mesh"].numpy(),
                   f"{what}, card vs CPU")
    rel = abs(lps["cuda"][0] - lps["cpu"][0]) / abs(lps["cpu"][0])
    log(f"# {what}: (logpdf, d/dOmega_m_, d/dsigma8_) card {lps['cuda']}, CPU "
        f"{lps['cpu']}; logpdf relative difference {rel:.3e} (limit 1e-4)")
    assert rel <= 1e-4, f"{what}: the logpdf disagrees between card and CPU"


def phase_kaiser():
    """5h: the Kaiser flagship (bench.py's configuration, evolution='kaiser':
    128^3 final, init 192^3, evol 224^3) in its three regimes, each first
    held at 32^3 against the CPU (`card_vs_cpu_32`), then timed as phase 5 (2
    warm-ups, 5 value+grads, the tables fixed beside); K8 and K9 must
    launch.  Returns K9's launches of each regime's 7 evaluations."""
    for name, regime in KAISER_REGIMES.items():
        card_vs_cpu_32(f"5h 32^3 Kaiser, {name}", "kaiser", **regime)
    for name, regime in KAISER_REGIMES.items():
        phase_bench("kaiser", (), f"Kaiser, {name}", **regime)
    return {name: K9_LAUNCHES[f"Kaiser, {name}"] for name in KAISER_REGIMES}


# the AP and PNG flagships (4g at 32^3, 5k at bench.py's widths): the name,
# the evolution and the config updates
AP_PNG = {"2LPT, Lagrangian bias, ap_auto=True, png_type=fNL":
          ("lpt", dict(ap_auto=True, png_type="fNL")),
          "Kaiser flat-sky light cone, ap_auto=False":
          ("kaiser", dict(a_obs=None, curved_sky=False, ap_auto=False)),
          "2LPT, Eulerian bias, png_type=bias":
          ("lpt", dict(bias_type="eulerian", png_type="bias"))}
AP_PNG_LATENTS = ("alpha_iso_", "alpha_ap_", "fNL_", "fNL_bp_", "fNL_bpd_", "fNL_bpd2_",
                  "fNL_bps2_", "fNL_bn2p_")


def phase_ap_png_32():
    """4g: the three AP/PNG configurations at 32^3 on the golden white mesh,
    their latents off the fiducial (so that the AP remap and the PNG terms
    are not the identity and 0), card against CPU at phase 4's tolerances
    (`card_vs_cpu_32`)."""
    for name, (evolution, updates) in AP_PNG.items():
        card_vs_cpu_32(f"4g 32^3 {name}", evolution, off_fiducial=True, **updates)


def phase_ap_png():
    """5k: the three AP/PNG flagships at bench.py's widths (128^3 final,
    quad-Gaussian, Kaiser preconditioning, float32): each timed as phase 5
    (2 warm-ups, 5 value+grads, the tables fixed beside), every latent's
    gradient finite (alpha_iso_, alpha_ap_ and the fNL*_ ones included),
    peak memory, one value+grad profiled (device kernels, busy share); K1,
    K2 and K3 must launch in the designs the route takes at CIC (the 2LPT
    render and the Eulerian matter and phi paints; the Kaiser mesh's AP
    re-paint), K8 and K9 too.  Returns each one's launches per
    value+grad."""
    out = {}
    for name, (evolution, updates) in AP_PNG.items():
        launches = phase_bench(evolution, path_kernels(2), f"5k {name}", latents=AP_PNG_LATENTS,
                               profile=True, **updates)
        out[name] = {k: v / 7 for k, v in launches.items()}
    return out


# ---------------------------------------------------------------- phase 5l
# the registered-survey campaign: catalogs of examples/cutsky_inference.py at
# full width, its register at the flagship's 128^3 cell budget, and the
# campaign's cut depth (run/infer.py's phases, MCLMC)
SURVEY = {"data": 2_000_000, "randoms": 20_000_000, "cell_budget": 128**3,
          "check_data": 200_000, "check_randoms": 1_000_000, "check_budget": 32**3}
CAMPAIGN = dict(n_chains=2, n_steps_field=8, n_steps_full=8, n_samples=4, thinning=2)
SURVEY_COSMO = dict(Omega_m=0.3111, sigma8=0.8102)  # default_config's fiducial
# the 32^3 card-vs-CPU models on the catalog's counts are held in the cells
# whose resampled selection is at least EDGE of its mean, at most MAX_EDGE of
# the footprint being left out
EDGE, MAX_EDGE = 0.01, 0.05


def survey_catalog(n, seed):
    """A cut-sky catalog (examples/cutsky_inference.py:29-48): RA 150-210
    deg, DEC +-20 deg uniform on the sphere, z triangular 0.8-1.0-1.2, unit
    weights; numpy float64, seeded."""
    rng = np.random.default_rng(seed)
    smin, smax = np.sin(np.deg2rad(-20.0)), np.sin(np.deg2rad(20.0))
    return dict(RA=rng.uniform(150.0, 210.0, n),
                DEC=np.rad2deg(np.arcsin(rng.uniform(smin, smax, n))),
                Z=rng.triangular(0.8, 1.0, 1.2, n), WEIGHT=np.ones(n))


def survey_32(data, rand, tmp):
    """5l at 32^3: the register of the thinned catalogs built on the card
    and on the CPU (K1's and K3's plain versions): footprint masks equal
    cell for cell, selection and counts within TOL of their largest value;
    then each register's model (2LPT, curved-sky light cone, masked) at the
    same latents (the fiducial, one seeded white mesh): the logpdfs given
    the CPU model's predicted counts within 1e-4 relative; and, given each
    register's own catalog counts, the count log-prob summed over the
    cells whose resampled selection is at least EDGE of its mean within
    1e-4 relative, those cells at least 1 - MAX_EDGE of the footprint.
    The footprint's edge is left out of that sum: there the variance is
    the selection, near zero, so a count over it turns the registers'
    float32 rounding of the selection (within TOL of its largest value)
    into log-prob differences of order one per cell; their share of the
    whole difference is printed."""
    from montecosmo_tpu_torch import FieldLevelModel
    from montecosmo_tpu_torch.infer import build_model
    from montecosmo_tpu_torch.models import ppl
    from montecosmo_tpu_torch.ops.background import get_cosmology
    from montecosmo_tpu_torch.utils.io import npsave

    sub_d = {k: v[:SURVEY["check_data"]] for k, v in data.items()}
    sub_r = {k: v[:SURVEY["check_randoms"]] for k, v in rand.items()}
    regs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        regs[dev] = FieldLevelModel.register_catalog(
            SURVEY["check_budget"], get_cosmology(**SURVEY_COSMO), sub_d, sub_r, device=dev)
        log(f"# 5l 32^3 register on {dev}: {1e3 * (time.perf_counter() - t0):.3f} ms, final "
            f"{regs[dev]['count_mesh'].shape}")
    card, cpu = regs["cuda"], regs["cpu"]
    diff = int((card["mask_mesh"] != cpu["mask_mesh"]).sum())
    errs = {k: float(np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max())
            for k in ("count_mesh", "selec_mesh")}
    log(f"# 5l 32^3 register, card vs CPU: footprint {int(cpu['mask_mesh'].sum())} of "
        f"{cpu['mask_mesh'].size} cells, {diff} differ (limit 0); max|difference| / max|value| "
        f"{errs} (limit {TOL})")
    assert diff == 0, "5l: the card's footprint mask differs from the CPU's"
    assert all(e <= TOL for e in errs.values()), "5l: the card's register disagrees"
    lps, cells, obs, edge = {}, {}, None, None
    for dev in ("cpu", "cuda"):
        npsave(tmp / f"register_32_{dev}.npz", regs[dev])
        m = build_model(tmp / f"register_32_{dev}.npz", device=dev)
        p = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
        p["white_mesh_"] = torch.as_tensor(np.random.default_rng(0).standard_normal(
            m.init_shape).astype(np.float32), device=dev)
        with torch.no_grad():
            if obs is None:
                obs = m.predict(seed=0, samples=p, hide_samp=False)["count_mesh"]
                selec = m._selec_final.abs().cpu()
                edge = selec < EDGE * selec.mean()
            lps[dev] = m.logpdf(p | {"count_mesh": obs.to(dev)}).item()
            lp, _ = ppl.compute_log_probs(m.model, (), {}, p | m.obs_data(), sum_log_prob=False)
            cells[dev] = lp["count_mesh"].double().cpu()
    rel = abs(lps["cuda"] - lps["cpu"]) / abs(lps["cpu"])
    d = (cells["cuda"] - cells["cpu"]).abs()
    inner = {dev: float(c[~edge].sum()) for dev, c in cells.items()}
    rel_inner = abs(inner["cuda"] - inner["cpu"]) / abs(inner["cpu"])
    whole = {dev: float(c.sum()) for dev, c in cells.items()}
    share_edge = int(edge.sum()) / edge.numel()
    log(f"# 5l 32^3 models of the two registers, the CPU's predicted counts: logpdf card "
        f"{lps['cuda']:.6e} vs CPU {lps['cpu']:.6e}, relative {rel:.3e} (limit 1e-4); the "
        f"catalog's counts: count_mesh log-prob over the {int((~edge).sum())} cells whose "
        f"selection is at least {EDGE} of its mean card {inner['cuda']:.6e} vs CPU "
        f"{inner['cpu']:.6e}, relative {rel_inner:.3e} (limit 1e-4); the other "
        f"{int(edge.sum())} cells, {share_edge:.4f} of the footprint (limit {MAX_EDGE}), "
        f"hold {100 * float(d[edge].sum() / d.sum().clamp(min=1e-300)):.2f}% of the per-cell "
        f"difference; over "
        f"every cell card {whole['cuda']:.6e} vs CPU {whole['cpu']:.6e}, relative "
        f"{abs(whole['cuda'] - whole['cpu']) / abs(whole['cpu']):.3e}")
    assert rel <= 1e-4, "5l: the 32^3 registered models' logpdfs disagree"
    assert share_edge <= MAX_EDGE, "5l: the footprint's edge is more of it than MAX_EDGE"
    assert rel_inner <= 1e-4, "5l: the 32^3 registered models disagree on the catalog's counts"


def phase_survey(tmp):
    """5l: the registered-survey campaign at full width.  Catalogs of
    SURVEY's sizes (numpy, seeded); first `survey_32`; then the 128^3-budget
    cut-sky register on the card (default paint settings: CIC, interlace
    2, deconvolved; K1 unclamped in its atomic design, K3), timed with its
    K1/K3 launches, npsave'd; the campaign through the CLI's function
    (`infer.infer`, --self-data, MCLMC, CAMPAIGN, 2 runs), then again with
    3 runs, which must load both warmups and make run 3 only; every run's
    logdensity finite, the chains' ESS and r-hat printed; the ms per
    value+grad of the campaign's model (2 warm-ups, 5 timed) and per
    McLachlan step (every step of the campaign timed), its peak memory,
    and the path's kernels launched (K1, K2, K3 in the route's designs, K8,
    K9).  Its files stay under `tmp`.  Returns the K1/K3 rows' extras and
    the campaign's save dir."""
    from montecosmo_tpu_torch import FieldLevelModel
    from montecosmo_tpu_torch.infer import DEFAULT_OBS, build_model, infer, obs_names_of
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.ops.background import get_cosmology
    from montecosmo_tpu_torch.samplers import mclmc as S
    from montecosmo_tpu_torch.utils.io import npload, npsave

    t0 = time.perf_counter()
    data, rand = survey_catalog(SURVEY["data"], 0), survey_catalog(SURVEY["randoms"], 1)
    log(f"# 5l catalogs: {SURVEY['data']} data, {SURVEY['randoms']} randoms "
        f"({time.perf_counter() - t0:.2f} s, numpy)")
    tmp = Path(tmp) / "survey"
    tmp.mkdir()
    survey_32(data, rand, tmp)

    P.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg = FieldLevelModel.register_catalog(SURVEY["cell_budget"],
                                           get_cosmology(**SURVEY_COSMO), data, rand)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(P.LAUNCHES)
    k1 = sum(n for (k, w, o), n in launches.items() if k.startswith("paint_cic") and o == 2
             and k != "paint_cic_adjoint")
    k3 = launches.get(("nufft_epilogue", "bspline", 2), 0)
    npsave(tmp / "register_survey.npz", reg)
    count = reg["count_mesh"]
    final = count.shape
    m = build_model(tmp / "register_survey.npz")
    log(f"# 5l register (cell budget {SURVEY['cell_budget']}): final {final} "
        f"({int(np.prod(final))} cells, footprint {int(reg['mask_mesh'].sum())}), init "
        f"{m.init_shape}, paint {m.paint_shape}, selection {reg['selec_mesh'].shape}; cell "
        f"{reg['cell_length']:.4f} Mpc/h; built in {build_ms:.3f} ms with {k1} K1 and {k3} "
        f"K3 launches {launches}; count_mesh.sum() {float(count.sum(dtype=np.float64)):.3f} "
        f"against the data's weight {float(data['WEIGHT'].sum()):.1f}")
    assert k1 >= 3 and k3 >= 2, "5l: the register did not go through K1 and K3"
    np.testing.assert_allclose(float(count.sum(dtype=np.float64)), SURVEY["data"],
                               rtol=1e-4)
    del data, rand

    # the campaign's model: one value+grad timed, then the campaign
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    p["white_mesh_"] = torch.randn(m.init_shape, generator=gen, device="cuda")
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    obs = m.obs_data()

    def value_and_grad():
        for v in leaves.values():
            v.grad = None
        m.logpdf({**leaves, **obs}).backward()

    walls = []
    for i in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        value_and_grad()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    vg_ms = float(np.median(walls[2:]))
    log(f"# 5l value+grad of the campaign's model (2LPT, Lagrangian bias, quad-Gaussian, "
        f"curved-sky light cone, masked, d = {sum(v.numel() for v in p.values())}): ms "
        f"{[round(w, 3) for w in walls[2:]]} median {vg_ms:.3f}")
    del m, leaves, obs

    steps, step = [], S._mclachlan_step

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t))
        return out

    kw = dict(CAMPAIGN, self_data=True, sampler="mclmc", device="cuda",
              save_root=str(tmp / "results"), obs_names=obs_names_of(None, "quad_gauss", None))
    S._mclachlan_step = timed_step
    P.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        save_dir, _ = infer(tmp / "register_survey.npz", n_runs=2, **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        n_first = len(steps)
        path = dict(P.LAUNCHES)
        chains_dir = save_dir / "chains"
        kept = ["field_warm_state.npz", "full_warm_state.npz", "run_1.npz", "run_2.npz"]
        mtimes = {f: (chains_dir / f).stat().st_mtime_ns for f in kept}
        t1 = time.perf_counter()
        save_dir, chains = infer(tmp / "register_survey.npz", n_runs=3, **kw)
        torch.cuda.synchronize()
        resumed = time.perf_counter() - t1
    finally:
        S._mclachlan_step = step
    peak = torch.cuda.max_memory_allocated() / 2**30
    need = path_kernels(2) + ("background_tables", "segment_sum")
    made = {k: sum(n for (kk, _, _), n in path.items() if kk == k) for k in need}
    log(f"# 5l campaign (2 runs): {first:.2f} s, {n_first} McLachlan steps; resumed with 3 "
        f"runs: {resumed:.2f} s, {len(steps) - n_first} steps; McLachlan step ms median "
        f"{float(np.median(steps)):.3f} (min {min(steps):.3f}, max {max(steps):.3f}); peak "
        f"memory {peak:.2f} GiB; path launches {made}")
    assert all(made.values()), f"5l: kernels of the path never launched: {made}"
    out = (save_dir / "run.out").read_text()
    for line in ("Loading field warmup...", "Loading full warmup...", "Resuming at run 3..."):
        assert line in out, f"5l: the resumed campaign did not log {line!r}"
    assert out.count("run 3/3") == 1 and "run 1/3" not in out and "run 2/3" not in out
    assert all((chains_dir / f).stat().st_mtime_ns == t for f, t in mtimes.items()), \
        "5l: the resumed campaign rewrote a finished phase"
    assert len(steps) - n_first == CAMPAIGN["n_chains"] * CAMPAIGN["n_samples"] * CAMPAIGN[
        "thinning"], "5l: the resumed campaign ran more than run 3"
    for i in (1, 2, 3):
        lp = npload(chains_dir / f"run_{i}.npz")["logdensity"]
        assert lp.shape == (CAMPAIGN["n_chains"], CAMPAIGN["n_samples"]) and np.isfinite(
            lp).all(), f"5l: run {i}'s logdensity is not finite"
    ess = {k: float(v) for k, v in chains[["*~white_mesh_"]].multi_ess().data.items()}
    rhat = {k: float(_rhat(v)) for k, v in chains.data.items()
            if k not in ("white_mesh_", "n_evals")}
    log(f"# 5l chains {chains.shape}: ESS {ess}; r-hat {rhat}")
    log(f"# 5l observed sites {sorted(set(DEFAULT_OBS) & set(npload(save_dir / 'obs.npz')))}")
    return {"launches_register": {"paint_cic": k1, "nufft_epilogue": k3},
            "register_ms": build_ms, "campaign_value_and_grad_ms": vg_ms,
            "campaign_mclachlan_step_ms": float(np.median(steps)), "save_dir": save_dir}


# ---------------------------------------------------------------- phase 5m
# the N-body remainder: the integrators in scale-factor time at the
# flagship's cell (1000/128 Mpc/h), the accuracy report, the register CLI
REMAINDER = {"check": 32, "final": 128, "rk4_steps": 16, "fine_rk4": (64, 128),
             "tsit5_tol": 1e-3, "fine_tol": 1e-4, "grad_tol": 1e-2, "grad_max_steps": 24,
             "report_f64": 32, "register_ptcl": 256, "register_box": 2000.0}
# the SKILL drive's smallest campaign (.claude/skills/verify/SKILL.md)
SMOKE_REGISTER = ["--cell-budget", "512", "--n-ptcl", "16", "--box-size", "320",
                  "--init-oversamp", "1.0", "--paint-oversamp", "1.0"]
SMOKE_CAMPAIGN = dict(evolution="kaiser", self_data=True, n_chains=2, n_steps_field=64,
                      n_steps_full=64, n_samples=4, n_runs=2, thinning=2)
# K1, K2, K4, K5 in their per-particle designs: this path paints and reads
# unclamped
REMAINDER_KERNELS = ("paint_cic", "paint_cic_adjoint", "read_cic", "read_cic_adjoint")


def remainder_field(n, device, seed=7):
    """(Background, rfft linear field, particle lattice) at n^3 with the
    flagship's cell: the white field drawn on the CPU from a seeded
    generator, so that the card and the CPU integrate the same field."""
    from montecosmo_tpu_torch.models.bricks import regular_pos, white2lin, white_noise
    from montecosmo_tpu_torch.ops.background import Background, get_cosmology

    shape, box = (n,) * 3, (n * 1000.0 / 128,) * 3
    cosmo = get_cosmology(**SURVEY_COSMO)
    lin = white2lin(cosmo, white_noise(torch.Generator().manual_seed(seed), shape, box), shape, box)
    return Background.create(cosmo, device=device), lin.to(device), regular_pos(shape, device=device)


def _launched():
    """{kernel: launches} of REMAINDER_KERNELS at CIC since the last reset."""
    from montecosmo_tpu_torch.ops import paint as P

    return {k: P.LAUNCHES.get((k, "bspline", 2), 0) for k in REMAINDER_KERNELS}


def remainder_32():
    """5m (a): lpt_fpm (order 2), nbody_bf_scan (10 steps), a 16-step
    nbody_rk4 and nbody_tsit5 (tol 1e-3, 3 snapshots), grad_fd 4, at 32^3
    on the card and on the CPU: positions within 1e-3 cells (Tsit5 10 tol),
    the Tsit5 step counts of both printed."""
    from montecosmo_tpu_torch.ops import pm

    tol = REMAINDER["tsit5_tol"]
    runs = {"lpt_fpm": (lambda bg, lin, p, st: pm.lpt_fpm(bg, lin, p, 0.05, 2, grad_fd=4), 1e-3),
            "nbody_bf_scan": (lambda bg, lin, p, st: pm.nbody_bf_scan(bg, lin, p, 0.5, 10,
                                                                      grad_fd=4), 1e-3),
            "nbody_rk4": (lambda bg, lin, p, st: pm.nbody_rk4(bg, lin, p, 0.05, 0.5,
                                                              REMAINDER["rk4_steps"]), 1e-3),
            "nbody_tsit5": (lambda bg, lin, p, st: pm.nbody_tsit5(bg, lin, p, 0.05, 0.5, tol,
                                                                  snapshots=3, stats=st), 10 * tol)}
    fields = {dev: remainder_field(REMAINDER["check"], dev) for dev in ("cuda", "cpu")}
    for name, (fn, limit) in runs.items():
        out, stats = {}, {}
        for dev, (bg, lin, pos0) in fields.items():
            stats[dev] = {}
            with torch.no_grad():
                out[dev] = fn(bg, lin, pos0, stats[dev])
        (pc, vc), (pr, vr) = out["cuda"], out["cpu"]
        dpos = float((pc.cpu() - pr).abs().max())
        dvel = float((vc.cpu() - vr).abs().max() / vr.abs().max())
        # lpt_fpm returns the displacement, the integrators the positions
        disp = pr if name == "lpt_fpm" else pr[-1] - fields["cpu"][2]
        log(f"# 5m 32^3 {name}: card vs CPU max |d pos| {dpos:.3e} cells (limit {limit:g}), "
            f"max |d vel| / max |vel| {dvel:.3e}, max displacement "
            f"{float(disp.abs().max()):.3f} cells"
            + (f"; steps card {stats['cuda']}, CPU {stats['cpu']}" if stats["cpu"] else ""))
        assert torch.isfinite(pc).all() and dpos <= limit, f"5m: {name} on the card disagrees"


def remainder_128():
    """5m (b): Tsit5 (tol 1e-4) from a = 0.05 to 0.5 against RK4 with 64
    steps (and RK4 64 against 128) at 128^3, 2,097,152 particles, timed,
    with ms per force evaluation and K1/K4 launches per force evaluation;
    held: the Tsit5 / RK4(64) difference in Tsit5's own error norm (each
    position's over tol (1 + |pos|), RMS over the particles) at most the
    number of accepted steps (each step's estimate is within 1), and
    RK4(64) against RK4(128) within 2e-3 cells; the max, 99.9th percentile
    and RMS in cells printed.  Then a value+grad through Tsit5 (tol 1e-2,
    24 attempts at most, in the white field), finite, timed (a warm-up,
    then 2), with its launches and peak memory, and one more profiled."""
    from montecosmo_tpu_torch.models.bricks import white2lin
    from montecosmo_tpu_torch.ops import paint as P, pm
    from montecosmo_tpu_torch.ops.hermitian import rg2cgh

    bg, lin, pos0 = remainder_field(REMAINDER["final"], "cuda")
    with torch.no_grad():  # warm-up: cuFFT plans and the kernels' first launches at 128^3
        pm.nbody_tsit5(bg, lin, pos0, 0.05, 0.5, REMAINDER["tsit5_tol"])
    out, times, per = {}, {}, {}
    for name in ("tsit5", *REMAINDER["fine_rk4"]):
        P.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = {}
        with torch.no_grad():
            if name == "tsit5":
                out[name] = pm.nbody_tsit5(bg, lin, pos0, 0.05, 0.5, REMAINDER["fine_tol"],
                                           stats=stats)
                evals = stats["force_evaluations"]
            else:
                out[name] = pm.nbody_rk4(bg, lin, pos0, 0.05, 0.5, name)
                evals = 4 * name
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0)
        per[name] = {k: v / evals for k, v in _launched().items() if v}
        log(f"# 5m 128^3 {'Tsit5 tol %g' % REMAINDER['fine_tol'] if name == 'tsit5' else 'RK4 %d' % name}"
            f": {times[name]:.3f} ms, {evals} force evaluations, {times[name] / evals:.3f} ms "
            f"each; launches per force evaluation {per[name]}" + (f"; steps {stats}" if stats else ""))
        if name == "tsit5":
            t5_stats, t5_launches = stats, dict(P.LAUNCHES)
    fine, finer = REMAINDER["fine_rk4"]
    (pa, va), (pr, vr), (pr2, _) = out["tsit5"], out[fine], out[finer]
    d = (pa[-1] - pr[-1]).abs()
    norm = float(((d / (REMAINDER["fine_tol"] * (1 + torch.maximum(pa[-1].abs(), pr[-1].abs()))))
                  ** 2).mean().sqrt())
    sub = d.flatten()[::7]
    log(f"# 5m 128^3 Tsit5 vs RK4 {fine}: |d pos| max {float(d.max()):.4e}, 99.9% "
        f"{float(torch.quantile(sub[:2**24], 0.999)):.4e}, RMS {float(d.pow(2).mean().sqrt()):.4e} "
        f"cells; in Tsit5's error norm {norm:.4f} (limit {t5_stats['accepted']}: its accepted "
        f"steps, each within 1); |d vel| max "
        f"{float((va[-1] - vr[-1]).abs().max()):.4e}; RK4 {fine} vs {finer}: max "
        f"{float((pr[-1] - pr2[-1]).abs().max()):.4e} cells (limit 2e-3); max |pos - lattice| "
        f"{float((pr[-1] - pos0).abs().max()):.3f} cells")
    assert norm <= t5_stats["accepted"], "5m: Tsit5 strays from RK4 past its own tolerance"
    assert float((pr[-1] - pr2[-1]).abs().max()) <= 2e-3, "5m: RK4 with 64 steps is not converged"
    del out, pa, va, pr, vr, pr2, d, sub

    shape, box = (REMAINDER["final"],) * 3, (1000.0,) * 3
    x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda", requires_grad=True)
    stats = {}

    def value_and_grad():
        stats.clear()
        white = rg2cgh(x) * float(np.prod(np.divide(shape, box)) ** 0.5)  # as white_noise
        pos, _ = pm.nbody_tsit5(bg, white2lin(bg.cosmo, white, shape, box), pos0, 0.05, 0.5,
                                REMAINDER["grad_tol"], max_steps=REMAINDER["grad_max_steps"],
                                stats=stats)
        loss = torch.sin(pos[-1]).sum()
        return loss, torch.autograd.grad(loss, x)[0]

    walls = []
    for i in range(3):  # the first a warm-up
        P.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = value_and_grad()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    grad_ms = float(np.median(walls[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    grad_launches = _launched()
    k8 = P.LAUNCHES.get(("background_tables", "background", 0), 0)
    k9 = sum(n for (k, _, _), n in P.LAUNCHES.items() if k == "segment_sum")
    log(f"# 5m 128^3 value+grad through Tsit5 (tol {REMAINDER['grad_tol']}, "
        f"{REMAINDER['grad_max_steps']} attempts at most): ms {[round(w, 3) for w in walls]} "
        f"(first: warm-up), steps {stats}, loss {loss.item():.6e}, |grad| max "
        f"{float(g.abs().max()):.4e}, peak {peak:.2f} GiB; launches {grad_launches}, K8 {k8}, "
        f"K9 {k9}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        value_and_grad()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    log(f"# 5m the value+grad profiled: device busy "
        f"{sum(e.self_device_time_total for e in kernels) / 1e3:.3f} ms, "
        f"{sum(e.count for e in kernels)} device kernels")
    log(events.table(sort_by="self_cpu_time_total", row_limit=12))
    log(events.table(sort_by="self_cuda_time_total", row_limit=12))
    assert torch.isfinite(loss) and torch.isfinite(g).all() and float(g.abs().max()) > 0, \
        "5m: the gradient through Tsit5 is not finite"
    assert grad_launches["paint_cic_adjoint"] and grad_launches["read_cic_adjoint"], \
        "5m: the gradient through Tsit5 did not launch K2 and K5"
    return {"tsit5_per_force_evaluation": per["tsit5"],
            "tsit5_per_accepted_step": {
                k: t5_launches.get((k, "bspline", 2), 0) / t5_stats["accepted"]
                for k in REMAINDER_KERNELS if t5_launches.get((k, "bspline", 2))},
            "rk4_per_force_evaluation": per[fine],
            "tsit5_value_and_grad": grad_launches, "tsit5_value_and_grad_ms": grad_ms,
            "tsit5_value_and_grad_peak_gib": peak,
            "ms_per_force_evaluation": {"tsit5": times["tsit5"] / t5_stats["force_evaluations"],
                                        f"rk4_{fine}": times[fine] / (4 * fine)},
            "tsit5_steps": t5_stats, "k8_value_and_grad": k8, "k9_value_and_grad": k9}


def remainder_report():
    """5m (c): `python -m montecosmo_tpu_torch.accuracy --final 128` in a
    subprocess (section 3 at 32^3), its exit code asserted, its lines
    printed; returns its kernel launches."""
    cmd = [sys.executable, "-m", "montecosmo_tpu_torch.accuracy", "--final",
           str(REMAINDER["final"]), "--f64-final", str(REMAINDER["report_f64"])]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        log(f"# 5m report | {line}")
    log(f"# 5m report: exit code {r.returncode}, {wall:.2f} s wall")
    assert r.returncode == 0, f"5m: the accuracy report failed: {r.stderr[-2000:]}"
    launches = json.loads(r.stdout.split("# kernel launches ")[-1].splitlines()[0])
    return {"launches": launches, "wall_s": wall}


def remainder_register(tmp):
    """5m (d): the verify drive on the port: `register synthetic` at the
    128^3 cell budget from a 256^3-particle 2LPT mock in a 2000 Mpc/h box
    (count conservation within 1e-4, ms, K1/K3 launches), the model of that
    register (FieldLevelModel(register=...)): one value+grad timed; then
    the SKILL drive's campaign on a 512-cell synthetic register (Kaiser,
    --self-data, 2 chains, 64 + 64 warmup steps, 2 runs of 4 samples thinned
    by 2), every run's logdensity finite."""
    from montecosmo_tpu_torch import register
    from montecosmo_tpu_torch.infer import build_model, infer, obs_names_of
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.utils.io import npload

    P.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = register.main(["synthetic", "--cell-budget", str(REMAINDER["final"] ** 3), "--n-ptcl",
                          str(REMAINDER["register_ptcl"]), "--box-size",
                          str(REMAINDER["register_box"]), "--out", str(tmp)])
    torch.cuda.synchronize()
    reg_ms = 1e3 * (time.perf_counter() - t0)
    k1 = sum(n for (k, w, o), n in P.LAUNCHES.items() if k.startswith("paint_cic") and o == 2
             and k != "paint_cic_adjoint")
    k3 = P.LAUNCHES.get(("nufft_epilogue", "bspline", 2), 0)
    k4 = P.LAUNCHES.get(("read_cic", "bspline", 1), 0)
    reg = npload(path)
    n = REMAINDER["register_ptcl"] ** 3
    total = float(np.sum(reg["count_mesh"], dtype=np.float64))
    log(f"# 5m register synthetic ({n} particles, box {REMAINDER['register_box']:g} Mpc/h, "
        f"cell budget {REMAINDER['final']}^3): final {reg['count_mesh'].shape}, {reg_ms:.3f} ms, "
        f"K1 {k1}, K3 {k3}, K4 (NGP, the mock's reads) {k4}; count_mesh.sum() {total:.3f} "
        f"against {n}; launches {dict(P.LAUNCHES)}")
    assert k1 >= 1 and k3 >= 1, "5m: the register did not go through K1 and K3"
    np.testing.assert_allclose(total, n, rtol=1e-4)

    m = build_model(path)
    p = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    p["white_mesh_"] = torch.randn(m.init_shape, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    obs = m.obs_data()
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = m.logpdf({**leaves, **obs})
        grads = torch.autograd.grad(lp, list(leaves.values()))
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    log(f"# 5m the register's model (final {m.final_shape}, evolution {m.evolution}): logpdf "
        f"{lp.item():.6e}, value+grad ms {[round(w, 3) for w in walls]} (first: warm-up)")
    assert torch.isfinite(lp) and all(bool(torch.isfinite(g).all()) for g in grads), \
        "5m: the register's model value+grad is not finite"
    del m, leaves, obs, grads, reg

    small = register.main(["synthetic", *SMOKE_REGISTER, "--out", str(tmp / "smoke")])
    t0 = time.perf_counter()
    # the CLI's observed sites (its default --obs), so that obs.npz holds the
    # counts that 5n's analysis reads
    save_dir, _ = infer(small, save_root=str(tmp / "results"), device="cuda",
                        obs_names=obs_names_of(None, "quad_gauss", None), **SMOKE_CAMPAIGN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = (save_dir / "run.out").read_text()
    assert "logpdf of fiduc: " in out, "5m: the campaign did not log the fiducial logpdf"
    fid = out.split("logpdf of fiduc: ")[1].split()[0]
    lps = [npload(save_dir / "chains" / f"run_{i}.npz")["logdensity"] for i in (1, 2)]
    log(f"# 5m SKILL drive: register {small.name}, campaign {wall:.2f} s, logpdf of fiduc {fid}, "
        f"runs' logdensity {[np.round(lp.ravel(), 3).tolist() for lp in lps]}")
    assert np.isfinite(float(fid)) and all(np.isfinite(lp).all() for lp in lps), \
        "5m: the SKILL drive's campaign is not finite"
    return {"register_ms": reg_ms, "launches_register": {"paint_cic": k1, "nufft_epilogue": k3},
            "campaign_s": wall, "save_dir": save_dir}


def phase_nbody_remainder(tmp):
    """5m: the N-body remainder (scale-factor-time integrators, the accuracy
    report, the register CLI) on the card, its files under `tmp`.  Returns
    (the CIC rows' launches on this path by kernel, 5m (b)'s measurements,
    the report's, the SKILL campaign's save dir)."""
    t0 = time.perf_counter()
    remainder_32()
    log(f"# 5m (a) done in {time.perf_counter() - t0:.1f} s")
    big = remainder_128()
    log(f"# 5m (b) done in {time.perf_counter() - t0:.1f} s")
    report = remainder_report()
    log(f"# 5m (c) done in {time.perf_counter() - t0:.1f} s")
    reg = remainder_register(Path(tmp))
    log(f"# 5m (d) done in {time.perf_counter() - t0:.1f} s")
    rows = {k: {"design": f"per-particle ({CSRC}paint_cic.cu): this path is unclamped",
                "tsit5_128_per_force_evaluation": big["tsit5_per_force_evaluation"].get(k, 0),
                "tsit5_128_per_accepted_step": big["tsit5_per_accepted_step"].get(k, 0),
                "rk4_128_per_force_evaluation": big["rk4_per_force_evaluation"].get(k, 0),
                "tsit5_128_value_and_grad": big["tsit5_value_and_grad"].get(k, 0),
                "accuracy_report_128": report["launches"].get(f"{k}/bspline/2", 0)}
            for k in REMAINDER_KERNELS}
    rows["paint_cic"]["register_synthetic_128"] = reg["launches_register"]["paint_cic"]
    return rows, big, report, reg["save_dir"]


# ---------------------------------------------------------------- phase 5n
# the analysis layer: the bispectrum (K10), bdec, make_logdf_mesh and
# compare_chains on the campaign 5m leaves.  K10_TOL: max |K10 - plain| over
# each triple's float64 sum of |products| (both sum float64 products, in
# another order)
K10_TOL = 1e-9
BISPECTRUM_TOL = 1e-4  # card B against CPU B over max |B| (tests/test_torch_bispectrum.py)
K10_NAMES = (("bispectrum_sums", "partials", 0), ("bispectrum_sums", "reduce", 0))


def local_quadratic(n, seed, device="cuda"):
    """tests/test_bispectrum.py's local-quadratic field (fnl 0.05) at n^3,
    drawn on the CPU from a seeded generator."""
    g = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(seed))
    return (g + 0.05 * (g**2 - (g**2).mean())).to(device)


def k10_inputs(n, box):
    """(F, U, triples (T, 3) int32, bins) of the bispectrum of the
    local-quadratic field at n^3 on the card (the default kedges), as
    metrics.bispectrum forms them."""
    from montecosmo_tpu_torch import metrics as M

    F, U, tri, plan = M._bispectrum_inputs(local_quadratic(n, n), (box,) * 3)
    return F, U, tri, plan["nb"]


def k10_bound(F, tri):
    """(bound ms, bound_by): each field read once, the triples read, the
    (T, 2) float64 sums written; 4 T + 2 P operations a cell: a triple's
    F_l and U_l each one FMA (2 operations) onto the pair products F_i F_j
    and U_i U_j, which cost one multiplication each for every one of the P
    distinct pairs (i, j).  The sums are float64, on the FP64 tensor
    cores, whose rate on an H100 SXM (67 TFLOP/s) equals the float32 rate
    that `bound` takes."""
    bins, n = F.shape
    t = tri.shape[0]
    pairs = len(set(map(tuple, tri[:, :2].tolist())))
    return bound(2 * bins * n * 4 + t * 12 + t * 16, float(n) * (4 * t + 2 * pairs))


def library_triples(F, U, tri):
    """The dense library form of the same sums: for every l, the FP32 GEMM
    (X * X_l) X^T of all B^2 ordered pairs (TF32 off), read at the triples."""
    out = []
    for X in (F, U):
        full = torch.stack([(X * X[l]) @ X.T for l in range(X.shape[0])], -1)
        out.append(full[tri[:, 0].long(), tri[:, 1].long(), tri[:, 2].long()])
    return torch.stack(out, -1)


def check_k10(n, box, tag, reps, sample=None):
    """K10 at n^3 (the default kedges) against its plain version: within
    K10_TOL of each triple's sum of |products| (on `sample` triples drawn
    from a seed when given), two launches bit for bit; K10, the plain
    version (on the same triples) and the library GEMM timed with CUDA
    events.  Returns the row's numbers."""
    from montecosmo_tpu_torch.ops import bispectrum as BS

    F, U, tri, bins = k10_inputs(n, box)
    t = tri.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = BS.bispectrum_plan(tri.cpu().numpy(), bins, n ** 3, sms)
    # the MMAs the plan issues: a block's FMAs a cell, F and U, each strip's l's
    mma_flops = 2 * 2 * BS.BLOCK[0] * BS.BLOCK[1] * int(plan["strips"][:, 3].sum()) * n ** 3
    out = BS.bispectrum_triples_kernel(F, U, tri)
    again = BS.bispectrum_triples_kernel(F, U, tri)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"5n {tag}: two K10 launches differ"
    rows = torch.arange(t, device="cuda")
    if sample is not None:
        rows = torch.sort(torch.randperm(t, generator=torch.Generator().manual_seed(5))[
            :sample]).values.to("cuda")
    pick, out_pick = tri[rows], out[rows]
    plain = lambda: BS.bispectrum_triples_plain(F, U, pick)
    ref, mag = BS.bispectrum_triples_plain(F, U, pick, with_abs=True)
    err = float(((out_pick - ref).abs() / mag.clamp(min=1e-300)).max())
    abs_err = float((out_pick - ref).abs().max())
    ms = cuda_ms(lambda: BS.bispectrum_triples_kernel(F, U, tri), reps, 1)
    plain_ms = cuda_ms(plain, 1, 1)
    lib_reps = 1 if n > 128 else 3
    lib = library_triples(F, U, tri)
    lib_err = float(((lib.double() - out).abs() / (out.abs().max(0).values)).max())
    library_ms = cuda_ms(lambda: library_triples(F, U, tri), lib_reps, 1)
    bms, by = k10_bound(F, tri)
    log(f"# 5n (a) K10 {tag}: B = {bins}, T = {t}, N = {n}^3; max |K10 - plain| {abs_err:.3e} = "
        f"{err:.3e} of the triples' sum of |products| (tol {K10_TOL:g}; "
        f"{pick.shape[0]} triples held){' ' if sample is None else ' drawn from seed 5; '}"
        f"bit for bit twice; K10 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms ({pick.shape[0]} triples), library GEMM {library_ms:.4f} ms (FP32, "
        f"TF32 off; its float32 sums {lib_err:.2e} of the largest off K10); bound {bms:.4f} ms "
        f"({by}, FP64 tensor-core rate), {ms / bms:.2f}x; plan: {len(plan['rows'])} strips "
        f"in {plan['ny']} CTA rows x {plan['nx']} cell ranges of {plan['per']} cells, tiles of "
        f"{plan['tile']}; the MMAs' {mma_flops:.3e} FP64 operations at "
        f"{mma_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    assert err <= K10_TOL, f"5n {tag}: K10 off its plain version by {err:.3e}"
    del F, U
    return {"B": bins, "T": t, "max_abs_err": abs_err, "max_rel_err_of_abs_sum": err, "ms": ms,
            "plain_ms": plain_ms, "strips": len(plan["rows"]), "mma_tflops": mma_flops / ms / 1e9,
            "plain_triples": int(pick.shape[0]), "library_ms": library_ms, "bound_ms": bms,
            "bound_by": by}


def _figure_lines(lines):
    return [" ".join(map(str, a)) for a in lines if "skipped" in " ".join(map(str, a))]


def bdec_card_vs_cpu(x, w):
    """max |card - CPU| of bdec.qbci and sci at the 68% and 95% levels
    over the draws x (n, ...) weighted by w (n or x's shape), and how many
    columns of x differ by more than 1e-6."""
    from montecosmo_tpu_torch import bdec

    out = {}
    for k in ("qbci", "sci"):
        fn = getattr(bdec, k)
        d = (fn(torch.as_tensor(x, device="cuda"), [0.68, 0.95], 0,
                torch.as_tensor(w, device="cuda")).cpu()
             - fn(torch.as_tensor(x), [0.68, 0.95], 0, torch.as_tensor(w))).abs()
        out[k] = (float(d.max()), int((d.reshape(2, -1, 2).amax((0, 2)) > 1e-6).sum()))
    return out


def bdec_witness(sets=4096):
    """bdec card against CPU on `sets` seeded sets of 16 and of 64 normal
    draws whose weights exp(-span u), u uniform, spread as a campaign's
    density weights do (1e-16..1 at span 37; spans 10, 37, 80), in float64
    and in float32: by dtype, the largest difference and the sets off by
    more than 1e-6 summed over the cases."""
    out = {}
    for draws in (16, 64):
        for span in (10.0, 37.0, 80.0):
            rng = np.random.default_rng(11)
            x = rng.standard_normal((draws, sets))
            w = np.exp(-span * rng.uniform(size=(draws, sets)))
            for dt in (np.float64, np.float32):
                for err, off in bdec_card_vs_cpu(x.astype(dt), w.astype(dt)).values():
                    e, o = out.get(dt.__name__, (0.0, 0))
                    out[dt.__name__] = (max(e, err), o + off)
    return out


def phase_analysis(survey_dir, skill_dir):
    """5n: the analysis layer.  (a) K10 against its plain version at 32^3
    and 128^3 (and at 256^3 on 64 triples); (b) metrics.bispectrum card
    against CPU at 32^3; the main path: metrics.bispectrum of a 128^3
    field through K10, its launches counted from 0; (c) on the chains of
    5l's registered-survey campaign in `survey_dir`: make_logdf_mesh on
    the card (K1, K3, K8 and K9 counted from 0; the last sample of run 1
    of each chain, card against CPU within 1e-4 of the largest entry over
    the cells whose selection is at least EDGE of its mean, as 5l holds
    them, that edge at most MAX_EDGE of the footprint); on 5m's SKILL
    campaign in `skill_dir` make_logdf_mesh, run 1's samples card against
    CPU within 1e-4 over every cell; compare_chains on each; on 5m's
    chains bdec.qbci and sci card against CPU within 1e-6 with integer weights
    and with the draws' density weights in float64 and in float32, and
    `bdec_witness` in both, every set within 1e-6; (d) the figures skipped
    for want of matplotlib."""
    from montecosmo_tpu_torch import FieldLevelModel, metrics as M, script
    from montecosmo_tpu_torch.chains import Chains
    from montecosmo_tpu_torch.ops import paint as P

    t0 = time.perf_counter()
    rows = {"32": check_k10(32, 64.0, "32^3", 10), "128": check_k10(128, 1000.0, "128^3", 5)}
    rows["256"] = check_k10(256, 2000.0, "256^3", 1, sample=64)
    torch.cuda.empty_cache()
    log(f"# 5n (a) done in {time.perf_counter() - t0:.1f} s")

    field = local_quadratic(32, 3)
    kc, tc, bc, cc = M.bispectrum(field, box_size=(64.0,) * 3)
    kh, th, bh, ch = M.bispectrum(field.cpu(), box_size=(64.0,) * 3)
    bc, bh = bc.cpu().numpy(), bh.numpy()
    b_err = float(np.abs(bc - bh).max() / np.abs(bh).max())
    log(f"# 5n (b) bispectrum 32^3 card vs CPU: {len(tc)} triples, the same triples "
        f"{np.array_equal(tc, th)}, gate {np.array_equal(bc != 0, bh != 0)}, max |dB| / max |B| "
        f"{b_err:.3e} (tol {BISPECTRUM_TOL:g})")
    assert np.array_equal(tc, th) and np.array_equal(cc, ch) and np.allclose(kc, kh)
    assert np.array_equal(bc != 0, bh != 0) and b_err <= BISPECTRUM_TOL, "5n (b): card B off CPU"

    # the main path: a user's bispectrum of the flagship's 128^3 final mesh
    field = local_quadratic(128, 4)
    P.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kmean, tri, bs, _ = M.bispectrum(field, box_size=(1000.0,) * 3)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t1)
    main_launches = {k: P.LAUNCHES.get(k, 0) for k in K10_NAMES}
    log(f"# 5n main path: metrics.bispectrum at 128^3 ({len(tri)} triples) {wall:.3f} ms wall "
        f"(first call), B finite {bool(torch.isfinite(bs).all())}, nonzero "
        f"{int((bs != 0).sum())}; K10 launches {main_launches}")
    assert all(main_launches.values()), "5n: the bispectrum did not go through K10"
    assert bool(torch.isfinite(bs).all()) and bs.shape == (len(tri),)
    del field

    lines = []
    collect = lambda *a: lines.append(a)
    P.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lpdf, lcdf = script.make_logdf_mesh(survey_dir, device="cuda", log=collect)
    torch.cuda.synchronize()
    logdf_s = time.perf_counter() - t1
    logdf_launches = {f"{k}/{w}/{o}": v for (k, w, o), v in P.LAUNCHES.items()}
    # K1 in either design
    made = {k: sum(v for (kk, _, _), v in P.LAUNCHES.items() if kk in (k, k + "_tiled"))
            for k in ("paint_cic", "nufft_epilogue", "background_tables", "segment_sum")}
    t1 = time.perf_counter()
    # run 1 thinned to its last sample: 2 forwards on the CPU
    lpdf_cpu, lcdf_cpu = script.make_logdf_mesh(
        survey_dir, start=1, end=1, thinning=CAMPAIGN["n_samples"], prefix="cpu_",
        device="cpu", log=lambda *a: None)
    cpu_s = time.perf_counter() - t1
    last = CAMPAIGN["n_samples"] - 1
    # the cells are held as 5l holds them: those whose selection is at
    # least EDGE of its mean (the masked cells, in logdf_mesh's order)
    selec = FieldLevelModel.load(Path(survey_dir) / "model.yaml",
                                 device="cpu")._selec_final.abs().numpy()
    inner = selec >= EDGE * selec.mean()
    share_edge = 1 - inner.mean()
    errs = {}
    for name, a, b in (("logpdf", lpdf, lpdf_cpu), ("logcdf", lcdf, lcdf_cpu)):
        a, b = a[:, last].astype(np.float64), b[:, 0].astype(np.float64)
        d = np.abs(a - b)
        errs[name] = {"inner": float(d[:, inner].max() / np.abs(b[:, inner]).max()),
                      "every": float(d.max() / np.abs(b).max()),
                      "edge_share_of_difference": float(d[:, ~inner].sum() / max(d.sum(), 1e-300)),
                      "sum": float(np.abs(a.sum() - b.sum()) / abs(b.sum()))}
    log(f"# 5n (c) make_logdf_mesh on 5l's campaign on the card: shape {lpdf.shape}, "
        f"{logdf_s:.2f} s ({lpdf.shape[0] * lpdf.shape[1]} forwards), finite "
        f"{bool(np.isfinite(lpdf).all() and np.isfinite(lcdf).all())}; samples (c, {last}) "
        f"card vs CPU, max |difference| / max |value| over the {int(inner.sum())} cells whose "
        f"selection is at least {EDGE} of its mean (tol 1e-4), over every cell, the other "
        f"{int((~inner).sum())} cells' ({share_edge:.4f} of the footprint, limit {MAX_EDGE}) "
        f"share of the difference, and the sums' relative difference: {errs} (the CPU's 2 "
        f"forwards {cpu_s:.2f} s); launches {logdf_launches}")
    assert np.isfinite(lpdf).all() and np.isfinite(lcdf).all()
    assert lpdf.shape == lcdf.shape and lpdf.shape[:2] == (
        CAMPAIGN["n_chains"], 3 * CAMPAIGN["n_samples"]) and lpdf.shape[2:] == selec.shape
    assert share_edge <= MAX_EDGE, "5n (c): the footprint's edge is more of it than MAX_EDGE"
    assert max(e["inner"] for e in errs.values()) <= 1e-4, \
        "5n (c): the logpdf mesh on the card is off the CPU's"
    assert all(made[k] for k in ("paint_cic", "nufft_epilogue", "background_tables")), \
        f"5n (c): make_logdf_mesh's forwards did not go through K1, K3 and K8: {made}"
    # 5m's SKILL campaign (8^3 Kaiser, no mask): run 1's samples over every cell
    skill = script.make_logdf_mesh(skill_dir, device="cuda", log=collect)
    skill_cpu = script.make_logdf_mesh(skill_dir, start=1, end=1, prefix="cpu_", device="cpu",
                                       log=lambda *a: None)
    n1 = skill_cpu[0].shape[1]
    skill_err = max(float(np.abs(a[:, :n1] - b).max() / np.abs(b).max())
                    for a, b in zip(skill, skill_cpu))
    log(f"# 5n (c) make_logdf_mesh on 5m's campaign: shape {skill[0].shape}; run 1's samples "
        f"card vs CPU {skill_err:.3e} of the largest over every cell (tol 1e-4)")
    assert all(np.isfinite(m).all() for m in skill) and skill_err <= 1e-4, \
        "5n (c): the logpdf mesh of 5m's campaign on the card is off the CPU's"
    t1 = time.perf_counter()
    for d in (survey_dir, skill_dir):
        kpow_ref, kptcs = script.compare_chains([d, d], ["a", "b"], d, device="cuda",
                                                log=collect)
        assert np.isfinite(kpow_ref[1]).all() and all(np.isfinite(v[1]).all()
                                                      for v in kptcs.values())
    log(f"# 5n (c) compare_chains on 5l's and 5m's campaigns: {time.perf_counter() - t1:.2f} s, "
        f"kptc of {sorted(kptcs)}")

    chains = Chains.load(Path(skill_dir) / "chains" / "chains.npz")
    names = [k for k, v in chains.data.items()
             if np.ndim(v) == 2 and k not in ("n_evals", "logdensity")]
    x = np.stack([np.asarray(chains.data[k], np.float64).reshape(-1) for k in names], -1)
    lp = np.asarray(chains.data["logdensity"], np.float64).reshape(-1)
    dens = np.exp(lp - lp.max())
    # integer weights 1, 2, 3, ...: float32 cumulative sums exact on both devices
    ints = (1 + np.arange(x.shape[0]) % 3).astype(np.float32)
    bd_err = bdec_card_vs_cpu(x.astype(np.float32), ints)
    bd64 = bdec_card_vs_cpu(x, dens)
    bd32 = bdec_card_vs_cpu(x.astype(np.float32), dens.astype(np.float32))
    witness = bdec_witness()
    log(f"# 5n (c) bdec on 5m's chains ({x.shape[0]} draws of {names}): card vs CPU (max, "
        f"columns off by more than 1e-6), integer weights float32 {bd_err} (tol 1e-6); density "
        f"weights (exp(logdensity - max), {dens.min():.3e}..1) float64 {bd64}, float32 {bd32} "
        f"(tol 1e-6, no column off); 4096 seeded sets of 16 and of 64 draws weighted exp(-span "
        f"u), spans 10, 37, 80 (max, sets off summed over the 6 cases): {witness} (tol 1e-6, no "
        f"set off)")
    out = (Path(survey_dir) / "run.out").read_text().splitlines() + (
        Path(skill_dir) / "run.out").read_text().splitlines()
    skipped = _figure_lines(lines) + [ln for ln in out if "skipped" in ln]
    log(f"# 5n (d) figures skipped for want of matplotlib ({len(skipped)}): {skipped}")
    assert max(e for e, _ in bd_err.values()) <= 1e-6, "5n (c): bdec on the card is off the CPU's"
    held = [*bd64.values(), *bd32.values(), *witness.values()]
    assert max(e for e, _ in held) <= 1e-6 and not any(o for _, o in held), \
        f"5n (c): bdec on the card is off the CPU's (float64 {bd64}, float32 {bd32}, {witness})"
    log(f"# 5n done in {time.perf_counter() - t0:.1f} s")
    return rows, main_launches


def _rhat(x):
    from montecosmo_tpu_torch.metrics import gelman_rubin

    x = np.asarray(x, np.float64)
    x = x.reshape(x.shape[0], x.shape[1], -1).mean(-1)
    return gelman_rubin(x)


LIKELIHOODS = ("poisson", "fourier_gauss", "two_quad_gauss", "shash", "powspec")


def phase_likelihoods():
    """5i: the other likelihoods at the Kaiser flat-sky flagship: lik_type
    poisson, fourier_gauss, two_quad_gauss and shash, then
    observable='powspec' with poles (0, 2, 4); each a `predict` draw, the
    model conditioned on it, 1 warm-up and 3 timed value+grads, finite,
    with the peak memory and K8/K9 launches; powspec must launch K9's
    forward (the spectrum's binning).  Returns {likelihood: median ms}."""
    from montecosmo_tpu_torch.ops import paint as P

    out = {}
    for lik in LIKELIHOODS:
        upd = dict(observable="powspec", poles=(0, 2, 4)) if lik == "powspec" else dict(
            lik_type=lik)
        t0 = time.perf_counter()
        m = bench_model(evolution="kaiser", **upd)
        site = "powspec" if lik == "powspec" else "count_mesh"
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
        params["white_mesh_"] = torch.randn(m.init_shape, generator=gen, device="cuda")
        obs = m.predict(seed=gen, samples=params, hide_samp=False)[site]
        assert bool(torch.isfinite(obs).all()), f"5i {lik}: non-finite draw"
        m.substitute({site: obs})
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        set_up = time.perf_counter() - t0

        def value_and_grad():
            for v in leaves.values():
                v.grad = None
            lp = m.logpdf(leaves)
            lp.backward()
            return lp

        P.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        value_and_grad()
        times, values = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            values.append(value_and_grad().item())
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        k8, k9 = P.LAUNCHES["background_tables", "background", 0], k9_launches()
        ok = np.all(np.isfinite(values)) and all(bool(torch.isfinite(v.grad).all())
                                                 for v in leaves.values())
        log(f"# 5i Kaiser flat-sky flagship, {lik} ({site} {tuple(obs.shape)}, set-up "
            f"{set_up:.2f} s): ms/eval {[round(t, 3) for t in times]} median "
            f"{np.median(times):.3f}; logpdf {values}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches in 4 evals: K8 {k8}, "
            f"K9 {k9}")
        assert ok, f"5i {lik}: non-finite logpdf or gradient"
        assert k8 == 4 and k9.get("take_rows", 0) >= 4, f"5i {lik}: K8/K9 launches {k8} {k9}"
        if lik == "powspec":
            assert k9.get("segment_sum", 0) >= 4, "5i powspec: K9's forward never launched"
        out[lik] = float(np.median(times))
        del m, leaves, obs
    return out


# ---------------------------------------------------------------- phase 5e
SAMPLER_STEPS = {"field warmup": 4, "full warmup": 4, "run": (2, 2), "mams": (1, 1, 4)}


def _finite_state(state, what):
    ok = all(bool(torch.isfinite(v).all()) for v in state.position.values()) and all(
        bool(torch.isfinite(v).all()) for v in state.logdensity_grad.values()) and bool(
        torch.isfinite(state.logdensity))
    assert ok, f"{what}: non-finite position, logdensity or gradient"


def phase_sampler(per_eval):
    """Phase 5e: the field-level MCLMC loop of run/infer.py at the 2LPT
    flagship, I/O left out: the observation self-predicted at the fiducial,
    the logpdf recentred there; a field warmup (every other latent at the
    fiducial, start kaiser_post(scale_field=7/8)), a full warmup with a
    diagonal mass (start kaiser_post, the field warmup's white mesh), an
    MCLMC run, then MAMS (warmup and run) from the full warmup's state.
    Every McLachlan step is timed (synchronised); K1, K2 and K3 must launch
    `per_eval` (phase 5's launches per value+grad) times each value+grad.
    Then the same 2 McLachlan steps twice from one state and one seed, the
    largest position difference printed (the table gradients' atomics)."""
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.samplers import mclmc as S

    t0 = time.perf_counter()
    m = bench_model()
    gen = torch.Generator(device="cuda").manual_seed(0)
    truth = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    truth["white_mesh_"] = torch.randn(m.init_shape, generator=gen, device="cuda")
    m.count_mesh = m.predict(seed=gen, samples=truth, hide_samp=False)["count_mesh"]
    m.recenter_logpdf(truth | m.obs_data())
    torch.cuda.synchronize()
    log(f"# 5e sampler at the 2LPT flagship (d = {sum(v.numel() for v in truth.values())}); "
        f"set-up {time.perf_counter() - t0:.2f} s")

    evals, steps, phase = [0], [], ["field warmup"]

    def logdf(p):
        evals[0] += 1
        return m.logpdf(p)

    step = S._mclachlan_step

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        n, t = evals[0], time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        steps.append((phase[0], 1e3 * (time.perf_counter() - t), evals[0] - n))
        return out

    n_f, n_w, (n_s, thin), (n_mw, n_ms, max_steps) = SAMPLER_STEPS.values()
    made = {}
    S._mclachlan_step = timed_step
    P.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        def run(name, fn):
            phase[0], n = name, evals[0]
            out = fn()
            made[name] = evals[0] - n
            return out

        m.reset()
        m.substitute(m.fiduc | m.obs_data(), from_base=True)
        m.block()
        state_f, conf_f = run("field warmup", lambda: S.mclmc_warmup(
            gen, m.kaiser_post(gen, scale_field=7 / 8), logdf, n_steps=n_f,
            desired_energy_var=1e-5))
        _conditioned(m)
        state_w, conf_w = run("full warmup", lambda: S.mclmc_warmup(
            gen, m.kaiser_post(gen) | state_f.position, logdf, n_steps=n_w,
            desired_energy_var=1e-7, diagonal_preconditioning=True))
        state_r, samples = run("run", lambda: S.mclmc_run(gen, state_w, conf_w, logdf,
                                                          n_samples=n_s, thinning=thin))
        state_m, conf_m = run("mams warmup", lambda: S.mams_warmup(
            gen, state_w.position, logdf, n_steps=n_mw, config=conf_w, max_steps=max_steps))
        state_mr, samples_m = run("mams run", lambda: S.mams_run(
            gen, state_m, conf_m, logdf, n_samples=n_ms, max_steps=max_steps))
        torch.cuda.synchronize()
    finally:
        S._mclachlan_step = step
    launches = P.launches_at(2, "bspline")
    peak = torch.cuda.max_memory_allocated()

    for name, state in (("field warmup", state_f), ("full warmup", state_w), ("run", state_r),
                        ("mams warmup", state_m), ("mams run", state_mr)):
        _finite_state(state, name)
        ms = [round(t, 3) for ph, t, _ in steps if ph == name]
        per = [n for ph, _, n in steps if ph == name]
        log(f"# 5e {name}: {len(ms)} McLachlan steps, ms/step {ms} median "
            f"{np.median(ms) if ms else float('nan'):.3f}; value+grads per step {per}; "
            f"value+grads made {made[name]}; logdensity {state.logdensity.item():.6e}")
    for name, conf in (("field warmup", conf_f), ("full warmup", conf_w), ("mams warmup", conf_m)):
        invmm = conf.inverse_mass_matrix
        log(f"# 5e {name} config: step_size {conf.step_size.item():.6e} L {conf.L.item():.6e} "
            f"inverse mass mean {float(invmm.mean()):.6e} min {float(invmm.min()):.6e} max "
            f"{float(invmm.max()):.6e}")
    mse, n_ev = samples["mse_per_dim"].tolist(), samples["n_evals"].tolist()
    acc, n_ev_m = samples_m["acceptance_rate"].tolist(), samples_m["n_evals"].tolist()
    log(f"# 5e run: mse_per_dim {mse}, logdensity {samples['logdensity'].tolist()}, n_evals "
        f"{n_ev}; MAMS run: acceptance {acc}, n_evals {n_ev_m}; peak memory "
        f"{peak / 2**30:.3f} GiB")
    assert all(bool(torch.isfinite(v).all()) for v in samples.values())
    assert all(bool(torch.isfinite(v).all()) for v in samples_m.values())
    # n_evals as the JAX contract has it: 2 per McLachlan step, each
    # warmup's init one more, MAMS's 2 per step of its (random) trajectory
    assert made["field warmup"] == 1 + 2 * n_f and made["full warmup"] == 1 + 2 * n_w
    assert n_ev == [2.0 * thin] * n_s and made["run"] == sum(n_ev)
    assert 1 + 2 * n_mw <= made["mams warmup"] <= 1 + 2 * n_mw * max_steps
    assert made["mams run"] == sum(n_ev_m) and all(2 <= n <= 2 * max_steps for n in n_ev_m)
    assert all(n == 2 for _, _, n in steps)
    n_evals = sum(made.values())
    per_vg = {k: v / n_evals for k, v in launches.items()}
    log(f"# 5e launches in {n_evals} value+grads {launches}; per value+grad {per_vg} "
        f"(phase 5: {per_eval})")
    assert set(launches) == set(per_eval) and all(
        launches[k] == per_eval[k] * n_evals for k in per_eval), "5e: launches per value+grad"

    # the same 2 McLachlan steps twice, from one state and one seed
    kernel = S.mclmc_kernel(m.logpdf, conf_w.inverse_mass_matrix)
    ends = []
    for _ in range(2):
        g, state = torch.Generator(device="cuda").manual_seed(5), state_w
        for _ in range(2):
            state, _ = kernel(g, state, conf_w.L, conf_w.step_size)
        ends.append(state)
    diff = max(float((ends[0].position[k] - ends[1].position[k]).abs().max())
               for k in state_w.position)
    same = all(torch.equal(ends[0].position[k], ends[1].position[k]) for k in state_w.position)
    log(f"# 5e the same 2 McLachlan steps twice from one state and seed: largest position "
        f"difference {diff:.3e}, logdensities {ends[0].logdensity.item():.6e} / "
        f"{ends[1].logdensity.item():.6e}; every position equal bit for bit {same}")
    assert same and torch.equal(ends[0].logdensity, ends[1].logdensity), \
        "5e: two chains from one state and seed differ"
    return m, state_f


# ---------------------------------------------------------------- phase 5f
# the NUTS path's cuts at the flagship: warmup steps per block, doublings
# per transition, Gibbs sweeps, Hutchinson probes
NUTS_CUTS = {"warmup steps": 4, "max doublings": 3, "sweeps": 2, "probes": 4}
SECOND_ORDER = ("paint_cic_grad", "read_cic_hess")


def _timed_nuts(H, record, evals):
    """A drop-in for hmc.nuts_kernel whose transitions are synchronised and
    timed: each appends (ms, depth, integration steps, value+grads)."""
    nuts = H.nuts_kernel

    def factory(*args, **kwargs):
        kernel = nuts(*args, **kwargs)

        def timed(rng, state):
            torch.cuda.synchronize()
            n, t = evals[0], time.perf_counter()
            new, info = kernel(rng, state)
            torch.cuda.synchronize()
            record.append((1e3 * (time.perf_counter() - t), info["depth"],
                           info["num_integration_steps"], evals[0] - n))
            return new, info
        return timed
    return nuts, factory


def timed_hvp(tag, fn):
    """fn() (a Hessian-vector product) synchronised and timed, counted from
    0: (its output, ms, peak GiB, launches by (kernel, window, order))."""
    from montecosmo_tpu_torch.ops import paint as P

    P.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms, peak = 1e3 * (time.perf_counter() - t), torch.cuda.max_memory_allocated() / 2**30
    launches = dict(P.LAUNCHES)
    log(f"# 5f {tag}: {ms:.3f} ms, peak {peak:.3f} GiB, launches "
        f"{ {k[0]: v for k, v in launches.items()} }")
    return out, ms, peak, launches


def phase_nuts(m, state_f, per_eval):
    """Phase 5f: the NUTS path of run/infer.py --sampler nuts at the 2LPT
    flagship (5e's model and field-warmup state), I/O left out: the blocked
    NUTS full warmup (mesh_, rest_; bracketed step sizes, then window
    adaptation steps), one NUTS-within-Gibbs sweep; every transition timed
    with its tree depth and value+grads; finite states; n_evals as the JAX
    package counts them; K1, K2, K3 launched `per_eval` times a
    value+grad.  Then the second-order work at full width, each HVP timed
    with its peak memory and launches: the Laplace seed of {Omega_m_, b1_,
    sigma8_} at the Kaiser start (and the same Hessian with the RK4 tables
    fixed), the Hutchinson marginal covariance of those given
    white_mesh_, one HVP column of the N-body flagship in Omega_m_.
    Returns the K6/K7 launches of the HVPs and their rows' extras."""
    from montecosmo_tpu_torch import lapprox as L
    from montecosmo_tpu_torch import script as SC
    from montecosmo_tpu_torch.ops import paint as P
    from montecosmo_tpu_torch.samplers import hmc as H

    log(f"# 5f NUTS at the 2LPT flagship, cuts {NUTS_CUTS} (the mesh is not cut)")
    gen = torch.Generator(device="cuda").manual_seed(9)
    evals, record = [0], []
    logpdf = m.logpdf

    def counted(p):
        evals[0] += 1
        return logpdf(p)

    nuts, factory = _timed_nuts(H, record, evals)
    # a Laplace seed of rest_ (at most 64 dimensions; the flagship's has 97)
    # costs value+grads and double backwards outside n_evals
    seed_cost, laplace_seed = {"evals": 0, "launches": Counter()}, SC._laplace_seed

    def seed(*args):
        n, before = evals[0], Counter(P.LAUNCHES)
        out = laplace_seed(*args)
        seed_cost["evals"] += evals[0] - n
        seed_cost["launches"] += Counter(P.LAUNCHES) - before
        return out

    m.logpdf, H.nuts_kernel, SC._laplace_seed = counted, factory, seed
    P.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        field = H.HMCState({k: v[None] for k, v in state_f.position.items()}, None, None)
        state, config, n_evals = SC._nuts_full_warmup(
            m, {}, field, NUTS_CUTS["warmup steps"], 1, gen,
            max_num_doublings=NUTS_CUTS["max doublings"], log=lambda *a: log("#", *a))
        made_warm, n_warm = evals[0], len(record)
        step_fn, init_fn, _, _ = H.nutswg_init(m.logpdf, max_num_doublings=NUTS_CUTS["max doublings"])
        chain = {k: H.HMCState({kk: v[0] for kk, v in st.position.items()}, st.logdensity[0],
                               {kk: v[0] for kk, v in st.logdensity_grad.items()})
                 for k, st in state.items()}
        conf = {k: {kk: v[0] for kk, v in c.items()} for k, c in config.items()}
        last, (samples, infos) = H.sampling_loop_general(gen, chain, m.logpdf, step_fn, init_fn,
                                                         conf, NUTS_CUTS["sweeps"])
        torch.cuda.synchronize()
    finally:
        m.logpdf, H.nuts_kernel, SC._laplace_seed = logpdf, nuts, laplace_seed
    wall = time.perf_counter() - t0
    launches = {k: n for (k, w, o), n in (Counter(P.LAUNCHES) - seed_cost["launches"]).items()
                if (w, o) == ("bspline", 2)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    made = evals[0]
    for k, st in last.items():
        _finite_state(st, f"5f NUTS-within-Gibbs block {k}")
    for k, st in state.items():
        assert all(bool(torch.isfinite(v).all()) for v in st.position.values()), k
    log(f"# 5f NUTS warmup: {n_warm} transitions, value+grads made {made_warm}, n_evals "
        f"{n_evals} (+ {len(state)} carry inits, + {seed_cost['evals']} of a Laplace seed); config "
        f"{ {k: (float(c['step_size'][0]), tuple(c['inverse_mass_matrix'].shape)) for k, c in config.items()} }")
    for i, (ms, depth, n_int, n_ev) in enumerate(record):
        log(f"# 5f NUTS transition {i} ({'warmup' if i < n_warm else 'sweep'}): {ms:.3f} ms, "
            f"depth {depth}, integration steps {n_int}, value+grads {n_ev}")
    sweep_evals = int(infos["n_evals"].sum())
    log(f"# 5f sweep: n_evals {sweep_evals}, logdensity {infos['logdensity'].tolist()}; "
        f"all {made} value+grads in {wall:.2f} s, peak {peak:.3f} GiB; launches {launches}")
    assert all(n_int == n_ev for _, _, n_int, n_ev in record), "5f: value+grads per transition"
    assert made_warm == n_evals + len(state) + seed_cost["evals"], "5f: the warmup's n_evals"
    # each sweep re-initialises every block (one value+grad) before its step
    assert made - made_warm == sweep_evals + len(last) * NUTS_CUTS["sweeps"], \
        "5f: the sweeps' n_evals"
    made -= seed_cost["evals"]
    assert set(launches) == set(per_eval) and all(
        launches[k] == per_eval[k] * made for k in per_eval), "5f: launches per value+grad"

    # second order at full width: the Kaiser start of the full warmup
    p0 = m.kaiser_post(gen)
    keys = HESS_KEYS
    p_block = {k: p0[k] for k in keys}
    others = {k: v for k, v in p0.items() if k not in keys}
    (cov, w), ms_seed, peak_seed, l_seed = timed_hvp(
        "_laplace_seed of (Omega_m_, b1_, sigma8_) at the Kaiser start (3 HVP columns)",
        lambda: SC._laplace_seed(m.logpdf, p_block, others))
    log(f"# 5f Laplace seed: covariance {cov.tolist()}, curvatures {w.tolist()}")
    assert bool(torch.isfinite(cov).all()) and np.all(np.isfinite(w))
    # ROADMAP Queue C 4's witness: the seed again from the same inputs, equal
    # bit for bit (K6 adds fixed point, as K1 and K5 do)
    cov2, w2 = SC._laplace_seed(m.logpdf, p_block, others)
    same_seed = bool(torch.equal(cov, cov2)) and np.array_equal(np.asarray(w), np.asarray(w2))
    log(f"# 5f Laplace seed twice: equal bit for bit {same_seed} (max |difference| "
        f"{float((cov - cov2).abs().max()):.3e})")
    assert same_seed, "5f: two Laplace seeds from the same inputs differ"

    def fixed_hessian():
        with fixed_tables(m):
            return scalar_hessian(m, p0, {})

    hess_f, ms_fixed, _, _ = timed_hvp("the same Hessian (3 HVP columns), RK4 tables fixed",
                                       fixed_hessian)
    # K6's and K7's own inputs inside an HVP column of the flagship, each
    # design held and timed on them
    flagship_hess = flagship_inputs("2LPT HVP column", lambda: hvp_column(m.logpdf, p0, "Omega_m_"),
                                    "hess")
    log(f"# 5f Hessian, tables fixed {hess_f.tolist()} ({ms_fixed:.3f} ms against the seed's "
        f"{ms_seed:.3f} ms): the RK4 tables' share {1 - ms_fixed / ms_seed:.3f}")

    wm = others["white_mesh_"]
    rest = {k: v for k, v in others.items() if k != "white_mesh_"}

    def pot(x, y):
        return -m.logpdf({**rest, "white_mesh_": y.reshape(wm.shape),
                          **{k: x[i] for i, k in enumerate(keys)}})

    x0 = torch.stack([p_block[k].reshape(()) for k in keys])
    (cov_h, schur), ms_h, peak_h, l_h = timed_hvp(
        f"marginal_covariance(method='hutchinson') given white_mesh_ ({wm.numel()} dims), "
        f"{NUTS_CUTS['probes']} probes (3 + {NUTS_CUTS['probes']} HVPs)",
        lambda: L.marginal_covariance(pot, x0, wm.reshape(-1), "hutchinson", NUTS_CUTS["probes"],
                                      key=gen))
    log(f"# 5f marginal covariance {cov_h.tolist()}; Schur complement {schur.tolist()}")
    assert bool(torch.isfinite(cov_h).all()) and bool(torch.isfinite(schur).all())

    # one HVP column of the N-body flagship in Omega_m_
    mb = bench_model(evolution="nbody")
    pb = mb.reparam({k: np.asarray(v) for k, v in mb.fiduc.items()}, inv=True)
    pb["white_mesh_"] = torch.randn(mb.init_shape, generator=gen, device="cuda")
    obs = {"count_mesh": mb.predict(seed=gen, samples=pb, hide_samp=False)["count_mesh"]}
    k5_double = [0]
    k5_backward = P._ReadCICAdjoint.backward

    def counted_backward(ctx, *grads):
        k5_double[0] += 1
        return k5_backward(ctx, *grads)

    def nbody_column():
        return hvp_column(lambda p: mb.logpdf({**p, **obs}), pb, "Omega_m_")

    P._ReadCICAdjoint.backward = staticmethod(counted_backward)
    try:
        col_b, ms_b, peak_b, l_b = timed_hvp("one HVP column of the N-body flagship in Omega_m_",
                                             nbody_column)
    finally:
        P._ReadCICAdjoint.backward = staticmethod(k5_backward)
    log(f"# 5f N-body HVP column: d2/dOmega_m_^2 {col_b[list(pb).index('Omega_m_')].item():.6e}, "
        f"|column| max {max(float(c.abs().max()) for c in col_b):.6e}; K4/K5 double backwards "
        f"{k5_double[0]}")
    assert all(bool(torch.isfinite(c).all()) for c in col_b)
    col_b2 = nbody_column()
    diff = {k: float((a - b).abs().max()) for k, a, b in zip(pb, col_b, col_b2)}
    same_col = all(torch.equal(a, b) for a, b in zip(col_b, col_b2))
    log(f"# 5f N-body HVP column twice: equal bit for bit {same_col} (max |difference| per "
        f"latent {diff})")
    assert same_col, "5f: two N-body HVP columns from the same inputs differ"
    assert k5_double[0] > 0, "5f: K4/K5's double backward never ran on the N-body flagship"
    hvps = {"2LPT Laplace seed": l_seed, "2LPT Hutchinson": l_h, "N-body column": l_b}
    routed_2 = dict(zip(SECOND_ORDER, hess_names(2)))
    for tag, l in hvps.items():
        missing = [k for k in routed_2.values() if not l.get((k, "bspline", 2))]
        assert not missing, f"5f: {missing} never launched in the {tag}"
    launches_2 = {k: sum(l.get((r, "bspline", 2), 0) for l in hvps.values())
                  for k, r in routed_2.items()}
    per_hvp = {k: {tag: l.get((r, "bspline", 2), 0) for tag, l in hvps.items()}
               for k, r in routed_2.items()}
    extras = {k: {"launches_per_hvp": per_hvp[k],
                  "hvp_ms": {"2LPT Laplace seed (3 columns)": ms_seed,
                             "2LPT Hessian, tables fixed (3 columns)": ms_fixed,
                             "2LPT Hutchinson": ms_h, "N-body column": ms_b},
                  "hvp_peak_gib": {"2LPT Laplace seed": peak_seed, "2LPT Hutchinson": peak_h,
                                   "N-body column": peak_b}} | flagship_hess[k]
              for k in SECOND_ORDER}
    return launches_2, extras


def hvp_column(logpdf, p, key):
    """One Hessian-vector product column of logpdf at the latents `p`: the
    gradient of d logpdf / d p[key] with respect to every latent, reverse
    over reverse (a None as zeros)."""
    leaves = {k: torch.as_tensor(v).detach().clone().requires_grad_(True) for k, v in p.items()}
    (g,) = torch.autograd.grad(logpdf(leaves), leaves[key], create_graph=True)
    col = torch.autograd.grad(g, list(leaves.values()), allow_unused=True)
    return [torch.zeros_like(v) if c is None else c for v, c in zip(leaves.values(), col)]


# ---------------------------------------------------------------- phase 5g
def phase_tables_launches():
    """5g: one value+grad of the 2LPT flagship profiled (torch.profiler):
    the device kernels launched and the device-busy ms; then 3 value+grads
    timed after a warm-up.  Returns {"K8": (launches, busy ms, median wall
    ms)}."""
    _, _, _, value_and_grad = flagship("lpt")
    value_and_grad()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        value_and_grad()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    counts = {"K8": (*profiled_kernels(value_and_grad), float(np.median(walls)))}
    n, busy, wall = counts["K8"]
    log(f"# 5g 2LPT flagship value+grad: {n} device kernels launched, device busy {busy:.3f} ms "
        f"(profiled); wall ms {[round(t, 3) for t in walls]} median {wall:.3f}")
    return counts


def profiled_kernels(fn):
    """(device kernels launched, device-busy ms) of one call of `fn`, from
    torch.profiler's CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.count for e in kernels), sum(e.self_device_time_total for e in kernels) / 1e3


# the kernels whose inputs each flagship capture records: the 2LPT render's
# paint and its backward; the N-body force read's VJP at the last step (the
# first K5 of the backward) and that step's read (the last K4 before it);
# K6 and K7 at their first launch in a 2LPT HVP column (the render's)
CAPTURES = {"paint": ("paint_cic", "paint_cic_adjoint"), "read": ("read_cic_adjoint", "read_cic"),
            "hess": SECOND_ORDER}


def flagship_inputs(tag, value_and_grad, which):
    """The flagship's own inputs of the kernels CAPTURES[which] names,
    recorded from one more value+grad (or HVP column) through whichever
    design the route calls: the per-axis quantiles of |pos - site| in cells, the tiled
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
                    name == "read_cic" and not first_k5) or (
                    name in SECOND_ORDER and name not in seen):
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


def fixed_profile(m, fn, eval_s, tag):
    """The profile's summary for one evaluation with the background tables
    held fixed: against the unfixed one, what the tables' gradient path
    (K8's backward and every lookup's) launches and costs."""
    log(f"# --- profile ({tag}), background tables held fixed")
    with fixed_tables(m):
        fn()
        profile_eval(fn, eval_s, table=False)


def profile_eval(fn, eval_s, table=True):
    """Device time by kernel name for one evaluation (and, with `table`,
    the profiler's table of the 40 largest)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"# profiler: device busy {busy_ms:.1f} ms per evaluation = "
        f"{100 * busy_ms / (1e3 * eval_s):.1f}% of the unprofiled {1e3 * eval_s:.1f} ms; "
        f"{launches} device kernels")
    for tag in ("paint_cic_tiled_kernel", "paint_cic_forward_kernel", "paint_cic_adjoint_kernel",
                "read_cic_forward_kernel", "read_cic_tiled_kernel", "read_cic_adjoint_tiled_kernel",
                "read_cic_adjoint_kernel", "nufft_epilogue", "background_tables_kernel",
                "segment_sum_kernel", "indexing_backward", "indexFunc"):
        ms = sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
        log(f"# profiler: kernels named *{tag}* {ms:.3f} ms = "
            f"{100 * ms / max(busy_ms, 1e-9):.2f}% of device time")
    if table:
        log(events.table(sort_by="cuda_time_total", row_limit=40))


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
# K6 and K7 (the double backward): lattice-brick and per-particle sources,
# and what each replaces
HESS_SOURCES = {"paint_cic_grad": (CSRC + "paint_tiled.cu", CSRC + "paint_hess.cu",
                                   "montecosmo_tpu/ops/paint_window.py:240"),
                "read_cic_hess": (CSRC + "read_tiled.cu", CSRC + "paint_hess.cu",
                                  "montecosmo_tpu/ops/paint_window.py:330")}
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


def hess_names(order):
    """The launch names of K6 and K7 (the double backward) at B-spline
    `order` on a clamped geometry, in the design the route takes."""
    return tuple(path_name(n, order) for n in SECOND_ORDER)


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
    phase_sampler_32()
    done("4e")
    for evolution in ("lpt", "nbody"):
        phase_hessian_32(evolution)
    done("4f")
    phase_ap_png_32()
    done("4g")
    # the flagships' own inputs by B-spline order: CIC from 5 and 5b, TSC from 5c
    lpt_launches, flagship = phase_bench("lpt", path_kernels(2), capture="paint")
    flagship = {2: flagship}
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
    phase_kaiser()
    done("5h")
    lik_ms = phase_likelihoods()
    done("5i")
    eulerian = phase_bench("lpt", path_kernels(2), "2LPT, Eulerian bias", bias_type="eulerian")
    done("5j")
    assert all(v % 7 == 0 for v in lpt_launches.values()), lpt_launches
    per_eval = {k: v // 7 for k, v in lpt_launches.items()}
    m, state_f = phase_sampler(per_eval)
    done("5e")
    hvp_launches, hvp_extras = phase_nuts(m, state_f, per_eval)
    del m, state_f
    done("5f")
    tables = phase_tables_launches()
    done("5g")
    ap_png = phase_ap_png()
    done("5k")
    with tempfile.TemporaryDirectory() as tmp:
        survey = phase_survey(tmp)
        done("5l")
        remainder, remainder_big, remainder_report, save_dir = phase_nbody_remainder(tmp)
        done("5m")
        k10, k10_launches = phase_analysis(survey["save_dir"], save_dir)
        done("5n")
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
            if kernel != KB and order == 2:
                kernels[-1]["launches_ap_png"] = {
                    tag: per.get(path_name(n, order), 0) for tag, per in ap_png.items()}
                if n in remainder:
                    kernels[-1]["launches_nbody_remainder"] = remainder[n]
                if n in survey["launches_register"]:
                    # one 128^3-budget register: unclamped paints (the atomic
                    # design) and their nufft epilogues
                    kernels[-1]["launches_register"] = survey["launches_register"][n]
                    kernels[-1]["register_ms"] = survey["register_ms"]
    for order in ORDERS:
        sfx = _suffix(order, "rectangular")
        for n, (tiled, other, rep) in HESS_SOURCES.items():
            src = tiled if res[n + sfx]["design"] == "tiled" else other
            kernels.append({"name": n + sfx, "route": "cuda", "source": src, "tiled_source": tiled,
                            "replaces": rep, "window": "bspline", "order": order,
                            "launches": hvp_launches[n] if order == 2 else 0,
                            **res[n + sfx], **(hvp_extras[n] if order == 2 else {})})
    k9_rows = {tag: {w: n / 7 for w, n in k9.items()} for tag, k9 in K9_LAUNCHES.items()}
    kernels.append({"name": "segment_sum", "route": "cuda", "source": CSRC + "segment_sum.cu",
                    "replaces": "montecosmo_tpu/metrics.py:104",
                    "also_replaces": "montecosmo_tpu/ops/interp.py:20 (the VJP of jnp.take)",
                    "design": "one launch: coalesced warps, runs summed by a segmented warp "
                              "scan in float64, added once as fixed point (the CTA's own "
                              "scale) with integer shared atomics over the rows touched, CTA "
                              "partials summed pairwise by ticket-counter finishers",
                    "launches": sum(K9_LAUNCHES["lpt"].values()),
                    "launches_per_value_and_grad": k9_rows,
                    "likelihood_value_and_grad_ms": lik_ms,
                    "eulerian_launches": eulerian,
                    "path_cotangents_max_rel_err_per_column": K9_PATH,
                    "launches_nbody_remainder": {
                        "tsit5_128_value_and_grad": remainder_big["k9_value_and_grad"],
                        "accuracy_report_128": sum(
                            n for k, n in remainder_report["launches"].items()
                            if k.startswith("segment_sum/"))},
                    **res["segment_sum"]})
    kernels.append({"name": "background_tables", "route": "cuda",
                    "source": CSRC + "background_rk4.cu",
                    "replaces": "montecosmo_tpu/ops/background.py:115",
                    "launches": K8_LAUNCHES["lpt"], **res["background_tables"],
                    "launches_ap_png": {tag: K8_LAUNCHES[f"5k {tag}"] / 7 for tag in AP_PNG},
                    "launches_nbody_remainder": {
                        "tsit5_128_value_and_grad": remainder_big["k8_value_and_grad"],
                        "accuracy_report_128": remainder_report["launches"].get(
                            "background_tables/background/0", 0)},
                    "launches_per_2lpt_value_and_grad": {
                        w: n for w, (n, _, _) in tables.items()},
                    "2lpt_value_and_grad_ms": {w: t for w, (_, _, t) in tables.items()}})
    k10_row = k10["128"]
    kernels.append({"name": "bispectrum_sums", "route": "cuda", "source": CSRC + "bispectrum.cu",
                    "replaces": "montecosmo_tpu/metrics.py:179",
                    "design": "16 x 8 blocks of (i, j), a strip of l's a warp, on the FP64 "
                              "tensor cores (mma.sync m16n8k8.f64), cp.async double-buffered "
                              "float64 tiles, per-CTA partials summed in order",
                    "launches": sum(k10_launches.values()),
                    **{k: k10_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
                    "library": "FP32 GEMM (X * X_l) X^T for every l, TF32 off",
                    "at": {size: row for size, row in k10.items()}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
