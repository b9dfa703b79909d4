"""Accuracy report: transfer and coherence of the port's forward model
across integrators, resolutions and precisions, at matched white meshes.

    python -m montecosmo_tpu_torch.accuracy --final 128            # on the card
    python -m montecosmo_tpu_torch.accuracy --final 16 --device cpu

  1. BullFrog N-body (10 steps) against 2LPT: the integrator's systematic;
  2. evol_oversamp 1.75 against 2.25 (2LPT): resolution convergence;
  4. adaptive Tsit5 (tol 1e-3, from a = 0.05) against BullFrog (10 steps)
     on the matter painted at a = 0.5: the production integrator against
     the validation one;
  3. float32 on --device against float64 (2LPT): the precision floor.  The
     kernels take float32 only, so the float64 run is the plain path on the
     CPU, in the same process; --f64-final runs it at another size.

Each section prints the transfer range (or its largest distance to 1) and
the least coherence over k < 0.8 k_Nyquist, and its wall time; on the card
the last line counts the kernels launched.

Parity: `run/accuracy_report.py` (its sections and lines; the float64 run
in a child process with x64 there).
"""
import argparse
import json
import time

import numpy as np
import torch

from montecosmo_tpu_torch.metrics import powtranscoh
from montecosmo_tpu_torch.ops._kernels import LAUNCHES
from montecosmo_tpu_torch.models.bricks import regular_pos, white2lin, white_noise
from montecosmo_tpu_torch.models.model import FieldLevelModel, default_config
from montecosmo_tpu_torch.ops.background import Background
from montecosmo_tpu_torch.ops.fourier import irfftn, rfftn
from montecosmo_tpu_torch.ops.hermitian import chreshape, r2chshape
from montecosmo_tpu_torch.ops.paint import paint
from montecosmo_tpu_torch.ops.pm import nbody_bf, nbody_tsit5


def report_model(final, evolution, evol_oversamp, device="cuda", n_steps=10):
    """The report's configuration: `final`^3 in a 1000 Mpc/h box at (0, 0,
    1500), flat sky, a_obs 0.5, 2LPT or BullFrog, quad-Gaussian, Kaiser
    preconditioning, the evol/particle/paint meshes at `evol_oversamp`."""
    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=1000.0 / final, evolution=evolution,
                lpt_order=2, nbody_n_steps=n_steps, a_obs=0.5, curved_sky=False,
                box_center=(0.0, 0.0, 1500.0), lik_type="quad_gauss", precond="kaiser",
                evol_oversamp=evol_oversamp, ptcl_oversamp=evol_oversamp,
                paint_oversamp=evol_oversamp)
    return FieldLevelModel(**conf, device=device)


def galaxy_field(m, white, dtype=torch.float32, seed=1):
    """The galaxy mesh that `m` predicts at its fiducial with the white
    field `white` (numpy, `m.init_shape`), resampled to the final mesh, in
    `dtype`."""
    params = m.reparam({k: np.asarray(v) for k, v in m.fiduc.items()}, inv=True)
    params["white_mesh_"] = white
    params = {k: torch.as_tensor(v).to(m.device, dtype) for k, v in params.items()}
    pred = m.predict(seed=seed, samples=params, hide_base=False, hide_det=False,
                     hide_samp=False)
    return irfftn(chreshape(rfftn(pred["gxy_mesh"]), r2chshape(m.final_shape)))


def transfer_coherence(mesh0, mesh1, box_size, final):
    """(transfer, coherence) of mesh1 against mesh0 at k < 0.8 k_Nyquist,
    numpy float64."""
    k, _, trans, coh = (torch.as_tensor(x).double().cpu().numpy() for x in powtranscoh(
        mesh0, mesh1.to(mesh0.device, mesh0.dtype), box_size))
    sel = k < 0.8 * np.pi * final / box_size[0]
    return trans[sel], coh[sel]


def matter_pair(m, final, seed=7):
    """(Tsit5, BullFrog) matter at a = 0.5 from one white draw at `final`^3
    (one particle a cell): Tsit5 at tol 1e-3 from a = 0.05, BullFrog in 10
    steps from a = 0, each painted at CIC.  Returns the two meshes and the
    Tsit5 counts."""
    shape, box = 3 * (final,), m.box_size
    gen = torch.Generator(device=m.device).manual_seed(seed)
    stats = {}
    with torch.no_grad():
        bg = Background.create(m.cosmo_fid, device=m.device)
        lin = white2lin(m.cosmo_fid, white_noise(gen, shape, box), shape, box)
        pos0 = regular_pos(shape, device=m.device)
        pos_bf, _ = nbody_bf(bg, lin, pos0, a1=0.5, n_steps=10)
        pos_ad, _ = nbody_tsit5(bg, lin, pos0, 0.05, 0.5, tol=1e-3, stats=stats)
        return paint(pos_ad[-1], shape, order=2), paint(pos_bf[-1], shape, order=2), stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--final", type=int, default=32)
    ap.add_argument("--f64-final", type=int, default=None,
                    help="final mesh of section 3 (default --final)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the report on the CPU")
    final = args.final
    t_all = time.perf_counter()

    def white_of(m):
        return np.random.default_rng(0).standard_normal(m.init_shape).astype(np.float32)

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        m = report_model(final, "lpt", 1.75, device)
        g_lpt, t_lpt = timed(galaxy_field, m, white_of(m))
        box = m.box_size
        print(f"# Accuracy report at {final}^3 final (box {box[0]:.0f} Mpc/h) on "
              f"{device.type}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else "") + "\n")

        m_nb = report_model(final, "nbody", 1.75, device)
        g_nb, t_nb = timed(galaxy_field, m_nb, white_of(m_nb))
        t, c = transfer_coherence(g_nb, g_lpt, box, final)
        print("1. BullFrog(10) vs 2LPT:")
        print(f"   transfer range [{t.min():.4f}, {t.max():.4f}], coherence min {c.min():.4f} "
              f"(k < 0.8 k_nyq); 2LPT {t_lpt:.2f} s, BullFrog {t_nb:.2f} s")
        del m_nb, g_nb

        m_hi = report_model(final, "lpt", 2.25, device)
        g_hi, t_hi = timed(galaxy_field, m_hi, white_of(m_hi))
        t, c = transfer_coherence(g_lpt, g_hi, box, final)
        print("2. evol_oversamp 1.75 vs 2.25 (2LPT):")
        print(f"   transfer within {np.abs(t - 1).max():.4f} of 1, coherence min {c.min():.5f}; "
              f"{t_hi:.2f} s")
        del m_hi, g_hi

        (d_ad, d_bf, stats), t_pair = timed(matter_pair, m, final)
        t, c = transfer_coherence(d_ad, d_bf, box, final)
        print("4. Tsit5(tol=1e-3, adaptive) vs BullFrog(10) matter:")
        print(f"   transfer range [{t.min():.4f}, {t.max():.4f}], coherence min {c.min():.5f}; "
              f"Tsit5 {stats['accepted']} accepted, {stats['rejected']} rejected steps, "
              f"{stats['force_evaluations']} force evaluations; {t_pair:.2f} s")
        del d_ad, d_bf

        f64 = args.f64_final or final
        if f64 != final:
            m = report_model(f64, "lpt", 1.75, device)
            g_lpt, _ = timed(galaxy_field, m, white_of(m))
        m64 = report_model(f64, "lpt", 1.75, "cpu")
        g64, t64 = timed(galaxy_field, m64, white_of(m64), torch.float64)
        t, c = transfer_coherence(g_lpt.double().cpu(), g64, m64.box_size, f64)
        print(f"3. float32 ({device.type}) vs float64 (2LPT, {f64}^3; the float64 run is the "
              f"plain path on the CPU, in this process):")
        print(f"   transfer within {np.abs(t - 1).max():.2e} of 1, coherence min {c.min():.8f}; "
              f"{t64:.2f} s")
    print(f"# report done in {time.perf_counter() - t_all:.2f} s")
    if device.type == "cuda":
        print("# kernel launches " + json.dumps({"/".join(map(str, k)): n
                                                for k, n in sorted(LAUNCHES.items())}))


if __name__ == "__main__":
    main()
