"""Register a catalog, or a synthetic 2LPT mock, into the port's register
file (`.npz`): geometry, the painted count, selection and mask meshes, the
fiducial cosmology, the tabulated linear power and whitened initial
conditions.  `FieldLevelModel(register=...)` and
`python -m montecosmo_tpu_torch.infer --register` read it.

    python -m montecosmo_tpu_torch.register synthetic --cell-budget 32768 --out registered
    python -m montecosmo_tpu_torch.register fullsky --pos catalog.npy --box-size 2000
    python -m montecosmo_tpu_torch.register cutsky --data data.npz --random randoms.npz

Runs on `--device` (default cuda; without a card pass --device cpu).  The
register itself is `FieldLevelModel.register_catalog` (K1 paints, K3
epilogues).  Catalog files: `utils/catalogs.py` (.npy and .npz with numpy
alone).  The synthetic mock's white field and, where the register has no
initial conditions (cut sky, a full sky without --ic), `white_fake` are
drawn from torch.Generators seeded with --seed: the same seed draws other
fields than the JAX package's.

Parity: `run/register.py` and its flags, --device in place of --platform.
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from montecosmo_tpu_torch.models.bricks import lin2white, regular_pos, white2lin, white_noise
from montecosmo_tpu_torch.models.model import FieldLevelModel
from montecosmo_tpu_torch.ops.background import AbacusSummit0, Background, Esqr, get_cosmology
from montecosmo_tpu_torch.ops.fourier import irfftn, rfftn
from montecosmo_tpu_torch.ops.hermitian import chreshape, r2chshape, scale_shape
from montecosmo_tpu_torch.ops.pm import lpt
from montecosmo_tpu_torch.ops.power import lin_power
from montecosmo_tpu_torch.utils.io import npsave


def compute_lin_kpow(cosmo, device="cuda"):
    """(k, P(k) / sigma8^2) at z = 0 as a (2, 256) float32 array, computed
    on `device` (the card by default; `device="cpu"` on the CPU): the model
    scales it by the sampled sigma8^2."""
    ks, pows = lin_power(cosmo._replace(sigma8=1.0), device=device)
    return torch.stack((ks, pows)).cpu().numpy()


def build_init(init_shape, cosmo, box_size, real_ic=None, seed=42, lin_kpow=None,
               device="cuda"):
    """The register's initial conditions: lin_kpow, and the real IC mesh
    whitened at `init_shape` (`white_mesh`) or, without one, a unit-power
    white draw (`white_fake`, from a torch.Generator seeded with `seed`),
    computed on `device` (the card by default)."""
    if lin_kpow is None:
        lin_kpow = compute_lin_kpow(cosmo, device)
    init = {"lin_kpow": lin_kpow}
    with torch.no_grad():
        if real_ic is not None:
            fmesh = rfftn(torch.as_tensor(np.asarray(real_ic, np.float32), device=device))
            fmesh = chreshape(fmesh, r2chshape(init_shape))
            init["white_mesh"] = lin2white(cosmo, fmesh, init_shape, box_size,
                                           kpow=lin_kpow).cpu().numpy()
        else:
            gen = torch.Generator(device=device).manual_seed(int(seed))
            init["white_fake"] = white_noise(gen, init_shape, box_size).cpu().numpy()
    return init


def lpt_mock(cosmo, white, box_size, n_ptcl, a_obs):
    """A 2LPT mock from the rfft white mesh `white` (n_ptcl^3, on the
    device it runs on): ({'pos' [Mpc/h] in [0, box), 'vel' [km/s]}, the
    real linear field), numpy float32."""
    shape = 3 * (int(n_ptcl),)
    box = np.full(3, float(box_size))
    device = white.device
    with torch.no_grad():
        bg = Background.create(cosmo, device=device)
        lin = white2lin(cosmo, white, shape, box)
        pos0 = regular_pos(shape, device=device)
        dpos, vel = lpt(bg, lin, pos0, a=a_obs, lpt_order=2, read_order=1)
        pos = (pos0 + dpos) % n_ptcl
        a = torch.as_tensor(a_obs, dtype=torch.float32, device=device)
        # growth-time velocity -> peculiar km/s: v = a H D f dq_phys
        to_kms = a_obs * 100.0 * float(torch.sqrt(Esqr(cosmo, a))) * float(
            bg.a2g(a) * bg.a2f(a))
        cell = box_size / n_ptcl
        return ({"pos": pos.cpu().numpy() * cell, "vel": vel.cpu().numpy() * cell * to_kms},
                irfftn(lin).cpu().numpy())


def synthetic_mock(cosmo, box_size=640.0, n_ptcl=32, a_obs=0.5, seed=0, device="cuda"):
    """A 2LPT particle mock with velocities (for the catalog's RSD) from a
    white field drawn with a torch.Generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    white = white_noise(gen, 3 * (int(n_ptcl),), np.full(3, float(box_size)))
    return lpt_mock(cosmo, white, box_size, n_ptcl, a_obs)


def register(args):
    """Build and save the register that `args` (the CLI's) describes;
    returns its path."""
    from montecosmo_tpu_torch.utils.catalogs import (
        lin_kpow_cosmoprimo, load_box_catalog, load_cutsky_catalog, load_ic_mesh,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to register on the CPU")
    lin_kpow = None
    if args.cosmoprimo:
        lin_kpow, loc = lin_kpow_cosmoprimo(args.cosmoprimo)
        cosmo = get_cosmology(**loc)
    else:
        cosmo = AbacusSummit0()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    box_kw = dict(a_obs=args.a_obs, los=(0.0, 0.0, 1.0), box_center=(0.0, 0.0, 0.0))
    common = dict(cell_budget=args.cell_budget, cosmo_fid=cosmo, padding=args.padding,
                  init_oversamp=args.init_oversamp, paint_oversamp=args.paint_oversamp,
                  device=device)

    if args.mode == "synthetic":
        data, real_ic = synthetic_mock(cosmo, args.box_size, args.n_ptcl, args.a_obs, args.seed,
                                       device)
        tag = f"synthetic_z{1 / args.a_obs - 1:.3f}"
        reg = FieldLevelModel.register_catalog(data=data, box_size=np.full(3, args.box_size),
                                               **box_kw, **common)
    elif args.mode == "fullsky":
        data = load_box_catalog(args.pos, pos_cols=args.pos_cols.split(","),
                                vel_cols=args.vel_cols.split(",") if args.vel_cols else None)
        if args.vel:  # velocities in a file of their own (.npy)
            data["vel"] = np.load(args.vel)
        real_ic = load_ic_mesh(args.ic, args.ic_growth) if args.ic else None
        tag = Path(args.pos).stem
        reg = FieldLevelModel.register_catalog(data=data, box_size=np.full(3, args.box_size),
                                               **box_kw, **common)
    elif args.mode == "cutsky":
        data = load_cutsky_catalog(args.data)
        random = load_cutsky_catalog(args.random)
        real_ic = None
        tag = Path(args.data).stem
        reg = FieldLevelModel.register_catalog(data=data, random=random, **common)
    else:
        raise ValueError(args.mode)

    final_shape = reg["count_mesh"].shape
    init_shape = scale_shape(final_shape, reg["init_oversamp"])
    box = np.multiply(final_shape, reg["cell_length"])
    reg |= build_init(init_shape, cosmo, box, real_ic=real_ic, seed=args.seed,
                      lin_kpow=lin_kpow, device=device)

    mesh_len = int(round(np.prod(final_shape) ** (1 / 3)))
    path = out / f"register_{tag}_b{mesh_len}_p{args.padding:g}.npz"
    npsave(path, reg)
    print(f"registered {reg['n_tracers']:.0f} tracers at {final_shape} -> {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cell-budget", type=float, default=32**3)
    common.add_argument("--padding", type=float, default=0.0)
    common.add_argument("--init-oversamp", type=float, default=1.5)
    common.add_argument("--paint-oversamp", type=float, default=1.75)
    common.add_argument("--a-obs", type=float, default=0.5)
    common.add_argument("--seed", type=int, default=42)
    common.add_argument("--out", type=str, default="registered")
    common.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu to run on the CPU)")
    common.add_argument("--cosmoprimo", type=str, default=None,
                        help="cosmoprimo fiducial factory (e.g. AbacusSummit) for a Boltzmann "
                             "linear P(k); needs the cosmoprimo package")

    syn = sub.add_parser("synthetic", parents=[common])
    syn.add_argument("--box-size", type=float, default=640.0)
    syn.add_argument("--n-ptcl", type=int, default=64)

    full = sub.add_parser("fullsky", parents=[common])
    full.add_argument("--pos", required=True,
                      help="positions: .npy (n, 3) [Mpc/h], or a table .npz/.fits/.h5 (see "
                           "--pos-cols), or an AbacusSummit .asdf")
    full.add_argument("--pos-cols", default="x,y,z", help="position columns of a table")
    full.add_argument("--vel-cols", default=None,
                      help="velocity columns of a table (e.g. vx,vy,vz) [km/s]")
    full.add_argument("--vel", help=".npy (n, 3) peculiar velocities [km/s]")
    full.add_argument("--ic", help="real-space linear IC mesh: .npy or AbacusSummit ic_dens "
                                   ".asdf")
    full.add_argument("--ic-growth", type=int, default=None,
                      help="GrowthTable index for .asdf ICs")
    full.add_argument("--box-size", type=float, required=True)

    cut = sub.add_parser("cutsky", parents=[common])
    cut.add_argument("--data", required=True, help=".npz/.fits/.h5 with RA/DEC/Z[/WEIGHT]")
    cut.add_argument("--random", required=True, help=".npz/.fits/.h5 with RA/DEC/Z[/WEIGHT]")
    return register(ap.parse_args(argv))


if __name__ == "__main__":
    main()
