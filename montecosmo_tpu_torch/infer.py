"""Field-level inference campaign on a registered survey, on the card.

The three phases of `montecosmo_tpu_torch.script` (field warmup, full
warmup, runs) with file-based idempotent resume, then `make_chains`:

    python -m montecosmo_tpu_torch.infer --register reg.npz --self-data \
        --n-chains 2 --n-steps-field 64 --n-steps-full 64 --n-samples 4 \
        --n-runs 2 --thinning 2 --save-root results

`--register` takes the port's `.npz` (`utils.io.npsave` of
`FieldLevelModel.register_catalog`'s dict) or, where h5py is installed, a
JAX package `.h5`.  The campaign runs on `--device` (default cuda; it does
not fall back to the CPU).  Its log goes to <save_dir>/run.out; running the
same command again loads each finished phase and resumes at the first
missing run.

Parity: `run/infer.py:27-170` and its flags, without the JAX/TPU-only ones
(--platform, --spatial-mesh, --distributed, the compilation cache).
"""
import argparse
import contextlib
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from montecosmo_tpu_torch.models.model import FieldLevelModel, default_config
from montecosmo_tpu_torch.script import field_warmup, full_run, full_warmup, make_chains
from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.io import npload, npsave

TRUTH = "truth.npz"  # the initial field a self-data campaign drew, when the register has none
DEFAULT_OBS = [
    "count_mesh", "powspec", "alpha_iso", "alpha_ap", "Omega_m", "sigma8",
    "b3", "bds2", "bs3", "bn2", "bnpar",
    "fNL_bpd2", "fNL_bps2", "fNL_bn2p", "s_e", "s_ed", "s_e2", "s_ep",
]


def campaign_dir(register, evolution, final_shape, fnl, sampler, observable, lik_type,
                 self_data, expe, save_root):
    """The campaign's folder, named as run/infer.py names it."""
    mesh_length = int(round(np.prod(final_shape) ** (1 / 3)))
    tag = Path(register).stem.replace("register_", "")
    folder = (f"{tag}_{evolution}_{mesh_length}_fNL{fnl:.0f}"
              + (f"_{sampler}" if sampler != "mclmc" else "")
              + (f"_{observable}" if observable != "field" else "")
              + ("_fourier" if lik_type == "fourier_gauss" else "")
              + ("_self" if self_data else "") + (f"_{expe}" if expe else ""))
    return Path(save_root) / folder


def infer(register, png_type=None, lik_type="quad_gauss", evolution="lpt", self_data=False,
          fnl=0.0, expe="", overwrite=False, obs_names=(), n_chains=4, tune_mass=True,
          n_steps_field=2**12, dev_field=1e-5, n_steps_full=2**13, dev_full=1e-7,
          n_samples=None, n_runs=8, thinning=64, scale_fid_fac=1.0, save_root="results",
          sampler="mclmc", observable="field", recenter=True, device="cuda"):
    """Run (or resume) the campaign; returns (save_dir, the sample-space
    chains)."""
    model = build_model(register, png_type, lik_type, evolution, fnl, scale_fid_fac,
                        observable, device)
    save_dir = campaign_dir(register, evolution, model.final_shape, fnl, sampler, observable,
                            lik_type, self_data, expe, save_root)
    chains_dir = save_dir / "chains"
    chains_dir.mkdir(parents=True, exist_ok=True)
    print(f"SAVE DIR: {save_dir}")
    with open(save_dir / "run.out", "a", buffering=1) as out, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        print(f"Started at {datetime.now().astimezone().isoformat()} on {model.device}"
              + (f" ({torch.cuda.get_device_name(model.device)})"
                 if model.device.type == "cuda" else ""))
        print(model)
        chains = _campaign(model, save_dir, chains_dir, self_data, overwrite, obs_names,
                           n_chains, tune_mass, n_steps_field, dev_field, n_steps_full, dev_full,
                           n_samples, n_runs, thinning, sampler, recenter)
        print(f"Finished at {datetime.now().astimezone().isoformat()}")
    return save_dir, chains


def build_model(register, png_type=None, lik_type="quad_gauss", evolution="lpt", fnl=0.0,
                scale_fid_fac=1.0, observable="field", device="cuda"):
    """The campaign's model of `register`: default_config, the campaign's
    fiducial (every bias and stochastic latent at its zero point, fNL
    `fnl`), its scale_fid scaled by `scale_fid_fac` and one radial bin, on
    `device`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the campaign on the CPU")
    fiduc = {
        "b1": 1.0, "b2": 0.0, "bs2": 0.0, "b3": 0.0, "bds2": 0.0, "bs3": 0.0,
        "bn2": 0.0, "bnpar": 0.0,
        "fNL": fnl, "fNL_bp": 0.0, "fNL_bpd": 0.0, "fNL_bpd2": 0.0,
        "fNL_bps2": 0.0, "fNL_bn2p": 0.0,
        "s_e": 1.0, "s_k2e": 0.0, "s_kmu2e": 0.0,
        "s_ed": 0.0, "s_e2": 0.0, "s_ep": 0.0,
        "alpha_iso": 1.0, "alpha_ap": 1.0,
    }
    latents = FieldLevelModel.new_latents_from_loc(default_config["latents"], fiduc,
                                                   update_prior=True)
    for name in fiduc:
        latents[name] = latents[name] | {"scale_fid": latents[name]["scale_fid"] * scale_fid_fac}
    return FieldLevelModel(**default_config | {
        "evolution": evolution, "lik_type": lik_type, "png_type": png_type,
        "observable": observable, "register": str(register), "latents": latents,
        "n_rbins": 1}, device=device)


def _campaign(model, save_dir, chains_dir, self_data, overwrite, obs_names, n_chains, tune_mass,
              n_steps_field, dev_field, n_steps_full, dev_full, n_samples, n_runs, thinning,
              sampler, recenter):
    obs_site = "powspec" if model.observable == "powspec" else "count_mesh"
    truth_path = save_dir / TRUTH
    if self_data:
        cached = {}
        if (save_dir / "obs.npz").exists() and not overwrite:
            cached = npload(save_dir / "obs.npz")
        if obs_site in cached:
            print("\nLoading cached synthetic data...")
            value = torch.as_tensor(np.asarray(cached[obs_site]), device=model.device)
            if obs_site == "powspec":
                model.powspec_data = value
            else:
                model.count_mesh = value
            if model.white_mesh is None and truth_path.exists():
                model.white_mesh = to_tensor(npload(truth_path)["white_mesh"], model.device)
        else:
            print("\nSelf-predicting synthetic data from the fiducial loc...")
            # a register painted from a catalog has no initial field: the
            # synthetic data's is drawn from the prior and kept (truth.npz)
            truth = {} if model.white_mesh is None else {"white_mesh": model.white_mesh}
            pred = model.predict(samples=model.fiduc | truth, hide_base=False,
                                 hide_samp=False, from_base=True)
            if model.white_mesh is None:
                model.white_mesh = pred["white_mesh"]
                npsave(truth_path, {"white_mesh": model.white_mesh})
            if obs_site == "powspec":
                model.powspec_data = pred["powspec"]
            else:
                model.count_mesh = pred["count_mesh"]
            del pred

    model.save(save_dir / "model.yaml")
    fid = model.fiduc | {"white_mesh": model.white_mesh} | model.obs_data()
    with torch.no_grad():
        logpdf_fid = model.logpdf(model.reparam(fid, inv=True))
    print("logpdf of fiduc:", float(logpdf_fid), "\n")
    if not np.isfinite(float(logpdf_fid)):
        raise ValueError("fiducial logpdf is infinite or nan")
    if recenter:
        # a constant shift of the logpdf (zero-points at the fiducial): the
        # samplers difference float32 log-densities of ~1e6
        zp = model.recenter_logpdf(model.reparam(fid, inv=True))
        print(f"logpdf recentred at fiducial ({len(zp)} site zero-points)\n")

    # -------------------------------------------------- inference
    params = model.fiduc | {"white_mesh": model.white_mesh} | model.obs_data()
    obs = {k: params[k] for k in obs_names if k in params}
    npsave(save_dir / "obs.npz", obs)
    print(f"Inferring: {sorted(set(params) - set(obs))}")
    if n_samples is None:
        n_samples = 128 * 64 // int(round(np.prod(model.final_shape) ** (1 / 3)))
    print(f"n_samples: {n_samples}, n_runs: {n_runs}, n_chains: {n_chains}, "
          f"tune_mass: {tune_mass}")

    state = None
    if "white_mesh" not in obs:
        state, _, _ = field_warmup(model, chains_dir, n_steps=n_steps_field,
                                   desired_energy_var=dev_field, n_chains=n_chains,
                                   overwrite=overwrite)
    state, config = full_warmup(model, obs, state, chains_dir, n_steps=n_steps_full,
                                desired_energy_var=dev_full, n_chains=n_chains,
                                tune_mass=tune_mass, overwrite=overwrite, sampler=sampler)
    full_run(model, state, config, chains_dir, n_samples=n_samples, n_runs=n_runs,
             n_chains=n_chains, thinning=thinning, overwrite=overwrite, sampler=sampler)
    return make_chains(save_dir, start=1, end=100, device=model.device)


def obs_names_of(obs, lik_type, png_type):
    """The observed sites: `obs` (None: DEFAULT_OBS) plus those the
    likelihood and the PNG type leave out, as run/infer.py adds them."""
    names = list(obs) if obs is not None else list(DEFAULT_OBS)
    names += ["s_ed", "s_e2", "s_ep"] if lik_type == "fourier_gauss" else ["s_k2e", "s_kmu2e"]
    if png_type == "fNL":
        names += ["fNL_bp", "fNL_bpd"]
    if png_type is None:
        names += ["fNL", "fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2", "fNL_bn2p"]
    return sorted(set(names))


def parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--register", required=True, help="register file (.npz, or .h5 with h5py)")
    ap.add_argument("--png-type", default=None, choices=[None, "fNL", "bias"])
    ap.add_argument("--lik-type", default="quad_gauss")
    ap.add_argument("--evolution", default="lpt", choices=["kaiser", "lpt", "nbody"])
    ap.add_argument("--self-data", action="store_true")
    ap.add_argument("--fnl", type=float, default=0.0)
    ap.add_argument("--expe", default="")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--obs", nargs="*", default=None,
                    help="base latents to observe (others are inferred)")
    ap.add_argument("--n-chains", type=int, default=4)
    ap.add_argument("--no-tune-mass", action="store_true")
    ap.add_argument("--n-steps-field", type=int, default=2**12)
    ap.add_argument("--n-steps-full", type=int, default=2**13)
    ap.add_argument("--n-samples", type=int, default=None)
    ap.add_argument("--n-runs", type=int, default=8)
    ap.add_argument("--thinning", type=int, default=64)
    ap.add_argument("--observable", default="field", choices=["field", "powspec"])
    ap.add_argument("--sampler", default="mclmc", choices=["mclmc", "mams", "nuts"],
                    help="phase-2/3 sampler (phase 1 stays MCLMC)")
    ap.add_argument("--save-root", default="results")
    ap.add_argument("--no-recenter", action="store_true",
                    help="disable the float32 logpdf recentring (a constant zero-point shift "
                         "set at the fiducial)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def run(args):
    """The campaign of parsed `args`: (save_dir, chains)."""
    if args.obs is not None and not args.obs:
        raise SystemExit("--obs given with no site names; omit the flag for defaults")
    return infer(args.register, png_type=args.png_type, lik_type=args.lik_type,
                 evolution=args.evolution, self_data=args.self_data, fnl=args.fnl,
                 expe=args.expe, overwrite=args.overwrite,
                 obs_names=obs_names_of(args.obs, args.lik_type, args.png_type),
                 n_chains=args.n_chains, tune_mass=not args.no_tune_mass,
                 n_steps_field=args.n_steps_field, n_steps_full=args.n_steps_full,
                 n_samples=args.n_samples, n_runs=args.n_runs, thinning=args.thinning,
                 save_root=args.save_root, sampler=args.sampler, observable=args.observable,
                 recenter=not args.no_recenter, device=args.device)


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
