"""The port's cut-sky inference campaign through its CLI on the CPU, with
h5py and PyYAML unimportable, as on the card's machine: the catalogs of
test_torch_register.py registered by `register_catalog` (12^3 budget: an
(8, 18, 12) final mesh, the footprint ~89% of it, so the likelihood, the
cached synthetic counts and the chains' spectra all run on the masked
model), `npsave`, `infer.main` (--device cpu) through the three phases and
`make_chains`, then the same command with one more run, which loads the
cached masked counts, the drawn initial field and both warmups, and runs
only run 3.  One test in a file of its own: xdist's file queue runs it
beside the JAX package's long one-test files instead of ahead of them."""
import os
import sys

import numpy as np
import torch

from montecosmo_tpu_torch.chains import Chains
from montecosmo_tpu_torch.utils.io import npload, npsave

from test_torch_register import catalog, OMEGA_M, SIGMA8

torch.set_num_threads(1)


def test_cut_sky_campaign_without_h5py_or_yaml(tmp_path, monkeypatch):
    """Catalogs -> register_catalog -> npsave -> the CLI with --self-data, 2
    chains, field and full warmups of 2 steps, 2 runs of 2 samples; then
    the same command with 3 runs."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "yaml", None)
    from montecosmo_tpu_torch import FieldLevelModel
    from montecosmo_tpu_torch.infer import main
    from montecosmo_tpu_torch.ops.background import get_cosmology

    reg = FieldLevelModel.register_catalog(
        12**3, get_cosmology(Omega_m=OMEGA_M, sigma8=SIGMA8), catalog(20_000, 1),
        catalog(50_000, 2), device="cpu")
    mask = reg["mask_mesh"]
    assert reg["count_mesh"].shape == (8, 18, 12) and 0.8 < mask.mean() < 0.95
    npsave(tmp_path / "register_cut.npz", reg)
    argv = ["--register", str(tmp_path / "register_cut.npz"), "--self-data", "--n-chains", "2",
            "--n-steps-field", "2", "--n-steps-full", "2", "--n-samples", "2", "--thinning", "1",
            "--save-root", str(tmp_path / "results"), "--device", "cpu"]
    main(argv + ["--n-runs", "2"])
    save_dir = tmp_path / "results" / "cut_lpt_12_fNL0_self"
    chains_dir = save_dir / "chains"
    kept = ["field_warm_state.npz", "full_warm_state.npz", "run_1.npz", "run_2.npz"]
    mtimes = {f: os.stat(chains_dir / f).st_mtime_ns for f in kept}
    counts = npload(save_dir / "obs.npz")["count_mesh"]
    assert counts.shape == (int(mask.sum()),) and np.isfinite(counts).all()
    truth = npload(save_dir / "truth.npz")["white_mesh"]
    main(argv + ["--n-runs", "3"])
    assert all(os.stat(chains_dir / f).st_mtime_ns == t for f, t in mtimes.items())
    np.testing.assert_array_equal(npload(save_dir / "obs.npz")["count_mesh"], counts)
    np.testing.assert_array_equal(npload(save_dir / "truth.npz")["white_mesh"], truth)
    log = (save_dir / "run.out").read_text()
    for line in ("Loading field warmup...", "Loading full warmup...", "Resuming at run 3...",
                 "Loading cached synthetic data..."):
        assert line in log, line
    assert log.count("run 3/3") == 1 and log.count("run 1/2") == 1
    chains_ = Chains.load(chains_dir / "chains_.npz")
    assert chains_["logdensity"].shape == (2, 6) and np.isfinite(chains_["logdensity"]).all()
    assert chains_["white_mesh_"].shape == (2, 6, 10)
    chains = Chains.load(chains_dir / "chains.npz")
    kptc = chains["kptc_white_mesh"]
    assert kptc.shape[:3] == (2, 6, 4) and np.isfinite(kptc[:, :, 2:, 1:]).all()
    assert {"b1", "b2", "bs2", "ngbars", "white_mesh"} <= set(chains.data)
    assert (save_dir / "model.yaml").read_text().lstrip().startswith("{")
