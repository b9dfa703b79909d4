"""The port's campaign functions on the CPU: every sampler branch of
`full_warmup` and `full_run` (mclmc, mams, nuts) after `field_warmup`, on a
Gaussian stand-in for the model: finite states, runs saved with leading
(chain, sample) axes, and a second `full_run` that resumes at the missing
run and leaves the done ones.

The chains' diagnostics against the JAX package's `metrics` are
test_torch_chain_diagnostics.py's, `Chains` against its `Chains`
test_torch_chains.py's, the cut-sky campaign through the CLI
test_torch_survey_campaign.py's.
"""
import os

import numpy as np
import pytest
import torch

from montecosmo_tpu_torch.utils.io import npload

torch.set_num_threads(1)


class Gaussian:
    """A stand-in for the model, with the calls the campaign makes: a field
    `white_mesh` (4 values) and a scalar block `x` (3 values), independent
    normals of scales 1 and 2 in sample space; the base values are the
    sample values."""

    device = torch.device("cpu")
    fiduc = {"x": np.zeros(3, np.float32)}

    def __init__(self):
        self.data = {}

    def reset(self):
        self.data = {}

    def substitute(self, data, from_base=False):
        self.data |= data

    def block(self):
        pass

    def obs_data(self):
        return {}

    def kaiser_post(self, gen, scale_field=1.0):
        start = {"white_mesh_": scale_field * torch.randn(4, generator=gen)}
        if "x" not in self.data:
            start["x_"] = 2 * torch.randn(3, generator=gen)
        return start

    def logpdf(self, p):
        x = p["x_"] if "x_" in p else torch.as_tensor(self.data["x"])
        return -0.5 * ((p["white_mesh_"] ** 2).sum() + ((x / 2) ** 2).sum())


@pytest.mark.parametrize("sampler", ["mclmc", "mams", "nuts"])
def test_campaign_branches_on_a_gaussian(sampler, tmp_path):
    """field_warmup -> full_warmup -> full_run (2 runs), then full_run with
    3 runs: only run 3 is made; every state and sample finite."""
    from montecosmo_tpu_torch.script import field_warmup, full_run, full_warmup

    m, quiet = Gaussian(), lambda *a: None
    state, _, start = field_warmup(m, tmp_path, n_steps=20, desired_energy_var=1e-3,
                                   n_chains=2, log=quiet)
    assert set(start) == {"white_mesh_"} and state.position["white_mesh_"].shape == (2, 4)
    state, config = full_warmup(m, {}, state, tmp_path, n_steps=20, desired_energy_var=1e-3,
                                n_chains=2, tune_mass=True, sampler=sampler, log=quiet)
    full_run(m, state, config, tmp_path, n_samples=3, n_runs=2, n_chains=2, thinning=2,
             sampler=sampler, log=quiet)
    done = {i: os.stat(tmp_path / f"run_{i}.npz").st_mtime_ns for i in (1, 2)}
    lines = []
    full_run(m, state, config, tmp_path, n_samples=3, n_runs=3, n_chains=2, thinning=2,
             sampler=sampler, log=lambda *a: lines.append(" ".join(map(str, a))))
    assert "Resuming at run 3..." in lines and "run 3/3" in lines and "run 2/3" not in lines
    assert all(os.stat(tmp_path / f"run_{i}.npz").st_mtime_ns == t for i, t in done.items())
    for i in (1, 2, 3):
        run = npload(tmp_path / f"run_{i}.npz")
        assert run["white_mesh_"].shape == (2, 3, 4) and run["x_"].shape == (2, 3, 3)
        assert np.isfinite(run["logdensity"]).all() and run["n_evals"].shape == (2, 3)
