"""Samplers of the port: MCLMC and MAMS, HMC and NUTS with window
adaptation and NUTS-within-Gibbs, Adam MAP optimisation, ADVI, and the
chunked run-and-save runner.  Parity: `montecosmo_tpu/samplers/`, without
the TPU workaround `nuts_host_transition`."""
from montecosmo_tpu_torch.samplers.mclmc import (
    IntegratorState, MCLMCAdaptationState,
    mclmc_init, mclmc_kernel, mclmc_warmup, mclmc_run, get_mclmc_warmup, get_mclmc_run,
    mams_kernel, mams_warmup, mams_run, get_mams_warmup, get_mams_run,
)
from montecosmo_tpu_torch.samplers.hmc import (
    HMCState, hmc_init, nuts_kernel, hmc_kernel, window_adaptation,
    find_reasonable_step_size,
    mwg_warmup, mwg_kernel_general, sampling_loop_general,
    nutswg_init, nutswg_run, get_nutswg_run, nutswg_warm, get_nutswg_warm,
    get_init_state,
)
from montecosmo_tpu_torch.samplers.optimize import optimize
from montecosmo_tpu_torch.samplers.runner import sample_and_save, save_run
from montecosmo_tpu_torch.samplers.vi import advi, ApproxPosterior
