"""Samplers of the port: MCLMC and MAMS, and the chunked run-and-save
runner.  Parity: `montecosmo_tpu/samplers/{mclmc,runner}.py`."""
from montecosmo_tpu_torch.samplers.mclmc import (
    IntegratorState, MCLMCAdaptationState,
    mclmc_init, mclmc_kernel, mclmc_warmup, mclmc_run, get_mclmc_warmup, get_mclmc_run,
    mams_kernel, mams_warmup, mams_run, get_mams_warmup, get_mams_run,
)
from montecosmo_tpu_torch.samplers.runner import sample_and_save, save_run
