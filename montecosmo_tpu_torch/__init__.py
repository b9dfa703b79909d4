"""montecosmo_tpu_torch: the field-level model of montecosmo_tpu in PyTorch,
with hand-written CUDA kernels for the particle paint and the NUFFT on
Hopper."""
from montecosmo_tpu_torch.models.model import FieldLevelModel, default_config

__all__ = ["FieldLevelModel", "default_config"]
