import numpy as np
import torch


def to_tensor(x, device):
    """Tensor -> moved to `device` (dtype kept); numpy or scalar -> float32
    (complex64 when complex) tensor on `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    x = np.array(x)
    dtype = torch.complex64 if np.iscomplexobj(x) else torch.float32
    return torch.as_tensor(x, dtype=dtype, device=device)
