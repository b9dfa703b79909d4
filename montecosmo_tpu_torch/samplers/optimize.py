"""MAP optimisation: Adam on the potential with a 1/sqrt(t) learning-rate
decay.

Parity: `montecosmo_tpu/samplers/optimize.py` (optax.adam with the schedule
lr0 / sqrt(1 + t)).  `torch.optim.Adam` under a `LambdaLR` of the same
schedule takes the same steps: both divide the bias-corrected first moment
by sqrt(bias-corrected second moment) + eps, eps = 1e-8 (optax's eps_root
is 0), with betas (0.9, 0.999), and the first step at t = 0.
"""
import torch


def adam_schedule(params, lr0, decay=1.0):
    """(Adam on `params`, its LambdaLR at lr0 / sqrt(1 + decay t))."""
    opt = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: (1.0 + decay * t) ** -0.5)
    return opt, sched


def optimize(potential, start, lr0=0.1, n_epochs=100, scan=True):
    """Minimise `potential` (a dict of tensors -> scalar) from `start` with
    Adam and a 1/sqrt(t) learning-rate decay.

    Returns (params, potential values before each update): a tensor, or with
    scan=False a list of floats, as the JAX function returns them."""
    params = {k: torch.as_tensor(v).detach().clone().requires_grad_(True)
              for k, v in start.items()}
    opt, sched = adam_schedule(list(params.values()), lr0)
    values = []
    for _ in range(n_epochs):
        opt.zero_grad()
        with torch.enable_grad():
            value = potential(params)
            value.backward()
        opt.step()
        sched.step()
        values.append(value.detach())
    params = {k: v.detach() for k, v in params.items()}
    return params, torch.stack(values) if scan else [float(v) for v in values]
