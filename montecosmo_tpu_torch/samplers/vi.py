"""Mean-field Gaussian ADVI over the unconstrained sample space.

q = N(mu, diag sigma^2) over the raveled latent dict; the reparametrised
ELBO E_{eps~N(0,I)}[logpdf(mu + sigma * eps)] + sum(log sigma) + const is
maximised with Adam at lr0 / sqrt(1 + 0.1 t).

Parity: `montecosmo_tpu/samplers/vi.py` (same names and updates).  The
`n_mc` Monte-Carlo samples of a step are a loop (the JAX package vmaps
them).  Where the JAX package draws eps from `seed`, the port takes an
integer seed, a torch.Generator, or the (n_steps, n_mc, d) draws.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.samplers.mclmc import _ravel
from montecosmo_tpu_torch.samplers.optimize import adam_schedule


def _eps(seed, n_steps, n_mc, like):
    """The (n_steps, n_mc, d) standard normal draws of the ELBO gradients."""
    if torch.is_tensor(seed):
        return seed.to(like)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(
        device=like.device).manual_seed(int(seed))
    return torch.randn((n_steps, n_mc) + tuple(like.shape), generator=gen,
                       device=gen.device).to(like)


def advi(logpdf, start, n_steps=1000, n_mc=4, lr0=1e-2, seed=0, init_log_sigma=-2.0, scan=True):
    """Fit q = N(mu, diag sigma^2) to exp(logpdf) by stochastic ELBO ascent.

    logpdf : dict -> scalar joint log-density (sample-space params).
    start  : initial latent dict (e.g. a prior sample or fiducial point).
    n_mc   : Monte-Carlo samples per ELBO gradient.
    Returns (ApproxPosterior, ELBO trace (n_steps,), the ELBO before each
    update; a list of floats with scan=False)."""
    x0, unravel = _ravel({k: torch.as_tensor(v).detach() for k, v in start.items()})
    mu = x0.clone().requires_grad_(True)
    log_sigma = torch.full_like(x0, init_log_sigma).requires_grad_(True)
    opt, sched = adam_schedule([mu, log_sigma], lr0, decay=0.1)
    eps = _eps(seed, n_steps, n_mc, x0)
    elbos = []
    for e in eps:
        opt.zero_grad()
        with torch.enable_grad():
            lps = torch.stack([logpdf(unravel(mu + torch.exp(log_sigma) * z)) for z in e])
            elbo = lps.mean() + log_sigma.sum()
            (-elbo).backward()
        opt.step()
        sched.step()
        elbos.append(elbo.detach())
    post = ApproxPosterior(mu.detach(), torch.exp(log_sigma.detach()), unravel)
    return post, torch.stack(elbos) if scan else [float(v) for v in elbos]


class ApproxPosterior:
    """Mean-field Gaussian posterior approximation over a latent dict."""

    def __init__(self, mu, sigma, unravel):
        self.mu, self.sigma, self._unravel = mu, sigma, unravel

    @property
    def mean(self):
        return self._unravel(self.mu)

    @property
    def std(self):
        return self._unravel(self.sigma)

    def sample(self, gen, n=1):
        """n draws as a dict of (n, ...) tensors; `gen` is a torch.Generator
        or the (n, d) standard normal draws."""
        eps = gen.to(self.mu) if torch.is_tensor(gen) else torch.randn(
            (n, self.mu.shape[0]), generator=gen, device=gen.device).to(self.mu)
        draws = [self._unravel(self.mu + self.sigma * e) for e in eps]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}

    def log_prob(self, params):
        x, _ = _ravel(params)
        z = (x - self.mu) / self.sigma
        return torch.sum(-0.5 * z**2 - torch.log(self.sigma) - 0.5 * np.log(2 * np.pi))
