"""Laplace approximation: marginal covariance of a small scalar-parameter
block given a large field, without materialising the field Hessian.

For a potential U(x, y) with Hessian blocks [[A, B], [B^T, D]] (x small,
y the field), the marginal covariance on x is the inverse Schur complement
(A - B D^-1 B^T)^-1, D approximated by its diagonal:

  * A        - dense (m, m) Hessian on the scalar block,
  * C = B^T  - the (n, m) cross block, column j = grad_y (dU/dx_j),
  * diag(D)  - exact basis probes of the y-Hessian diagonal, or Hutchinson
               estimates,
  * Schur    - A minus C^T (C / diag(D)).

Parity: `montecosmo_tpu/lapprox.py` (same names and results).  The JAX
package computes forward over reverse (`linearize`, `jacfwd`); the port
reverse over reverse: one forward and one gradient with `create_graph`,
then one backward of that gradient per Hessian-vector product
(`torch.autograd.grad(g @ v, x)`).  Probes run in a loop, one at a time on
the one gradient graph, not under `torch.func.vmap` (the kernels' autograd
Functions carry no vmap rule).
"""
import torch

__all__ = ["marginal_covariance", "hessian_diag", "hessian_diag_stochastic",
           "cov_x_from_pot_x_y"]


def _grad_graph(f, *xs):
    """(leaves, gradient of f at xs with its graph kept): the first half of
    every Hessian-vector product below."""
    leaves = [x.detach().clone().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        grads = torch.autograd.grad(f(*leaves), leaves, create_graph=True)
    return leaves, grads


def _hvp(grad, leaves, v):
    """grad(grad . v) w.r.t. `leaves`, the graph kept for the next probe (a
    leaf the product does not reach gets zeros)."""
    with torch.enable_grad():
        out = torch.autograd.grad(grad @ v, leaves, retain_graph=True, allow_unused=True)
    return [torch.zeros_like(x) if o is None else o.detach() for x, o in zip(leaves, out)]


def _rademacher(key, n_probes, like):
    """(n_probes, n) Rademacher probes: `key` itself when a tensor (the
    caller's draws), else from the torch.Generator or integer seed `key`."""
    if torch.is_tensor(key):
        return key.to(like)
    gen = key if isinstance(key, torch.Generator) else torch.Generator(
        device=like.device).manual_seed(0 if key is None else int(key))
    bits = torch.randint(0, 2, (n_probes,) + tuple(like.shape), generator=gen,
                         device=gen.device)
    return (2 * bits - 1).to(like)


def _diag_exact(g, y):
    """diag of the Hessian whose gradient graph is g(y): H_kk = (H e_k)_k,
    one Hessian-vector product per basis probe."""
    diag = torch.empty_like(y)
    for k in range(y.shape[0]):
        e = torch.zeros_like(y)
        e[k] = 1
        diag[k] = _hvp(g, [y], e)[0][k]
    return diag


def _diag_hutchinson(g, y, probes):
    """Hutchinson estimate of that diagonal: the mean of r * (H r)."""
    return torch.stack([r * _hvp(g, [y], r)[0] for r in probes]).mean(0)


def hessian_diag(f, y):
    """Exact diag of the Hessian of f at y, one basis probe at a time on one
    gradient graph."""
    (yl,), (g,) = _grad_graph(f, y)
    return _diag_exact(g, yl)


def hessian_diag_stochastic(f, y, n_probes=64, key=None):
    """Hutchinson estimate of diag(H): mean of r * (H r), r Rademacher.
    `key`: a torch.Generator, an integer seed, or the (n_probes, n) probes."""
    (yl,), (g,) = _grad_graph(f, y)
    return _diag_hutchinson(g, yl, _rademacher(key, n_probes, y))


def marginal_covariance(pot_fn, x, y, method="exact", chunk_size=None, ridge=1e-9, key=None):
    """Marginal covariance of x under the Laplace approximation at (x, y).

    pot_fn : (x (m,), y (n,)) -> scalar potential (negative log density).
    method : 'exact' (basis probes of diag D) or 'hutchinson' (`chunk_size`
             probes, n when None; `key` as in `hessian_diag_stochastic`).
    ridge  : added to diag(D) before inversion.
    Returns (cov_x (m, m), schur (m, m))."""
    m, n = x.shape[0], y.shape[0]
    chunk_size = n if chunk_size is None else chunk_size
    (xl, yl), (gx, gy) = _grad_graph(pot_fn, x, y)
    # row j of [A, B]: one backward of dU/dx_j gives A's row and C's column
    rows = [_hvp(gx, [xl, yl], torch.eye(m, dtype=x.dtype, device=x.device)[j])
            for j in range(m)]
    A = torch.stack([r[0] for r in rows])
    C = torch.stack([r[1] for r in rows], 1)
    if method == "exact":
        d = _diag_exact(gy, yl)
    elif method == "hutchinson":
        d = _diag_hutchinson(gy, yl, _rademacher(key, chunk_size, y))
    else:
        raise ValueError(f"unknown method {method!r}")
    correction = C.T @ (C / (d + ridge)[:, None])
    schur = A - correction
    schur = 0.5 * (schur + schur.T)
    return torch.linalg.inv(schur), schur


def cov_x_from_pot_x_y(pot_fn, x, y, method="exact", chunk_size=None, eps_diag=1e-9):
    """The reference's name of `marginal_covariance`."""
    return marginal_covariance(pot_fn, x, y, method=method, chunk_size=chunk_size,
                               ridge=eps_diag)
