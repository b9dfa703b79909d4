"""Physics bricks of the main path: reparametrizations, the linear field,
Kaiser boost, Lagrangian bias, box geometry (flat or curved sky, at a fixed
scale factor or on the light cone), RSD and the radial count selection.

Parity: `montecosmo_tpu/models/bricks.py` (cited per function).  Rotations
are 3x3 matrices (`Rotation`), in place of jax.scipy's Rotation objects.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.models.truncnorm import std2trunc, trunc2std
from montecosmo_tpu_torch.ops.background import Background, Cosmology
from montecosmo_tpu_torch.ops.fourier import gradient_hat, invlaplace_hat, irfftn, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import cgh2rg, ch2rshape, rg2cgh
from montecosmo_tpu_torch.ops.interp import take_rows
from montecosmo_tpu_torch.ops.paint import read_multi, read_sites
from montecosmo_tpu_torch.ops.power import lin_power_mesh
from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.safe import safe_div, safe_sqrt


class Rotation:
    """Rotation from a rotation vector (axis * angle, radians)."""

    def __init__(self, rotvec):
        rotvec = np.asarray(rotvec, float)
        theta = float(np.linalg.norm(rotvec))
        if theta == 0.0:
            mat = np.eye(3)
        else:
            k = rotvec / theta
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            mat = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
        self.matrix = mat
        self.identity = theta == 0.0

    def apply(self, v, inverse=False):
        """R v (or R^T v) for vectors along the last axis of `v`."""
        if self.identity:
            return v
        mat = self.matrix.T if inverse else self.matrix
        if torch.is_tensor(v):
            return v @ torch.as_tensor(mat.T, dtype=v.dtype, device=v.device)
        return np.asarray(v) @ mat.T


# ======================================================================= power
def white2lin(cosmo: Cosmology, white_mesh, init_shape, box_size, kpow=None):
    """White-noise mesh -> linear matter mesh (times sqrt(P)).

    Parity: bricks.py:81-88."""
    pmesh = lin_power_mesh(cosmo, init_shape, box_size, kpow=kpow, device=white_mesh.device)
    return white_mesh * safe_sqrt(pmesh)


def lin2white(cosmo: Cosmology, lin_mesh, init_shape, box_size, kpow=None):
    """Linear matter mesh -> white-noise mesh (divided by sqrt(P)).

    Parity: bricks.py:91-98."""
    pmesh = lin_power_mesh(cosmo, init_shape, box_size, kpow=kpow, device=lin_mesh.device)
    return safe_div(lin_mesh, safe_sqrt(pmesh))


def kaiser_boost(cosmo: Cosmology, a, mesh_shape, box_size, b1E, los=(0.0, 0.0, 0.0),
                 bg=None, device="cpu"):
    """Eulerian Kaiser boost growth x (b1E + f mu^2), flat sky, no PNG.

    Parity: bricks.py:102-122."""
    if bg is None:
        bg = Background.create(cosmo, device)
    kvec = rfftk(mesh_shape, box_size, bg.a_tab.device)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    mumesh = safe_div(sum(ki * float(li) for ki, li in zip(kvec, los)), kmesh)
    g, _, f, _ = bg._growth(a)
    return g * (b1E + f * mumesh**2)


def kaiser_posterior(delta_obs, cosmo: Cosmology, a, box_size, var_noise, b1E,
                     los=(0.0, 0.0, 0.0), bg=None):
    """Exact Gaussian posterior (mean, std) fields of the linear matter field
    given the observed field `delta_obs` (rfft mesh), under the flat-sky
    Kaiser model at one scale factor `a`.  Fourier space.

    Parity: bricks.py:170-186."""
    mesh_shape = ch2rshape(delta_obs.shape)
    pmesh = lin_power_mesh(cosmo, mesh_shape, box_size, device=delta_obs.device)
    pmesh = pmesh * float(np.prod(np.divide(mesh_shape, box_size)))  # power in cell units
    boost = kaiser_boost(cosmo, a, mesh_shape, box_size, b1E, los=los, bg=bg,
                         device=delta_obs.device)
    stds = (pmesh / (1 + boost**2 / var_noise * pmesh)) ** 0.5
    means = stds**2 * boost / var_noise * delta_obs
    return means, stds


# ======================================================================= reparametrization
def samp2base(params: dict, config, inv=False, temp=1.0) -> dict:
    """Sample-space <-> base-space transform per scalar latent: affine
    x*scale_fid + loc_fid, or truncated-normal transport when bounded.

    Parity: bricks.py:189-222."""
    out = {}
    for in_name, value in params.items():
        name = in_name if inv else in_name[:-1]
        out_name = in_name + "_" if inv else in_name[:-1]
        conf = config[name]
        low, high = conf.get("low", -np.inf), conf.get("high", np.inf)
        loc_fid = np.asarray(conf["loc_fid"], float)
        scale_fid = np.asarray(conf["scale_fid"], float) * temp**0.5
        bounded = np.any(np.asarray(low) != -np.inf) or np.any(np.asarray(high) != np.inf)

        value = torch.as_tensor(value, dtype=torch.float32)
        value = torch.broadcast_to(value, np.shape(loc_fid))
        f32 = lambda x: torch.as_tensor(
            np.array(np.broadcast_to(np.asarray(x, float), np.shape(loc_fid)), np.float32),
            device=value.device)
        loc, scale = f32(loc_fid), f32(scale_fid)
        if bounded:
            fn = trunc2std if inv else std2trunc
            out[out_name] = fn(value, loc, scale, f32(low), f32(high))
        else:
            out[out_name] = (value - loc) / scale if inv else value * scale + loc
    return out


def samp2base_mesh(init: dict, precond, transfer, inv=False, temp=1.0) -> dict:
    """Sample-space <-> base-space transform of the init mesh: 'real'
    (rfftn) or 'fourier'/'kaiser' (Hermitian repack), times `transfer`.

    Parity: bricks.py:225-250."""
    assert len(init) <= 1, "init dict should only have one or zero key"
    for in_name, mesh in init.items():
        out_name = in_name + "_" if inv else in_name[:-1]
        transfer = transfer * temp**0.5
        if not inv:
            if precond == "real":
                mesh = rfftn(mesh)
            elif precond in ("fourier", "kaiser"):
                mesh = rg2cgh(mesh)
            mesh = mesh * transfer
        else:
            mesh = safe_div(mesh, transfer)
            if precond == "real":
                mesh = irfftn(mesh)
            elif precond in ("fourier", "kaiser"):
                mesh = cgh2rg(mesh)
        return {out_name: mesh}
    return {}


# ======================================================================= bias
def lagrangian_bias(cosmo: Cosmology, pos, a, box_size, lin_mesh, bias, bg,
                    sites_shape):
    """Lagrangian bias weights up to 3rd order plus the Laplacian operator,
    read at the undisplaced particles and scaled by growth powers:

        w = 1 + b1 dL + b2/2 (dL^2 - s2) + bs2 (s^2 - 2/3 s2) + b3/6 (dL^3 - 3 s2 dL)
            + bds2 dL s^2 + bs3 s^3 + bn2 lap(dL)

    plus the velocity-bias displacement dvel = bnpar grad(dL) D.  Returns
    (weights, dvel, phi=0).  No PNG operators (png_type None).  The fields
    are read at the lattice sites by strided slicing when the mesh refines
    the `sites_shape` lattice, else at `pos` with `read_multi` at order 1
    (K4 at NGP): the JAX model always passes read_order=1.

    Parity: bricks.py:254-410 (the fused form)."""
    b1, b2, bs2 = bias["b1"], bias["b2"], bias["bs2"]
    b3, bds2, bs3 = bias["b3"], bias["bds2"], bias["bs3"]
    bn2, bnpar = bias["bn2"], bias["bnpar"]

    growths = bg.a2g(a)
    mesh_shape = ch2rshape(lin_mesh.shape)
    kvec = rfftk(mesh_shape, box_size, lin_mesh.device)
    g = growths.squeeze()

    def shear_comp(lk, i, j):
        pot = lk * invlaplace_hat(kvec)
        nabi = gradient_hat(kvec, i)
        if i == j:
            return irfftn(nabi**2 * pot - lk / 3)
        return irfftn(nabi * gradient_hat(kvec, j) * pot)

    sa = shear_comp(lin_mesh, 0, 0)
    sb = shear_comp(lin_mesh, 1, 1)
    sc = -(sa + sb)
    sd = shear_comp(lin_mesh, 0, 1)
    se = shear_comp(lin_mesh, 0, 2)
    sf = shear_comp(lin_mesh, 1, 2)
    shear2 = sa**2 + sb**2 + sc**2 + 2 * (sd**2 + se**2 + sf**2)
    shear3 = 3 * (sa * (sb * sc - sf**2) - sd * (sd * sc - se * sf)
                  + se * (sd * sf - sb * se))

    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    delta = irfftn(lin_mesh)
    delta_nab2 = irfftn(-(kmesh**2) * lin_mesh)
    grad_fields = [irfftn(gradient_hat(kvec, i) * lin_mesh) for i in range(3)]

    fields = [delta, shear2, shear3, delta_nab2, *grad_fields]
    if sites_shape is not None:
        vals = read_sites(fields, sites_shape)
    else:
        vals = read_multi(pos, fields, 1)
    delta_pos = vals[..., 0] * g
    shear2_pos = vals[..., 1] * g**2
    shear3_pos = vals[..., 2] * g**3
    delta_nab2_pos = vals[..., 3] * g
    delta_nabpar_pos = vals[..., 4:7]

    weights = 1.0 + b1 * delta_pos
    delta2_pos = delta_pos**2
    sigma2 = delta2_pos.mean()
    delta2_pos = delta2_pos - sigma2
    weights = weights + b2 * delta2_pos / 2
    shear2_pos = shear2_pos - 2 / 3 * sigma2
    weights = weights + bs2 * shear2_pos
    weights = weights + b3 * (delta_pos**3 - 3 * sigma2 * delta_pos) / 6
    weights = weights + bds2 * delta_pos * shear2_pos
    weights = weights + bs3 * shear3_pos
    weights = weights + bn2 * delta_nab2_pos

    dvel = bnpar * delta_nabpar_pos * growths
    return weights, dvel, 0.0


def b1_L2E(b1):
    return 1 + b1


# ======================================================================= geometry
def regular_pos(mesh_shape: tuple, ptcl_shape: tuple = None, device="cpu"):
    """Regular particle lattice in cell coordinates, lattice-major order.

    Parity: bricks.py:516-528."""
    if ptcl_shape is None:
        ptcl_shape = mesh_shape
    axes = [torch.arange(p, dtype=torch.float32, device=device) * float(np.float32(m / p))
            for m, p in zip(mesh_shape, ptcl_shape)]
    grid = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grid, -1).reshape(-1, len(mesh_shape))


def cell2phys_pos(pos, box_center, box_rot: Rotation, box_size, mesh_shape):
    """Cell positions -> physical positions (box center + rotation)."""
    pos = pos * to_tensor(np.divide(box_size, mesh_shape), pos.device)
    pos = pos - to_tensor(box_size, pos.device) / 2
    pos = box_rot.apply(pos)
    return pos + to_tensor(box_center, pos.device)


def phys2cell_pos(pos, box_center, box_rot: Rotation, box_size, mesh_shape):
    """Physical positions -> cell positions."""
    pos = pos - to_tensor(box_center, pos.device)
    pos = box_rot.apply(pos, inverse=True)
    pos = pos + to_tensor(box_size, pos.device) / 2
    return pos / to_tensor(np.divide(box_size, mesh_shape), pos.device)


def cell2phys_vel(vel, box_rot: Rotation, box_size, mesh_shape):
    vel = vel * to_tensor(np.divide(box_size, mesh_shape), vel.device)
    return box_rot.apply(vel)


def radius_mesh(box_center, box_rot: Rotation, box_size, mesh_shape, curved_sky=True,
                device="cpu"):
    """Physical distance of each mesh cell from the observer (flat sky: along
    the line of sight), with the JAX package's float32 rounding order: the
    per-axis offsets in float64, rounded to float32, plus the rotated box
    center in float32.

    Parity: bricks.py:577-597."""
    c = box_rot.apply(np.asarray(box_center, float), inverse=True).astype(np.float32)
    if not curved_sky:
        los = (c / np.linalg.norm(c)).astype(np.float32) if np.linalg.norm(c) \
            else np.zeros(3, np.float32)
    out = 0.0
    for ax, (m, b) in enumerate(zip(mesh_shape, box_size)):
        shape = [1, 1, 1]
        shape[ax] = -1
        r = (np.arange(m).reshape(shape) * b / m - b / 2).astype(np.float32)
        rt = torch.as_tensor(r, device=device) + float(c[ax])
        out = out + (rt**2 if curved_sky else rt * float(los[ax]))
    return out**0.5 if curved_sky else out.abs()


def pos_mesh(box_center, box_rot: Rotation, box_size, mesh_shape, device="cpu"):
    """Mesh of physical cell positions, shape (*mesh_shape, 3).

    Parity: bricks.py:600-604."""
    pos = torch.as_tensor(np.indices(mesh_shape, dtype=np.float32).reshape(3, -1).T,
                          device=device)
    pos = cell2phys_pos(pos, box_center, box_rot, box_size, mesh_shape)
    return pos.reshape(tuple(mesh_shape) + (3,))


def _radius_and_los(pos):
    """(|pos|, pos / |pos|) along the last axis, 0 and 0 at the observer."""
    r = torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    return r, safe_div(pos, r)


def los_scalefactor_pos(pos, box_center, box_rot: Rotation, box_size, mesh_shape,
                        bg: Background, a_obs=None, curved_sky=True):
    """Per-particle line of sight and scale factor: curved sky, the unit
    vector to each particle (P, 3); flat sky, the box center's direction.
    With a_obs None (the light cone) a = chi2a of the particle's radius (or
    its distance along the line of sight), else a_obs.

    Parity: bricks.py:633-649."""
    if curved_sky:
        pos = cell2phys_pos(pos, box_center, box_rot, box_size, mesh_shape)
        rpos, los = _radius_and_los(pos)
        return los, (bg.chi2a(rpos) if a_obs is None else a_obs)
    los = safe_div(np.asarray(box_center, float), np.linalg.norm(box_center))
    if a_obs is not None:
        return los, a_obs
    pos = cell2phys_pos(pos, box_center, box_rot, box_size, mesh_shape)
    rpos = (pos * to_tensor(los, pos.device)).sum(-1, keepdim=True).abs()
    return los, bg.chi2a(rpos)


def los_scalefactor_mesh(box_center, box_rot: Rotation, box_size, mesh_shape,
                         bg: Background, a_obs=None, curved_sky=True):
    """Per-cell line of sight ((X, Y, Z, 3) on the curved sky) and scale
    factor (per cell on the light cone, else a_obs).

    Parity: bricks.py:652-664."""
    device = bg.a_tab.device
    if curved_sky:
        rmesh, los = _radius_and_los(pos_mesh(box_center, box_rot, box_size, mesh_shape, device))
        rmesh = rmesh[..., 0]
        return los, (bg.chi2a(rmesh) if a_obs is None else a_obs)
    los = safe_div(np.asarray(box_center, float), np.linalg.norm(box_center))
    if a_obs is not None:
        return los, a_obs
    return los, bg.chi2a(radius_mesh(box_center, box_rot, box_size, mesh_shape, False, device))


def rsd(bg: Background, vel, los, a, box_rot, box_size, mesh_shape, dvel=0.0):
    """Redshift-space displacement along the line of sight: one direction
    (flat sky) or one per particle (curved sky, `los` (P, 3)).

    Parity: bricks.py:667-675."""
    vel = cell2phys_vel(vel, box_rot, box_size, mesh_shape)
    g, _, f, _ = bg._growth(a)
    vel = vel * g * f + dvel
    los = to_tensor(los, vel.device)
    return (vel * los).sum(-1, keepdim=True) * los


def set_radial_count(mesh, rmesh, redges, rcounts):
    """Multiply mesh by each cell's per-radial-bin count (right-closed bins
    (low, high]; cells outside every bin are left unchanged).

    Parity: bricks.py:941-981 (select chain for <= 4 bins, uniform-edge ceil
    lookup, searchsorted otherwise)."""
    redges = np.asarray(redges, np.float64)
    n_bins = rcounts.shape[0]
    assert len(redges) == n_bins + 1
    if n_bins <= 4:
        out = mesh
        for b in range(n_bins):
            rmask = (float(np.float32(redges[b])) < rmesh) & (rmesh <= float(np.float32(redges[b + 1])))
            out = torch.where(rmask, out * rcounts[b], out)
        return out
    idx = radial_bin_index(rmesh, redges)
    inside = (idx >= 0) & (idx < n_bins)
    mult = take_rows(rcounts, torch.clamp(idx, 0, n_bins - 1))
    return mesh * torch.where(inside, mult, torch.ones_like(mult))


def count2delta(mesh, selec_mesh):
    """Counts -> overdensity imposing the global integral constraint against
    the selection.

    Parity: bricks.py:762-769."""
    alpha_selec = selec_mesh * mesh.mean() / selec_mesh.mean()
    return (mesh - alpha_selec) / (alpha_selec**2).mean() ** 0.5


def radial_bin_index(rmesh, redges):
    """Per-cell bin index of `set_radial_count` (< 0 or >= n_bins: outside):
    bin b holds the radii in (e_b, e_{b+1}], e the float32 edges.  The JAX
    package's ceil lookup on uniform edges may put a radius on an edge in
    the adjacent bin; this lookup does not."""
    edges = torch.as_tensor(np.asarray(redges, np.float32), device=rmesh.device).to(rmesh.dtype)
    return torch.searchsorted(edges, rmesh.contiguous(), right=False) - 1
