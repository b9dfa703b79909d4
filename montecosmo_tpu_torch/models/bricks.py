"""Physics bricks of the model paths: reparametrizations, the linear field
and its local primordial non-Gaussianity (PNG), the Kaiser boost and the
Kaiser (linear) galaxy field, Lagrangian and Eulerian bias with their PNG
operators, box geometry (flat or curved sky, at a fixed scale factor or on
the light cone), RSD, the Alcock-Paczynski (AP) remaps, the radial count
selection, and the catalogs and selections of a register (sky coordinates,
the box fitted to randoms, the painted selection, footprint and counts).

Parity: `montecosmo_tpu/models/bricks.py` (cited per function).  Rotations
are 3x3 matrices (`Rotation`), in place of jax.scipy's Rotation objects.
"""
import numpy as np
import torch

from montecosmo_tpu_torch.metrics import optim_mu2_delta
from montecosmo_tpu_torch.models.truncnorm import std2trunc, trunc2std
from montecosmo_tpu_torch.ops.background import RH, Background, Cosmology, Esqr
from montecosmo_tpu_torch.ops.fourier import gradient_hat, invlaplace_hat, irfftn, rfftk, rfftn
from montecosmo_tpu_torch.ops.hermitian import cgh2rg, ch2rshape, rg2cgh
from montecosmo_tpu_torch.ops.interp import log_uniform_interp_fn, take_rows
from montecosmo_tpu_torch.ops.paint import nufft, paint, read_multi, read_sites
from montecosmo_tpu_torch.ops.power import lin_power, lin_power_mesh
from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.geometry import cart2radecrad, radecrad2cart
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


# ======================================================================= power / PNG
def trans_phi2delta_interp(cosmo: Cosmology, a=1.0, kpow=None, n_interp=256, bg=None):
    """Interpolator k-mesh -> the primordial-potential to linear-density
    transfer 2 rh^2 k^2 T(k) D(a) / (3 Omega_m) (arXiv:1904.08859), linear
    in k between the log-uniform nodes of `lin_power` (the lookup of
    `lin_power_interp`: one stacked-pair gather, K9 its backward).

    Parity: bricks.py:30-51 (`log_uniform_interp_fn` on the EH98 nodes or a
    register's table)."""
    if bg is None:
        bg = Background.create(cosmo)
    ks, pow_lin = lin_power(cosmo, kpow=kpow, n_interp=n_interp, device=bg.a_tab.device)
    pow_large = ks**cosmo.n_s  # primordial power on large scales
    lin_trans = (pow_lin / pow_large / (pow_lin[0] / pow_large[0])) ** 0.5
    a_md = 1.0 / (1.0 + 10.0)  # matter-dominated era
    growth_md = bg.a2g(a_md) / a_md  # constant during matter domination
    norm_growth = bg.a2g(a) / growth_md
    trans = 2.0 * RH**2 * ks**2 * lin_trans * norm_growth / (3.0 * cosmo.Omega_m)
    nodes = np.logspace(-4, 1, n_interp) if kpow is None else np.asarray(kpow[0])
    return log_uniform_interp_fn(nodes, trans, left=0.0, right=0.0)


def _kmesh(mesh_shape, box_size, device):
    return sum(ki**2 for ki in rfftk(mesh_shape, box_size, device)) ** 0.5


def phi_transfer(cosmo: Cosmology, lin_mesh, box_size, kpow=None, bg=None):
    """The primordial potential of the linear rfft mesh, lin / transfer (0
    where the transfer is 0), and the transfer on its k-mesh."""
    kmesh = _kmesh(ch2rshape(lin_mesh.shape), box_size, lin_mesh.device)
    trans = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh)
    return safe_div(lin_mesh, trans), trans


def add_png(fNL, phi, trans):
    """Local PNG: the primordial potential `phi` (real space) -> phi + fNL
    (phi^2 - <phi^2>), back to the linear density's rfft mesh through the
    transfer `trans` (both from `phi_transfer` of the linear mesh).

    Parity: bricks.py:54-66."""
    phi2 = phi**2
    phi = phi + fNL * (phi2 - phi2.mean())
    return trans * rfftn(phi)


def white_noise(gen: torch.Generator, mesh_shape, box_size):
    """Unit-power white noise in Fourier space, physical units, drawn from
    `gen` on its device.

    Parity: bricks.py:70-78 (the draw from a torch.Generator, not a JAX
    key: the two packages' streams differ)."""
    white = rg2cgh(torch.randn(tuple(mesh_shape), generator=gen, device=gen.device))
    return white * float(np.prod(np.divide(mesh_shape, box_size)) ** 0.5)


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


def kaiser_boost(cosmo: Cosmology, a, mesh_shape, box_size, b1E, fNL_bp=0.0, png_type=None,
                 los=(0.0, 0.0, 0.0), kpow=None, bg=None, device="cpu"):
    """Eulerian Kaiser boost growth x (b1E + f mu^2), flat sky, plus the PNG
    scale-dependent term fNL_bp / transfer(k) when png_type is set.

    Parity: bricks.py:102-122."""
    if bg is None:
        bg = Background.create(cosmo, device)
    kvec = rfftk(mesh_shape, box_size, bg.a_tab.device)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    mumesh = safe_div(sum(ki * float(li) for ki, li in zip(kvec, los)), kmesh)
    g, _, f, _ = bg._growth(a)
    boost = g * (b1E + f * mumesh**2)
    if png_type is not None:
        boost = boost + safe_div(fNL_bp, trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh))
    return boost


def kaiser_model(cosmo: Cosmology, a, lin_mesh, box_size, b1E, fNL_bp=0.0, png_type=None,
                 los=(0.0, 0.0, 0.0), kpow=None, bg=None):
    """Linear (Kaiser) galaxy field 1 + delta_g in real space: growth,
    Eulerian bias b1E, RSD and, with png_type set, the PNG term fNL_bp phi,
    in one of three regimes by the shapes of `a` and `los`:
    * flat sky at one scale factor (los (3,), `a` a number): diagonal in
      Fourier, irfftn(lin_mesh (g (b1E + f mu^2) + fNL_bp / transfer));
    * flat-sky light cone (los (3,), `a` a per-cell mesh): two irffts,
      g(a) (b1E irfftn(lin_mesh) + f(a) irfftn(mu^2 lin_mesh)), plus
      fNL_bp irfftn(phi);
    * curved sky (`los` a per-cell unit field (X, Y, Z, 3)): the mu^2 field
      through the Y_2m decomposition (`metrics.optim_mu2_delta`), plus the
      same PNG term.
    g and f come from one lookup of the stacked growth table
    (`Background._growth`).

    Parity: bricks.py:125-167."""
    if bg is None:
        bg = Background.create(cosmo, lin_mesh.device)
    mesh_shape = ch2rshape(lin_mesh.shape)
    flat = not torch.is_tensor(los) or los.ndim == 1
    if flat and not torch.is_tensor(a):  # flat sky, one scale factor
        boost = kaiser_boost(cosmo, a, mesh_shape, box_size, b1E, fNL_bp=fNL_bp,
                             png_type=png_type, los=los, kpow=kpow, bg=bg)
        return 1 + irfftn(lin_mesh * boost)
    g, _, f, _ = bg._growth(a)
    if flat:  # flat-sky light cone
        kvec = rfftk(mesh_shape, box_size, lin_mesh.device)
        kmesh = sum(ki**2 for ki in kvec) ** 0.5
        mumesh = safe_div(sum(ki * float(li) for ki, li in zip(kvec, los)), kmesh)
        delta = g * (b1E * irfftn(lin_mesh) + f * irfftn(mumesh**2 * lin_mesh))
    else:  # curved sky
        delta, mu2_delta = optim_mu2_delta(lin_mesh, los)
        delta = g * (b1E * delta + f * mu2_delta)
    if png_type is not None:
        delta = delta + fNL_bp * irfftn(phi_transfer(cosmo, lin_mesh, box_size, kpow, bg)[0])
    return 1 + delta


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
def shear_comp(mesh, kvec, i, j):
    """Component (i, j) of the traceless tidal tensor of the rfft mesh
    `mesh`, in real space: irfftn((k_i k_j / k^2 - delta_ij / 3) mesh)."""
    pot = mesh * invlaplace_hat(kvec)
    nabi = gradient_hat(kvec, i)
    if i == j:
        return irfftn(nabi**2 * pot - mesh / 3)
    return irfftn(nabi * gradient_hat(kvec, j) * pot)


def lagrangian_bias(pos, a, box_size, lin_mesh, bias, bg, sites_shape, png=None, phik=None):
    """Lagrangian bias weights up to 3rd order plus the Laplacian operator
    and, given the primordial potential's rfft mesh `phik` (from
    `phi_transfer`), the PNG operators, read at the undisplaced particles
    and scaled by growth powers:

        w = 1 + b1 dL + b2/2 (dL^2 - s2) + bs2 (s^2 - 2/3 s2) + b3/6 (dL^3 - 3 s2 dL)
            + bds2 dL s^2 + bs3 s^3 + bn2 lap(dL)
            + fNL (bp phi + bpd phi dL + bpd2 phi dL^2 + bps2 phi s^2 + bn2p lap(phi))

    (`png` the effective amplitudes of `fNL_bias`), plus the velocity-bias
    displacement dvel = bnpar grad(dL) D.  Returns (weights, dvel, phi):
    phi the full primordial-potential mesh given `phik` (a likelihood
    input), else 0.  The fields are read at the lattice sites by strided
    slicing when the mesh refines the `sites_shape` lattice, else at `pos`
    with `read_multi` at order 1 (K4 at NGP): the JAX model always passes
    read_order=1.

    Parity: bricks.py:254-410 (the fused form)."""
    b1, b2, bs2 = bias["b1"], bias["b2"], bias["bs2"]
    b3, bds2, bs3 = bias["b3"], bias["bds2"], bias["bs3"]
    bn2, bnpar = bias["bn2"], bias["bnpar"]

    growths = bg.a2g(a)
    mesh_shape = ch2rshape(lin_mesh.shape)
    kvec = rfftk(mesh_shape, box_size, lin_mesh.device)
    g = growths.squeeze()

    sa = shear_comp(lin_mesh, kvec, 0, 0)
    sb = shear_comp(lin_mesh, kvec, 1, 1)
    sc = -(sa + sb)
    sd = shear_comp(lin_mesh, kvec, 0, 1)
    se = shear_comp(lin_mesh, kvec, 0, 2)
    sf = shear_comp(lin_mesh, kvec, 1, 2)
    shear2 = sa**2 + sb**2 + sc**2 + 2 * (sd**2 + se**2 + sf**2)
    shear3 = 3 * (sa * (sb * sc - sf**2) - sd * (sd * sc - se * sf)
                  + se * (sd * sf - sb * se))

    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    delta = irfftn(lin_mesh)
    delta_nab2 = irfftn(-(kmesh**2) * lin_mesh)
    grad_fields = [irfftn(gradient_hat(kvec, i) * lin_mesh) for i in range(3)]

    fields = [delta, shear2, shear3, delta_nab2, *grad_fields]
    phi = 0.0
    if phik is not None:
        phi = irfftn(phik)
        fields += [phi, irfftn(-(kmesh**2) * phik)]
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

    if phik is not None:
        phi_pos, phi_nab2_pos = vals[..., 7], vals[..., 8]
        weights = weights + png["fNL_bp"] * phi_pos
        phi_delta_pos = phi_pos * delta_pos
        sigma_pd = phi_delta_pos.mean()
        weights = weights + png["fNL_bpd"] * (phi_delta_pos - sigma_pd)
        # delta2_pos is renormalized already: only the cross term remains
        weights = weights + png["fNL_bpd2"] * (phi_pos * delta2_pos - 2 * sigma_pd * delta_pos)
        weights = weights + png["fNL_bps2"] * phi_pos * shear2_pos
        weights = weights + png["fNL_bn2p"] * phi_nab2_pos

    dvel = bnpar * delta_nabpar_pos * growths
    return weights, dvel, phi


def velocity_bias(pos, a, box_size, lin_mesh, bnpar, bg, sites_shape):
    """The Lagrangian velocity-bias displacement bnpar grad(dL) D at the
    undisplaced particles: the part of `lagrangian_bias` that the Eulerian
    path takes (its RSD), the same values (the three gradient fields read
    at the sites, or at `pos` at order 1)."""
    kvec = rfftk(ch2rshape(lin_mesh.shape), box_size, lin_mesh.device)
    fields = [irfftn(gradient_hat(kvec, i) * lin_mesh) for i in range(3)]
    if sites_shape is not None:
        vals = read_sites(fields, sites_shape)
    else:
        vals = read_multi(pos, fields, 1)
    return bnpar * vals * bg.a2g(a)


def b1_L2E(b1):
    return 1 + b1


def b1_E2L(b1):
    return b1 - 1


def b2_L2E(b2, b1L):
    return b2 + 8 / 21 * b1L


def b2_E2L(b2, b1L):
    return b2 - 8 / 21 * b1L


def bpd_L2E(bpd, bp):
    return bpd + bp / 2


def bpd_E2L(bpd, bp):
    return bpd - bp / 2


def b_phi(b1, p=1.0, delta_c=1.686):
    """Universal-mass-relation primordial bias 2 dc (b1 + 1 - p)
    (arXiv:0911.0017, arXiv:2107.06887)."""
    return 2 * delta_c * (b1 + 1 - p)


def b_phi_delta(b1, b2, delta_c=1.686):
    """Primordial-density bias 2 (dc b2 - b1)."""
    return 2 * (delta_c * b2 - b1)


def fNL_bias(png, bias, p=1.0, png_type=None):
    """The effective amplitudes fNL b_phi and fNL b_phi_delta of png_type:
    'fNL' from the universal mass relation of b1, b2; 'bias' the sampled
    fNL_bp, fNL_bpd times fNL; None the sampled values as they are.

    Parity: bricks.py:448-466."""
    fNL, fNL_bp, fNL_bpd = png["fNL"], png["fNL_bp"], png["fNL_bpd"]
    b1, b2 = bias["b1"], bias["b2"]
    if png_type == "fNL":
        fNL_bp = fNL * b_phi(b1, p)
        fNL_bpd = fNL * b_phi_delta(b1, b2)
    elif png_type == "bias":
        fNL_bp = fNL * fNL_bp
        fNL_bpd = fNL * fNL_bpd
    return dict(png) | {"fNL_bp": fNL_bp, "fNL_bpd": fNL_bpd}


def eulerian_bias(matter_mesh, box_size, bias, phi_mesh=None, png=None, png_type=None):
    """Renormalized Eulerian bias operators applied to the advected matter
    mesh (an rfft mesh) and, with png_type set, to the advected primordial
    potential `phi_mesh` (an rfft mesh):

        w = 1 + b1E d + fNL bp phi + fNL bpdE (phi d - <phi d>)
            + b2E/2 (d^2 - s2) + bs2 (s^2 - 2/3 s2) + bn2 lap(d)

    with b1E, b2E, bpdE the Eulerian biases of the Lagrangian b1, b2, bpd
    (arXiv:1611.09787 eqs. 3.38, 7.10, 7.11) and `png` the effective
    amplitudes of `fNL_bias`.  Returns w in real space.

    Parity: bricks.py:469-513."""
    b1, b2, bs2, bn2 = bias["b1"], bias["b2"], bias["bs2"], bias["bn2"]
    b1, b2 = b1_L2E(b1), b2_L2E(b2, b1)
    matter_mesh = matter_mesh.clone()
    matter_mesh[0, 0, 0] = 0.0  # zero mean
    delta = irfftn(matter_mesh)
    kvec = rfftk(delta.shape, box_size, delta.device)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5

    weights = 1.0 + b1 * delta
    if png_type is not None:
        fNL, fNL_bp = png["fNL"], png["fNL_bp"]
        fNL_bpd = fNL * bpd_L2E(safe_div(png["fNL_bpd"], fNL), safe_div(fNL_bp, fNL))
        phi = irfftn(phi_mesh)
        weights = weights + fNL_bp * phi
        phi_delta = phi * delta
        weights = weights + fNL_bpd * (phi_delta - phi_delta.mean())
    delta2 = delta**2
    sigma2 = delta2.mean()
    weights = weights + b2 * (delta2 - sigma2) / 2

    shear2 = 0.0
    for i in range(3):
        for j in range(i, 3):
            shear2 = shear2 + (1 if i == j else 2) * shear_comp(matter_mesh, kvec, i, j) ** 2
    weights = weights + bs2 * (shear2 - 2 / 3 * sigma2)
    return weights + bn2 * irfftn(-(kmesh**2) * matter_mesh)


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


# ======================================================================= AP
def scale_pos(pos, los, scale_par, scale_perp):
    """Scale positions along and across the line of sight `los` ((3,) or
    one per position)."""
    los = to_tensor(los, pos.device).to(pos.dtype)
    pos_par = (pos * los).sum(-1, keepdim=True) * los
    return pos_par * scale_par + (pos - pos_par) * scale_perp


def parperp2isoap(alpha_par, alpha_perp):
    return (alpha_par * alpha_perp**2) ** (1 / 3), alpha_par / alpha_perp


def isoap2parperp(alpha_iso, alpha_ap):
    return alpha_iso * alpha_ap ** (2 / 3), alpha_iso * alpha_ap ** (-1 / 3)


def _ap_radius(pos, los, curved_sky):
    """The distance the AP remap reads: |pos| (curved sky) or |pos . los|."""
    if curved_sky:
        return torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    return (pos * to_tensor(los, pos.device).to(pos.dtype)).sum(-1, keepdim=True).abs()


def _ap_alpha(bg: Background, bg_fid: Background):
    """r -> chi_fid(a(r)) / r: the sampled cosmology's scale factor at r,
    at the fiducial cosmology's distance."""
    return lambda r: safe_div(bg_fid.a2chi(bg.chi2a(r)), r)


def ap_auto(pos, los, bg: Background, bg_fid: Background, curved_sky=True):
    """Automatic Alcock-Paczynski: each position scaled by chi_fid(a(r)) / r,
    r its distance (curved sky) or its distance along the line of sight.

    Parity: bricks.py:678-691."""
    return pos * _ap_alpha(bg, bg_fid)(_ap_radius(pos, los, curved_sky))


def ap_auto_absdetjac(pos, los, bg: Background, bg_fid: Background, curved_sky=True):
    """`ap_auto` and the |det Jacobian| of its remap, alpha^(d-1) (alpha +
    r alpha'(r)) (d = 3 on the curved sky, 1 along the flat sky's line of
    sight): alpha' by autograd, itself differentiable (create_graph).

    Parity: bricks.py:694-724."""
    alpha_fn = _ap_alpha(bg, bg_fid)
    rpos = _ap_radius(pos, los, curved_sky)
    new_pos = pos * alpha_fn(rpos)
    with torch.enable_grad():
        r = rpos.squeeze(-1)
        if not r.requires_grad:
            r = r.detach().requires_grad_(True)
        alpha = alpha_fn(r)
        (dalpha,) = torch.autograd.grad(alpha.sum(), r, create_graph=True)
    adj = alpha + r * dalpha
    if curved_sky:
        adj = adj * alpha**2
    return new_pos, adj


def ap_param(pos, los, alphas, curved_sky=True):
    """Parametrized AP: isotropic scaling by alpha_iso (curved sky), or
    alpha_par along and alpha_perp across the line of sight (flat sky).

    Parity: bricks.py:719-724."""
    if curved_sky:
        return pos * alphas["alpha_iso"]
    alpha_par, alpha_perp = isoap2parperp(alphas["alpha_iso"], alphas["alpha_ap"])
    return scale_pos(pos, los, alpha_par, alpha_perp)


def rsd_ap_auto(pos, vel, rpos, los, a, bg: Background, bg_fid: Background, curved_sky=True):
    """RSD and automatic AP in one remap: the scale factor redshifted by the
    line-of-sight velocity, 1/a_obs = 1/a + v_los E(a) / rh, then placed at
    the fiducial distance chi_fid(a_obs) (radially on the curved sky, along
    the line of sight on the flat sky, where positions behind the observer
    flip the velocity's sign).

    Parity: bricks.py:727-743."""
    los = to_tensor(los, pos.device).to(pos.dtype)
    vel_los = (vel * los).sum(-1, keepdim=True)
    if not curved_sky:
        vel_los = vel_los * torch.sign((pos * los).sum(-1, keepdim=True))
    a = (1 / a + vel_los * torch.sqrt(Esqr(bg.cosmo, a)) / RH) ** -1
    alpha = safe_div(bg_fid.a2chi(a), rpos)
    if curved_sky:
        return pos * alpha
    return scale_pos(pos, los, alpha, 1.0)


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


# ======================================================================= selection / catalogs
def radecz2cart(bg: Background, radecz: dict):
    """(RA, DEC, Z) in degrees -> cartesian Mpc/h (P, 3), float32 on the
    background's device.

    Parity: bricks.py:747-752."""
    device = bg.a_tab.device
    z = torch.as_tensor(np.asarray(radecz["Z"], np.float32), device=device)
    return radecrad2cart(radecz["RA"], radecz["DEC"], bg.a2chi(1 / (1 + z)), device)


def cart2radecz(bg: Background, cart):
    """Cartesian Mpc/h -> {RA, DEC, Z}.

    Parity: bricks.py:755-759."""
    ra, dec, radius = cart2radecrad(cart, bg.a_tab.device)
    return {"RA": ra, "DEC": dec, "Z": 1 / bg.chi2a(radius) - 1}


def _unit_mean_in_support(selec):
    return selec / selec[selec > 0].mean()


def top_hat_selection(mesh_shape, padding=0.0, norm_order: float = np.inf,
                      pow_order: float = np.inf, device="cpu"):
    """lp-ball selection mesh with a padded fraction, unit mean within its
    support.

    Parity: bricks.py:772-795."""
    norm_order = float(norm_order)
    rvec = []
    for ax, m in enumerate(mesh_shape):
        shape = [1, 1, 1]
        shape[ax] = -1
        rvec.append(np.abs((np.arange(m) + 0.5) * 2 / m - 1).reshape(shape))
    if norm_order == np.inf:
        rmesh = np.maximum(np.maximum(rvec[0], rvec[1]), rvec[2])
    elif norm_order == -np.inf:
        rmesh = np.minimum(np.minimum(rvec[0], rvec[1]), rvec[2])
    else:
        rmesh = sum(ri**norm_order for ri in rvec) ** (1 / norm_order)
    arg = -((rmesh / (1 / (1 + padding))) ** pow_order)
    return _unit_mean_in_support(torch.exp(torch.as_tensor(arg.astype(np.float32), device=device)))


def gen_gauss_selection(box_center, box_rot: Rotation, box_size, mesh_shape, curved_sky,
                        r_loc=None, r_scale=None, order: float = 2.0, device="cpu"):
    """Generalized-Gaussian radial selection mesh, unit mean within its
    support.

    Parity: bricks.py:798-816."""
    rmesh = radius_mesh(box_center, box_rot, box_size, mesh_shape, curved_sky, device)
    if r_loc is None:
        r_loc = float(np.linalg.norm(np.asarray(box_center, float)))
    if r_scale is None:
        if r_loc == 0.0:
            r_scale = float(np.min(box_size)) / 4
        else:
            los = safe_div(np.asarray(box_center, float), np.linalg.norm(box_center))
            los = box_rot.apply(los, inverse=True)
            r_scale = float(np.asarray(box_size) @ np.abs(los)) / 4
    return _unit_mean_in_support(torch.exp(-((rmesh - r_loc) / r_scale).abs() ** order))


def minmax_box(pos):
    """Axis-aligned box (size, center, rotvec) covering the positions, numpy
    (computed in the positions' dtype, as the JAX package's).

    Parity: bricks.py:819-822."""
    low, high = pos.min(0).values, pos.max(0).values
    return (high - low).cpu().numpy(), ((low + high) / 2).cpu().numpy(), np.zeros(pos.shape[-1])


def get_mesh_shape(box_size, cell_budget, padding=0.0):
    """Mesh shape (even ints) and cell length for a box and a cell budget.

    Parity: bricks.py:825-830."""
    box_size = np.multiply(box_size, 1 + padding)
    cell_length = float((np.prod(box_size) / cell_budget) ** (1 / 3))
    mesh_shape = 2 * np.rint(box_size / cell_length / 2).astype(int)
    return tuple(map(int, mesh_shape)), cell_length


def cutsky2config(data, bg: Background, cell_budget: float, padding: float = 0.0,
                  box_size=None, box_center=None, box_rotvec=None):
    """Fit the box geometry to cut-sky randoms: (final_shape, cell_length,
    box_center, box_rotvec); a given box_size/center/rotvec is kept.

    Parity: bricks.py:833-847."""
    computed = minmax_box(radecz2cart(bg, data))
    box_size, box_center, box_rotvec = (
        np.asarray(p, float) if p is not None else np.asarray(c, float)
        for p, c in zip((box_size, box_center, box_rotvec), computed))
    final_shape, cell_length = get_mesh_shape(box_size, cell_budget, padding)
    return final_shape, cell_length, box_center, box_rotvec


def _catalog_cells(data, bg, box_size, box_center, box_rotvec, mesh_shape):
    """A catalog's positions in cells of `mesh_shape` and its weights (1
    where the catalog has no WEIGHT), float32 on the background's device."""
    pos = radecz2cart(bg, data)
    weights = data.get("WEIGHT")
    weights = (torch.ones(pos.shape[0], device=pos.device) if weights is None
               else torch.as_tensor(np.asarray(weights, np.float32), device=pos.device))
    pos = phys2cell_pos(pos, box_center, Rotation(box_rotvec), box_size, mesh_shape)
    return pos, weights


def cutsky2selection(data, bg: Background, mask_shape, selec_shape, paint_shape,
                     box_size, box_center, box_rotvec,
                     paint_order=2, interlace_order=2, paint_deconv=True):
    """Paint randoms into the selection mesh at `selec_shape` (the nufft, K1
    and K3: unit mean within the painted support) and the binary footprint
    at `mask_shape` (`paint(...) > 0`, K1).

    Parity: bricks.py:850-873."""
    pos, weights = _catalog_cells(data, bg, box_size, box_center, box_rotvec, selec_shape)
    selec = irfftn(nufft(pos, tuple(selec_shape), paint_shape, weights=weights,
                         paint_order=paint_order, interlace_order=interlace_order,
                         paint_deconv=paint_deconv))
    mask = paint(pos, tuple(selec_shape), weights=weights, order=paint_order) > 0
    selec = selec / selec[mask].mean()
    pos = pos * torch.as_tensor(np.divide(mask_shape, selec_shape).astype(np.float32),
                                device=pos.device)
    mask = paint(pos, tuple(mask_shape), weights=weights, order=paint_order) > 0
    return selec, mask


def cutsky2count(data, bg: Background, count_shape, paint_shape, box_size, box_center,
                 box_rotvec, paint_order=2, interlace_order=2, paint_deconv=True):
    """Paint a cut-sky data catalog into a count mesh (the nufft: K1, K3).

    Parity: bricks.py:876-890."""
    pos, weights = _catalog_cells(data, bg, box_size, box_center, box_rotvec, count_shape)
    return irfftn(nufft(pos, tuple(count_shape), paint_shape, weights=weights,
                        paint_order=paint_order, interlace_order=interlace_order,
                        paint_deconv=paint_deconv))


def fullsky2count(data, bg: Background, a_obs: float, los, box_size, box_center, box_rotvec,
                  final_shape, paint_shape, paint_order=2, interlace_order=2,
                  paint_deconv=True):
    """Count mesh from cartesian particle chunks (a full-sky periodic box),
    summed in Fourier space chunk by chunk, with the catalog's RSD from its
    velocities (km/s) at `a_obs` along `los`; the total weight is conserved
    (asserted to 1e-3).

    Parity: bricks.py:893-938."""
    box_rot = Rotation(box_rotvec)
    los = np.asarray(los, float)
    device = bg.a_tab.device
    chunks = [data] if isinstance(data, dict) else data
    n_tracers, count = 0.0, 0.0
    for chunk in chunks:
        pos = torch.as_tensor(np.asarray(chunk["pos"], np.float32), device=device)
        if "vel" in chunk:
            E = float(Esqr(bg.cosmo, torch.as_tensor(a_obs, dtype=torch.float64)) ** 0.5)
            vel = torch.as_tensor(np.asarray(chunk["vel"], np.float32) / (a_obs * 100 * E),
                                  device=device)  # km/s -> Mpc/h
            los_t = torch.as_tensor(los.astype(np.float32), device=device)
            pos = pos + (vel * los_t).sum(-1, keepdim=True) * los_t
        weights = (torch.as_tensor(np.asarray(chunk["WEIGHT"], np.float32), device=device)
                   if "WEIGHT" in chunk else torch.ones(pos.shape[0], device=device))
        pos = phys2cell_pos(pos, box_center, box_rot, box_size, final_shape)
        count = count + nufft(pos, tuple(final_shape), paint_shape, weights=weights,
                              paint_order=paint_order, interlace_order=interlace_order,
                              paint_deconv=paint_deconv)
        n_tracers += float(weights.sum()) if "WEIGHT" in chunk else len(pos)
    count = irfftn(count)
    # the nufft applies the units jacobian: the total counts are conserved
    assert np.allclose(float(count.sum()), n_tracers, rtol=1e-3), \
        f"count sum {float(count.sum())} != n_tracers {n_tracers}"
    return count
