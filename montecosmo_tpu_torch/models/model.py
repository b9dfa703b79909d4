"""Field-level cosmological model on the main path: prior -> 2LPT or BullFrog
N-body evolve -> quad-Gaussian field likelihood, with the handler algebra of
`Model`.

Parity: `montecosmo_tpu/models/model.py` (default_config:56-154,
Model:157-403, FieldLevelModel:420-962 and 1096-1280).  The port covers
evolution='lpt' and 'nbody' (BullFrog, at one scale factor `a_obs` or on
the light cone with a_obs=None), B-spline paint orders 1-4 and Kaiser-Bessel
windows of support 1-4, bias_type='lagrangian', flat or curved sky without
AP or PNG,
observable='field' with lik_type='quad_gauss', and precond 'kaiser', 'real'
or 'fourier'; any other value raises NotImplementedError naming its ROADMAP
item.  `reparam` works on plain dicts (no `Chains`).
"""
from dataclasses import dataclass

import numpy as np
import torch

from montecosmo_tpu_torch.convert import params_from_numpy
from montecosmo_tpu_torch.models import ppl
from montecosmo_tpu_torch.models.bricks import (
    Rotation, b1_L2E, cell2phys_pos, kaiser_boost, lagrangian_bias,
    los_scalefactor_mesh, los_scalefactor_pos, phys2cell_pos, radius_mesh,
    regular_pos, rsd, samp2base, samp2base_mesh, set_radial_count, white2lin,
)
from montecosmo_tpu_torch.models.distributions import (
    DetruncTruncNorm, DetruncUnif, Normal, QuadGaussian,
)
from montecosmo_tpu_torch.ops.background import Background, get_cosmology
from montecosmo_tpu_torch.ops.fourier import irfftn, rfftk, rfftn, top_hat
from montecosmo_tpu_torch.ops.hermitian import (
    cgh2rg, chreshape, masked2mesh, mesh2masked, r2chshape, scale_shape,
)
from montecosmo_tpu_torch.ops.paint import nufft
from montecosmo_tpu_torch.ops.pm import lpt, nbody_bf, nbody_bf_lightcone
from montecosmo_tpu_torch.ops.power import lin_power_mesh
from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.safe import safe_div


default_config = {
    # Mesh and box parameters
    "final_shape": 3 * (64,),
    "cell_length": 20.0,                 # Mpc/h
    "box_center": (0.0, 0.0, 0.0),       # Mpc/h (observer at origin)
    "box_rotvec": (0.0, 0.0, 0.0),       # rotation vector (radians)
    "k_cut": np.inf,                     # h/Mpc; None -> k_nyquist
    # Init
    "png_type": None,                    # None, 'fNL', 'bias'
    # Evolution
    "evolution": "lpt",                  # kaiser, lpt, nbody
    "nbody_a_start": 0.0,
    "nbody_n_steps": 10,
    "nbody_snapshots": None,
    "lpt_order": 2,
    "paint_order": 2,
    "paint_deconv": True,
    "kernel_type": "rectangular",        # rectangular | kaiser_bessel
    "init_oversamp": 3 / 2,
    "evol_oversamp": 7 / 4,
    "ptcl_oversamp": 7 / 4,
    "paint_oversamp": 7 / 4,
    "interlace_order": 2,
    "paint_method": "auto",              # auto | window | scatter
    "max_disp": 8,                       # paint_window bound (paint cells)
    # Observable
    "observable": "field",               # field | powspec
    "poles": (0, 2, 4),
    "powspec_kedges": None,              # powspec k-bin edges / width / count
    "a_obs": None,                       # None -> light-cone
    "curved_sky": True,
    "ap_auto": None,                     # None: no AP; True: auto; False: parametric
    "register": None,                    # path to a register HDF5 file
    "n_rbins": None,
    "lik_type": "quad_gauss",            # poisson, fourier_gauss, quad_gauss,
                                         # two_quad_gauss, shash
    "bias_type": "lagrangian",           # lagrangian, eulerian
    # Latents
    "precond": "kaiser",                 # real, fourier, kaiser
    "latents": {
        "Omega_m": {"group": "cosmo", "label": r"{\Omega}_m",
                    "loc": 0.3111, "scale": 0.1, "scale_fid": 1e-2,
                    "low": 0.05, "high": 1.0},
        "sigma8": {"group": "cosmo", "label": r"{\sigma}_8",
                   "loc": 0.8102, "scale": 1e-1, "scale_fid": 1e-2,
                   "low": 0.0, "high": np.inf},
        "b1": {"group": "bias", "label": r"{b}_1",
               "loc": 1.0, "scale": 1e2, "scale_fid": 1e-2},
        "b2": {"group": "bias", "label": r"{b}_2",
               "loc": 0.0, "scale": 1e2, "scale_fid": 3e-2},
        "bs2": {"group": "bias", "label": r"{b}_{s^2}",
                "loc": 0.0, "scale": 1e2, "scale_fid": 1e-1},
        "b3": {"group": "bias", "label": r"{b}_{3}",
               "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "bds2": {"group": "bias", "label": r"{b}_{\delta s^2}",
                 "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "bs3": {"group": "bias", "label": r"{b}_{s^3}",
                "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "bn2": {"group": "bias", "label": r"{b}_{\nabla^2}",
                "loc": 0.0, "scale": 1e3, "scale_fid": 1e0},
        "bnpar": {"group": "bias", "label": r"{b}_{\nabla_\parallel}",
                  "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "fNL": {"group": "png", "label": r"{f}_\mathrm{NL}",
                "loc": 0.0, "scale": 1e4, "scale_fid": 1e2},
        "fNL_bp": {"group": "png", "label": r"{f}_\mathrm{NL} b_\phi",
                   "loc": 0.0, "scale": 1e4, "scale_fid": 3e1},
        "fNL_bpd": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\phi\delta}",
                    "loc": 0.0, "scale": 1e4, "scale_fid": 3e2},
        "fNL_bpd2": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\phi\delta^2}",
                     "loc": 0.0, "scale": 1e8, "scale_fid": 1e3},
        "fNL_bps2": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\phi s^2}",
                     "loc": 0.0, "scale": 1e8, "scale_fid": 1e4},
        "fNL_bn2p": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\nabla^2\phi}",
                     "loc": 0.0, "scale": 1e8, "scale_fid": 3e5},
        "alpha_iso": {"group": "ap", "label": r"{\alpha}_\mathrm{iso}",
                      "loc": 1.0, "scale": 1e-1, "scale_fid": 1e-2,
                      "low": 0.0, "high": np.inf},
        "alpha_ap": {"group": "ap", "label": r"{\alpha}_\mathrm{AP}",
                     "loc": 1.0, "scale": 1e-1, "scale_fid": 1e-2,
                     "low": 0.0, "high": np.inf},
        "ngbars": {"group": "syst", "label": r"{\bar{n}}_g",
                   "loc": 0.000843318125, "scale": 1e-2, "scale_fid": 1e-7,
                   "low": 0.0, "high": np.inf},
        "s_e": {"group": "stoch", "label": r"{s}_{\epsilon}",
                "loc": 1.0, "scale": 1.0, "scale_fid": 3e-3,
                "low": 0.0, "high": np.inf},
        "s_k2e": {"group": "stoch", "label": r"{s}_{k^2}",
                  "loc": 0.0, "scale": 3e2, "scale_fid": 1e1},
        "s_kmu2e": {"group": "stoch", "label": r"{s}_{k^2\mu^2}",
                    "loc": 0.0, "scale": 3e2, "scale_fid": 1e1},
        "s_ed": {"group": "stoch", "label": r"{s}_{\epsilon\delta}",
                 "loc": 0.0, "scale": 1e1, "scale_fid": 1e-2},
        "s_e2": {"group": "stoch", "label": r"{s}_{\epsilon^2}",
                 "loc": 0.0, "scale": 1e1, "scale_fid": 3e-3},
        "s_ep": {"group": "stoch", "label": r"{s}_{\epsilon\phi}",
                 "loc": 0.0, "scale": 1e5, "scale_fid": 1e2},
        "white_mesh": {"group": "init", "label": r"{\delta}_\mathrm{w}"},
    },
}


_ROADMAP = {
    "evolution": "ROADMAP Queue A item 12 (Kaiser evolution)",
    "lik_type": "ROADMAP Queue A item 12 (likelihoods and observables)",
    "bias_type": "ROADMAP Queue A item 12 (Eulerian bias)",
    "png_type": "ROADMAP Queue A item 12 (PNG)",
    "ap_auto": "ROADMAP Queue A item 12 (AP)",
    "observable": "ROADMAP Queue A item 12 (likelihoods and observables)",
    "register": "ROADMAP Queue A item 13 (register files)",
}
_SUPPORTED = {"evolution": ("lpt", "nbody"), "lik_type": ("quad_gauss",),
              "bias_type": ("lagrangian",), "png_type": (None,), "ap_auto": (None,),
              "observable": ("field",), "register": (None,)}


@dataclass
class Model:
    """Handler algebra over a generative `_model` function."""

    def _model(self, *args, **kwargs):
        raise NotImplementedError

    def model(self, *args, **kwargs):
        return self._model(*args, **kwargs)

    def _block_det(self, model, hide_base=True, hide_det=True):
        base_names = set(self.latents.keys())
        if hide_base:
            if hide_det:
                hide_fn = lambda site: site["type"] == "deterministic"
            else:
                hide_fn = lambda site: (site["type"] == "deterministic"
                                        and site["name"] in base_names)
        else:
            if hide_det:
                hide_fn = lambda site: (site["type"] == "deterministic"
                                        and site["name"] not in base_names)
            else:
                hide_fn = lambda site: False
        return ppl.block(model, hide_fn=hide_fn)

    def predict(self, seed=42, samples=None, hide_base=True, hide_det=True,
                hide_samp=True, from_base=False):
        """Run the model once, conditioned on `samples` (a dict, or None for a
        prior draw).  `seed` is an int or a torch.Generator on the model's
        device.  Batched predictions (int/tuple `samples`, `batch_ndim`) are
        not ported yet."""
        if samples is not None and not isinstance(samples, dict):
            raise NotImplementedError("batched predictions are not ported yet")
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator(
            device=self.device).manual_seed(int(seed))
        sample = params_from_numpy(samples or {}, self.device)
        with torch.no_grad():
            if from_base:
                sample = self.reparam(sample, inv=True)
            model = ppl.condition(self.model, data=sample)
            if hide_samp:
                model = ppl.block(model, hide=set(sample.keys()))
            model = self._block_det(model, hide_base=hide_base, hide_det=hide_det)
            tr = ppl.trace(ppl.seed(model, rng_seed=gen)).get_trace()
        return {k: v["value"] for k, v in tr.items()}

    def logpdf(self, params={}):
        """Joint log-probability density at `params` (recentred by the
        zero-points of `recenter_logpdf`, when set)."""
        return ppl.log_density(self.model, (), {}, params_from_numpy(params, self.device),
                               zero_point=getattr(self, "_lp_zero", None))[0]

    def recenter_logpdf(self, params=None, enable=True):
        """Set per-site zero-points c = mean elementwise log-prob at `params`,
        so that `logpdf` sums (lp - c): the value shifts by a constant and
        the float32 sum accumulates O(1) terms.  Returns the zero-points."""
        if not enable:
            self._lp_zero = None
            return None
        with torch.no_grad():
            lps, _ = ppl.compute_log_probs(self.model, (), {},
                                           params_from_numpy(params or {}, self.device),
                                           sum_log_prob=False)
        self._lp_zero = {k: float(v.mean()) for k, v in lps.items()}
        return self._lp_zero


@dataclass
class FieldLevelModel(Model):
    """Field-level model on the main path: 2LPT or BullFrog N-body (at
    `a_obs`, or on the light cone), Lagrangian bias, flat- or curved-sky
    RSD, quad-Gaussian field likelihood.  Takes
    every key of `default_config` plus `device`, the card ("cuda") unless
    the caller names another."""

    final_shape: tuple
    cell_length: float
    box_center: tuple
    box_rotvec: tuple
    k_cut: float
    png_type: str
    evolution: str
    nbody_a_start: float
    nbody_n_steps: int
    nbody_snapshots: object
    lpt_order: int
    paint_order: int
    paint_deconv: bool
    kernel_type: str
    init_oversamp: float
    evol_oversamp: float
    ptcl_oversamp: float
    paint_oversamp: float
    interlace_order: int
    paint_method: str
    max_disp: int
    observable: str
    poles: tuple
    a_obs: object
    curved_sky: bool
    ap_auto: object
    register: object
    n_rbins: object
    lik_type: str
    bias_type: str
    precond: str
    latents: dict
    powspec_kedges: object = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.kernel_type not in ("rectangular", "kaiser_bessel"):
            raise ValueError(f"Unknown kernel type: {self.kernel_type}")
        if self.kernel_type == "kaiser_bessel" and int(self.paint_order) > 4:
            raise NotImplementedError(
                f"Kaiser-Bessel windows of support {self.paint_order} are not ported yet "
                "(ROADMAP Queue B, B1: supports 1-4 are)")
        if self.paint_order not in (1, 2, 3, 4):
            raise ValueError(f"paint_order must be a window order in 1..4, got "
                             f"{self.paint_order!r}")
        for key, allowed in _SUPPORTED.items():
            if getattr(self, key) not in allowed:
                raise NotImplementedError(
                    f"{key}={getattr(self, key)!r} is not ported yet ({_ROADMAP[key]})")
        if self.evolution == "nbody" and self.a_obs is None and self.nbody_snapshots is not None:
            raise ValueError("nbody_snapshots and the N-body light cone (a_obs=None) are "
                             "exclusive")
        self.lin_kpow = None
        self.white_mesh = None
        self.count_mesh = None
        self.selec_mesh = np.array(1.0)
        self.mask_mesh = None

        # Geometry
        self.cell_length = float(self.cell_length)
        self.box_center = np.asarray(self.box_center, float)
        self.box_rotvec = np.asarray(self.box_rotvec, float)
        self.box_rot = Rotation(self.box_rotvec)

        # Shapes
        self.final_shape = tuple(map(int, self.final_shape))
        self.box_size = np.multiply(self.final_shape, self.cell_length)
        self.init_shape = scale_shape(self.final_shape, self.init_oversamp)
        self.evol_shape = scale_shape(self.final_shape, self.evol_oversamp)
        self.ptcl_shape = scale_shape(self.final_shape, self.ptcl_oversamp)
        self.paint_shape = scale_shape(self.final_shape, self.paint_oversamp)

        # Paint path: the clamped lattice paint (the window path of the JAX
        # package) when the paint and evol meshes refine the particle
        # lattice and the displacement bound stays narrow; else the plain
        # unclamped scatter.  Same choice as montecosmo_tpu (model.py:539-570).
        self.max_disp = int(self.max_disp)
        geom_ok = all(p % q == 0 for p, q in zip(self.paint_shape, self.ptcl_shape)) \
            and all(e % q == 0 for e, q in zip(self.evol_shape, self.ptcl_shape))
        paint_cell = float(np.min(np.divide(self.box_size, self.paint_shape)))
        if self.paint_method == "window":
            assert geom_ok, (f"paint_method='window' needs paint {self.paint_shape} "
                             f"and evol {self.evol_shape} to be multiples of "
                             f"ptcl {self.ptcl_shape}")
            self.paint_lattice = tuple(self.ptcl_shape)
        elif self.paint_method == "auto" and geom_ok:
            need = int(np.ceil(36.0 / paint_cell))
            if need <= 24:
                self.max_disp = max(4, need)
                self.paint_lattice = tuple(self.ptcl_shape)
            else:
                self.paint_lattice = None
        elif self.paint_method in ("auto", "scatter"):
            self.paint_lattice = None
        else:
            raise ValueError(f"Unknown paint_method: {self.paint_method}")

        # reads at the undisplaced lattice (Lagrangian bias, LPT forces) are
        # strided slices when the evolution mesh refines the particle
        # lattice, else order-1 reads (K4)
        self.evol_sites = tuple(self.ptcl_shape) if all(
            e % q == 0 for e, q in zip(self.evol_shape, self.ptcl_shape)) else None

        # Scale cut
        self.k_funda = 2 * np.pi / np.min(self.box_size)
        self.k_nyquist = np.pi * np.min(np.divide(self.final_shape, self.box_size))
        if self.k_cut in (np.inf, "inf"):
            self.k_cut = np.inf
            self.cut_mask = None
        else:
            if self.k_cut is None:
                self.k_cut = float(self.k_nyquist)
            kvec = rfftk(self.init_shape, self.box_size, self.device)
            mask = torch.broadcast_to(top_hat(kvec, self.k_cut),
                                      r2chshape(self.init_shape)).float()
            self.cut_mask = cgh2rg(mask, norm="amp").bool()

        # Latents / groups / labels
        self._rmesh = radius_mesh(self.box_center, self.box_rot, self.box_size,
                                  self.final_shape, self.curved_sky, self.device)
        self.latents = self._validate_latents()
        (self.n_rbins, self.rmasked, self.redges,
         self.latents["ngbars"]) = self._validate_rbins()
        self.groups = self._groups(base=True)
        self.groups_ = self._groups(base=False)

        # Fiducial quantities
        self.fiduc = self._fiduc()
        self.count_fid = np.mean(self.fiduc["ngbars"]) * self.cell_length**3
        self.cosmo_fid = get_cosmology(**{k: float(np.mean(self.fiduc[k]))
                                          for k in ("Omega_m", "sigma8")})
        self.bg_fid = Background.create(self.cosmo_fid, self.device)
        _, a = los_scalefactor_mesh(self.box_center, self.box_rot, self.box_size,
                                    self.final_shape, self.bg_fid, self.a_obs,
                                    self.curved_sky)
        self.a_fid = float(self.bg_fid.g2a(torch.mean(self.bg_fid.a2g(a))))
        los = safe_div(self.box_center, np.linalg.norm(self.box_center))
        self.los_fid = np.asarray(self.box_rot.apply(los, inverse=True))
        self.selec_fid = float(np.mean(np.asarray(self.selec_mesh)**2)**0.5
                               / np.mean(np.asarray(self.selec_mesh)))
        self._precond_cache = None

    # ------------------------------------------------------------------ program
    def _model(self, temp_prior=1.0, temp_lik=1.0):
        x = self.prior(temp=temp_prior)
        x = self.evolve(x)
        return self.likelihood(x, temp=temp_lik)

    def prior(self, temp=1.0):
        """Sample the latents in unconstrained coordinates, reparametrize into
        base space, and register the base values as deterministic sites."""
        tup = ()
        for g in ["cosmo", "bias", "png", "stoch", "ap", "syst"]:
            dic = self._sample(self.groups.get(g, []))
            dic = samp2base(dic, self.latents, inv=False, temp=temp)
            tup += ({k: ppl.deterministic(k, v) for k, v in dic.items()},)
        cosmo, bias, png, stoch, ap, syst = tup
        cosmology = get_cosmology(**cosmo)

        init = {}
        name_ = self.groups["init"][0] + "_"
        scale, transfer = self._precond_scale_and_transfer()
        if self.cut_mask is not None:
            samp = ppl.sample(name_, Normal(0.0, scale[self.cut_mask]))
            init[name_] = masked2mesh(samp, self.cut_mask)
        else:
            init[name_] = ppl.sample(name_, Normal(0.0, scale))
        init = samp2base_mesh(init, self.precond, transfer=transfer, inv=False, temp=temp)
        init = {k: ppl.deterministic(k, v) for k, v in init.items()}
        return cosmology, bias, png, stoch, ap, syst, init

    def evolve(self, params: tuple):
        """Linear field -> 2LPT or BullFrog N-body -> Lagrangian bias -> RSD
        -> painted galaxy mesh (1 + delta_obs) on the paint mesh.  The
        render's paint window is `kernel_type`'s; the N-body force paints and
        reads are B-splines of `paint_order` whatever it is, as in the JAX
        package."""
        cosmology, bias, png, stoch, ap, syst, init = params
        bg = Background.create(cosmology, self.device)

        init_mesh = white2lin(cosmology, init["white_mesh"], self.init_shape,
                              self.box_size, self.lin_kpow)
        init_mesh = chreshape(init_mesh, r2chshape(self.evol_shape))

        pos = regular_pos(self.evol_shape, self.ptcl_shape, self.device)
        _, a = los_scalefactor_pos(pos, self.box_center, self.box_rot, self.box_size,
                                   self.evol_shape, bg, self.a_obs, self.curved_sky)
        lbe_weights, dvel, phi = lagrangian_bias(cosmology, pos, a, self.box_size,
                                                 init_mesh, bias, bg, self.evol_sites)
        if self.evolution == "lpt":
            dpos, vel = lpt(bg, init_mesh, pos=pos, a=a, lpt_order=self.lpt_order,
                            read_order=1, sites_shape=self.evol_sites)
            pos = pos + dpos
            pos, vel = ppl.deterministic("lpt_ptcl", torch.stack((pos, vel)))
        else:
            # the force paints run on the evol mesh: rescale the window
            # bound from paint cells to evol cells
            max_disp_evol = int(np.ceil(self.max_disp * np.max(
                np.divide(self.evol_shape, self.paint_shape))))
            kw = dict(n_steps=self.nbody_n_steps, paint_order=self.paint_order,
                      lpt_order=self.lpt_order, paint_deconv=False,
                      lattice_shape=self.paint_lattice, max_disp=max_disp_evol,
                      sites_shape=self.evol_sites)
            if self.a_obs is not None:
                pos, vel = nbody_bf(bg, init_mesh, pos=pos, a0=self.nbody_a_start, a1=a,
                                    snapshots=self.nbody_snapshots, **kw)
            else:
                # the light cone: each particle seen at the growth of its
                # Lagrangian radius, the evolution run to the latest one
                g_tgt = bg.a2g(a)
                a1 = bg.g2a(g_tgt.max())
                pos, vel = nbody_bf_lightcone(bg, init_mesh, pos=pos, g_tgt=g_tgt,
                                              a0=self.nbody_a_start, a1=a1, **kw)
                pos, vel = pos[None], vel[None]
            pos, vel = ppl.deterministic("nbody_ptcl", torch.stack((pos, vel)))
            pos, vel = pos[-1], vel[-1]

        los, a = los_scalefactor_pos(pos, self.box_center, self.box_rot, self.box_size,
                                     self.evol_shape, bg, self.a_obs, self.curved_sky)
        pos = cell2phys_pos(pos, self.box_center, self.box_rot, self.box_size,
                            self.evol_shape)
        pos = pos + rsd(bg, vel, los, a, self.box_rot, self.box_size, self.evol_shape, dvel)
        pos = phys2cell_pos(pos, self.box_center, self.box_rot, self.box_size,
                            self.init_shape)

        gxy = nufft(pos, self.init_shape, tuple(self.paint_shape), weights=lbe_weights,
                    paint_order=self.paint_order, interlace_order=self.interlace_order,
                    kernel_type=self.kernel_type, paint_deconv=self.paint_deconv,
                    lattice_shape=self.paint_lattice, max_disp=self.max_disp, clip=True)
        gxy = gxy * float(np.prod(np.divide(self.init_shape, self.ptcl_shape)))
        gxy_mesh = irfftn(chreshape(gxy, r2chshape(self.paint_shape)))
        gxy_mesh = ppl.deterministic("gxy_mesh", gxy_mesh)
        return gxy_mesh, phi, stoch, syst

    def likelihood(self, params: tuple, temp=1.0):
        """Observe the galaxy count mesh under the quad-Gaussian noise."""
        gxy_mesh, phi, stoch, syst = params
        rcounts = syst["ngbars"] * self.cell_length**3
        count_mesh = irfftn(chreshape(rfftn(gxy_mesh * float(self.selec_mesh)),
                                      r2chshape(self.final_shape)))
        count_mesh = set_radial_count(count_mesh, self._rmesh, self.redges, rcounts)
        selec_mesh = rcounts.mean()

        delta = count_mesh / selec_mesh - 1
        scale1 = (stoch["s_e"] + stoch["s_ed"] * delta + stoch["s_ep"] * phi).abs() + 1e-9
        scale1 = scale1 * selec_mesh**0.5 * temp**0.5
        scale2 = stoch["s_e2"] * selec_mesh**0.5
        return ppl.sample("count_mesh", QuadGaussian(count_mesh, scale1, scale2))

    # ------------------------------------------------------------------ reparam
    def reparam(self, params: dict, fourier=True, inv=False, temp=1.0):
        """Sample-space <-> base-space transform of a param dict."""
        params_ = params_from_numpy(params, self.device)
        gdict = self.groups if inv else self.groups_
        suffix = "" if inv else "_"
        out = {}
        for g in ["cosmo", "bias", "png", "stoch", "ap", "syst"]:
            dic = {k: params_[k] for k in gdict.get(g + suffix, []) if k in params_}
            out |= samp2base(dic, self.latents, inv=inv, temp=temp)

        init = {k: params_[k] for k in gdict.get("init" + suffix, []) if k in params_}
        if init:
            _, transfer = self._precond_scale_and_transfer()
            if inv and not fourier:
                init = {k: rfftn(v) for k, v in init.items()}
            if not inv and self.cut_mask is not None:
                init = {k: masked2mesh(v, self.cut_mask) for k, v in init.items()}
            init = samp2base_mesh(init, self.precond, transfer=transfer, inv=inv, temp=temp)
            if inv and self.cut_mask is not None:
                init = {k: mesh2masked(v, self.cut_mask) for k, v in init.items()}
            if not inv and not fourier:
                init = {k: irfftn(v) for k, v in init.items()}
            out |= init

        grouped = {k for names in gdict.values() for k in names}
        out = {k: v for k, v in out.items() if (k[:-1] if inv else k + "_") in params}
        rest = {k: v for k, v in params_.items() if k not in grouped}
        return rest | out

    # ------------------------------------------------------------------ getters
    def _validate_latents(self):
        new = {}
        for name, conf in self.latents.items():
            new[name] = conf.copy()
            loc, scale = conf.get("loc"), conf.get("scale")
            low, high = conf.get("low"), conf.get("high")
            loc_fid, scale_fid = conf.get("loc_fid"), conf.get("scale_fid")
            assert not ((loc is None) ^ (scale is None)), \
                f"latent '{name}': loc and scale must come together"
            assert not ((low is None) ^ (high is None)), \
                f"latent '{name}': low and high must come together"
            if loc is not None:
                if loc_fid is None:
                    new[name]["loc_fid"] = loc
                if scale_fid is None:
                    new[name]["scale_fid"] = scale
            elif low is not None:
                assert low <= high, f"latent '{name}': low must be <= high"
                assert np.isfinite(low) and np.isfinite(high), \
                    f"latent '{name}': uniform bounds must be finite"
                if loc_fid is None:
                    new[name]["loc_fid"] = (low + high) / 2
                if scale_fid is None:
                    new[name]["scale_fid"] = (high - low) / 12**0.5
        return new

    def _validate_rbins(self):
        rmasked = self._rmesh.cpu().numpy()
        rmin, rmax = rmasked.min(), rmasked.max()
        dr = 3**0.5 * self.cell_length
        n_rbins = max(int((rmax - rmin) / dr), 1) if self.n_rbins is None else self.n_rbins
        redges = np.linspace(rmin - dr / 1000, rmax + dr / 1000, n_rbins + 1)
        ngbars_conf = self.latents["ngbars"].copy()
        for attr in ("loc", "scale", "loc_fid", "scale_fid", "low", "high"):
            if attr in ngbars_conf:
                ngbars_conf[attr] = np.broadcast_to(ngbars_conf[attr], n_rbins)
        return n_rbins, rmasked, redges, ngbars_conf

    def _sample(self, names):
        """Sample latent parameters in unconstrained coordinates."""
        dic = {}
        for name in np.atleast_1d(names):
            conf = self.latents[name]
            loc, scale = conf.get("loc"), conf.get("scale")
            low, high = conf.get("low", -np.inf), conf.get("high", np.inf)
            loc_fid, scale_fid = conf["loc_fid"], conf["scale_fid"]
            if loc is not None and None not in np.atleast_1d(loc):
                if np.all(np.asarray(low) == -np.inf) and np.all(np.asarray(high) == np.inf):
                    fn = Normal(to_tensor((np.asarray(loc) - np.asarray(loc_fid))
                                          / np.asarray(scale_fid), self.device),
                                to_tensor(np.asarray(scale) / np.asarray(scale_fid), self.device))
                else:
                    fn = DetruncTruncNorm(*(to_tensor(x, self.device) for x in (
                        loc, scale, low, high, loc_fid, scale_fid)))
            else:
                fn = DetruncUnif(*(to_tensor(x, self.device)
                                   for x in (low, high, loc_fid, scale_fid)))
            dic[name + "_"] = ppl.sample(name + "_", fn)
        return dic

    def _precond_scale_and_transfer(self):
        """Per-mode sampling scale (real packing) and transfer (rfft grid) of
        the white-field latent; constant, computed once per model.

        precond 'kaiser': scale = (1 + boost^2 P / sigma_noise^2)^1/2 from the
        fiducial Kaiser SNR; 'real'/'fourier': unit scale."""
        if self._precond_cache is not None:
            return self._precond_cache
        unit = float(np.prod(np.divide(self.init_shape, self.box_size)))
        with torch.no_grad():
            if self.precond in ("real", "fourier"):
                scale = torch.ones(tuple(self.init_shape), device=self.device)
                cache = (scale, unit ** 0.5)
            elif self.precond == "kaiser":
                b1E_fid = b1_L2E(float(np.mean(self.fiduc["b1"])))
                boost_fid = kaiser_boost(self.cosmo_fid, self.a_fid, self.init_shape,
                                         self.box_size, b1E_fid, los=self.los_fid,
                                         bg=self.bg_fid)
                pmesh_fid = lin_power_mesh(self.cosmo_fid, self.init_shape, self.box_size,
                                           kpow=self.lin_kpow, device=self.device) * unit
                var_fid = float(np.mean(self.fiduc["s_e"])) / (self.count_fid * self.selec_fid)
                scale = (1 + boost_fid**2 / var_fid * pmesh_fid) ** 0.5
                transfer = unit ** 0.5 / scale
                cache = (cgh2rg(scale, norm="amp"), transfer)
            else:
                raise ValueError(f"Unknown preconditioning: {self.precond}")
        self._precond_cache = cache
        return cache

    def _groups(self, base=True):
        groups = {}
        for name, val in self.latents.items():
            g = val["group"] if base else val["group"] + "_"
            groups.setdefault(g, []).append(name if base else name + "_")
        return groups

    def _fiduc(self):
        return {k: v["loc_fid"] for k, v in self.latents.items() if "loc_fid" in v}
