"""Field-level cosmological model: prior -> Kaiser, 2LPT or BullFrog N-body
evolve -> field or power-spectrum likelihood, with the handler algebra of
`Model`.

Parity: `montecosmo_tpu/models/model.py` (default_config:56-154,
Model:157-417 but `value_and_grad_staged`, FieldLevelModel:420-1130,
1283-1406 and 1449-1509).  The port covers
evolution='kaiser' (its three regimes: flat sky at `a_obs`, the flat-sky
light cone, the curved sky), 'lpt' and 'nbody' (BullFrog, at one scale
factor `a_obs` or on the light cone with a_obs=None), B-spline paint orders
1-4 and Kaiser-Bessel windows of support 1-4, bias_type 'lagrangian' or
'eulerian', flat or curved sky, Alcock-Paczynski distortions (ap_auto None,
True: through the fiducial distances, False: the `ap` latents) and local
primordial non-Gaussianity (png_type None, 'fNL' or 'bias'), observable
'field' with every lik_type (poisson, fourier_gauss, quad_gauss,
two_quad_gauss, shash) or 'powspec', and precond 'kaiser', 'real' or
'fourier'; a register file (`register`: the port's `.npz`, or the JAX
package's `.h5` where h5py is installed) with its selection mesh and
footprint mask in the likelihood, and `register_catalog`, which paints a
catalog (cut sky or full sky) into one.  `reparam` works on plain dicts;
`reparam_chains` and `powtranscoh_chains` loop over a `Chains` batch.
`kaiser_post`, the samplers' start, is the flat-sky Kaiser posterior at
the fiducial.  `save` writes the config as JSON, which the JAX package's
`FieldLevelModel.load` reads; `load` reads either package's file.
"""
import functools
import warnings
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np
import torch

from montecosmo_tpu_torch.chains import Chains
from montecosmo_tpu_torch.convert import params_from_numpy
from montecosmo_tpu_torch.metrics import (
    _plan, _spectrum, kbin_edges, legendre, powtranscoh, spectrum,
)
from montecosmo_tpu_torch.models import ppl
from montecosmo_tpu_torch.models.bricks import (
    Rotation, add_png, ap_auto, ap_param, b1_L2E, cell2phys_pos, count2delta, cutsky2config,
    cutsky2count, cutsky2selection, eulerian_bias, fNL_bias, fullsky2count, get_mesh_shape,
    kaiser_boost, kaiser_model, kaiser_posterior, lagrangian_bias, lin2white,
    los_scalefactor_mesh, los_scalefactor_pos, phi_transfer, phys2cell_pos, radius_mesh,
    regular_pos, rsd, samp2base, samp2base_mesh, set_radial_count, velocity_bias, white2lin,
)
from montecosmo_tpu_torch.models.distributions import (
    BlockMultivariateNormal, DetruncTruncNorm, DetruncUnif, Normal, Poisson, QuadGaussian,
    SinhArcsinh, TwoQuadGaussian,
)
from montecosmo_tpu_torch.ops.background import Background, Cosmology, get_cosmology
from montecosmo_tpu_torch.ops.fourier import irfftn, rfftk, rfftn, top_hat
from montecosmo_tpu_torch.ops.hermitian import (
    cgh2rg, ch2rshape, chreshape, masked2mesh, mesh2masked, r2chshape, rg2cgh, scale_shape,
)
from montecosmo_tpu_torch.ops.paint import nufft, read, read_sites
from montecosmo_tpu_torch.ops.pm import lpt, nbody_bf, nbody_bf_lightcone
from montecosmo_tpu_torch.ops.power import lin_power, lin_power_mesh
from montecosmo_tpu_torch.utils import to_tensor
from montecosmo_tpu_torch.utils.io import load_tree, yload, ysave
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
    "register": None,                    # path to a register file (.npz, or .h5 with h5py)
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


_CHOICES = {"evolution": ("kaiser", "lpt", "nbody"), "ap_auto": (None, True, False),
            "png_type": (None, "fNL", "bias"),
            "lik_type": ("poisson", "fourier_gauss", "quad_gauss", "two_quad_gauss", "shash"),
            "bias_type": ("lagrangian", "eulerian"), "observable": ("field", "powspec")}


@dataclass
class Model:
    """Handler algebra over a generative `_model` function: `substitute`,
    `block`, `seed` and `partial` wrap `self.model`, `reset` unwraps it.
    Seeds are ints or torch.Generators on the model's device."""

    def __post_init__(self):
        self.data = {}  # observed / substituted values

    # ------------------------------------------------------------------ calls
    def _model(self, *args, **kwargs):
        raise NotImplementedError

    def model(self, *args, **kwargs):
        return self._model(*args, **kwargs)

    def reset(self):
        self.model = self._model
        self.data = {}

    def __call__(self):
        return self.model()

    def reparam(self, params, inv=False):
        return params

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

    def predict(self, seed=42, samples=None, batch_ndim=0, hide_base=True, hide_det=True,
                hide_samp=True, from_base=False):
        """Run the model conditioned on samples.

        samples None -> single prediction; int/tuple -> that batch shape of
        prior predictions; dict -> one prediction per sample (`batch_ndim`
        leading dims).  A batch runs one prediction after another (no vmap
        through the kernels), all drawn from one generator, and stacks them.
        `seed` is an int or a torch.Generator on the model's device."""
        gen = ppl._generator(seed, self.device)

        def single(sample):
            with torch.no_grad():
                if from_base:
                    sample = self.reparam(sample, inv=True)
                model = ppl.condition(self.model, data=sample)
                if hide_samp:
                    model = ppl.block(model, hide=set(sample.keys()))
                model = self._block_det(model, hide_base=hide_base, hide_det=hide_det)
                tr = ppl.trace(ppl.seed(model, rng_seed=gen)).get_trace()
            return {k: v["value"] for k, v in tr.items()}

        if samples is None:
            return single({})
        if isinstance(samples, (int, tuple)):
            shape = (samples,) if isinstance(samples, int) else tuple(samples)
            return _stacked([single({}) for _ in np.ndindex(shape)], shape)
        if isinstance(samples, dict):
            if len(samples) == 0:
                return {}
            samples = params_from_numpy(samples, self.device)
            shape = tuple(next(iter(samples.values())).shape[:batch_ndim])
            if not shape:
                return single(samples)
            return _stacked([single({k: v[idx] for k, v in samples.items()})
                             for idx in np.ndindex(shape)], shape)
        raise ValueError("samples must be None, int, tuple, or dict")

    # ------------------------------------------------------------------ densities
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

    def logdf_mesh(self, params={}, site="count_mesh"):
        """Per-voxel (log-pdf, log-cdf) of `site` at the latents and
        observables `params`."""
        lps, tr = ppl.compute_log_probs(self.model, (), {}, params_from_numpy(params, self.device),
                                        sum_log_prob=False)
        d, value = tr[site]["fn"], tr[site]["value"]
        logcdf = d.log_cdf(value) if hasattr(d, "log_cdf") else torch.log(d.cdf(value))
        return lps[site], logcdf

    def potential(self, params={}):
        return -self.logpdf(params)

    def force(self, params={}):
        """Gradient of `logpdf` with respect to every entry of `params` (the
        keys of the JAX package's `grad`); zero where logpdf does not depend
        on an entry."""
        leaves = {k: v.detach().requires_grad_(v.is_floating_point() or v.is_complex())
                  for k, v in params_from_numpy(params, self.device).items()}
        with torch.enable_grad():
            lp = self.logpdf(leaves)
            wrt = [v for v in leaves.values() if v.requires_grad]
            grads = iter(torch.autograd.grad(lp, wrt, allow_unused=True))
        out = {}
        for k, v in leaves.items():
            g = next(grads) if v.requires_grad else None
            out[k] = torch.zeros_like(v) if g is None else g
        return out

    # ------------------------------------------------------------------ handlers
    def trace(self, seed):
        gen = ppl._generator(seed, self.device)
        return ppl.trace(ppl.seed(self.model, rng_seed=gen)).get_trace()

    def seed(self, seed):
        self.model = ppl.seed(self.model, rng_seed=ppl._generator(seed, self.device))

    def substitute(self, data={}, from_base=False):
        """Substitute random variables by values, optionally reparametrizing
        base values into sample space first.  Values accumulate in `data`."""
        data = params_from_numpy(data, self.device)
        if from_base:
            self.data |= data
            data = self.reparam(data, inv=True)
        self.data |= data
        self.model = ppl.condition(self.model, data=data)

    def block(self, hide_fn=None, hide=None, expose_types=None, expose=None,
              hide_base=True, hide_det=True):
        """Hide sites from traces.  The default call hides base and other
        deterministic sites (sampling configuration)."""
        if all(x is None for x in (hide_fn, hide, expose_types, expose)):
            self.model = self._block_det(self.model, hide_base=hide_base,
                                         hide_det=hide_det)
        else:
            self.model = ppl.block(self.model, hide_fn=hide_fn, hide=hide,
                                   expose_types=expose_types, expose=expose)

    def render(self, filename=None):
        """Text rendering of the model's sites."""
        with torch.no_grad():
            tr = self.trace(0)
        lines = []
        for name, site in tr.items():
            fn = type(site["fn"]).__name__ if site["fn"] is not None else ""
            obs = " [obs]" if site.get("is_observed") else ""
            shape = tuple(torch.as_tensor(site["value"]).shape)
            lines.append(f"{name:>24} : {site['type']:<13} {fn:<18} {shape}{obs}")
        out = "\n".join(lines)
        if filename:
            Path(filename).write_text(out)
        print(out)
        return out

    def partial(self, *args, **kwargs):
        self.model = functools.partial(self.model, *args, **kwargs)

    # ------------------------------------------------------------------ persistence
    def asdict(self):
        """The config: every field but `device` (the JAX package's keys)."""
        return {f.name: getattr(self, f.name) for f in fields(self) if f.name != "device"}

    def save(self, path):
        """Write the config as JSON (YAML 1.2 reads it: the JAX package's
        `FieldLevelModel.load` takes the file)."""
        ysave(self.asdict(), path)

    @classmethod
    def load(cls, path, device="cuda"):
        """The model of a config file written by either package's `save`."""
        return cls(**yload(path), device=device)


def _stacked(outs, shape):
    """Dicts of per-sample values -> one dict of values with leading `shape`."""
    return {k: torch.stack([torch.as_tensor(o[k]) for o in outs]).reshape(
        shape + tuple(torch.as_tensor(outs[0][k]).shape)) for k in outs[0]}


@dataclass
class FieldLevelModel(Model):
    """Field-level model: Kaiser, 2LPT or BullFrog N-body (at `a_obs`, or
    on the light cone), Lagrangian or Eulerian bias, flat- or curved-sky
    RSD, a field likelihood or the multipoles' (powspec).  Takes
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
        super().__post_init__()
        self.device = torch.device(self.device)
        self.lin_kpow = None
        self.white_mesh = None
        self.count_mesh = None
        self.selec_mesh = np.array(1.0)
        self.mask_mesh = None
        if self.register is not None:
            self._load_register()
        if self.kernel_type not in ("rectangular", "kaiser_bessel"):
            raise ValueError(f"Unknown kernel type: {self.kernel_type}")
        if self.kernel_type == "kaiser_bessel" and int(self.paint_order) > 4:
            raise NotImplementedError(
                f"Kaiser-Bessel windows of support {self.paint_order} are not ported yet "
                "(ROADMAP Queue B item 8: supports 1-4 are)")
        if self.paint_order not in (1, 2, 3, 4):
            raise ValueError(f"paint_order must be a window order in 1..4, got "
                             f"{self.paint_order!r}")
        for key, allowed in _CHOICES.items():
            if getattr(self, key) not in allowed:
                raise ValueError(f"Unknown {key}: {getattr(self, key)!r} (one of {allowed})")
        if self.evolution == "nbody" and self.a_obs is None and self.nbody_snapshots is not None:
            raise ValueError("nbody_snapshots and the N-body light cone (a_obs=None) are "
                             "exclusive")

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
        self._rmasked = mesh2masked(self._rmesh, self.mask_mesh)
        self._selection()
        self.latents = self._validate_latents()
        (self.n_rbins, self.rmasked, self.redges,
         self.latents["ngbars"]) = self._validate_rbins()
        self.groups = self._groups(base=True)
        self.groups_ = self._groups(base=False)
        self.labels = self._labels()

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
        # the powspec observable's binning and covariance: host numpy, once
        self._powspec_cache = None
        self.powspec_data = None
        if self.observable == "powspec":
            self._powspec_static()

    def _load_register(self):
        """Take the register file's geometry and paint keys (they override
        the config's), its tabulated spectrum, white mesh, selection,
        footprint and counts (masked, or the real packing of their rfft for
        lik_type='fourier_gauss'), the final shape of its counts, and its
        fiducial cosmology and mean density as the latents' centres.

        Parity: model.py:469-511."""
        path = str(self.register)
        if not Path(path).exists():
            raise FileNotFoundError(f"register file not found: {path}")
        self.register = path
        reg = load_tree(path)
        for k in ("cell_length", "box_center", "box_rotvec", "init_oversamp", "paint_oversamp"):
            setattr(self, k, reg[k])
        for k in ("a_obs", "curved_sky", "paint_order", "interlace_order", "paint_deconv",
                  "kernel_type"):
            if k in reg:
                setattr(self, k, reg[k])
        kpow = reg.get("lin_kpow")  # (k, P / sigma8^2)
        if isinstance(kpow, dict):
            kpow = (kpow["k"], kpow["pow"])
        if kpow is not None:
            self.lin_kpow = tuple(np.asarray(x, np.float32) for x in kpow)
        white = reg.get("white_mesh", reg.get("white_fake"))
        if white is not None:
            self.white_mesh = to_tensor(white, self.device)
        if reg.get("selec_mesh") is not None:
            self.selec_mesh = np.asarray(reg["selec_mesh"], np.float32)
        if reg.get("mask_mesh") is not None:
            self.mask_mesh = torch.as_tensor(np.asarray(reg["mask_mesh"], bool),
                                             device=self.device)
        count = torch.as_tensor(np.asarray(reg["count_mesh"], np.float32), device=self.device)
        if self.lik_type == "fourier_gauss":
            self.count_mesh = cgh2rg(rfftn(count))
        else:
            self.count_mesh = mesh2masked(count, self.mask_mesh)
        self.final_shape = tuple(count.shape)
        n_tracers = reg.get("n_tracers", float(count.sum()))
        ngbar = n_tracers / (self.count_mesh.numel() * float(self.cell_length)**3)
        self.latents = self.new_latents_from_loc(
            self.latents, {**reg["cosmo_fid"], "ngbars": ngbar}, update_prior=True)

    def _selection(self):
        """The registered 3-D selection on the card once: at the paint
        shape, which multiplies the galaxy mesh, and resampled to the final
        mesh and masked, the likelihood's mean count before its radial
        counts (None for a scalar selection)."""
        self._selec_paint = self._selec_final = None
        if np.ndim(self.selec_mesh) == 3:
            selec = torch.as_tensor(self.selec_mesh, device=self.device)
            self._selec_paint = selec
            self._selec_final = mesh2masked(irfftn(chreshape(
                rfftn(selec), r2chshape(self.final_shape))), self.mask_mesh)

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
        """Linear field -> Kaiser, or (PNG) 2LPT or BullFrog N-body ->
        Lagrangian or Eulerian bias -> RSD -> AP -> the galaxy mesh (1 +
        delta_obs), on the paint mesh (the evol mesh, resampled to the final
        one, for Kaiser).  The render's paint window is `kernel_type`'s; the
        N-body force paints and reads are B-splines of `paint_order`
        whatever it is, as in the JAX package.  Returns (gxy_mesh, phi,
        stoch, syst), phi the primordial-potential mesh with png_type set
        on the particle paths, else 0."""
        cosmology, bias, png, stoch, ap, syst, init = params
        bg = Background.create(cosmology, self.device)

        init_mesh = white2lin(cosmology, init["white_mesh"], self.init_shape,
                              self.box_size, self.lin_kpow)
        init_mesh = chreshape(init_mesh, r2chshape(self.evol_shape))
        png = fNL_bias(png, bias, p=1.0, png_type=self.png_type)
        if self.evolution == "kaiser":
            return self._evolve_kaiser(cosmology, bias, png, stoch, ap, syst, init_mesh, bg)

        pos = regular_pos(self.evol_shape, self.ptcl_shape, self.device)
        _, a = los_scalefactor_pos(pos, self.box_center, self.box_rot, self.box_size,
                                   self.evol_shape, bg, self.a_obs, self.curved_sky)
        # the primordial potential and its transfer, built once for the
        # bias operators and add_png
        phik = trans = None
        if self.png_type is not None:
            phik, trans = phi_transfer(cosmology, init_mesh, self.box_size, self.lin_kpow, bg)
        if self.bias_type == "lagrangian":
            lbe_weights, dvel, phi = lagrangian_bias(
                pos, a, self.box_size, init_mesh, bias, bg, self.evol_sites, png=png, phik=phik)
        else:
            # the Eulerian path takes only the velocity bias of the
            # Lagrangian operators (the JAX package evaluates them all) and,
            # with PNG, their phi mesh, read at the particles
            phi = 0.0
            dvel = velocity_bias(pos, a, self.box_size, init_mesh, bias["bnpar"], bg,
                                 self.evol_sites)
            if self.png_type is not None:
                phi = irfftn(phik)
                phi_pos = (read_sites(phi, self.evol_sites) if self.evol_sites is not None
                           else read(pos, phi, order=1))
        if self.png_type is not None:
            init_mesh = add_png(png["fNL"], phi, trans)
            init_mesh = chreshape(chreshape(init_mesh, r2chshape(self.init_shape)),
                                  r2chshape(self.evol_shape))
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
        pos = self._ap(pos, los, bg, ap)
        pos = phys2cell_pos(pos, self.box_center, self.box_rot, self.box_size,
                            self.init_shape)

        if self.bias_type == "lagrangian":
            gxy_mesh = irfftn(self._advect(pos, lbe_weights, self.init_shape, self.init_shape))
        else:
            # the advected matter (and phi) meshes, in paint-mesh units (the
            # JAX package's advect: paint_shape / ptcl_shape, not the
            # Lagrangian render's init_shape / ptcl_shape)
            phi_mesh = None if self.png_type is None else self._advect(
                pos, phi_pos, self.init_shape, self.paint_shape)
            gxy_mesh = eulerian_bias(self._advect(pos, 1.0, self.init_shape, self.paint_shape),
                                     self.box_size, bias, phi_mesh=phi_mesh, png=png,
                                     png_type=self.png_type)
        gxy_mesh = ppl.deterministic("gxy_mesh", gxy_mesh)
        return gxy_mesh, phi, stoch, syst

    def _advect(self, pos, weights, cell_shape, units):
        """Paint `weights` at `pos` (in cells of `cell_shape`) on the paint
        mesh through `nufft` (K1, K3), times prod(units / ptcl_shape): the
        rfft mesh at the paint shape."""
        mesh = nufft(pos, cell_shape, tuple(self.paint_shape), weights=weights,
                     paint_order=self.paint_order, interlace_order=self.interlace_order,
                     kernel_type=self.kernel_type, paint_deconv=self.paint_deconv,
                     lattice_shape=self.paint_lattice, max_disp=self.max_disp, clip=True)
        mesh = mesh * float(np.prod(np.divide(units, self.ptcl_shape)))
        return chreshape(mesh, r2chshape(self.paint_shape))

    def _ap(self, pos, los, bg, ap):
        """The Alcock-Paczynski remap of physical positions: none (ap_auto
        None), through the fiducial distances (True) or the `ap` latents
        (False)."""
        if self.ap_auto is None:
            return pos
        if self.ap_auto:
            return ap_auto(pos, los, bg, self.bg_fid, self.curved_sky)
        return ap_param(pos, los, ap, self.curved_sky)

    def _evolve_kaiser(self, cosmology, bias, png, stoch, ap, syst, init_mesh, bg):
        """The Kaiser evolution (`kaiser_model`) on the evol mesh, each cell
        at its scale factor on the light cone (a_obs None) and along its
        own line of sight on the curved sky; with AP, read at the particle
        lattice, remapped and painted back through `nufft`; resampled to
        the final mesh."""
        los, a = los_scalefactor_mesh(self.box_center, self.box_rot, self.box_size,
                                      self.evol_shape, bg, self.a_obs, self.curved_sky)
        # flat sky: the box frame's line of sight
        cell_los = los if torch.is_tensor(los) else self.box_rot.apply(
            np.asarray(los, float), inverse=True)
        gxy_mesh = kaiser_model(cosmology, a, init_mesh, self.box_size, b1_L2E(bias["b1"]),
                                fNL_bp=png["fNL_bp"], png_type=self.png_type, los=cell_los,
                                kpow=self.lin_kpow, bg=bg)
        if self.ap_auto is not None:
            # the Kaiser mesh re-sampled on the AP-distorted particle lattice
            pos = regular_pos(self.evol_shape, self.ptcl_shape, self.device)
            if self.evol_sites is not None and self.paint_order <= 2:
                weights = read_sites(gxy_mesh, self.evol_sites)
            else:
                weights = read(pos, gxy_mesh, self.paint_order)
            pos = cell2phys_pos(pos, self.box_center, self.box_rot, self.box_size,
                                self.evol_shape)
            pos = self._ap(pos, los, bg, ap)
            pos = phys2cell_pos(pos, self.box_center, self.box_rot, self.box_size,
                                self.paint_shape)
            gxy_mesh = irfftn(self._advect(pos, weights, self.paint_shape, self.evol_shape))
        if tuple(gxy_mesh.shape) != tuple(self.final_shape):
            gxy_mesh = irfftn(chreshape(rfftn(gxy_mesh), r2chshape(self.final_shape)))
        gxy_mesh = ppl.deterministic("gxy_mesh", gxy_mesh)
        return gxy_mesh, 0.0, stoch, syst

    def _count_mesh(self, gxy_mesh, rcounts, masked=True):
        """The galaxy mesh times the selection, on the final mesh, in the
        footprint (`masked`: the mask's cells, a vector) or the whole box,
        times each radial bin's count."""
        if self._selec_paint is not None:
            gxy_mesh = gxy_mesh * self._selec_paint
        count_mesh = irfftn(chreshape(rfftn(gxy_mesh), r2chshape(self.final_shape)))
        if masked:
            count_mesh = mesh2masked(count_mesh, self.mask_mesh)
        rmesh = self._rmasked if masked else self._rmesh
        return set_radial_count(count_mesh, rmesh, self.redges, rcounts)

    def likelihood(self, params: tuple, temp=1.0):
        """Observe the galaxy count mesh under the `lik_type` noise, or its
        multipole spectra (observable='powspec')."""
        gxy_mesh, phi, stoch, syst = params
        if self.observable == "powspec":
            return self._likelihood_powspec(gxy_mesh, stoch, syst, temp)
        rcounts = syst["ngbars"] * self.cell_length**3
        count_mesh = self._count_mesh(gxy_mesh, rcounts)
        if self._selec_final is not None:
            selec_mesh = set_radial_count(self._selec_final, self._rmasked, self.redges,
                                          rcounts).abs()
        else:
            selec_mesh = rcounts.mean()
        if self.png_type is not None and torch.is_tensor(phi) and phi.ndim == 3:
            phi = mesh2masked(irfftn(chreshape(rfftn(phi), r2chshape(self.final_shape))),
                              self.mask_mesh)

        if self.lik_type == "poisson":
            return ppl.sample("count_mesh", Poisson(count_mesh.abs() ** (1 / temp)))
        if self.lik_type == "fourier_gauss":
            if self.mask_mesh is not None:
                raise ValueError("the Fourier likelihood needs a full box (no footprint mask)")
            kvec = rfftk(self.final_shape, self.box_size, self.device)
            kmesh = sum(ki**2 for ki in kvec) ** 0.5
            mumesh = safe_div(sum(ki * float(li) for ki, li in zip(kvec, self.los_fid)), kmesh)
            scale = (stoch["s_e"] + stoch["s_k2e"] * kmesh**2
                     + stoch["s_kmu2e"] * (kmesh * mumesh) ** 2).abs()
            scale = cgh2rg(scale * selec_mesh**0.5 * temp**0.5, norm="amp")
            return ppl.sample("count_mesh", Normal(cgh2rg(rfftn(count_mesh)), scale))

        delta = count_mesh / selec_mesh - 1
        scale1 = (stoch["s_e"] + stoch["s_ed"] * delta + stoch["s_ep"] * phi).abs() + 1e-9
        scale1 = scale1 * selec_mesh**0.5 * temp**0.5
        scale2 = stoch["s_e2"] * selec_mesh**0.5
        if self.lik_type == "quad_gauss":
            return ppl.sample("count_mesh", QuadGaussian(count_mesh, scale1, scale2))
        if self.lik_type == "two_quad_gauss":
            return ppl.sample("count_mesh", TwoQuadGaussian(count_mesh, scale1, scale2))
        # shash: the moment-matched SinhArcsinh of the quad-Gaussian (mean
        # and std exact, skewness and tails to first order in scale2/scale1)
        ratio = scale2 / scale1
        return ppl.sample("count_mesh", SinhArcsinh(
            count_mesh, (scale1**2 + 2 * scale2**2) ** 0.5, 3.540 * ratio, 1 + 5.884 * ratio**2))

    # ------------------------------------------------------------------ powspec observable
    def _powspec_estimate(self, delta):
        """Stacked multipole spectra (n_ell, n_k) of a density-contrast cube:
        the cached plan's weights, one segment sum (K9)."""
        _, _, pows = _spectrum(delta, box_size=self.box_size, ells=tuple(self.poles),
                               kedges=self._powspec_static()["kedges"], include_corners=False,
                               los=self.los_fid)
        return torch.stack([pows[int(ell)] for ell in self.poles])

    def _powspec_static(self):
        """The powspec observable's static artefacts, host numpy, once per
        model: the k binning (`kedges`, `kmean`) and `tril`, the (n_k, n_ell,
        n_ell) Cholesky factors of the Gaussian multipole covariance
        evaluated on the discrete rfft mode grid,
            C_l1l2(bin) = (2 l1 + 1)(2 l2 + 1) / N_k^2
                          sum_modes 2 w L_l1(mu) L_l2(mu) (P_fid(k, mu) + shot)^2,
        P_fid the fiducial Kaiser spectrum from the port's own `lin_power`,
        shot = s_e^2 / nbar (tril on the model's device)."""
        if self._powspec_cache is not None:
            return self._powspec_cache
        if float(np.linalg.norm(self.los_fid)) == 0 and any(int(ell) > 0 for ell in self.poles):
            warnings.warn("observable='powspec' with ell>0 needs a fixed line of sight "
                          "(off-center box): los_fid is zero, higher multipoles are estimated "
                          "with mu=0.")
        # the plan `_powspec_estimate`'s spectra take (the same cache key)
        kedges = kbin_edges(tuple(self.final_shape), np.asarray(self.box_size, float),
                            self.powspec_kedges, include_corners=False)
        plan, *_, (kmesh, mumesh, mult) = _plan(self.final_shape, self.box_size, kedges,
                                                tuple(int(ell) for ell in self.poles), False,
                                                self.los_fid, self.device)
        kmean, nk, seg, B = plan["kmean"], plan["nmodes"], plan["seg"], plan["nb"]
        nk = np.maximum(nk, 1.0)

        with torch.no_grad():
            ks, pows = lin_power(self.cosmo_fid, a=self.a_fid, kpow=self.lin_kpow,
                                 bg=self.bg_fid, device=self.device)
            f_fid = float(self.bg_fid.a2f(self.a_fid))
        pk = np.interp(kmesh, ks.cpu().numpy(), pows.cpu().numpy(), left=0.0, right=0.0)
        b1E = float(b1_L2E(np.mean(self.fiduc["b1"])))
        nbar = float(np.mean(self.fiduc["ngbars"]))
        shot = float(np.mean(self.fiduc["s_e"])) ** 2 / nbar
        ptot = (b1E + f_fid * mumesh**2) ** 2 * pk + shot

        poles = [int(ell) for ell in self.poles]
        legs = [legendre(ell)(mumesh).reshape(-1) for ell in poles]
        var = 2.0 * mult.reshape(-1) * ptot.reshape(-1) ** 2
        inbin = seg < B
        D = len(poles)
        cov = np.empty((B, D, D))
        for i, li in enumerate(poles):
            for j, lj in enumerate(poles[: i + 1]):
                cij = np.zeros(B)
                np.add.at(cij, seg[inbin], (legs[i] * legs[j] * var)[inbin])
                cij *= (2 * li + 1) * (2 * lj + 1) / nk**2
                cov[:, i, j] = cov[:, j, i] = cij
        # ridge-regularize near-singular low-k blocks
        tr = np.trace(cov, axis1=-2, axis2=-1) / D
        cov += (1e-6 * tr[:, None, None] + 1e-30) * np.eye(D)
        tril = torch.as_tensor(np.linalg.cholesky(cov), dtype=torch.float32, device=self.device)
        self._powspec_cache = {"kedges": np.asarray(kedges), "kmean": np.asarray(kmean),
                               "tril": tril}
        return self._powspec_cache

    def _likelihood_powspec(self, gxy_mesh, stoch, syst, temp=1.0):
        """Gaussian multipole-spectrum likelihood with the per-k-bin
        multipole covariance of `_powspec_static`."""
        rcounts = syst["ngbars"] * self.cell_length**3
        nbar_cell = rcounts.mean()
        delta = self._count_mesh(gxy_mesh, rcounts, masked=False) / nbar_cell - 1.0
        pred = self._powspec_estimate(delta)
        # stochasticity enters as the (scaled) shot-noise monopole
        shot = stoch["s_e"] ** 2 / (nbar_cell / self.cell_length**3)
        e0 = torch.tensor([float(int(ell) == 0) for ell in self.poles], device=self.device)
        mean = pred + shot * e0[:, None]
        tril = self._powspec_static()["tril"] * temp**0.5
        return ppl.sample("powspec", BlockMultivariateNormal(mean, tril))

    def powspec_obs(self, count_mesh=None):
        """The multipoles (n_ell, n_k) of a count mesh (the registered one by
        default), by the likelihood's own estimator."""
        count_mesh = to_tensor(self.count_mesh if count_mesh is None else count_mesh,
                               self.device)
        if self.mask_mesh is not None and count_mesh.ndim == 1:
            count_mesh = masked2mesh(count_mesh, self.mask_mesh)
        nbar_cell = float(np.mean(self.fiduc["ngbars"])) * self.cell_length**3
        with torch.no_grad():
            return self._powspec_estimate(count_mesh / nbar_cell - 1.0)

    def obs_data(self):
        """{site: value} to condition the model on its data: the count mesh,
        or for observable='powspec' its multipoles (an assigned
        `powspec_data`, e.g. a predicted draw, first)."""
        if self.observable == "powspec":
            data = self.powspec_data
            return {"powspec": data if data is not None else self.powspec_obs()}
        return {"count_mesh": self.count_mesh}

    # ------------------------------------------------------------------ reparam
    def reparam(self, params: dict, fourier=True, inv=False, temp=1.0):
        """Sample-space <-> base-space transform of a param dict, on the
        substituted values `self.data` updated by `params`; the output holds
        the counterparts of the keys of `params` only."""
        params_ = params_from_numpy(self.data | params, self.device)
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
        rest = {k: v for k, v in params_.items() if k not in grouped and k in params}
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
        rmasked = self._rmasked.cpu().numpy()
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

    def _labels(self):
        labs = {}
        for name, val in self.latents.items():
            labs[name] = val["label"]
            labs[name + "_"] = "\\tilde" + val["label"]
        return labs

    @classmethod
    def new_latents_from_loc(cls, latents, loc: dict, update_prior: bool = False):
        """New latents config with updated fiducial (and optionally prior)
        locations."""
        new = {}
        for name, conf in latents.items():
            new[name] = conf.copy()
            if name in loc:
                new[name]["loc_fid"] = loc[name]
                if update_prior and "loc" in conf:
                    new[name]["loc"] = loc[name]
        return new

    # ------------------------------------------------------------------ data helpers
    def mesh2masked(self, mesh):
        return mesh2masked(to_tensor(mesh, self.device), self.mask_mesh)

    def masked2mesh(self, mesh):
        return masked2mesh(to_tensor(mesh, self.device), self.mask_mesh)

    def count2delta(self, mesh):
        """Counts -> overdensity under the global integral constraint (the
        fourier_gauss likelihood's counts are the real packing of their
        rfft)."""
        if self.lik_type == "fourier_gauss":
            mesh = irfftn(rg2cgh(to_tensor(mesh, self.device)))
        else:
            mesh = masked2mesh(to_tensor(mesh, self.device), self.mask_mesh)
        selec = self.selec_mesh
        if np.ndim(selec) == 3 and tuple(np.shape(selec)) != tuple(mesh.shape):
            selec = irfftn(chreshape(rfftn(to_tensor(selec, self.device)),
                                     r2chshape(tuple(mesh.shape))))
            selec = masked2mesh(mesh2masked(selec, self.mask_mesh), self.mask_mesh)
        else:
            selec = to_tensor(selec, self.device)
        return count2delta(mesh, selec)

    @classmethod
    def register_catalog(cls, cell_budget: float, cosmo_fid: Cosmology, data, random=None,
                         box_size=None, box_center=None, box_rotvec=None, a_obs=None, los=None,
                         padding: float = 0.0, init_oversamp: float = 3 / 2,
                         paint_oversamp: float = 7 / 4, paint_order: int = 2,
                         interlace_order: int = 2, paint_deconv: bool = True,
                         kernel_type: str = "rectangular", device="cuda"):
        """Register a catalog into inference-ready meshes and metadata, on
        `device` (the card unless the caller names another):
        * cut sky (`random` given): (RA, DEC, Z[, WEIGHT]) dicts; the box
          fitted to the randoms, the selection and the footprint painted
          from the randoms, the counts from the data; light cone, curved sky;
        * full sky (`random` None): a cartesian 'pos' (optional 'vel',
          'WEIGHT') dict or an iterable of such chunks; a periodic box, the
          catalog's RSD at `a_obs` along `los`.
        Every paint is K1 (and the nufft's epilogue K3).  Returns the
        register dict that `utils.io.npsave` writes (None entries dropped).

        Parity: model.py:1332-1406."""
        bg = Background.create(cosmo_fid, device)
        cut_sky = random is not None
        if cut_sky:
            assert a_obs is None and los is None, \
                "cut-sky: a_obs and los must be None (light-cone, curved sky)"
            curved_sky = True
            final_shape, cell_length, box_center, box_rotvec = cutsky2config(
                random, bg, cell_budget, padding, box_size=box_size, box_center=box_center,
                box_rotvec=box_rotvec)
        else:
            assert a_obs is not None and los is not None and box_size is not None \
                and box_center is not None, \
                "full-sky: a_obs, los, box_size, box_center are required"
            box_rotvec = np.zeros(3) if box_rotvec is None else np.asarray(box_rotvec, float)
            final_shape, cell_length = get_mesh_shape(box_size, cell_budget)
            curved_sky = False

        paint_kw = dict(paint_order=paint_order, interlace_order=interlace_order,
                        paint_deconv=paint_deconv)
        box_size = np.multiply(final_shape, cell_length)
        init_shape = scale_shape(final_shape, init_oversamp)
        paint_shape = scale_shape(final_shape, paint_oversamp)
        with torch.no_grad():
            if cut_sky:
                selec_mesh, mask_mesh = cutsky2selection(
                    random, bg, mask_shape=final_shape, selec_shape=init_shape,
                    paint_shape=paint_shape, box_size=box_size, box_center=box_center,
                    box_rotvec=box_rotvec, **paint_kw)
                selec_mesh = irfftn(chreshape(rfftn(selec_mesh), r2chshape(paint_shape)))
                count_mesh = cutsky2count(data, bg, final_shape, paint_shape, box_size=box_size,
                                          box_center=box_center, box_rotvec=box_rotvec,
                                          **paint_kw)
                n_tracers = float(np.sum(np.asarray(data["WEIGHT"], np.float64)))
                n_randoms = float(np.sum(np.asarray(random["WEIGHT"], np.float64)))
            else:
                count_mesh = fullsky2count(data, bg, a_obs, los=los, box_size=box_size,
                                           box_center=box_center, box_rotvec=box_rotvec,
                                           final_shape=final_shape, paint_shape=paint_shape,
                                           **paint_kw)
                box_center = np.multiply(los, float(bg.a2chi(torch.tensor(a_obs))))
                n_tracers = float(count_mesh.sum())
                selec_mesh = mask_mesh = n_randoms = None
        host = lambda x: None if x is None else x.cpu().numpy()
        return {
            "cell_length": float(cell_length),
            "box_center": np.asarray(box_center, float),
            "box_rotvec": np.asarray(box_rotvec, float),
            "init_oversamp": float(init_oversamp),
            "paint_oversamp": float(paint_oversamp),
            "cosmo_fid": {"Omega_m": float(cosmo_fid.Omega_m), "sigma8": float(cosmo_fid.sigma8)},
            "count_mesh": host(count_mesh),
            "selec_mesh": host(selec_mesh),
            "mask_mesh": host(mask_mesh),
            "n_tracers": n_tracers, "n_randoms": n_randoms,
            "a_obs": a_obs, "curved_sky": curved_sky,
            "paint_order": int(paint_order), "interlace_order": int(interlace_order),
            "paint_deconv": bool(paint_deconv), "kernel_type": kernel_type,
            "cell_budget": float(cell_budget), "padding": float(padding),
        }

    # ------------------------------------------------------------------ metrics
    def spectrum(self, mesh0, mesh1=None, ells=0, kedges=None, include_corners=True):
        return spectrum(mesh0, mesh1=mesh1, box_size=self.box_size, box_center=self.box_center,
                        ells=ells, kedges=kedges, include_corners=include_corners)

    def powtranscoh(self, mesh0, mesh1, kedges=None, include_corners=True):
        """(k, P1, (P1/P0)^1/2, P01/(P0 P1)^1/2) of mesh1 against mesh0."""
        return powtranscoh(mesh0, mesh1, box_size=self.box_size, kedges=kedges,
                           include_corners=include_corners)

    # ------------------------------------------------------------------ chains
    def load_runs(self, path, start: int, end: int, transforms=None, batch_ndim=2):
        return Chains.load_runs(path, start, end, transforms, groups=self.groups | self.groups_,
                                labels=self.labels, batch_ndim=batch_ndim)

    def _batched(self, fn, data, batch_ndim):
        """fn(one sample's dict) over the leading `batch_ndim` axes of the
        numpy dict `data`, one sample after another, stacked as numpy."""
        shape = np.shape(next(iter(data.values())))[:batch_ndim]
        outs = []
        for idx in np.ndindex(shape):
            out = fn({k: v[idx] for k, v in data.items()})
            outs.append({k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                         for k, v in out.items()})
        return {k: np.stack([o[k] for o in outs]).reshape(shape + np.shape(outs[0][k]))
                for k in outs[0]}

    def reparam_chains(self, chains: Chains, fourier=False, inv=False, batch_ndim=2):
        """`reparam` of every sample of the chains (their latents; the other
        entries, logdensity and n_evals, as they are)."""
        chains = chains.copy()
        grouped = set().union(*self.groups.values(), *self.groups_.values())
        latents = {k: v for k, v in chains.data.items() if k in grouped}
        if latents:
            with torch.no_grad():
                out = self._batched(functools.partial(self.reparam, fourier=fourier, inv=inv),
                                    latents, batch_ndim)
            chains.data = {k: v for k, v in chains.data.items() if k not in grouped} | out
        return chains

    def powtranscoh_chains(self, chains: Chains, mesh0, names=(), kedges=None, batch_ndim=2):
        """Add 'kptc_{name}' = (k, P, transfer, coherence) of each sample's
        mesh `name` against the reference `mesh0`, stacked (*batch, 4, n_k)
        (the batch axes first, so that runs concatenate as every entry)."""
        chains = chains.copy()
        mesh0 = to_tensor(mesh0, self.device)
        for name in np.atleast_1d(names):
            def kptc(d):
                out = self.powtranscoh(mesh0, to_tensor(d[name], self.device), kedges=kedges)
                return {str(i): x for i, x in enumerate(out)}
            with torch.no_grad():
                out = self._batched(kptc, {name: chains.data[name]}, batch_ndim)
            chains.data[f"kptc_{name}"] = np.stack([out[str(i)] for i in range(4)], batch_ndim)
        return chains

    def kaiser_post(self, gen, base=False, temp=1.0, scale_field=1.0):
        """Draw from the analytic Kaiser posterior of the init field given the
        observed counts, with the fiducial values for the latents not in
        `data`: the chains' start.  `gen` is a torch.Generator on the model's
        device (or an int); temp=0 gives the posterior mean."""
        gen = ppl._generator(gen, self.device)
        with torch.no_grad():
            delta_obs = rfftn(self.count2delta(self.count_mesh))
            delta_obs = chreshape(delta_obs, r2chshape(self.init_shape))

            b1E_fid = b1_L2E(float(np.mean(self.fiduc["b1"])))
            var_fid = float(np.mean(self.fiduc["s_e"])) / (self.count_fid * self.selec_fid)
            means, stds = kaiser_posterior(delta_obs, self.cosmo_fid, self.a_fid,
                                           self.box_size, var_noise=var_fid, b1E=b1E_fid,
                                           los=self.los_fid, bg=self.bg_fid)

            noise = torch.randn(ch2rshape(means.shape), generator=gen, device=self.device)
            post_mesh = rg2cgh(noise)
            post_mesh = temp**0.5 * stds * post_mesh + means
            post_mesh = lin2white(self.cosmo_fid, post_mesh, self.init_shape,
                                  self.box_size, self.lin_kpow)
            # scaling down is recommended when the Kaiser approximation degrades
            post_mesh = post_mesh * scale_field

            start = {k: self.fiduc[k] for k in self.fiduc.keys() - self.data.keys()}
            start |= {k: post_mesh for k in {"white_mesh"} - self.data.keys()}
            return start if base else self.reparam(start, inv=True)
