"""The port's figures on the CPU under the Agg backend: every `plot`
function draws the JAX package's numbers, the campaign's figures are
written from chains saved directly as arrays (no sampling), and
`make_logdf_mesh` equals the JAX package's `Model.logdf_mesh` per sample.

"The same numbers" is every array the two figures hold, in drawing order:
line data, collection paths (bands, contours, error bars), images.  They
come from the same numpy arithmetic on the same numpy inputs, so they are
held to 1e-6 relative.  The logpdf/logcdf meshes are the
8^3 Kaiser model of tests/test_torch_likelihoods.py (every latent
unbounded), at 1e-4 of the largest entry, that file's tolerance.
"""
import importlib
import sys

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax import numpy as jnp  # noqa: E402
from matplotlib.collections import Collection  # noqa: E402
from matplotlib.image import AxesImage  # noqa: E402
from matplotlib.lines import Line2D  # noqa: E402

import montecosmo_tpu.plot as jplot  # noqa: E402
from montecosmo_tpu.chains import Chains as JaxChains  # noqa: E402

from montecosmo_tpu_torch import FieldLevelModel, default_config  # noqa: E402
from montecosmo_tpu_torch import plot as tplot  # noqa: E402
from montecosmo_tpu_torch import script  # noqa: E402
from montecosmo_tpu_torch.chains import Chains  # noqa: E402
from montecosmo_tpu_torch.utils.io import npload, npsave  # noqa: E402

torch.set_num_threads(1)

RNG = np.random.default_rng(3)
K = np.logspace(-2, -0.5, 10)
KPTC = (np.broadcast_to(K, (6, 10)), np.exp(RNG.normal(8, 0.1, (6, 10))),
        RNG.normal(1, 0.05, (6, 10)), RNG.normal(0.9, 0.05, (6, 10)))
SCALARS = {"Omega_m": RNG.normal(0.3, 0.02, (2, 60)), "sigma8": RNG.normal(0.8, 0.03, (2, 60)),
           "b1": RNG.normal(1.0, 0.1, (2, 60))}
LABELS = {"Omega_m": r"\Omega_m", "sigma8": r"\sigma_8"}


def _drawn(fig):
    """Every array a figure holds, in drawing order."""
    out = []
    for a in fig.findobj(lambda o: isinstance(o, (Line2D, Collection, AxesImage))):
        if isinstance(a, Line2D):
            out.append(np.asarray(a.get_xydata(), float))
        elif isinstance(a, AxesImage):
            out.append(np.asarray(a.get_array(), float))
        else:
            out.extend(np.asarray(p.vertices, float) for p in a.get_paths())
    return out


def _same_figure(draw_jax, draw_port):
    figs = []
    for draw in (draw_jax, draw_port):
        plt.figure(figsize=(6, 4))
        draw()
        figs.append(_drawn(plt.gcf()))
        plt.close("all")
    want, got = figs
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)


def test_plot_functions_draw_the_jax_numbers():
    """The spectrum panels (lines, bands, the 3-panel figure), the pdf, the
    mesh projection with robust limits, the animations' frames, corner plots
    of one and two Chains with markers, trace grids (by name and group) and
    the powspec posterior predictive; the palette and theme helpers; and the
    numbers' own functions against the JAX package's."""
    for fn in ("plot_pow", "plot_trans", "plot_coh"):
        _same_figure(lambda: getattr(jplot, fn)(K, KPTC[1][0], "k:"),
                     lambda: getattr(tplot, fn)(torch.as_tensor(K), KPTC[1][0], "k:"))
        _same_figure(lambda: getattr(jplot, fn)(*KPTC[:2], fill=(0.68, 0.95)),
                     lambda: getattr(tplot, fn)(*KPTC[:2], fill=(0.68, 0.95)))
    _same_figure(lambda: jplot.plot_powtranscoh(*KPTC, fill=0.68, color="C1", label="a"),
                 lambda: tplot.plot_powtranscoh(*KPTC, fill=0.68, color="C1", label="a"))
    _same_figure(lambda: jplot.plot_pdf(KPTC[2], 20), lambda: tplot.plot_pdf(KPTC[2], 20))
    mesh = RNG.normal(size=(8, 8, 8)).astype(np.float32)
    _same_figure(lambda: jplot.plot_mesh(mesh, (80, 80, 80), 1, 0.5, vlims=0.9),
                 lambda: tplot.plot_mesh(torch.as_tensor(mesh), (80, 80, 80), 1, 0.5,
                                         vlims=0.9))
    for maker in ("anim_meshes", "anim_scan"):
        frames = []
        for mod in (jplot, tplot):
            plt.figure()
            anim = getattr(mod, maker)([mesh, 2 * mesh] if maker == "anim_meshes" else mesh)
            anim._func(1)
            frames.append(_drawn(plt.gcf()))
            anim.event_source.stop()
            plt.close("all")
        for g, w in zip(*frames):
            np.testing.assert_array_equal(g, w)

    jc = [JaxChains({k: v[:, i::2] for k, v in SCALARS.items()}, {"cosmo": ["Omega_m", "sigma8"]},
                    LABELS) for i in range(2)]
    tc = [Chains({k: v[:, i::2] for k, v in SCALARS.items()}, {"cosmo": ["Omega_m", "sigma8"]},
                 LABELS) for i in range(2)]
    _same_figure(lambda: jplot.corner_plot(jc[0], markers={"Omega_m": 0.3, "b1": 1.0}),
                 lambda: tplot.corner_plot(tc[0], markers={"Omega_m": 0.3, "b1": 1.0}))
    _same_figure(lambda: jplot.corner_plot(jc, labels=["x", "y"], bins=20),
                 lambda: tplot.corner_plot(tc, labels=["x", "y"], bins=20))
    _same_figure(lambda: jplot.plot_chains(jc[0], ["cosmo", "b1"]),
                 lambda: tc[0].plot(["cosmo", "b1"]))
    preds = RNG.normal(1e3, 50, (20, 3, 10))
    tril = np.tile(np.diag([30.0, 20.0, 10.0]), (10, 1, 1))
    _same_figure(lambda: jplot.plot_powspec_ppc(K, preds[0], tril=tril, preds=preds),
                 lambda: tplot.plot_powspec_ppc(K, preds[0], tril=tril, preds=preds))
    _same_figure(lambda: jplot.plot_powspec_ppc(K, preds[0, :2], poles=(0, 2)),
                 lambda: tplot.plot_powspec_ppc(K, preds[0, :2], poles=(0, 2)))

    hist = RNG.uniform(size=(12, 12))
    assert tplot._contour_levels(hist, (0.68, 0.95)) == jplot._contour_levels(hist, (0.68, 0.95))
    np.testing.assert_array_equal(tplot.vlim(mesh, 0.9, 1.2),
                                  np.asarray(jax.jit(lambda m: jplot.vlim(m, 0.9, 1.2))(mesh)))
    assert [tplot.SetDark2(i, light) for i in range(9) for light in (0, 1)] == [
        jplot.SetDark2(i, light) for i in range(9) for light in (0, 1)]
    tplot.theme(dark=True)
    assert tplot.color_switch("k") == jplot.color_switch("k") == "w"
    tplot.theme()
    assert tplot.color_switch("black") == "k" and tplot.color_switch("C2") == "C2"


def test_plot_needs_matplotlib_and_the_campaign_skips_its_figures(monkeypatch, tmp_path):
    """Without matplotlib, importing the port's plot raises an ImportError
    naming it; a figure prints one line naming itself and the run goes on,
    the numbers behind it computed all the same."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "montecosmo_tpu_torch.plot")
    with pytest.raises(ImportError, match="matplotlib"):
        importlib.import_module("montecosmo_tpu_torch.plot")
    with pytest.raises(ImportError, match="getdist"):
        Chains({"x": np.zeros((1, 2))}).to_getdist()
    lines = []
    drawn = []
    out = script._figure("triangle plot", tmp_path / "t.png", lambda plot, plt: drawn.append(1),
                         lambda *a: lines.append(" ".join(map(str, a))))
    assert out is None and not drawn and not (tmp_path / "t.png").exists()
    assert len(lines) == 1 and lines[0].startswith("WARNING: triangle plot skipped")


# tests/test_torch_likelihoods.py's BASE (8^3 Kaiser at a_obs 0.5, flat sky,
# one radial bin), every latent unbounded
UNBOUNDED = {k: {kk: vv for kk, vv in v.items() if kk not in ("low", "high")}
             for k, v in default_config["latents"].items()}
BASE = dict(final_shape=(8, 8, 8), cell_length=40.0, evolution="kaiser", a_obs=0.5,
            curved_sky=False, box_center=(0.0, 0.0, 1000.0), precond="kaiser",
            init_oversamp=1.0, evol_oversamp=1.0, ptcl_oversamp=1.0, paint_oversamp=1.0,
            n_rbins=1, latents=UNBOUNDED)


INFERRED = ("Omega_m", "sigma8", "b1", "white_mesh")


def _campaign_dir(path, seed):
    """A campaign's save dir written directly, as a self-data campaign
    leaves it: model.yaml, obs.npz (the counts predicted at the fiducial,
    and every latent but INFERRED at its fiducial value), truth.npz (their
    white mesh) and two runs of 2 chains x 2 samples of the INFERRED
    latents, their fiducial sample-space values moved by 0.3 sigma and
    white meshes drawn from `seed`."""
    model = FieldLevelModel(**{**default_config, **BASE}, device="cpu")
    rng = np.random.default_rng(seed)
    (path / "chains").mkdir(parents=True)
    model.save(path / "model.yaml")
    with torch.no_grad():
        pred = model.predict(seed=seed, samples=model.fiduc, hide_base=False, hide_samp=False,
                             from_base=True)
        p0 = {k: v.numpy() for k, v in model.reparam(model.fiduc, inv=True).items()}
    npsave(path / "truth.npz", {"white_mesh": pred["white_mesh"]})
    obs = {k: np.float32(v) for k, v in model.fiduc.items() if k not in INFERRED}
    npsave(path / "obs.npz", obs | {"count_mesh": pred["count_mesh"].numpy()})
    for run in (1, 2):
        samples = {}
        for k in INFERRED:
            base = p0.get(k + "_", np.zeros(model.init_shape, np.float32))
            scale = 0.3 if k + "_" in p0 else 1.0
            samples[k + "_"] = (base + scale * rng.standard_normal((2, 2) + np.shape(base))
                                ).astype(np.float32)
        samples["logdensity"] = rng.normal(size=(2, 2)).astype(np.float32)
        samples["n_evals"] = np.full((2, 2), 10)
        npsave(path / "chains" / f"run_{run}.npz", samples)
    return model


def test_make_chains_compare_chains_and_field_warmup_write_their_figures(tmp_path):
    """make_chains writes chains.npz, chains_.npz, triangle.png, kptc.png
    and chains_.png; compare_chains writes the triangle_ and kptc_ figures
    of two campaigns (here one campaign under two labels) and returns the
    numbers it draws; plot_field_warmup writes field_warm.png from a chain
    state."""
    _campaign_dir(tmp_path / "a", 0)
    lines = []
    chains = script.make_chains(tmp_path / "a", device="cpu", log=lambda *a: lines.append(a))
    assert not any("skipped" in str(line) for line in lines)
    for f in ("triangle.png", "kptc.png", "chains_.png", "chains/chains.npz",
              "chains/chains_.npz"):
        assert (tmp_path / "a" / f).stat().st_size > 0, f
    assert chains.shape["logdensity"] == (2, 4)
    base = Chains.load(tmp_path / "a" / "chains" / "chains.npz")
    assert base.shape["kptc_white_mesh"][:3] == (2, 4, 4)
    kpow_ref, kptcs = script.compare_chains([tmp_path / "a"] * 2, ["a", "b"], tmp_path,
                                            device="cpu", log=lambda *a: None)
    for f in ("triangle_a_b.png", "kptc_a_b.png"):
        assert (tmp_path / f).stat().st_size > 0
    assert set(kptcs) == {"a", "b"} and kptcs["a"][1].shape == (8, len(kpow_ref[0]))
    np.testing.assert_array_equal(kptcs["a"][3], base["kptc_white_mesh"][:, :, 3].reshape(8, -1))
    assert np.isfinite(kpow_ref[1]).all()

    # the field warmup's model: every latent but the field at the fiducial
    model = FieldLevelModel.load(tmp_path / "a" / "model.yaml", device="cpu")
    model.white_mesh = torch.as_tensor(npload(tmp_path / "a" / "truth.npz")["white_mesh"])
    model.substitute(model.fiduc, from_base=True)
    run = npload(tmp_path / "a" / "chains" / "run_1.npz")
    pos = {"white_mesh_": torch.as_tensor(run["white_mesh_"][:, 0])}

    class State:
        position = {k: v + 0.1 for k, v in pos.items()}

    start, warm, true = script.plot_field_warmup(model, pos, State, tmp_path)
    assert (tmp_path / "field_warm.png").stat().st_size > 0
    assert start[1].shape == warm[1].shape == (2, len(true[0]))


def test_make_logdf_mesh_matches_jax(tmp_path):
    """make_logdf_mesh over 2 chains x 4 samples of the 8^3 Kaiser model
    equals the JAX package's Model.logdf_mesh of each sample, conditioned
    and blocked as its make_logdf_mesh does (one jitted program), and is
    saved to chains/logdf_mesh.npz."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default

    _campaign_dir(tmp_path, 7)
    logpdf, logcdf = script.make_logdf_mesh(tmp_path, thinning=1, device="cpu",
                                            log=lambda *a: None)
    assert logpdf.shape == logcdf.shape == (2, 4, 8, 8, 8)
    saved = npload(tmp_path / "chains" / "logdf_mesh.npz")
    np.testing.assert_array_equal(saved["logpdf_mesh"], logpdf)

    jm = JaxModel(**{**jax_default, **BASE})
    jm.reset()
    jm.substitute({k: jnp.asarray(v) for k, v in npload(tmp_path / "obs.npz").items()},
                  from_base=True)
    jm.block()
    fn = jax.jit(lambda p: jm.logdf_mesh(p, site="count_mesh"))
    runs = [npload(tmp_path / "chains" / f"run_{i}.npz") for i in (1, 2)]
    names = set().union(*jm.groups_.values())
    for c in range(2):
        for s in range(4):
            run, i = runs[s // 2], s % 2
            want = fn({k: jnp.asarray(v[c, i]) for k, v in run.items() if k in names})
            for got, ref in zip((logpdf[c, s], logcdf[c, s]), want):
                ref = np.asarray(ref)
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
