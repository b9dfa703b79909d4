"""Figures: mesh projections, power/transfer/coherence panels with credible
bands, pdf panels, corner plots, trace grids, the powspec posterior
predictive, themes.

matplotlib is imported with the module: where it is missing, importing
`montecosmo_tpu_torch.plot` raises an ImportError that names it (the
campaign's figures are then skipped with one line each, `script.py`).  The
numbers a figure draws come from functions of their own, which take and
return numpy: `_projection`, `vlim`, `_band`, `_pdf_curve`,
`_corner_names`, `_corner_1d`, `_corner_2d`, `_contour_levels`,
`_ppc_bands`, `_ppc_sigma`.  Tensors are taken off the device with
`utils.io.to_np`.

Parity: `montecosmo_tpu/plot.py` (all of it: palette and theme :20-43,
plot_mesh :47, anim_meshes :75, anim_scan :97, _fill_band :115, the
spectrum panels :124-174, plot_pdf :177, corner_plot :186, _contour_levels
:270, plot_chains :283, plot_powspec_ppc :317) and `vlim`
(`montecosmo_tpu/utils/safe.py:72`).
"""
import numpy as np

from montecosmo_tpu_torch.utils.io import to_np

try:
    import matplotlib as mpl
    import matplotlib.pyplot as plt
except ImportError as exc:  # the card's machine has no matplotlib
    raise ImportError("montecosmo_tpu_torch.plot draws with matplotlib, which is not "
                      "installed") from exc

# ----------------------------------------------------------------------- palette
_DARK2 = plt.get_cmap("Dark2").colors
_SET2 = plt.get_cmap("Set2").colors


def SetDark2(i, light=False):
    """Paired qualitative palette: Dark2 for lines, Set2 for fills."""
    return (_SET2 if light else _DARK2)[i % 8]


def theme(dark=False):
    """Switch the global matplotlib theme."""
    if dark:
        plt.style.use("dark_background")
        mpl.rcParams["figure.facecolor"] = "#111111"
        mpl.rcParams["axes.facecolor"] = "#111111"
    else:
        plt.style.use("default")


def color_switch(color, dark=None):
    """Flip black <-> white line colours for the current theme."""
    if dark is None:
        dark = mpl.rcParams["axes.facecolor"] in ("#111111", "black")
    if color in ("k", "black"):
        return "w" if dark else "k"
    return color


# ----------------------------------------------------------------------- meshes
def vlim(a, level=1.0, scale=1.0, axis=None):
    """Robust (inf, sup) limits of an array: the quantiles (1 -+ level) / 2,
    their margin around the midpoint scaled by `scale`."""
    a = to_np(a)
    vmin = np.quantile(a, (1 - level) / 2, axis=axis)
    vmax = np.quantile(a, (1 + level) / 2, axis=axis)
    mid, half = (vmax + vmin) / 2, scale * (vmax - vmin) / 2
    return np.stack((mid - half, mid + half), axis=-1)


def _projection(mesh, axis=2, fraction=1.0):
    """The mean of the central `fraction` slab of a mesh along `axis`."""
    mesh = to_np(mesh)
    n = mesh.shape[axis]
    lo = int(n * (1 - fraction) / 2)
    hi = max(lo + 1, n - lo)
    sl = [slice(None)] * 3
    sl[axis] = slice(lo, hi)
    return mesh[tuple(sl)].mean(axis)


def plot_mesh(mesh, box_size=None, axis=2, fraction=1.0, vlims=None, cmap="magma",
              colorbar=True, **kw):
    """Mean projection of a central slab of the mesh along `axis`."""
    proj = _projection(mesh, axis, fraction)
    extent = None
    if box_size is not None:
        axes = [i for i in range(3) if i != axis]
        extent = (0, box_size[axes[1]], 0, box_size[axes[0]])
    vmin, vmax = (None, None) if vlims is None else vlim(proj.astype(np.float32), vlims)
    im = plt.imshow(proj, extent=extent, cmap=cmap, vmin=vmin, vmax=vmax, **kw)
    if colorbar:
        plt.colorbar(im, fraction=0.046, pad=0.04)
    return im


def anim_meshes(meshes, box_size=None, axis=2, fraction=1.0, interval=100, cmap="magma", **kw):
    """Animate a sequence of meshes (N-body snapshots, say)."""
    from matplotlib.animation import FuncAnimation

    fig = plt.gcf()
    im = plot_mesh(meshes[0], box_size, axis, fraction, cmap=cmap, colorbar=False, **kw)

    def update(i):
        im.set_data(_projection(meshes[i], axis, fraction))
        return (im,)

    return FuncAnimation(fig, update, frames=len(meshes), interval=interval)


def anim_scan(mesh, axis=2, interval=50, cmap="magma", **kw):
    """Animate a scan through the slices of one mesh."""
    from matplotlib.animation import FuncAnimation

    mesh = to_np(mesh)
    fig = plt.gcf()
    sl = [slice(None)] * 3
    sl[axis] = 0
    im = plt.imshow(mesh[tuple(sl)], cmap=cmap, **kw)

    def update(i):
        sl[axis] = i
        im.set_data(mesh[tuple(sl)])
        return (im,)

    return FuncAnimation(fig, update, frames=mesh.shape[axis], interval=interval)


# ----------------------------------------------------------------------- spectra
def _band(ys, prob):
    """The equal-tail credible bands over the leading (chain) axis of ys,
    one (lo, hi) pair for each probability."""
    ys = to_np(ys)
    return [(np.quantile(ys, (1 - p) / 2, axis=0), np.quantile(ys, (1 + p) / 2, axis=0))
            for p in np.atleast_1d(prob)]


def _fill_band(x, ys, prob, color=None, alpha=0.25):
    for lo, hi in _band(ys, prob):
        plt.fill_between(to_np(x), lo, hi, color=color, alpha=alpha, lw=0)


def _panel(k, ys, args, fill, color, kw):
    """One spectrum panel: credible bands of batched ys with `fill`, else a
    line."""
    if fill is not None and np.ndim(ys) > 1:
        k0 = to_np(k)[0] if np.ndim(k) > 1 else to_np(k)
        _fill_band(k0, ys, fill, color=color)
        return None
    return plt.plot(to_np(k), to_np(ys), *args, color=color, **kw)


def plot_pow(k, pow, *args, fill=None, color=None, **kw):
    """P(k) panel (log-log); with batched pow and `fill`, credible bands."""
    plt.xlabel(r"$k$ [$h/\mathrm{Mpc}$]")
    plt.ylabel(r"$P(k)$ [$(\mathrm{Mpc}/h)^3$]")
    plt.xscale("log")
    plt.yscale("log")
    return _panel(k, pow, args, fill, color, kw)


def plot_trans(k, trans, *args, fill=None, color=None, **kw):
    """Transfer function panel (semilog x)."""
    plt.xlabel(r"$k$ [$h/\mathrm{Mpc}$]")
    plt.ylabel(r"$(P_1 / P_0)^{1/2}$")
    plt.xscale("log")
    return _panel(k, trans, args, fill, color, kw)


def plot_coh(k, coh, *args, fill=None, color=None, **kw):
    """Coherence panel (semilog x)."""
    plt.xlabel(r"$k$ [$h/\mathrm{Mpc}$]")
    plt.ylabel(r"$P_{01} / (P_0 P_1)^{1/2}$")
    plt.xscale("log")
    return _panel(k, coh, args, fill, color, kw)


def plot_powtranscoh(k, pow, trans, coh, *args, fill=None, color=None, label=None, **kw):
    """The 3-panel (P, transfer, coherence) figure; batched inputs and
    `fill` give credible bands."""
    plt.subplot(131)
    plot_pow(k, pow, *args, fill=fill, color=color, label=label, **kw)
    plt.subplot(132)
    plot_trans(k, trans, *args, fill=fill, color=color, label=label, **kw)
    plt.subplot(133)
    plot_coh(k, coh, *args, fill=fill, color=color, label=label, **kw)


def _pdf_curve(samples, bins=64, density=True):
    """(bin centres, histogram) of the flattened samples."""
    hist, edges = np.histogram(to_np(samples).reshape(-1), bins=bins, density=density)
    return (edges[:-1] + edges[1:]) / 2, hist


def plot_pdf(samples, bins=64, density=True, *args, **kw):
    """Histogram pdf panel of the flattened samples."""
    return plt.plot(*_pdf_curve(samples, bins, density), *args, **kw)


# ----------------------------------------------------------------------- corner
def _corner_names(chains):
    """The variables a corner plot shows: the entries of the first
    container of at most two dimensions (chain, sample), not empty."""
    return [k for k, v in chains[0].data.items() if np.ndim(v) <= 2 and np.size(v) > 0]


def _corner_1d(values, bins, lims, smooth):
    """(centres, smoothed density) of one variable's diagonal panel."""
    from scipy.ndimage import gaussian_filter1d

    hist, edges = np.histogram(values, bins=bins, range=lims, density=True)
    return (edges[:-1] + edges[1:]) / 2, gaussian_filter1d(hist, smooth)


def _corner_2d(xv, yv, bins, xlims, ylims, smooth, prob):
    """(x centres, y centres, smoothed 2-D histogram, contour levels) of one
    off-diagonal panel."""
    from scipy.ndimage import gaussian_filter

    h, xe, ye = np.histogram2d(xv, yv, bins=bins, range=(xlims, ylims))
    h = gaussian_filter(h.T, smooth)
    return (xe[:-1] + xe[1:]) / 2, (ye[:-1] + ye[1:]) / 2, h, _contour_levels(h, prob)


def corner_plot(chains, labels=None, markers=None, prob=(0.68, 0.95), bins=40, figsize=None,
                colors=None, smooth=1.5):
    """Triangle (corner) plot of one or several Chains: the variables of
    at most (chain, sample) dimensions; `markers` maps names to truth
    values drawn as reference lines."""
    if not isinstance(chains, (list, tuple)):
        chains = [chains]
    if colors is None:
        colors = [SetDark2(i) for i in range(len(chains))]
    names = _corner_names(chains)
    n = len(names)
    if n == 0:
        raise ValueError("no scalar variables to corner-plot")

    flat = [{k: to_np(c.data[k]).reshape(-1) for k in names} for c in chains]
    lims = {k: (min(f[k].min() for f in flat), max(f[k].max() for f in flat)) for k in names}
    fig, axes = plt.subplots(n, n, figsize=figsize or (2 * n, 2 * n), squeeze=False)
    for i, ki in enumerate(names):
        for j, kj in enumerate(names):
            ax = axes[i][j]
            if j > i:
                ax.axis("off")
                continue
            for c, f in enumerate(flat):
                if i == j:
                    centers, hist = _corner_1d(f[ki], bins, lims[ki], smooth)
                    ax.plot(centers, hist, color=colors[c],
                            label=(labels[c] if labels and i == 0 else None))
                else:
                    xc, yc, h, levels = _corner_2d(f[kj], f[ki], bins, lims[kj], lims[ki],
                                                   smooth, prob)
                    ax.contourf(xc, yc, h, levels=[*levels, h.max() + 1e-9], colors=[colors[c]],
                                alpha=0.3)
                    ax.contour(xc, yc, h, levels=levels, colors=[colors[c]], linewidths=1)
            if markers and ki in markers and i == j:
                ax.axvline(markers[ki], color="0.4", ls=":")
            if markers and i != j:
                if kj in markers:
                    ax.axvline(markers[kj], color="0.4", ls=":")
                if ki in markers:
                    ax.axhline(markers[ki], color="0.4", ls=":")
            lab_i = chains[0].labels.get(ki, ki) if chains[0].labels else ki
            lab_j = chains[0].labels.get(kj, kj) if chains[0].labels else kj
            if i == n - 1:
                ax.set_xlabel(f"${lab_j}$")
            else:
                ax.set_xticklabels([])
            if j == 0 and i != 0:
                ax.set_ylabel(f"${lab_i}$")
            elif i != j:
                ax.set_yticklabels([])
            if i == j:
                ax.set_yticks([])
    if labels:
        axes[0][0].legend(loc="upper left", bbox_to_anchor=(1.05, 1.0))
    fig.align_labels()
    plt.subplots_adjust(wspace=0.06, hspace=0.06)
    return fig


def _contour_levels(hist, prob):
    """The density levels that enclose the given probability masses."""
    flat = np.sort(hist.reshape(-1))[::-1]
    cum = np.cumsum(flat)
    cum /= cum[-1]
    levels = []
    for p in sorted(np.atleast_1d(prob), reverse=True):
        idx = np.searchsorted(cum, p)
        levels.append(flat[min(idx, len(flat) - 1)])
    return sorted(set(levels))


# ----------------------------------------------------------------------- traces
def plot_chains(chains, names=None, batch_ndim=2, grid=True, log=False):
    """A grid of per-chain trace plots, one subfigure per name (or group)."""
    names = list(chains.data) if names is None else list(np.atleast_1d(names))
    n_conc = max(batch_ndim - 2, 0)
    n_exp = max(2 - batch_ndim, 0)

    def conc_exp(v):
        v = to_np(v)
        for _ in range(n_conc):
            v = np.concatenate(v)
        return np.expand_dims(v, axis=tuple(range(n_exp)))

    conc = chains[names].map(conc_exp)
    n_chains = np.shape(next(iter(conc.data.values())))[0]

    fig = plt.gcf()
    subfigs = np.atleast_1d(fig.subfigures(len(names), 1))
    for subfig, name in zip(subfigs, names):
        subfig.suptitle(f"{name}")
        axs = np.atleast_1d(subfig.subplots(1, n_chains, sharey="row"))
        subfig.subplots_adjust(wspace=0)
        for k, v in conc[[name]].data.items():
            label = conc.labels.get(k) if conc.labels else None
            for i_c, ax in enumerate(axs):
                ax.plot(v[i_c].reshape(v[i_c].shape[0], -1),
                        label=k if label is None else "$" + label + "$")
                if log:
                    ax.set_yscale("log")
                ax.grid(grid)
        handles, _ = axs[-1].get_legend_handles_labels()
        if handles:
            axs[-1].legend()
    return fig


def _ppc_bands(preds, prob):
    """Per multipole: (median, [(lo, hi) for each probability, widest
    first]) of posterior-predictive draws (n_samples, n_ell, n_k)."""
    preds = to_np(preds)
    out = []
    for i in range(preds.shape[1]):
        ys = preds[:, i, :]
        bands = [tuple(np.percentile(ys, [50 - 50 * p, 50 + 50 * p], axis=0))
                 for p in sorted(prob, reverse=True)]
        out.append((np.median(ys, 0), bands))
    return out


def _ppc_sigma(tril):
    """The (n_ell, n_k) standard deviations of a covariance Cholesky (n_k,
    n_ell, n_ell)."""
    return np.sqrt(np.sum(to_np(tril)**2, axis=-1)).T


def plot_powspec_ppc(kmean, obs, tril=None, preds=None, poles=(0, 2, 4), prob=(0.68, 0.95),
                     axs=None):
    """The posterior-predictive multipole panel of observable='powspec':
    the observed multipoles obs (n_ell, n_k) at kmean, with +-1 sigma bars
    from the covariance Cholesky `tril`, and the median and credible bands
    of the draws `preds` (n_samples, n_ell, n_k).  Returns the axes."""
    kmean = to_np(kmean)
    obs = to_np(obs)
    n_ell = obs.shape[0]
    if axs is None:
        _, axs = plt.subplots(1, n_ell, figsize=(4 * n_ell, 3.2), layout="constrained",
                              squeeze=False)
        axs = axs[0]
    sig = None if tril is None else _ppc_sigma(tril)
    bands = None if preds is None else _ppc_bands(preds, prob)
    for i, ell in enumerate(poles[:n_ell]):
        ax = axs[i]
        if bands is not None:
            med, pairs = bands[i]
            for lo, hi in pairs:
                ax.fill_between(kmean, lo, hi, color=SetDark2(0), alpha=0.25)
            ax.plot(kmean, med, color=SetDark2(0), label="post")
        if sig is not None:
            ax.errorbar(kmean, obs[i], yerr=sig[i], fmt="k.", capsize=2, label="obs")
        else:
            ax.plot(kmean, obs[i], "k.", label="obs")
        ax.set_xlabel(r"$k$ [$h$/Mpc]")
        ax.set_ylabel(rf"$P_{{{int(ell)}}}(k)$")
        ax.set_xscale("log")
        if int(ell) == 0:
            ax.set_yscale("log")
        ax.legend()
    return axs
