"""Catalog and initial-condition files into the dicts that
`FieldLevelModel.register_catalog` takes:

* box catalogs: {'pos': (n, 3) [Mpc/h], optional 'vel': (n, 3) [km/s]};
* cut-sky catalogs (data or randoms): {'RA', 'DEC', 'Z', 'WEIGHT'};
* real-space linear IC meshes.

`.npy` and `.npz` need numpy only.  `.h5` needs h5py, `.fits` fitsio,
AbacusSummit `.asdf` asdf or abacusnbody, and a Boltzmann power spectrum
cosmoprimo: each is imported where a file asks for it, and its absence is an
ImportError that names the `.npy`/`.npz` alternative.

Parity: `run/catalogs.py:38-155` (read_table, load_box_catalog,
load_cutsky_catalog, load_ic_mesh, lin_kpow_cosmoprimo).
"""
import importlib
from pathlib import Path

import numpy as np

_MISSING = {
    "h5py": "reading .h5 catalogs needs h5py",
    "fitsio": "reading .fits catalogs needs fitsio",
    "asdf": "reading .asdf meshes needs asdf",
    "abacusnbody.data.read_abacus": "reading AbacusSummit particle files needs abacusnbody",
    "cosmoprimo": "a Boltzmann linear power spectrum needs cosmoprimo",
    "cosmoprimo.fiducial": "a Boltzmann linear power spectrum needs cosmoprimo",
}
_ALTERNATIVE = ("; numpy formats need nothing more: positions as a (n, 3) .npy, columns as "
                "arrays of one .npz (numpy.savez), an IC mesh as a .npy")


def optional_import(name: str):
    """Import `name`, or raise an ImportError that names what needs it and
    the numpy formats that do not."""
    try:
        return importlib.import_module(name)
    except ImportError as exc:
        raise ImportError(_MISSING.get(name, f"missing optional dependency {name!r}")
                          + _ALTERNATIVE) from exc


def _native(arr):
    """Native byte order (fitsio returns big-endian columns)."""
    arr = np.asarray(arr)
    if arr.dtype.byteorder not in ("=", "|", "<"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def read_table(path, columns):
    """Named columns of a .fits, .npz or .h5 table, as native float64."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".fits", ".fit", ".gz"):
        rec = optional_import("fitsio").read(str(path), columns=list(columns))
        return {c: _native(rec[c]).astype(np.float64) for c in columns}
    if suffix == ".npz":
        with np.load(path) as f:
            return {c: np.asarray(f[c], dtype=np.float64) for c in columns}
    if suffix in (".h5", ".hdf5"):
        with optional_import("h5py").File(path, "r") as f:
            return {c: np.asarray(f[c], dtype=np.float64) for c in columns}
    raise ValueError(f"unsupported catalog table format {path.suffix!r} ({path})")


def load_box_catalog(path, pos_cols=("x", "y", "z"), vel_cols=None):
    """A cartesian catalog -> {'pos', optional 'vel'}: a (n, 3) .npy of
    positions, the named columns of a table (.npz/.fits/.h5), or an
    AbacusSummit .asdf particle file."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        return {"pos": np.asarray(np.load(path), dtype=np.float64)}
    if path.suffix.lower() == ".asdf":
        cat = optional_import("abacusnbody.data.read_abacus").read_asdf(
            str(path), load=["pos", "vel"])
        out = {"pos": _native(cat["pos"]).astype(np.float64)}
        if "vel" in cat:
            out["vel"] = _native(cat["vel"]).astype(np.float64)
        return out
    cols = list(pos_cols) + (list(vel_cols) if vel_cols else [])
    tab = read_table(path, cols)
    out = {"pos": np.column_stack([tab[c] for c in pos_cols])}
    if vel_cols:
        out["vel"] = np.column_stack([tab[c] for c in vel_cols])
    return out


def load_cutsky_catalog(path, columns=("RA", "DEC", "Z", "WEIGHT")):
    """A cut-sky catalog (data or randoms) -> {'RA', 'DEC', 'Z', 'WEIGHT'};
    a table without a WEIGHT column gets unit weights."""
    try:
        return read_table(path, columns)
    except KeyError:
        if "WEIGHT" not in columns:
            raise
    tab = read_table(path, [c for c in columns if c != "WEIGHT"])
    tab["WEIGHT"] = np.ones_like(tab[columns[0]])
    return tab


def load_ic_mesh(path, growth_index=None):
    """A real-space linear IC mesh from a .npy, or the density of an
    AbacusSummit ic_dens .asdf (times its GrowthTable at `growth_index`)."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        return np.asarray(np.load(path), dtype=np.float32)
    if path.suffix.lower() == ".asdf":
        with optional_import("asdf").open(str(path)) as af:
            mesh = np.asarray(af["data"]["density"], dtype=np.float32)
            if growth_index is not None:
                mesh = mesh * np.float32(af["header"]["GrowthTable"][growth_index])
        return mesh
    raise ValueError(f"unsupported IC mesh format {path.suffix!r} ({path})")


def lin_kpow_cosmoprimo(cosmo_name="AbacusSummit", kmin=1e-4, kmax=1e1, n_interp=256,
                        **cosmo_kw):
    """((k, P(k) / sigma8^2), {Omega_m, sigma8}) from a cosmoprimo fiducial
    (e.g. AbacusSummit): the register's `lin_kpow` and the cosmology's loc."""
    fiducial = optional_import("cosmoprimo.fiducial")
    cosmo = getattr(fiducial, cosmo_name)(**cosmo_kw)
    fo = cosmo.get_fourier()
    pk = fo.pk_interpolator().to_1d(z=0.0)
    ks = np.logspace(np.log10(kmin), np.log10(kmax), n_interp)
    return np.stack((ks, np.asarray(pk(ks)) / fo.sigma8_m**2)), {
        "Omega_m": float(cosmo.Omega0_cdm + cosmo.Omega0_b),
        "sigma8": float(fo.sigma8_m),
    }
