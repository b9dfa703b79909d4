"""Serialization: pickle, JSON-as-YAML configs, and nested dict trees in one
`.npz` (the port's own format for registers, sampler states, configs and
chains).

The port's files use numpy and the standard library only:
* `npsave` / `npload`: a nested dict tree (or a NamedTuple of them, a
  sampler state or config) in one `.npz`, keys flattened with "/", `None`
  skipped: the tree `h5save` writes, in the layout of its HDF5 groups;
* `ysave` writes JSON that YAML 1.2 reads as the same tree (floats always
  with a fraction, infinities as 1.0e+999), so the JAX package's `yload`
  reads it; `yload` parses JSON with the standard library and imports PyYAML
  only for a file that is not JSON (a `model.yaml` the JAX package wrote);
* `h5load` / `h5save` read and write the JAX package's HDF5 files, through
  h5py where it is installed, and raise an ImportError naming `npload` /
  `npsave` where it is not.

Parity: `montecosmo_tpu/utils/io.py` (psave/pload, ysave/yload, h5save/h5load,
h5save_tree/h5load_tree, to_np).
"""
import json
import math
import pickle

import numpy as np


# ----------------------------------------------------------------------------- pickle
def psave(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def pload(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def to_np(x):
    """Tensor or array-like -> numpy (a tensor detached and moved to the
    host)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ----------------------------------------------------------------------------- yaml
def _plain(obj):
    """A config tree -> dicts, lists, str, bool, int, float and None."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "detach") or isinstance(obj, np.ndarray):
        return _plain(to_np(obj).tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _float(x):
    """A float token that JSON and YAML 1.1/1.2 both read as `x`: a fraction
    before any exponent (PyYAML reads 1e-07 as a string), and +-1.0e+999
    for the infinities (no common token exists; both overflow it to inf)."""
    if math.isnan(x):
        raise ValueError("NaN has no JSON/YAML representation here")
    if math.isinf(x):
        return "1.0e+999" if x > 0 else "-1.0e+999"
    r = repr(float(x))
    mant, e, exp = r.partition("e")
    if e and "." not in mant:
        r = f"{mant}.0e{exp}"
    return r


def _dump(obj, indent=""):
    inner = indent + "  "
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = [f"{inner}{json.dumps(k)}: {_dump(v, inner)}" for k, v in obj.items()]
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(obj, list):
        if all(not isinstance(v, (dict, list)) for v in obj):
            return "[" + ", ".join(_dump(v) for v in obj) + "]"
        return "[\n" + ",\n".join(inner + _dump(v, inner) for v in obj) + "\n" + indent + "]"
    if obj is None or isinstance(obj, (bool, str)):
        return json.dumps(obj)
    if isinstance(obj, int):
        return str(obj)
    if isinstance(obj, float):
        return _float(obj)
    raise TypeError(f"cannot write {type(obj).__name__} to a config file")


def ysave(obj, path):
    """Write a config tree as JSON (which YAML 1.2 reads as the same tree)."""
    with open(path, "w") as f:
        f.write(_dump(_plain(obj)) + "\n")


def yload(path):
    """Read a config file: JSON (the port's `ysave`), else YAML (PyYAML)."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(f"{path} is YAML, not JSON, and PyYAML is not installed: write "
                          "configs with montecosmo_tpu_torch.utils.io.ysave (JSON)") from exc
    return yaml.safe_load(text)


# ----------------------------------------------------------------------------- npz trees
def _tree_dict(tree):
    """A NamedTuple / dict tree -> nested dicts of numpy leaves."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _tree_dict(v) for k, v in tree.items()}
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if v is None:
            continue
        key = f"{prefix}{k}"
        if "/" in str(k):
            raise ValueError(f"key {k!r}: '/' separates the levels of an npz tree")
        if isinstance(v, dict):
            out |= _flatten(v, key + "/")
            continue
        if isinstance(v, str):
            out[key] = np.array(v)
        elif isinstance(v, (list, tuple)) and all(isinstance(x, str) for x in v):
            out[key] = np.array(list(v), dtype=np.str_)
        else:
            out[key] = to_np(v) if hasattr(v, "detach") else np.asarray(
                [to_np(x) for x in v] if isinstance(v, (list, tuple)) else v)
        if out[key].dtype == object:
            raise TypeError(f"{key}: object arrays are not saved (no pickle in npz trees)")
    return out


def _leaf(v):
    """0-d arrays -> Python scalars, string arrays -> lists of str (as
    `h5load` gives them)."""
    if v.dtype.kind == "U":
        return v.item() if v.ndim == 0 else [str(x) for x in v.reshape(-1)]
    if v.ndim == 0:
        return v.item()
    return v


def npsave(path, data):
    """Save a nested dict tree (dicts of arrays, tensors, scalars, strings,
    lists of strings), or a NamedTuple of them, to one `.npz`: keys joined
    with "/", None values skipped."""
    with open(path, "wb") as f:
        np.savez(f, **_flatten(_tree_dict(data)))


def npload(path):
    """Load a tree saved by `npsave`: nested dicts, 0-d values as Python
    scalars, string arrays as lists of str."""
    tree = {}
    with np.load(path, allow_pickle=False) as f:
        for key in f.files:
            *parents, name = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = _leaf(f[key])
    return tree


# ----------------------------------------------------------------------------- hdf5
def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("h5py is not installed: the port's own files are .npz "
                          "(montecosmo_tpu_torch.utils.io.npload / npsave); convert an .h5 "
                          "where h5py exists (montecosmo_tpu_torch.convert."
                          "register_from_h5)") from exc
    return h5py


def h5save(path, data: dict):
    """Save a nested dict to HDF5 as the JAX package's `h5save` does (None
    skipped, dicts as groups); needs h5py."""
    h5py = _h5py()

    def write(grp, d):
        for k, v in d.items():
            if v is None:
                continue
            if isinstance(v, dict):
                write(grp.create_group(k), v)
            elif isinstance(v, (str, bytes, bool, int, float)):
                grp[k] = v
            else:
                arr = to_np(v)
                if arr.dtype.kind == "U":
                    arr = arr.astype("S")
                grp[k] = arr

    with h5py.File(str(path), "w") as f:
        write(f, _tree_dict(data))


def h5load(path):
    """Load an HDF5 file written by the JAX package's `h5save` into a nested
    dict (byte strings decoded, 0-d values as Python scalars); needs h5py."""
    h5py = _h5py()

    def read(grp):
        out = {}
        for k, item in grp.items():
            if isinstance(item, h5py.Group):
                out[k] = read(item)
            else:
                v = item[()]
                if isinstance(v, bytes):
                    v = v.decode()
                elif isinstance(v, np.ndarray) and v.dtype.kind in ("S", "O"):
                    v = [x.decode() if isinstance(x, bytes) else x for x in v]
                elif isinstance(v, np.generic):
                    v = v.item()
                out[k] = v
        return out

    with h5py.File(str(path), "r") as f:
        return read(f)


def load_tree(path):
    """A register or tree file by its suffix: `.h5` through h5py (the JAX
    package's files), anything else through `npload`."""
    return h5load(path) if str(path).endswith((".h5", ".hdf5")) else npload(path)
