"""Samples / Chains containers: dicts of numpy arrays with group-aware
querying, run loading, thinning, and the chains' diagnostics.

Query language:
  s['name']            -> value
  s['group']           -> tuple of the group's values
  s['*']               -> everything
  s['*~group']         -> everything except a group/name
  s['a', '~b']         -> tuple queries with removals
  s[['a', 'b']]        -> new container restricted to keys
  s[1:3], s[idx]       -> global indexing over every leaf

`Chains` adds labels, `.npz` persistence (`utils.io.npsave`), sequential
run loading (`run_{i}.npz`, the runner's files) with a transform pipeline
applied run by run, thin/flatten/prune/stackby/choice, and the moments and
ESS ('n_evals' is summed, never averaged).  Leaves are numpy arrays
(chains live on the host).

`to_getdist` needs getdist and `plot` matplotlib (`montecosmo_tpu_torch.plot`);
where they are missing each raises an ImportError that names it.

Parity: `montecosmo_tpu/chains.py:35-475`, without `splitrans`/`cumtrans`/
`ravel` and the MSE metrics.
"""
import os
from collections import UserDict
from dataclasses import dataclass, fields
from itertools import product
from pathlib import Path

import numpy as np

from montecosmo_tpu_torch.metrics import effective_sample_size, gelman_rubin, multi_ess
from montecosmo_tpu_torch.utils.io import npload, npsave, to_np

N_EVALS = "n_evals"


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


@dataclass
class Samples(UserDict):
    """Dict of arrays with group querying and global indexing.

    A query is a sequence of tokens evaluated left to right against an
    ordered selection: a bare token (array key -> itself, '*' -> every key,
    group -> members), '~token' (remove the token's keys), '*~token' (add
    the complement of the token's keys), [tokens] (inside a tuple query:
    recursed on).  str keys return values, list keys a restricted container,
    tuple keys recurse per entry; int/slice/array keys index every leaf."""

    data: dict
    groups: dict = None  # group name -> list of keys

    NoneOrEmpty = object()  # default: missing keys -> None (values) / dropped (subdicts)

    def __post_init__(self):
        inherited = {}
        if isinstance(self.data, Samples):  # adopt the attributes of a wrapped instance
            inner, self.data = self.data, self.data.data
            inherited = inner.asdict()
        for field in fields(self):
            merged = dict(inherited.get(field.name) or {})
            merged.update(getattr(self, field.name) or {})
            setattr(self, field.name, merged)

    # ------------------------------------------------------------------ querying
    def _denoted(self, name):
        if name in self.data:
            return [name]
        if name == "*":
            return list(self.data)
        return list(self.groups.get(name, [name]))

    def _evaluate(self, tokens):
        chosen = []
        for tok in tokens:
            if isinstance(tok, list):
                chosen.append(tok)
            elif not isinstance(tok, str):
                raise KeyError(tok)
            elif tok[:2] == "*~":
                exclude = set(self._denoted(tok[2:]))
                chosen += [k for k in self.data if k not in exclude]
            elif tok[:1] == "~":
                for k in self._denoted(tok[1:]):
                    if k in chosen:
                        chosen.remove(k)
            else:
                chosen += self._denoted(tok)
        return chosen

    def _lookup(self, key, default_fn=None):
        try:
            return self.data[key]
        except KeyError:
            if default_fn is None:
                raise
            return None if default_fn is self.NoneOrEmpty else default_fn(key)

    def _restricted(self, tokens, default_fn):
        keys = self._evaluate(tokens)
        if default_fn is self.NoneOrEmpty:
            picked = {k: self.data[k] for k in keys if k in self.data}
        else:
            picked = {k: self._lookup(k, default_fn) for k in keys}
        return type(self)(**{**self.asdict(), "data": picked})

    def __getitem__(self, key, default_fn=None):
        if isinstance(key, (int, slice, type(Ellipsis), np.ndarray)) or (
                isinstance(key, tuple) and all(
                    isinstance(k, (int, slice, type(Ellipsis), np.ndarray)) for k in key)):
            return self.map(lambda x: x[key])
        if isinstance(key, str):
            sel = self._evaluate([key])
            if len(sel) == 1:
                return self._lookup(sel[0], default_fn)
            return tuple(self._lookup(k, default_fn) for k in sel)
        if isinstance(key, list):
            return self._restricted(key, default_fn)
        if isinstance(key, tuple):
            sel = self._evaluate(key)
            if len(sel) == 1:
                return self.__getitem__(sel[0], default_fn)
            return tuple(self.__getitem__(k, default_fn) for k in sel)
        raise KeyError(key)

    def get(self, key, default_fn=NoneOrEmpty):
        return self.__getitem__(key, default_fn)

    # ------------------------------------------------------------------ utils
    def asdict(self):
        return {f.name: getattr(self, f.name).copy() for f in fields(self)}

    def __copy__(self):
        return type(self)(**self.asdict())

    def copy(self):
        return self.__copy__()

    def map(self, fn, *others):
        """A copy with fn applied to every leaf (and the others' leaves of
        the same keys)."""
        new = self.copy()
        new.data = {k: fn(v, *(o.data[k] for o in others)) for k, v in self.data.items()}
        return new

    shape = property(lambda self: {k: np.shape(v) for k, v in self.data.items()})
    ndim = property(lambda self: {k: np.ndim(v) for k, v in self.data.items()})
    size = property(lambda self: {k: np.size(v) for k, v in self.data.items()})

    # ------------------------------------------------------------------ operations
    def _merge_fields(self, other, reverse=False):
        new = self.asdict()
        if isinstance(other, Samples):
            for name, theirs in other.asdict().items():
                ours = new.get(name, {})
                new[name] = {**theirs, **ours} if reverse else {**ours, **theirs}
        elif isinstance(other, (dict, UserDict)):
            theirs = dict(other)
            new["data"] = {**theirs, **new["data"]} if reverse else {**new["data"], **theirs}
        else:
            return None
        return new

    def __or__(self, other):
        merged = self._merge_fields(other)
        return NotImplemented if merged is None else type(self)(**merged)

    def __ror__(self, other):
        merged = self._merge_fields(other, reverse=True)
        return NotImplemented if merged is None else type(self)(**merged)

    def __ior__(self, other):
        if not isinstance(other, Samples):
            return super().__ior__(other)
        for f in fields(self):
            setattr(self, f.name, {**getattr(self, f.name), **getattr(other, f.name, {})})
        return self

    # ------------------------------------------------------------------ transforms
    def prune(self):
        """Drop group entries whose keys are absent from data."""
        new = self.copy()
        new.groups = {g: [k for k in members if k in new.data]
                      for g, members in new.groups.items()}
        return new

    def concat(self, *others, axis=0):
        return self.map(lambda x, *y: np.concatenate((x, *y), axis=axis), *others)

    def stackby(self, names=None, remove=True, axis=-1):
        """Stack variables by group (`names` group names, plain variables
        left untouched; None: every group), removing the stacked members."""
        names = list(self.groups) if names is None else list(np.atleast_1d(names))
        new = self.copy()
        for name in names:
            if name in self.data:
                continue
            members = self.groups[name]
            vals = self[name]
            new.data[name] = vals if len(members) == 1 else np.stack(vals, axis)
            if remove:
                for member in members:
                    new.data.pop(member, None)
        return new


@dataclass
class Chains(Samples):
    """Samples + labels + run persistence + chain metrics."""

    labels: dict = None

    # ------------------------------------------------------------------ persistence
    def save(self, path):
        npsave(path, {"data": {k: to_np(v) for k, v in self.data.items()},
                      "groups": self.groups, "labels": self.labels})

    @classmethod
    def load(cls, path):
        d = npload(path)
        return cls(d["data"], groups=d.get("groups"), labels=d.get("labels"))

    @classmethod
    def load_runs(cls, path, start: int, end: int, transforms=None, groups=None, labels=None,
                  batch_ndim=2):
        """Load `run_{start..end}.npz` (up to the first missing one after
        `start`), apply the `transforms` to each run, and concatenate them
        along the samples axis."""
        path = Path(path)
        for i_run in range(start, end + 1):
            if not os.path.exists(path / f"run_{i_run}.npz"):
                if i_run == start:
                    raise FileNotFoundError(path / f"run_{i_run}.npz")
                end = i_run - 1
                break
        transforms = [] if transforms is None else list(np.atleast_1d(transforms))
        conc_axis = max(batch_ndim - 1, 0)
        samples = None
        for i_run in range(start, end + 1):
            part = cls(npload(path / f"run_{i_run}.npz"), groups=groups, labels=labels)
            for trans in transforms:
                part = trans(part)
            if batch_ndim == 0:
                part = part.map(lambda x: np.asarray(x)[None])
            samples = part if samples is None else samples.concat(part, axis=conc_axis)
        return samples

    # ------------------------------------------------------------------ transforms
    def choice(self, n, names=None, seed=42, batch_ndim=2, replace=False):
        """A random subsample of n values (per batch entry) of each selected
        variable (its trailing axes flattened)."""
        names = list(self.data) if names is None else list(np.atleast_1d(names))
        keys = [k for k in self._evaluate(names) if isinstance(k, str) and k in self.data]
        new = self.copy()
        for k in keys:
            x = np.asarray(self.data[k])
            batch = x.shape[:batch_ndim]
            flat = x.reshape(batch + (-1,))
            rng = np.random.default_rng(seed)
            idx = rng.choice(flat.shape[-1], size=n, replace=replace)
            new.data[k] = flat[..., idx]
        return new

    def thin(self, thinning=None, moment=None, axis: int = 1):
        """Thin along `axis`: split it into round(length / thinning) blocks
        and keep each block's last element (or its moment); 'n_evals' is
        summed over each block."""
        length = np.shape(next(iter(self.data.values())))[axis]
        n_split = 1 if thinning is None else max(int(np.rint(length / thinning)), 1)
        parts = [self.map(lambda x: np.asarray(x)[(slice(None),) * axis + (sl,)])
                 for sl in _splits(length, n_split)]
        if moment is None:
            parts = [p.last(axis=axis) for p in parts]
        else:
            parts = [p.moment(m=moment, axis=axis) for p in parts]
        return parts[0].map(lambda *xs: np.stack(xs, axis), *parts[1:])

    def flatten(self, batch_ndim=2):
        """Flatten non-batch dims into scalar keys 'name[i,j]', updating the
        groups and labels."""
        data, labels, substitute = {}, {}, {}
        for k, v in self.data.items():
            shape = np.shape(v)[batch_ndim:]
            if len(shape) == 0:
                data[k] = v
                if k in self.labels:
                    labels[k] = self.labels[k]
            else:
                substitute[k] = []
                for ids in product(*map(range, shape)):
                    sufx = "[{}]".format(",".join(map(str, ids)))
                    data[k + sufx] = np.asarray(v)[batch_ndim * (slice(None),) + ids]
                    if k in self.labels:
                        labels[k + sufx] = self.labels[k] + sufx
                    substitute[k].append(k + sufx)
        groups = {}
        for g, gl in self.groups.items():
            groups[g] = []
            for k in gl:
                groups[g] += substitute.get(k, [k] if k in data else [])
        return Chains(data, groups=groups, labels=labels)

    # ------------------------------------------------------------------ metrics
    def metric(self, fn, *others, axis=None):
        """Map fn over the leaves, but 'n_evals' summed along `axis` (counts
        accumulate, they do not average)."""
        new = self.copy()
        new.data = {}
        for k, v in self.data.items():
            if k == N_EVALS:
                new.data[k] = np.sum(np.asarray(v), axis=axis)
            else:
                new.data[k] = fn(np.asarray(v), *(np.asarray(o.data[k]) for o in others))
        return new

    def last(self, axis=1):
        return self.metric(lambda x: np.take(x, -1, axis), axis=axis)

    def moment(self, m=(0, 1, 2), axis=1):
        if isinstance(m, int):
            return self.metric(lambda x: np.sum(x**m, axis), axis=axis)
        m = np.asarray(m)
        return self.metric(lambda x: np.sum(x[..., None] ** m, axis), axis=axis)

    def cmoment(self, axis=1):
        return self.metric(lambda x: np.stack((x.mean(axis), x.std(axis)), -1), axis=axis)

    def multi_ess(self, axis=None):
        return self.metric(lambda x: _np(multi_ess(x, axis=axis)))

    def eval_per_ess(self, axis=None):
        """'n_evals' over each variable's (harmonic-mean) ESS."""
        ess = self.multi_ess(axis=axis)
        n_evals = ess.data[N_EVALS]
        out = ess.copy()
        out.data = {k: v if k == N_EVALS else n_evals / v for k, v in ess.data.items()}
        return out

    # ------------------------------------------------------------------ reporting
    def to_getdist(self, label=None):
        """Export to a getdist MCSamples (where getdist is installed; else
        use `to_arrays` with `plot.corner_plot`)."""
        try:
            from getdist import MCSamples
        except ImportError as e:
            raise ImportError(
                "getdist is not installed; use Chains.to_arrays() with "
                "montecosmo_tpu_torch.plot.corner_plot for native corner plots") from e
        samples, names, labels = self.to_arrays(label)
        return MCSamples(samples=samples, names=names, labels=labels, label=label)

    def plot(self, names=None, batch_ndim=2, grid=True, log=False):
        """A grid of per-chain trace plots (`plot.plot_chains`)."""
        from montecosmo_tpu_torch.plot import plot_chains
        return plot_chains(self, names=names, batch_ndim=batch_ndim, grid=grid, log=log)

    def to_arrays(self, label=None):
        """Flattened (samples, names, labels) for corner plotting."""
        samples, names, labels = [], [], []
        for k, v in self.data.items():
            samples.append(np.asarray(v).reshape(-1))
            names.append(k)
            labels.append(self.labels.get(k, k))
        return samples, names, labels

    def print_summary(self, group_by_chain=True):
        """Posterior summary table: mean, std, 5%/95%, n_eff, r_hat."""
        print(f"{'':>16} {'mean':>9} {'std':>9} {'5.0%':>9} {'95.0%':>9} {'n_eff':>9} "
              f"{'r_hat':>7}")
        for k, v in self.data.items():
            v = np.asarray(v)
            if not group_by_chain:
                v = v[None]
            if v.ndim > 2:  # event dims averaged for the table
                v = v.reshape(v.shape[0], v.shape[1], -1).mean(-1)
            flat = v.reshape(-1)
            if v.shape[1] > 1 and np.issubdtype(v.dtype, np.floating):
                ess = float(_np(effective_sample_size(v)))
                rhat = float(_np(gelman_rubin(v))) if v.shape[0] > 1 else np.nan
            else:
                ess, rhat = np.nan, np.nan
            print(f"{k:>16} {flat.mean():>9.3g} {flat.std():>9.3g} "
                  f"{np.quantile(flat, 0.05):>9.3g} {np.quantile(flat, 0.95):>9.3g} "
                  f"{ess:>9.3g} {rhat:>7.3g}")


def _splits(length, n):
    """The slices of `np.array_split` of `length` items into n parts."""
    sizes = [length // n + (1 if i < length % n else 0) for i in range(n)]
    bounds = np.cumsum([0] + sizes)
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
