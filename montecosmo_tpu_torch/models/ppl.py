"""Minimal probabilistic-programming layer: effect handlers over generative
functions (`sample`, `deterministic`; `seed`, `trace`, `condition`,
`substitute`, `block`; `log_density`, `compute_log_probs`).

Seeds are `torch.Generator`s: `seed(model, rng_seed)` draws every unset
sample site from one generator, in program order.

Parity: `montecosmo_tpu/models/ppl.py:26-212` (same handler algebra).
"""
import torch

_STACK = []


def _generator(rng_seed, device="cpu"):
    if isinstance(rng_seed, torch.Generator):
        return rng_seed
    return torch.Generator(device=device).manual_seed(int(rng_seed))


class Messenger:
    """Base effect handler: wraps a model callable and intercepts its sites."""

    def __init__(self, fn=None):
        self.fn = fn

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        assert _STACK[-1] is self
        _STACK.pop()

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass

    def __call__(self, *args, **kwargs):
        with self:
            return self.fn(*args, **kwargs)


def _apply_stack(msg):
    for handler in reversed(_STACK):
        handler.process_message(msg)
    if msg["value"] is None and msg["type"] == "sample":
        if msg["key"] is None:
            raise RuntimeError(
                f"Site '{msg['name']}' has no value: wrap the model in seed() "
                "or provide the value via condition/substitute.")
        msg["value"] = msg["fn"].sample(msg["key"])
    for handler in _STACK:
        handler.postprocess_message(msg)
    return msg


def sample(name, fn, obs=None):
    """Declare a random site with distribution `fn`; returns its value."""
    if not _STACK:
        return fn.sample(_generator(0)) if obs is None else obs
    msg = dict(type="sample", name=name, fn=fn, value=obs,
               is_observed=obs is not None, key=None, hidden=False)
    return _apply_stack(msg)["value"]


def deterministic(name, value):
    """Register a deterministic site (recorded in traces); returns `value`."""
    if not _STACK:
        return value
    msg = dict(type="deterministic", name=name, fn=None, value=value,
               is_observed=False, key=None, hidden=False)
    return _apply_stack(msg)["value"]


class seed(Messenger):
    """Provide a torch.Generator to sample sites without a value."""

    def __init__(self, fn=None, rng_seed=0):
        super().__init__(fn)
        self.gen = _generator(rng_seed)

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["value"] is None and msg["key"] is None:
            msg["key"] = self.gen


class trace(Messenger):
    """Record every (non-hidden) site into an ordered dict."""

    def __init__(self, fn=None):
        super().__init__(fn)
        self._trace = None

    def postprocess_message(self, msg):
        if not msg["hidden"]:
            self._trace[msg["name"]] = dict(msg)

    def get_trace(self, *args, **kwargs):
        self._trace = {}
        self(*args, **kwargs)
        return self._trace

    def __call__(self, *args, **kwargs):
        self._trace = {} if self._trace is None else self._trace
        with self:
            return self.fn(*args, **kwargs)


class condition(Messenger):
    """Fix sample sites to observed values (marks them observed)."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class substitute(Messenger):
    """Fix sites to values without marking them observed (also applies to
    deterministic sites, unlike condition)."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]


class block(Messenger):
    """Selectively hide sites from enclosing traces.

    Precedence: hide_fn > hide > expose_types > expose.
    """

    def __init__(self, fn=None, hide_fn=None, hide=None, expose_types=None, expose=None):
        super().__init__(fn)
        if hide_fn is not None:
            self.hide_fn = hide_fn
        elif hide is not None:
            self.hide_fn = lambda msg: msg["name"] in hide
        elif expose_types is not None:
            self.hide_fn = lambda msg: msg["type"] not in expose_types
        elif expose is not None:
            self.hide_fn = lambda msg: msg["name"] not in expose
        else:
            self.hide_fn = lambda msg: True

    def process_message(self, msg):
        if self.hide_fn(msg):
            msg["hidden"] = True


def log_density(model, model_args, model_kwargs, params, zero_point=None):
    """Joint log-density of the model at `params`: (log_joint, trace).

    `zero_point` (site name -> float) recentres each site's elementwise
    log-probs before the reduction, sum(lp - c): the value shifts by a
    constant, the gradients do not change, and the float32 sum accumulates
    O(1) terms."""
    tr = trace(substitute(seed(model, 0), data=params)).get_trace(
        *model_args, **model_kwargs)
    log_joint = 0.0
    for name, site in tr.items():
        if site["type"] == "sample":
            lp = site["fn"].log_prob(site["value"])
            c = None if zero_point is None else zero_point.get(name)
            log_joint = log_joint + torch.sum(lp if c is None else lp - c)
    return log_joint, tr


def compute_log_probs(model, model_args, model_kwargs, params, sum_log_prob=True):
    """Per-site log-probabilities at `params`: (dict, trace)."""
    tr = trace(substitute(seed(model, 0), data=params)).get_trace(
        *model_args, **model_kwargs)
    out = {}
    for name, site in tr.items():
        if site["type"] == "sample":
            lp = site["fn"].log_prob(site["value"])
            out[name] = torch.sum(lp) if sum_log_prob else lp
    return out, tr
