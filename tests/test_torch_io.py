"""The port's files on the CPU: `npsave`/`npload` trees (nested dicts,
NamedTuple states, strings, Python scalars) round trip; `ysave` JSON reads
back equal through the standard library and through PyYAML (the JAX
package's `yload`), infinities and exponent floats included; a
`model.yaml` the port saves builds the same model in the JAX package, and
one the JAX package saves builds the same model in the port; the JAX
package's registered `.h5` converted (`convert.register_from_h5`) and
saved as `.npz` holds the same arrays; `h5load`/`yload` without h5py or
PyYAML raise ImportErrors that name the port's own formats."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from montecosmo_tpu_torch.samplers.mclmc import IntegratorState, MCLMCAdaptationState
from montecosmo_tpu_torch.utils import io

torch.set_num_threads(1)

REGISTER = str(Path(__file__).resolve().parent.parent
               / "registered" / "register_synthetic_z1.000_b32_p0.h5")


def test_npz_trees_round_trip(tmp_path):
    """Nested dicts (None skipped), tensors and arrays of every dtype the
    campaign writes, 0-d values back as Python scalars, strings and lists
    of strings, and a NamedTuple state rebuilt from its fields."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": torch.ones(3),
            "d": {"e": np.complex64(1 + 2j) * np.ones(4, np.complex64)}},
            "f": 3, "g": 0.5, "h": True, "i": "rectangular", "j": ["x", "y"], "k": None,
            "l": np.int64(7)}
    io.npsave(tmp_path / "t.npz", tree)
    back = io.npload(tmp_path / "t.npz")
    assert set(back) == set(tree) - {"k"}
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], np.ones(3, np.float32))
    assert back["b"]["d"]["e"].dtype == np.complex64
    assert (back["f"], back["g"], back["h"], back["i"], back["j"], back["l"]) == (
        3, 0.5, True, "rectangular", ["x", "y"], 7)
    assert all(type(back[k]) is t for k, t in (("f", int), ("g", float), ("h", bool),
                                                ("i", str), ("l", int)))
    state = IntegratorState({"x_": torch.arange(3.0)}, torch.ones(3), torch.tensor(-1.5),
                            {"x_": torch.zeros(3)})
    io.npsave(tmp_path / "s.npz", state)
    back = IntegratorState(**io.npload(tmp_path / "s.npz"))
    assert isinstance(back, IntegratorState) and back.logdensity == -1.5
    np.testing.assert_array_equal(back.position["x_"], [0.0, 1.0, 2.0])
    config = MCLMCAdaptationState(np.ones(2), np.full(2, 0.1), np.ones((2, 3)))
    io.npsave(tmp_path / "c.npz", config)
    assert MCLMCAdaptationState(**io.npload(tmp_path / "c.npz")).inverse_mass_matrix.shape == (2, 3)
    with pytest.raises(ValueError, match="separates"):
        io.npsave(tmp_path / "bad.npz", {"a/b": 1.0})


def test_ysave_is_json_that_yaml_reads_alike(tmp_path):
    """Floats with and without exponents, +-inf, nested lists, strings with
    backslashes, booleans and None: equal through `json` and PyYAML."""
    import yaml

    tree = {"x": 1e-07, "y": 3e20, "z": -2.5e-12, "inf": np.inf, "ninf": -np.inf,
            "n": [1, 2, [0.1, 1e-9]], "s": r"{\Omega}_m", "t": True, "u": None,
            "a": np.array([[1.0, 2.0]]), "g": np.float32(0.25), "e": {}}
    io.ysave(tree, tmp_path / "m.yaml")
    text = (tmp_path / "m.yaml").read_text()
    via_yaml = yaml.safe_load(text)
    via_json = io.yload(tmp_path / "m.yaml")
    want = {**tree, "a": [[1.0, 2.0]], "g": 0.25}
    assert via_json == want and via_yaml == want
    with pytest.raises(ValueError, match="NaN"):
        io.ysave({"x": float("nan")}, tmp_path / "nan.yaml")


def _small_conf(**updates):
    return dict(final_shape=(8, 8, 8), cell_length=40.0, evolution="kaiser", a_obs=0.5,
                curved_sky=False, box_center=(0.0, 0.0, 1000.0), n_rbins=1, **updates)


def _same_model(a, b):
    for attr in ("final_shape", "init_shape", "paint_shape", "max_disp", "paint_lattice",
                 "n_rbins", "k_cut", "evolution", "lik_type", "register"):
        assert getattr(a, attr) == getattr(b, attr), attr
    np.testing.assert_allclose(a.box_center, b.box_center)
    np.testing.assert_allclose(a.redges, b.redges, rtol=1e-6)
    assert set(a.latents) == set(b.latents)
    for name, conf in a.latents.items():
        for k, v in conf.items():
            if k in ("label", "group"):
                assert v == b.latents[name][k]
            else:
                np.testing.assert_allclose(v, b.latents[name][k], err_msg=f"{name}.{k}")


def test_model_yaml_round_trips_both_ways(tmp_path):
    """The port's `save` -> the JAX package's `FieldLevelModel.load`, and
    the JAX package's `save` -> the port's `load`: the same derived config
    and latents (bounds at inf included), for a default-latents model and
    for one built from a register file (its latents centred by it)."""
    from montecosmo_tpu import FieldLevelModel as JaxModel, default_config as jax_default
    from montecosmo_tpu_torch import FieldLevelModel, default_config

    for conf in (_small_conf(k_cut=0.05), _small_conf(register=REGISTER)):
        tm = FieldLevelModel(**{**default_config, **conf}, device="cpu")
        tm.save(tmp_path / "port.yaml")
        _same_model(JaxModel.load(tmp_path / "port.yaml"), tm)
        jm = JaxModel(**{**jax_default, **conf})
        jm.save(tmp_path / "jax.yaml")
        back = FieldLevelModel.load(tmp_path / "jax.yaml", device="cpu")
        _same_model(back, jm)
        assert back.device == torch.device("cpu")


def test_register_from_h5_to_npz(tmp_path):
    """The JAX package's register through `convert.register_from_h5` and
    `npsave`: every key, Python scalars as scalars (the shape arithmetic of
    `FieldLevelModel` takes them), float32 counts, complex64 white mesh."""
    from montecosmo_tpu.utils.io import h5load as jax_h5load
    from montecosmo_tpu_torch.convert import register_from_h5

    io.npsave(tmp_path / "reg.npz", register_from_h5(REGISTER))
    back, ref = io.npload(tmp_path / "reg.npz"), jax_h5load(REGISTER)
    assert set(back) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
        else:
            assert back[k] == v and type(back[k]) is type(v), k
    assert back["white_mesh"].dtype == np.complex64 and back["count_mesh"].dtype == np.float32


def test_without_h5py_or_yaml_the_errors_name_the_npz_path(tmp_path, monkeypatch):
    """With h5py and PyYAML unimportable: h5load/h5save raise an ImportError
    naming npload; a JSON config still loads; a YAML-only file raises one
    naming ysave."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="npload"):
        io.h5load(REGISTER)
    with pytest.raises(ImportError, match="npsave"):
        io.h5save(tmp_path / "x.h5", {"a": 1})
    io.ysave({"a": [1.0, np.inf]}, tmp_path / "c.yaml")
    assert io.yload(tmp_path / "c.yaml") == {"a": [1.0, np.inf]}
    (tmp_path / "y.yaml").write_text("a: 1\nb: [2, 3]\n")
    with pytest.raises(ImportError, match="ysave"):
        io.yload(tmp_path / "y.yaml")
