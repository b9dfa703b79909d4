"""The port's `Chains` against the JAX package's on the CPU: queries,
thin, flatten, prune, stackby, `|`, the ESS per evaluation, and the `.npz`
round trip.  One test in a file of its own: xdist's file queue runs it
beside the JAX package's long one-test files instead of ahead of them."""
import numpy as np
import torch
import jax

from montecosmo_tpu_torch.chains import Chains

from test_torch_chain_diagnostics import ar1

torch.set_num_threads(1)


def test_chains_match_jax(tmp_path):
    """The port's `Chains` and the JAX package's on the same runs."""
    from montecosmo_tpu.chains import Chains as JChains

    rng = np.random.default_rng(2)
    data = {"a": ar1((2, 40), 0.5, 3), "b": ar1((2, 40, 3), 0.2, 4),
            "c": ar1((2, 40), 0.7, 5),
            "logdensity": rng.standard_normal((2, 40)).astype(np.float32),
            "n_evals": np.full((2, 40), 4.0, np.float32)}
    groups = {"g": ["a", "b"], "h": ["a", "c"], "k": ["b", "z"]}
    labels = {"a": "A", "b": "B"}
    tc, jc = Chains(dict(data), groups, labels), JChains(dict(data), groups, labels)
    for q in ("a", "g", "*", "*~g", ("a", "~b"), ["g"]):
        vt, vj = tc[q], jc[q]
        if isinstance(vt, Chains):
            vt, vj = vt.data, vj.data
        jax.tree.map(lambda t, j: np.testing.assert_array_equal(np.asarray(t), np.asarray(j)),
                     vt, vj)
    for thinning in (None, 4, 7):
        t, j = tc.thin(thinning), jc.thin(thinning)
        for k in data:
            np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=1e-6, err_msg=k)
    t, j = tc.flatten(), jc.flatten()
    assert list(t.data) == list(j.data) and t.groups == j.groups and t.labels == j.labels
    assert tc.prune().groups == jc.prune().groups
    t, j = tc.stackby(["h"]), jc.stackby(["h"])
    assert list(t.data) == list(j.data)
    np.testing.assert_array_equal(t["h"], np.asarray(j["h"]))
    assert (tc | {"d": data["a"]}).data.keys() == (jc | {"d": data["a"]}).data.keys()
    t, j = tc[["a", "n_evals"]].eval_per_ess(), jc[["a", "n_evals"]].eval_per_ess()
    np.testing.assert_allclose(t["a"], np.asarray(j["a"]), rtol=1e-4)
    assert t["n_evals"] == np.asarray(j["n_evals"])
    tc.save(tmp_path / "c.npz")
    back = Chains.load(tmp_path / "c.npz")
    assert back.groups == groups and back.labels == labels
    for k, v in data.items():
        np.testing.assert_array_equal(back[k], v)
