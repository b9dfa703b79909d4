"""The port's register CLI (`python -m montecosmo_tpu_torch.register`, run
here in-process with --device cpu) against the JAX package's
run/register.py on the same catalog files, on the CPU; the catalog readers
of `utils/catalogs.py` against run/catalogs.py's; the synthetic mock's 2LPT
step against the JAX package's building blocks on the same white mesh.

The JAX CLI writes an `.h5`, read here through `convert.register_from_h5`;
the port writes its `.npz`.  Every key agrees but the `white_fake` draw (a
torch.Generator's stream, not a JAX key's: its shape, dtype family and unit
power are held): the register's own keys at test_torch_register.py's
tolerances (`_hold_register`; the cut sky's footprint mask equal but in
at most 1e-3 of its cells), `lin_kpow` within 2e-5 of its largest
power (EH98 in float32, its sigma8 normalisation integrated in another
order), a whitened IC mesh within 1e-5 of its largest value.  The mock's
positions and velocities within 1e-5 of their largest value (2LPT through
FFTs in another order), its linear field 1e-6.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from montecosmo_tpu_torch import register as treg
from montecosmo_tpu_torch.convert import register_from_h5
from montecosmo_tpu_torch.utils import catalogs as tcat
from montecosmo_tpu_torch.utils.io import npload

from test_torch_register import _hold_register, catalog

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from run import catalogs as jcat, register as jreg  # noqa: E402

torch.set_num_threads(1)

COMMON = dict(cell_budget=16**3, padding=0.0, init_oversamp=1.5, paint_oversamp=1.75, a_obs=0.5,
              seed=42, platform=None, cosmoprimo=None)


def _both(tmp_path, mode, jax_args, cli_args):
    """(port register, JAX register) of the same files."""
    jpath = jreg.register(argparse.Namespace(mode=mode, out=str(tmp_path / "jax"), **COMMON,
                                             **jax_args))
    tpath = treg.main([mode, "--cell-budget", str(16**3), "--out", str(tmp_path / "port"),
                       "--device", "cpu", *cli_args])
    assert tpath.name == jpath.name.replace(".h5", ".npz")
    return npload(tpath), register_from_h5(jpath)


def _hold_init(rt, rj):
    """The register keys and `_hold_register`'s tolerances, lin_kpow, and
    the white mesh (a whitened IC mesh) or the white draw."""
    assert set(rt) == set(rj)
    _hold_register({k: v for k, v in rt.items() if k not in ("lin_kpow", "white_mesh",
                                                             "white_fake")},
                   {k: v for k, v in rj.items() if k not in ("lin_kpow", "white_mesh",
                                                             "white_fake")})
    np.testing.assert_allclose(rt["lin_kpow"][0], rj["lin_kpow"][0], rtol=1e-6)
    np.testing.assert_allclose(rt["lin_kpow"][1], rj["lin_kpow"][1], rtol=0,
                               atol=2e-5 * np.abs(rj["lin_kpow"][1]).max())
    if "white_mesh" in rj:
        np.testing.assert_allclose(rt["white_mesh"], rj["white_mesh"], rtol=0,
                                   atol=1e-5 * np.abs(rj["white_mesh"]).max())
    else:
        wt, wj = rt["white_fake"], rj["white_fake"]
        assert wt.shape == wj.shape and np.iscomplexobj(wt) and np.iscomplexobj(wj)
        # unit power in physical units: <|w|^2> = cells per volume
        assert not np.allclose(wt, wj)
        np.testing.assert_allclose(np.mean(np.abs(wt) ** 2), np.mean(np.abs(wj) ** 2), rtol=0.1)


def test_full_sky_cli_matches_jax(tmp_path):
    """fullsky from a .npy of positions, a .npy of velocities and a .npy IC
    mesh (whitened into `white_mesh`) against the JAX CLI; then the port's
    CLI on the same catalog as a .npz table with velocity columns and no IC:
    the same register bit for bit, `white_fake` in place of `white_mesh`."""
    rng = np.random.default_rng(70)
    box = 640.0
    pos = rng.uniform(-box / 2, box / 2, (20_000, 3))
    vel = rng.normal(0, 300.0, (20_000, 3))
    ic = rng.standard_normal((24, 24, 24)).astype(np.float32)
    for name, arr in (("cat.npy", pos), ("vel.npy", vel), ("ic.npy", ic)):
        np.save(tmp_path / name, arr)
    np.savez(tmp_path / "tab.npz", x=pos[:, 0], y=pos[:, 1], z=pos[:, 2], vx=vel[:, 0],
             vy=vel[:, 1], vz=vel[:, 2])
    rt, rj = _both(tmp_path, "fullsky",
                   dict(pos=str(tmp_path / "cat.npy"), pos_cols="x,y,z", vel_cols=None,
                        vel=str(tmp_path / "vel.npy"), ic=str(tmp_path / "ic.npy"),
                        ic_growth=None, box_size=box),
                   ["--pos", str(tmp_path / "cat.npy"), "--vel", str(tmp_path / "vel.npy"),
                    "--ic", str(tmp_path / "ic.npy"), "--box-size", str(box)])
    assert "white_mesh" in rt
    _hold_init(rt, rj)
    np.testing.assert_allclose(rt["count_mesh"].sum(), 20_000, rtol=1e-5)
    tab = npload(treg.main(["fullsky", "--pos", str(tmp_path / "tab.npz"), "--vel-cols",
                            "vx,vy,vz", "--box-size", str(box), "--cell-budget", str(16**3),
                            "--out", str(tmp_path / "port"), "--device", "cpu"]))
    assert set(tab) - {"white_fake"} == set(rt) - {"white_mesh"}
    assert tab["white_fake"].shape == rt["white_mesh"].shape
    for k, v in rt.items():
        if k != "white_mesh":
            np.testing.assert_array_equal(np.asarray(tab[k]), np.asarray(v), err_msg=k)


def test_cut_sky_cli_matches_jax(tmp_path):
    """cutsky from .npz tables of the examples' geometry (20,000 data,
    50,000 randoms without a WEIGHT column: unit weights)."""
    data, rand = catalog(20_000, 71), catalog(50_000, 72)
    np.savez(tmp_path / "data.npz", **data)
    np.savez(tmp_path / "rand.npz", **{k: v for k, v in rand.items() if k != "WEIGHT"})
    files = dict(data=str(tmp_path / "data.npz"), random=str(tmp_path / "rand.npz"))
    rt, rj = _both(tmp_path, "cutsky", files,
                   ["--data", files["data"], "--random", files["random"]])
    _hold_init(rt, rj)
    # the footprint is paint(randoms) > 0: a random within float32 rounding
    # of a cell edge reaches the next cell in one package and not in the
    # other (1 of 4,320 cells here; test_torch_survey_register.py's
    # catalogs have none)
    assert (rt["mask_mesh"] != rj["mask_mesh"]).mean() <= 1e-3


def test_synthetic_mock_and_catalog_readers(tmp_path, monkeypatch):
    """`lpt_mock` (the synthetic mock's 2LPT step, NGP reads, the km/s
    conversion) against run/register.py's `make` written out with the JAX
    building blocks, on one white mesh; the synthetic CLI's register
    (white_mesh from its own linear field, count conservation); the
    catalog readers against run/catalogs.py's on .npy, .npz and .h5, the
    default unit weights, and the ImportError of a reader whose package is
    not installed naming the numpy alternative."""
    from montecosmo_tpu.models.bricks import regular_pos, white2lin
    from montecosmo_tpu.ops.background import AbacusSummit0, Background, Esqr
    from montecosmo_tpu.ops.hermitian import rg2cgh
    from montecosmo_tpu.ops.pm import lpt
    from montecosmo_tpu_torch.ops import background as tbg, hermitian as the

    n, box, a_obs = 16, 320.0, 0.5
    shape = (n,) * 3
    x = np.random.default_rng(73).standard_normal(shape).astype(np.float32)
    unit = np.prod(np.divide(shape, box)) ** 0.5

    @jax.jit
    def make(x):
        cosmo = AbacusSummit0()
        bg = Background.create(cosmo)
        lin = white2lin(cosmo, rg2cgh(x) * unit, shape, np.full(3, box))
        pos0 = regular_pos(shape)
        dpos, vel = lpt(bg, lin, pos0, a=a_obs, lpt_order=2, read_order=1)
        return (pos0 + dpos) % n, vel, jnp.fft.irfftn(lin), bg.a2g(a_obs) * bg.a2f(a_obs)

    posc, vel, lin_real, gf = make(jnp.asarray(x))
    to_kms = a_obs * 100.0 * float(np.sqrt(Esqr(AbacusSummit0(), a_obs))) * float(gf)
    mock, lin_t = treg.lpt_mock(tbg.AbacusSummit0(), the.rg2cgh(torch.tensor(x)) * unit, box, n,
                                a_obs)
    for t, j in ((mock["pos"], np.asarray(posc) * (box / n)),
                 (mock["vel"], np.asarray(vel) * (box / n) * to_kms)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())
    np.testing.assert_allclose(lin_t, lin_real, rtol=0, atol=1e-6 * np.abs(lin_real).max())

    path = treg.main(["synthetic", "--cell-budget", "512", "--n-ptcl", "16", "--box-size", "320",
                      "--init-oversamp", "1.0", "--paint-oversamp", "1.0", "--out",
                      str(tmp_path), "--device", "cpu"])
    reg = npload(path)
    assert path.name == "register_synthetic_z1.000_b8_p0.npz"
    assert "white_mesh" in reg and "white_fake" not in reg and reg["count_mesh"].shape == (8,) * 3
    np.testing.assert_allclose(reg["count_mesh"].sum(), 16**3, rtol=1e-4)

    data = catalog(500, 74)
    np.savez(tmp_path / "cat.npz", **data)
    np.save(tmp_path / "pos.npy", np.stack([data["RA"], data["DEC"], data["Z"]], -1))
    import h5py
    with h5py.File(tmp_path / "cat.h5", "w") as f:
        for k in ("RA", "DEC", "Z"):
            f[k] = data[k]
    for path in ("cat.npz", "cat.h5"):
        t, j = (m.load_cutsky_catalog(tmp_path / path) for m in (tcat, jcat))
        assert set(t) == set(j) == {"RA", "DEC", "Z", "WEIGHT"}
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
        t, j = (m.load_box_catalog(tmp_path / path, ("RA", "DEC"), ("Z",)) for m in (tcat, jcat))
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(tcat.load_box_catalog(tmp_path / "pos.npy")["pos"],
                                  jcat.load_box_catalog(tmp_path / "pos.npy")["pos"])
    np.save(tmp_path / "ic.npy", np.ones((4, 4, 4)))
    assert tcat.load_ic_mesh(tmp_path / "ic.npy").dtype == np.float32
    (tmp_path / "cat.fits").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "fitsio", None)  # as where fitsio is not installed
    with pytest.raises(ImportError, match=r"fitsio.*\.npz"):
        tcat.read_table(tmp_path / "cat.fits", ["RA"])
