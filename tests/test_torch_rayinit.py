"""rays_tpu_torch ray initializers against the JAX package: the
Appleton-Hartree solvers on seeded plasma parameters, the one-ray
initializer (solve, ``use_this_n_vec``, both errors, its alias) and the
file-input initializer (weights, dropped candidates) on the slab and on
the EQDSK toroid.

Tolerances: the solvers 1e-12 of scale; launch positions and weights equal;
refractive indices 1e-13 of each ray's scale.  Count and order of the
surviving rays are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu import run as jrun
from rays_tpu.wave import dispersion as jdisp
from rays_tpu_torch import convert, run as trun
from rays_tpu_torch.wave import dispersion as tdisp
from test_axisym import AXISYM_TMPL

SOLVER_TOL = 1e-12
RINDEX_TOL = 1e-13
MODES = ("plus", "minus", "fast", "slow")

ONE_RAY_LIST = """
&one_ray_init_XYZ_k_direction_list
 x={X}, y=0.02, z=-0.6, nx=1.0, ny=0.1, nz=0.4, use_this_n_vec={USE}
/
"""


def _plasma(n=200, seed=7):
    """(alpha (n,2), gamma (n,2), theta (n,)): electrons and deuterium from
    underdense to overdense, below and above the electron cyclotron
    frequency, every angle."""
    rng = np.random.default_rng(seed)
    a_e = 10.0 ** rng.uniform(-2, 0.5, n)
    g_e = -(10.0 ** rng.uniform(-0.7, 0.4, n))
    alpha = np.stack([a_e, a_e / 3670.0], axis=1)
    gamma = np.stack([g_e, -g_e / 3670.0], axis=1)
    theta = rng.uniform(0.0, np.pi, n)
    theta[:3] = [0.0, np.pi / 2, np.pi]
    return alpha, gamma, theta


def test_solve_cold_nsq_vs_theta_matches_jax():
    alpha, gamma, theta = _plasma()
    ref = np.asarray(jax.vmap(jdisp.solve_cold_nsq_vs_theta)(
        jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(theta)))
    got = tdisp.solve_cold_nsq_vs_theta(torch.from_numpy(alpha), torch.from_numpy(gamma),
                                        torch.from_numpy(theta)).numpy()
    assert got.shape == ref.shape == (200, 4)
    finite = np.isfinite(ref)
    assert finite.mean() > 0.99 and np.array_equal(np.isfinite(got), finite)
    tp.assert_rows_close(np.where(finite, got, 0.0), np.where(finite, ref, 0.0), SOLVER_TOL)
    assert (ref[finite] < 0).any() and (ref[finite] > 0).any()


@pytest.mark.parametrize("k_sign", [1, -1])
@pytest.mark.parametrize("mode", MODES)
def test_solve_n_vs_theta_matches_jax(mode, k_sign):
    alpha, gamma, theta = _plasma()
    jn, jv = jax.vmap(lambda a, g, t: jdisp.solve_n_vs_theta(a, g, mode, k_sign, t))(
        jnp.asarray(alpha), jnp.asarray(gamma), jnp.asarray(theta))
    tn, tv = tdisp.solve_n_vs_theta(torch.from_numpy(alpha), torch.from_numpy(gamma),
                                    mode, k_sign, torch.from_numpy(theta))
    assert tv.dtype == torch.bool and tv.tolist() == np.asarray(jv).tolist()
    assert 0 < int(tv.sum()) < 200
    ok = np.asarray(jv)
    np.testing.assert_allclose(tn.numpy()[ok], np.asarray(jn)[ok], rtol=SOLVER_TOL)
    assert float(tn[~tv].abs().max()) == 0.0
    assert bool((k_sign * tn >= 0).all())


def _slab_one_ray(x, use=".false.", model="one_ray_init_XYZ_k_direction"):
    text = jex.SLAB_ECH_90GHZ.replace("ray_init_model='simple_slab'",
                                      f"ray_init_model='{model}'")
    return text + ONE_RAY_LIST.format(X=x, USE=use)


def _both_init(text, input_dir="."):
    """The ray init of both packages on one namelist: each a
    (rvec, rindex, pwr) triple of numpy arrays, or the exception raised."""
    (jcfg, jparams), (pcfg, pparams) = tp.both_from_text(text, input_dir)
    assert pcfg.ray_init_model == jcfg.ray_init_model
    out = []
    for fn, cfg, params in ((jrun.init_rays, jcfg, jparams), (trun.init_rays, pcfg, pparams)):
        try:
            out.append(tuple(np.asarray(a) for a in fn(cfg, params)))
        except (RuntimeError, ValueError) as e:
            out.append(e)
    return out


def _assert_same_init(ref, got):
    assert not isinstance(ref, Exception) and not isinstance(got, Exception), (ref, got)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == np.float64
    np.testing.assert_array_equal(got[0], ref[0])
    tp.assert_rows_close(got[1], ref[1], RINDEX_TOL, "rindex")
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-15)


@pytest.mark.parametrize("model", ["one_ray_init_XYZ_k_direction",
                                   "one_ray_init_XYZ_n_direction"])
def test_one_ray_solves_along_the_direction(model):
    ref, got = _both_init(_slab_one_ray(-0.08, model=model))
    _assert_same_init(ref, got)
    assert got[0].tolist() == [[-0.08, 0.02, -0.6]] and got[2].tolist() == [1.0]
    # the direction is kept, the length solved: the vector no longer has
    # the length it was given
    unit = np.array([1.0, 0.1, 0.4]) / np.linalg.norm([1.0, 0.1, 0.4])
    n = np.linalg.norm(got[1][0])
    np.testing.assert_allclose(got[1][0] / n, unit, rtol=1e-13)
    assert 0.1 < n < 3.0 and abs(n - np.linalg.norm([1.0, 0.1, 0.4])) > 1e-3


def test_one_ray_use_this_n_vec():
    """The vector is used as given, with no solve: also where the mode does
    not propagate and where the launch point lies outside the box."""
    for x in (-0.08, 0.3, 0.7):
        ref, got = _both_init(_slab_one_ray(x, use=".true."))
        _assert_same_init(ref, got)
        assert got[1].tolist() == [[1.0, 0.1, 0.4]]


@pytest.mark.parametrize("x,message", [(0.7, "equilibrium error code"),
                                       (0.3, "evanescent")])
def test_one_ray_errors(x, message):
    ref, got = _both_init(_slab_one_ray(x))
    assert isinstance(ref, RuntimeError) and isinstance(got, RuntimeError)
    assert message in str(ref) and message in str(got)
    assert str(got) == str(ref)


FILE_INPUT_SLAB = """
&file_input_ray_init_list
 n_rays_in=5,
 rvec_in = -0.08,0.0,-0.6,  0.7,0.0,0.0,  0.1,0.1,0.3,  0.3,0.0,0.0,  -0.3,-0.1,0.5,
 rindex_vec_in = 1.0,0.0,0.4,  1.0,0.0,0.0,  0.5,0.5,0.2,  1.0,0.0,0.1,  1.0,0.2,-0.3,
 ray_pwr_wt_in = 1.0, 1.0, 3.0, 1.0, 0.5
/
"""


def test_file_input_on_the_slab(tmp_path):
    """Five candidates: the second lies outside the box and the fourth does
    not propagate; the file's weights are divided by the surviving count."""
    text = jex.SLAB_ECH_90GHZ.replace("ray_init_model='simple_slab'",
                                      "ray_init_model='file_input_ray_init'")
    (tmp_path / "ray_init_slab_demo.in").write_text(FILE_INPUT_SLAB)
    ref, got = _both_init(text, str(tmp_path))
    _assert_same_init(ref, got)
    assert got[0][:, 0].tolist() == [-0.08, 0.1, -0.3]
    assert got[2].tolist() == [1.0 / 3, 3.0 / 3, 0.5 / 3]


@pytest.mark.parametrize("form", ["no_weights", "indexed"])
def test_file_input_namelist_forms(tmp_path, form):
    """Weights left out default to 1; arrays given element by element."""
    text = jex.SLAB_ECH_90GHZ.replace("ray_init_model='simple_slab'",
                                      "ray_init_model='file_input_ray_init'")
    if form == "no_weights":
        body = FILE_INPUT_SLAB.replace(" ray_pwr_wt_in = 1.0, 1.0, 3.0, 1.0, 0.5\n", "")
    else:
        body = ("&file_input_ray_init_list\n n_rays_in=2,\n"
                " rvec_in(1)=-0.08, rvec_in(3)=-0.6, rvec_in(4)=0.1, rvec_in(5)=0.1,\n"
                " rindex_vec_in(1)=1.0, rindex_vec_in(3)=0.4, rindex_vec_in(4)=0.5,"
                " rindex_vec_in(5)=0.5,\n ray_pwr_wt_in(2)=3.0\n/\n")
    (tmp_path / "ray_init_slab_demo.in").write_text(body)
    ref, got = _both_init(text, str(tmp_path))
    _assert_same_init(ref, got)
    if form == "no_weights":
        assert got[2].tolist() == [1.0 / 3] * 3
    else:
        assert got[0].tolist() == [[-0.08, 0.0, -0.6], [0.1, 0.1, 0.0]]
        assert got[2].tolist() == [0.5, 1.5]


def test_file_input_all_dropped_raises(tmp_path):
    text = jex.SLAB_ECH_90GHZ.replace("ray_init_model='simple_slab'",
                                      "ray_init_model='file_input_ray_init'")
    (tmp_path / "ray_init_slab_demo.in").write_text(
        "&file_input_ray_init_list\n n_rays_in=1, rvec_in=0.7,0.0,0.0, "
        "rindex_vec_in=1.0,0.0,0.0\n/\n")
    ref, got = _both_init(text, str(tmp_path))
    assert isinstance(ref, RuntimeError) and isinstance(got, RuntimeError)
    assert str(got) == str(ref) and "no successful ray" in str(got)


FILE_INPUT_TOROID = """
&file_input_ray_init_list
 n_rays_in=4,
 rvec_in = 1.5,0.0,0.0,  1.45,0.1,0.1,  1.62,0.0,0.0,  1.3,-0.2,-0.15,
 rindex_vec_in = -1.0,0.3,0.0,  -1.0,0.2,0.1,  -1.0,0.0,0.0,  -0.8,0.3,0.2,
 ray_pwr_wt_in = 2.0, 1.0, 1.0, 1.0
/
"""


@pytest.mark.parametrize("model", ["file_input_ray_init", "one_ray_init_XYZ_k_direction"])
def test_inits_on_the_eqdsk_toroid(tmp_path, model):
    """The same two initializers on the spline geometry: of the four
    candidates the second does not propagate and the third lies outside
    psiN = 1; both are dropped."""
    path = tp.write_solovev_geqdsk(tmp_path / "s.geqdsk", n=33)
    text = AXISYM_TMPL.format(MAG="eqdsk_magnetics_spline_interp", EQDSK=path).replace(
        "ray_init_model='axisym_toroid_ray_init_R_Z_nphi_ntheta'",
        f"ray_init_model='{model}'")
    if model == "file_input_ray_init":
        (tmp_path / "ray_init_ax.in").write_text(FILE_INPUT_TOROID)
    else:
        text += ("&one_ray_init_XYZ_k_direction_list\n x=1.3, y=-0.2, z=-0.15, "
                 "nx=-1.0, ny=0.2, nz=0.1\n/\n")
    (jcfg, jparams), (pcfg, pparams) = tp.both_from_text(text, str(tmp_path))
    # the tables of the two importers differ in their last digits; the JAX
    # tables carried across make the comparison one of the initializers
    pparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ref = tuple(np.asarray(a) for a in jrun.init_rays(jcfg, jparams))
    got = tuple(a.numpy() for a in trun.init_rays(pcfg, pparams))
    _assert_same_init(ref, got)
    if model == "file_input_ray_init":
        assert got[0][:, 0].tolist() == [1.5, 1.3]
        assert got[2].tolist() == [2.0 / 2, 1.0 / 2]
        assert pcfg.rayinit_static.filename == os.path.join(str(tmp_path), "ray_init_ax.in")
    else:
        assert got[0].tolist() == [[1.3, -0.2, -0.15]]
