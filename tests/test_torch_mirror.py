"""rays_tpu_torch multiple mirror against the JAX package: the elliptic
integrals, the coil fields and the field file both ways, the namelist
importer with the ray-init file, every profile model's values and
jacobians, an RK4 trace (against JAX and against the NumPy oracle) and the
deposition coordinate on a damped run.  The mirror's inputs are made in the
test: a field file from four coils, a namelist and a ray-init file of four
candidates, one of which starts outside the plasma.

Tolerances: K(m), E(m) 1e-14 against JAX and scipy; coil fields 1e-13 of
scale; Params leaves of the two importers equal except the spline tables
(1e-7 of scale: the products M = T F cancel terms 1e8 times the result,
see tests/test_torch_axisym.py), so functions are compared on the JAX
tables carried across by ``convert``: fields and jacobians 1e-12 of each
point's scale, trajectories 1e-9 of trajectory scale with equal npoints and
flags, the oracle at the rtol 1e-6 of tests/test_parity.py, the deposition
profile 1e-10 of its largest bin.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import _oracle as oracle
import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import run as jrun
from rays_tpu.models import base as jbase
from rays_tpu.models import multiple_mirror as jmir
from rays_tpu.ops import elliptic as jell
from rays_tpu.post import deposition as jdep
from rays_tpu.tracing import trace as jtrace
from rays_tpu.utils import mirror_magnetics as jmag
from rays_tpu_torch import convert, run as trun
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.models import multiple_mirror as tmir
from rays_tpu_torch.ops import elliptic as tell
from rays_tpu_torch.post import deposition as tdep
from rays_tpu_torch.tracing import fused_slab
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.utils import mirror_magnetics as tmag
from test_parity import _assert_parity, _oracle_cfg

LEAF_TOL = 1e-7
FIELD_TOL = 1e-12
TRAJ_RTOL = 1e-9
PROFILE_RTOL = 1e-10
COILS = tuple(np.asarray(tp.MIRROR_COILS[k])
              for k in ("coil_r", "coil_z", "coil_current"))

PROFILES = {
    "hyperbolic": dict(DENS="hyperbolic", TEMP="2*'hyperbolic'"),
    "parabolic_mixed": dict(DENS="parabolic", TEMP="'constant','parabolic'"),
    "inside_lufs": dict(DENS="hyperbolic_prof_inside_LUFS",
                        TEMP="2*'hyperbolic_prof_inside_LUFS'"),
    "splines": dict(DENS="density_spline_interp", TEMP="2*'temperature_spline_interp'",
                    extra=tp.PROFILE_LISTS),
    "constant_zero": dict(DENS="constant", TEMP="2*'zero'"),
}


@pytest.fixture(scope="module")
def mirror_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mirror")
    tp.write_mirror_inputs(d)
    return str(d)


def _both(mirror_dir, name="rays.in", carried=True, **fmt):
    """((jax cfg, params), (port cfg, params)) of the mirror namelist; the
    port's params are the JAX tables carried across unless ``carried`` is
    off."""
    from rays_tpu.config import schema as jschema
    from rays_tpu_torch.config import schema as tschema

    path = tp.write_mirror_namelist(mirror_dir, name=name, **fmt)
    jcfg, jparams = jschema.from_file(path)
    pcfg, pparams = tschema.from_file(path)
    if carried:
        pparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return (jcfg, jparams), (pcfg, pparams)


def _points():
    """Inside the plasma, outside the last flux surface, outside the box
    and next to the axis (above the 1e-12 guard)."""
    rng = np.random.default_rng(31)
    ang = rng.uniform(0.0, 2.0 * np.pi, 8)
    rad = rng.uniform(0.005, 0.1, 8)
    inside = np.stack([rad * np.cos(ang), rad * np.sin(ang), rng.uniform(0.3, 3.7, 8)], axis=1)
    other = np.array([[0.19, 0.0, 2.0], [0.0, -0.17, 1.0], [0.2, 0.15, 2.0],
                      [0.01, 0.0, -0.1], [0.0, 0.02, 4.2], [1.0e-7, 0.0, 1.0],
                      [0.0, -3.0e-9, 2.6]])
    return np.concatenate([inside, other])


# --------------------------------------------------------------------------
# elliptic integrals, coil fields, the field file
# --------------------------------------------------------------------------


def test_ellipk_ellipe_match_jax_and_scipy():
    rng = np.random.default_rng(1)
    m = np.concatenate([[0.0, 1e-14, 0.5, 1.0 - 1e-12], rng.uniform(0.0, 1.0, 60),
                        1.0 - 10.0 ** rng.uniform(-10, -1, 20)])
    K, E = tell.ellipk_ellipe(torch.from_numpy(m))
    jK, jE = jell.ellipk_ellipe(jnp.asarray(m))
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=1e-14)
    np.testing.assert_allclose(E.numpy(), np.asarray(jE), rtol=1e-14)
    np.testing.assert_allclose(K.numpy(), scipy.special.ellipk(m), rtol=1e-14)
    np.testing.assert_allclose(E.numpy(), scipy.special.ellipe(m), rtol=1e-14)
    assert torch.equal(tell.ellipk(torch.from_numpy(m)), K)
    assert torch.equal(tell.ellipe(torch.from_numpy(m)), E)


def test_b_loop_matches_jax_and_axis_limit():
    rng = np.random.default_rng(2)
    r = np.concatenate([[0.0, 1e-9, 5e-7, 1e-6, 2e-6], rng.uniform(0.0, 0.6, 40)])
    z = np.concatenate([[0.3, -0.2, 0.1, 0.1, 0.4], rng.uniform(-1.0, 1.0, 40)])
    got = tmag.b_loop(0.3, 4.0e5, torch.from_numpy(r), torch.from_numpy(z))
    ref = jmag.b_loop(0.3, 4.0e5, jnp.asarray(r), jnp.asarray(z))
    for g, j, name in zip(got, ref, ("Br", "Bz", "Aphi")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-13,
                                   atol=1e-13 * np.abs(np.asarray(j)).max(), err_msg=name)
    # on the axis: Bz = mu0 I a^2 / (2 (a^2 + z^2)^1.5), Br = Aphi = 0
    from rays_tpu_torch import constants
    want = constants.MU0 * 4.0e5 * 0.09 / (2.0 * (0.09 + 0.09) ** 1.5)
    assert float(got[1][0]) == pytest.approx(want, rel=1e-14)
    assert float(got[0][0]) == 0.0 and float(got[2][0]) == 0.0
    # the series and the elliptic form meet at the switch (r = 1e-6)
    assert float(got[1][3]) == pytest.approx(float(got[1][2]), rel=1e-9)


@pytest.mark.parametrize("n_filaments", [1, 3])
def test_coil_set_fields_match_jax(n_filaments):
    rng = np.random.default_rng(3)
    r, z = rng.uniform(0.0, 0.2, 50), rng.uniform(0.0, 4.0, 50)
    r[0] = 0.0
    got = tmag.coil_set_fields(*COILS, torch.from_numpy(r), torch.from_numpy(z), n_filaments)
    ref = jmag.coil_set_fields(*(jnp.asarray(c) for c in COILS), jnp.asarray(r),
                               jnp.asarray(z), n_filaments)
    for g, j, name in zip(got, ref, ("Br", "Bz", "Aphi")):
        assert g.shape == (50,)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-13 * np.abs(np.asarray(j)).max(), err_msg=name)
    # a grid of points keeps its shape
    g2 = tmag.coil_set_fields(*COILS, torch.from_numpy(r).reshape(5, 10),
                              torch.from_numpy(z).reshape(5, 10), n_filaments)
    assert g2[0].shape == (5, 10) and torch.allclose(g2[1].reshape(-1), got[1], rtol=1e-14)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_field_file_both_ways(tmp_path, writer):
    """The port's file loads in the JAX package and the JAX file in the
    port: (n_z, n_r) C order, NetCDF3."""
    from scipy.io import netcdf_file

    path = str(tmp_path / "Brz.nc")
    gen = tmag if writer == "port" else jmag
    gen.generate_field_file(path, *COILS, n_r=11, n_z=21, r_lufs=0.15, z_lufs=1.9)
    other = str(tmp_path / "other.nc")
    (jmag if writer == "port" else tmag).generate_field_file(
        other, *COILS, n_r=11, n_z=21, r_lufs=0.15, z_lufs=1.9)
    fa, fb = netcdf_file(path, "r", mmap=False), netcdf_file(other, "r", mmap=False)
    try:
        assert sorted(fa.variables) == sorted(fb.variables)
        assert dict(fa.dimensions) == dict(fb.dimensions) == {"n_r": 11, "n_z": 21}
        for k in fa.variables:
            a, b = np.array(fa.variables[k].data), np.array(fb.variables[k].data)
            assert a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-13 * max(np.abs(b).max(), 1e-300),
                                       err_msg=k)
        assert fa.variables["Br"].shape == (21, 11)
    finally:
        fa.close()
        fb.close()
    jl, tl = jmir.load_field_file(path), tmir.load_field_file(path)
    for t, j in zip(tl[:3] + (tl[5],), jl[:3] + (jl[5],)):
        tp.assert_leaves_close(t, j, LEAF_TOL)
    assert tl[3] == pytest.approx(jl[3], rel=1e-12) and tl[4] == jl[4] == (0.2, 0.0, 4.0)
    assert isinstance(tl[3], float) and tl[5].cells.shape == (10, 20, 3, 4, 4)


# --------------------------------------------------------------------------
# the importer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("profiles", sorted(PROFILES))
def test_from_namelist_matches_jax(mirror_dir, profiles):
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir, carried=False, **PROFILES[profiles])
    jd = dataclasses.asdict(jcfg)
    jd.pop("fused_kernel")
    assert dataclasses.asdict(pcfg) == jd
    assert type(pcfg.eq_static).__name__ == "MultipleMirrorStatic"
    # the ray-init file sits beside the namelist, named after the run label
    assert pcfg.rayinit_static.filename == os.path.join(mirror_dir, "ray_init_mirror.in")
    assert tp.assert_leaves_close(pparams, jparams, LEAF_TOL) > 60
    assert all(t.dtype == torch.float64 for t in tree_leaves(pparams))
    assert convert.config_from_dict(dataclasses.asdict(jcfg)) == pcfg
    carried = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    assert tp.assert_leaves_close(carried, jparams, 0.0) > 60
    if profiles != "splines":
        assert tuple(pparams.eq.ne_knots.shape) == (2, 4)
        assert float(pparams.eq.ne_knots.abs().max()) == 0.0
    else:
        assert tuple(pparams.eq.ne_knots.shape) == (2, 6)
        assert tuple(pparams.eq.te_knots.shape) == (2, 5)


def test_missing_field_file_name_raises(mirror_dir):
    from rays_tpu_torch.config import schema as tschema
    from rays_tpu_torch.config.namelist import read_namelist_file

    nml = read_namelist_file(tp.write_mirror_namelist(mirror_dir, name="nofile.in"))
    del nml["mirror_magnetics_spline_interp_list"]
    with pytest.raises(ValueError, match="mirror_field_NC_file"):
        tschema.from_namelist(nml, input_dir=mirror_dir)


# --------------------------------------------------------------------------
# fields, jacobians, Aphi, error codes, the whole EqPoint
# --------------------------------------------------------------------------


def _jax_fields_and_jac(jcfg, jparams, pts):
    def f(x):
        return jmir.fields(jcfg.eq_static, jparams.eq, jparams.species, x)

    return jax.vmap(lambda x: (f(x), jax.jacfwd(f)(x)))(jnp.asarray(pts))


@pytest.mark.parametrize("profiles", sorted(PROFILES))
def test_fields_and_jac_match_jacfwd_of_jax_fields(mirror_dir, profiles):
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir, **PROFILES[profiles])
    pts = _points()
    vals, jacs = _jax_fields_and_jac(jcfg, jparams, pts)
    x = torch.from_numpy(pts)
    tv, tj = tmir.fields_and_jac(pcfg.eq_static, pparams.eq, pparams.species, x)
    names = ("bvec", "ns", "ts", "jb", "jn", "jt")
    # autodiff takes the slope of tanh as 1 - tanh^2, which cancels where
    # tanh -> 1; the closed form 1/cosh^2 does not, so the profile jacobians
    # of the tanh models are held to 1e-7 against jacfwd, and to 1e-9
    # against the JAX package's own closed form below (near the axis its
    # two 1/cosh^2 terms cancel, and the two libraries' cosh differ by an ulp)
    tanh = "hyperbolic" in PROFILES[profiles]["DENS"]
    for got, ref, name in zip(tv + tj, vals + jacs, names):
        tol = 1e-7 if tanh and name in ("jn", "jt") else FIELD_TOL
        tp.assert_rows_close(got, ref, tol, f"{profiles} {name}")
    if jmir.supports_analytic_jac(jcfg.eq_static, jparams.eq):
        cv, cj = jax.vmap(lambda r: jmir.fields_and_jac(
            jcfg.eq_static, jparams.eq, jparams.species, r))(jnp.asarray(pts))
        for got, ref, name in zip(tv + tj, cv + cj, names):
            tol = 1e-9 if tanh and name in ("jn", "jt") else FIELD_TOL
            tp.assert_rows_close(got, ref, tol, f"{profiles} closed form {name}")
    else:
        assert profiles == "splines"
    for got, ref, name in zip(tmir.fields(pcfg.eq_static, pparams.eq, pparams.species, x),
                              vals, names):
        tp.assert_rows_close(got, ref, FIELD_TOL, f"fields {name}")
    fused = tmir.fields_jac_geom(pcfg.eq_static, pparams.eq, pparams.species, x)
    assert torch.equal(fused[2], tmir.geom_err(pcfg.eq_static, pparams.eq, x))


def test_fields_and_jac_without_cell_table(mirror_dir):
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir, **PROFILES["hyperbolic"])
    jparams = jparams._replace(eq=jparams.eq._replace(field_cells=None))
    pts = _points()
    vals, jacs = _jax_fields_and_jac(jcfg, jparams, pts)
    tv, tj = tmir.fields_and_jac(pcfg.eq_static, pparams.eq._replace(field_cells=None),
                                 pparams.species, torch.from_numpy(pts))
    for got, ref, name in zip(tv + tj, vals + jacs, ("bvec", "ns", "ts", "jb", "jn", "jt")):
        tp.assert_rows_close(got, ref, 1e-7 if name in ("jn", "jt") else 1e-11,
                             f"no cells {name}")


def test_on_axis_matches_jax_closed_form(mirror_dir):
    """Exactly on the axis autodiff has no answer (the derivative of the
    square root); the closed form under the guard r = 1e-12 gives the axis
    limit dBx/dx = dBy/dy = dBr/dr, as the JAX package's own closed form."""
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir, **PROFILES["hyperbolic"])
    pts = np.array([[0.0, 0.0, 0.7], [0.0, 0.0, 2.0], [0.0, 0.0, 3.3]])
    ref = jax.vmap(lambda x: jmir.fields_and_jac(jcfg.eq_static, jparams.eq,
                                                 jparams.species, x))(jnp.asarray(pts))
    tv, tj = tmir.fields_and_jac(pcfg.eq_static, pparams.eq, pparams.species,
                                 torch.from_numpy(pts))
    for got, r, name in zip(tv + tj[:1], ref[0] + ref[1][:1], ("bvec", "ns", "ts", "jb")):
        tp.assert_rows_close(got, r, FIELD_TOL, f"axis {name}")
    # Aphi ~ r: on the axis its gradient, and with it the profiles', is zero
    # but for the rounding of the spline at r = 1e-12
    for vals, jac in ((tv[1], tj[1]), (tv[2], tj[2])):
        assert float(jac.abs().max()) <= 1e-9 * float(vals.abs().max()) / 0.2
    jb = tj[0]
    assert bool(torch.isfinite(jb).all())
    # div B = 0 on the axis to the spline's accuracy: 2 dBr/dr + dBz/dz = 0
    div = jb[:, 0, 0] + jb[:, 1, 1] + jb[:, 2, 2]
    assert float(div.abs().max()) < 1e-3 * float(jb.abs().max())


def test_aphi_geom_err_and_eq_point_match_jax(mirror_dir):
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir, **PROFILES["parabolic_mixed"])
    pts = _points()
    x = torch.from_numpy(pts)
    ref = jax.vmap(lambda r: jmir.magnetics(jparams.eq, r))(jnp.asarray(pts))
    for got, r, name in zip(tmir.magnetics(pparams.eq, x), ref, ("bvec", "aphi", "aphiN")):
        tp.assert_rows_close(got, r, FIELD_TOL, f"magnetics {name}")
    ref = jax.vmap(lambda r: jmir.aphi_and_grad(jcfg.eq_static, jparams.eq, r))(jnp.asarray(pts))
    for got, r, name in zip(tmir.aphi_and_grad(pcfg.eq_static, pparams.eq, x), ref,
                            ("aphi", "grad", "aphiN", "gradN")):
        tp.assert_rows_close(got, r, FIELD_TOL, f"aphi_and_grad {name}")
    geom = jax.vmap(lambda r: jmir.geom_err(jcfg.eq_static, jparams.eq, r))(jnp.asarray(pts))
    got = tmir.geom_err(pcfg.eq_static, pparams.eq, x)
    assert got.dtype == torch.int32 and got.tolist() == np.asarray(geom).tolist()
    assert len(set(got.tolist())) == 4      # ok, out of plasma, R and z out of box
    full = jax.vmap(lambda r: jmir.err(jcfg.eq_static, jparams.eq, jparams.species, r))(
        jnp.asarray(pts))
    assert tmir.err(pcfg.eq_static, pparams.eq, pparams.species, x).tolist() == \
        np.asarray(full).tolist()
    jeq = jax.vmap(lambda r: jbase.equilibrium(jcfg, jparams, r))(jnp.asarray(pts))
    peq = tbase.equilibrium(pcfg, pparams, x)
    for name in peq._fields:
        got, r = getattr(peq, name), np.asarray(getattr(jeq, name))
        if name == "err":
            assert got.tolist() == r.tolist()
        else:
            tp.assert_rows_close(got, r, 10 * FIELD_TOL, f"EqPoint.{name}")


def test_hyperbolic_profiles_match_jax():
    rho = np.concatenate([np.linspace(-0.2, 1.4, 33), [1.0, 0.999999]])
    t = torch.from_numpy(rho)
    args = (0.05, 0.5, 0.15)
    targs = tuple(torch.tensor(a, dtype=torch.float64) for a in args)
    for tf, jf in ((tmir.hyperbolic, jmir.hyperbolic),
                   (tmir.hyperbolic_inside_lufs, jmir.hyperbolic_inside_lufs)):
        for got, ref in zip(tf(t, *targs), jf(jnp.asarray(rho), *args)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=1e-15)


# --------------------------------------------------------------------------
# ray init, traces, deposition
# --------------------------------------------------------------------------


def _trace_both(mirror_dir, name, **fmt):
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir, name=name, **fmt)
    v0, st, pwr = tp.jax_launch(jcfg, jparams)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(jcfg, p, v, s, w))(
        jparams, v0, st, pwr)
    _, _, tv0, tst, tpw = trun.setup_from(pcfg, pparams, "cpu", torch.float64)
    tp.assert_rows_close(tv0, v0, 1e-13, "v0")
    np.testing.assert_allclose(tpw.numpy(), np.asarray(pwr), rtol=1e-15)
    assert ttrace.route(pcfg, False, "cuda") == "graph"
    assert ttrace.route(pcfg, False, "cpu") == "plain"
    assert not fused_slab.supported(pcfg)
    before = fused_slab.LAUNCHES
    got = ttrace.trace_rays(pcfg, pparams, tv0, tst, tpw)
    assert fused_slab.LAUNCHES == before
    return (jcfg, jparams, ref), (pcfg, pparams, got)


def _assert_same_trace(ref, got, what):
    assert got.npoints.tolist() == np.asarray(ref.npoints).tolist(), what
    assert got.stop_flag.tolist() == np.asarray(ref.stop_flag).tolist(), what
    tp.assert_scaled_close(got.ray_vec.numpy(), np.asarray(ref.ray_vec), TRAJ_RTOL, axis=1,
                           what=what)
    tp.assert_scaled_close(got.end_ray_vec.numpy(), np.asarray(ref.end_ray_vec), TRAJ_RTOL,
                           axis=-1, what=what + " end")


def test_file_input_ray_init_matches_jax(mirror_dir):
    """Four candidates; the third starts outside the last flux surface and
    is dropped, and the file's weights are divided by the surviving count."""
    (jcfg, jparams), (pcfg, pparams) = _both(mirror_dir)
    jr, jn, jw = jrun.init_rays(jcfg, jparams)
    pr, pn, pw = trun.init_rays(pcfg, pparams)
    assert pr.shape == jr.shape == (3, 3)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    tp.assert_rows_close(pn, jn, 1e-14, "rindex")
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    assert pw.tolist() == [1.0 / 3, 2.0 / 3, 0.5 / 3]
    assert pr[:, 2].tolist() == [1.4, 1.5, 1.6]


def test_rk4_trace_matches_jax(mirror_dir):
    (_, _, ref), (_, _, got) = _trace_both(mirror_dir, "trace.in", NSTEP=60)
    _assert_same_trace(ref, got, "mirror")
    assert float(got.max_residuals.max()) < 1e-4
    # second harmonic at the launch points: 2 |omega_ce| / omega = 0.75 - 0.9
    # the rays leave through the last flux surface
    assert set(got.stop_flag.tolist()) <= {9, 31} and got.npoints.min() > 5


def test_rk4_trace_matches_numpy_oracle(mirror_dir):
    """The port's trace against the scalar NumPy transcription of the
    reference (tests/_oracle.py::MirrorEq), at the bar of tests/test_parity.py."""
    from scipy.io import netcdf_file

    (_, _, _), (cfg, params, res) = _trace_both(mirror_dir, "oracle.in", NSTEP=40)
    f = netcdf_file(os.path.join(mirror_dir, "Brz_fields.test.nc"), "r", mmap=False)
    try:
        rg = np.array(f.variables["r_grid"][:], float)
        zg = np.array(f.variables["z_grid"][:], float)
        br, bz, aphi = (np.array(f.variables[k][:], float).T for k in ("Br", "Bz", "Aphi"))
        r_lufs = float(f.variables["r_LUFS"].getValue())
        z_lufs = float(f.variables["z_LUFS"].getValue())
    finally:
        f.close()
    e, sp = params.eq, params.species
    p = {k: float(getattr(e, k)) for k in
         ("box_rmax", "box_zmin", "box_zmax", "plasma_aphin_limit", "alphan1", "alphan2",
          "aphin0_d", "delta_d", "d_scrape_off", "t_scrape_off")}
    for k in ("alphat1", "alphat2", "aphin0_t", "delta_t"):
        p[k] = getattr(e, k).numpy()
    models = dict(density_prof_model=cfg.eq_static.density_prof_model,
                  temperature_prof_model=cfg.eq_static.temperature_prof_model)
    eq_fn = oracle.MirrorEq(models, p, sp.n0s.numpy() * float(sp.n_ref), sp.t0s.numpy(),
                            rg, zg, br, bz, aphi,
                            oracle.NotAKnot2D(rg, zg, aphi).evaluate(r_lufs, z_lufs)[0])
    res = tree_map(lambda t: t.numpy(), res)
    _assert_parity(cfg, params, res, _oracle_cfg(cfg, params, eq_fn), rtol=1e-6)


@pytest.fixture(scope="module")
def damped_runs(mirror_dir):
    """22 GHz at 1e18 m^-3 with damp_fund_ECH: the fundamental resonance
    (B = 0.786 T) lies between the coils, and the second ray is absorbed."""
    return _trace_both(mirror_dir, "damped.in", FRF="22.e9", N0="1.0e18",
                       DAMP="damp_fund_ECH", NSTEP=100)


def test_ptotal_aphin_matches_jax(damped_runs):
    (jcfg, jparams, ref), (pcfg, pparams, got) = damped_runs
    _assert_same_trace(ref, got, "damped mirror")
    assert float(got.end_ray_vec[:, 7].max()) > 0.9
    assert tdep.profile_names_for_geometry("multiple_mirror", pcfg, pparams) == \
        jdep.profile_names_for_geometry("multiple_mirror", jcfg, jparams) == ("Ptotal_AphiN",)
    jprof = jdep.calculate_deposition_profile(jcfg, jparams, ref, "Ptotal_AphiN", n_bins=32)
    tprof = tdep.calculate_deposition_profile(pcfg, pparams, got, "Ptotal_AphiN", n_bins=32)
    jp = np.asarray(jprof.profile)
    assert tprof.name == "Ptotal_AphiN" and jp.max() > 1e-2
    np.testing.assert_allclose(tprof.profile.numpy(), jp, rtol=PROFILE_RTOL,
                               atol=PROFILE_RTOL * np.abs(jp).max())
    np.testing.assert_allclose(tprof.grid.numpy(), np.asarray(jprof.grid), rtol=1e-15)


def test_deposition_file_and_refusals(damped_runs, tmp_path):
    from scipy.io import netcdf_file

    (_, _, _), (pcfg, pparams, got) = damped_runs
    path = tdep.write_deposition_profiles_nc(pcfg, pparams, got, n_bins=16,
                                             path=str(tmp_path / "dep.nc"))
    f = netcdf_file(path, "r", mmap=False)
    try:
        name = b"".join(f.variables["profile_name"][0]).decode().strip()
        grid = b"".join(f.variables["grid_name"][0]).decode().strip()
    finally:
        f.close()
    assert (name, grid) == ("Ptotal_AphiN", "AphiN")
    for which in ("Ptotal_psi", "Ptotal_rho", "Ptotal_x"):
        if which == "Ptotal_x":
            continue
        with pytest.raises(ValueError, match="not available"):
            tdep.calculate_deposition_profile(pcfg, pparams, got, which)
