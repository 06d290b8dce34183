"""rays_tpu_torch axisymmetric toroid against the JAX package: the G-EQDSK
file both ways, the namelist importer, the three magnetics backends with
every profile model, the flux-coordinate maps, the ray init, RK4 and
adaptive traces, the deposition coordinates and the adjoint through the
psi cell table.  The same namelist text and the same generated files go
through both packages.

Tolerances: Params leaves of the two importers equal, except the tables
that come out of a matrix product or a bisection, which are held to 1e-7
of scale: T has entries of 6/h^2 ~ 2e4, so the terms of Mxy = Tx F Ty^T are
1e8 times the result, and XLA's and PyTorch's products both sit ~1e-8 of
scale from the product in extended precision.  Every comparison of
functions therefore runs the port on the JAX tables, carried across by
``convert.params_from_numpy``, so that it holds the evaluators and not the
conditioning of the build: fields, jacobians and the
whole EqPoint 1e-12 of each point's scale for the Solovev and spline
backends, 1e-10 for the bilinear one (its central differences divide
rounding by half a grid step); ray init 1e-14; trajectories 1e-9 of
trajectory scale with equal npoints and flags; the NumPy oracle at the
rtol 1e-6 of tests/test_parity.py; deposition profiles 1e-10 of the
largest bin; gradients 1e-8 of each leaf's scale against ``jax.grad``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _oracle as oracle
import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu import run as jrun
from rays_tpu.models import axisym_toroid as jat
from rays_tpu.models import base as jbase
from rays_tpu.post import deposition as jdep
from rays_tpu.tracing import trace as jtrace
from rays_tpu.utils import eqdsk_io as jio
from rays_tpu.utils import solovev_2_eqdsk as jgen
from rays_tpu_torch import convert, run as trun
from rays_tpu_torch.config import schema as tschema
from rays_tpu_torch.config.namelist import parse_namelist as tparse
from rays_tpu_torch.core.types import tree_leaves, tree_map
from rays_tpu_torch.models import axisym_toroid as tat
from rays_tpu_torch.models import base as tbase
from rays_tpu_torch.models import solovev as tsolovev
from rays_tpu_torch.post import deposition as tdep
from rays_tpu_torch.tracing import fused_slab
from rays_tpu_torch.tracing import trace as ttrace
from rays_tpu_torch.utils import eqdsk_io as tio
from rays_tpu_torch.utils import solovev_2_eqdsk as tgen
from test_axisym import AXISYM_TMPL
from test_parity import _assert_parity, _oracle_cfg

LEAF_TOL = 1e-7
FIELD_TOL = {"solovev_magnetics": 1e-12, "eqdsk_magnetics_spline_interp": 1e-12,
             "eqdsk_magnetics_lin_interp": 1e-10}
INIT_TOL = 1e-14
TRAJ_RTOL = 1e-9
PROFILE_RTOL = 1e-10
GRAD_TOL = 1e-8
MAGS = sorted(FIELD_TOL)

# profile-model sets: (density, temperatures, text changes)
PROFILES = {
    "parabolic_zero": {},
    "constant_mixed": {
        "density_prof_model='parabolic'": "density_prof_model='constant'",
        "temperature_prof_model=2*'zero'":
            "temperature_prof_model='constant','parabolic', alphat1=2*1.5, "
            "alphat2=2*2.0, t_scrape_off=0.02"},
    "splines": {
        "density_prof_model='parabolic'": "density_prof_model='density_spline_interp'",
        "temperature_prof_model=2*'zero'":
            "temperature_prof_model=2*'temperature_spline_interp', t_scrape_off=0.02"},
}


def _text(mag, eqdsk, profiles="parabolic_zero", **changes):
    text = AXISYM_TMPL.format(MAG=mag, EQDSK=eqdsk)
    for old, new in {**PROFILES[profiles], **changes}.items():
        assert old in text, old
        text = text.replace(old, new)
    return text + (tp.PROFILE_LISTS if profiles == "splines" else "")


@pytest.fixture(scope="module")
def eqdsk_file(tmp_path_factory):
    return tp.write_solovev_geqdsk(tmp_path_factory.mktemp("eqdsk") / "solovev.geqdsk")


@pytest.fixture(scope="module")
def eqdsk_file_q(tmp_path_factory):
    return tp.write_solovev_geqdsk(tmp_path_factory.mktemp("eqdsk_q") / "solovev_q.geqdsk",
                                   with_q=True)


def _both(text, carried=True):
    """((jax cfg, params), (port cfg, params)): the port's Config from its
    own importer and, unless ``carried`` is off, the JAX tables carried
    across."""
    (jcfg, jparams), (pcfg, pparams) = tp.both_from_text(text)
    if carried:
        pparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return (jcfg, jparams), (pcfg, pparams)


def _points():
    """Inside the plasma, outside psiN = 1 but in the box, outside the box
    and the grid, and next to the axis (above the 1e-12 guard)."""
    rng = np.random.default_rng(21)
    inside = np.stack([rng.uniform(0.95, 1.5, 8), rng.uniform(-0.2, 0.2, 8),
                       rng.uniform(-0.3, 0.3, 8)], axis=1)
    other = np.array([[1.58, 0.1, 0.35], [0.8, 0.0, 0.75], [1.9, 0.3, 0.95],
                      [0.3, 0.1, -1.2], [1.0e-7, 0.0, 0.1], [0.0, 3.0e-9, -0.05],
                      [1.45, 0.0, 0.1], [1.2, 0.3, -0.2]])
    return np.concatenate([inside, other])


# --------------------------------------------------------------------------
# files and the importer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_geqdsk_file_both_ways(tmp_path, writer):
    """A file written by one package is read by the other, and the port's
    generator writes what the JAX package's writes."""
    geq = (tgen if writer == "port" else jgen).solovev_geqdsk(nrbox=33, nzbox=33)
    path = str(tmp_path / "s.geqdsk")
    (tio if writer == "port" else jio).write_geqdsk(path, geq)
    other = str(tmp_path / "other.geqdsk")
    (jio if writer == "port" else tio).write_geqdsk(
        other, (jgen if writer == "port" else tgen).solovev_geqdsk(nrbox=33, nzbox=33))
    assert open(path).read() == open(other).read()
    a, b = tio.read_geqdsk(path), jio.read_geqdsk(path)
    assert a.nrbox == b.nrbox == 33 and a.header == b.header
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name
    np.testing.assert_allclose(a.psi, geq.psi, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(a.r_grid, b.r_grid)


def test_solovev_2_eqdsk_cli(tmp_path, capsys):
    out = str(tmp_path / "cli.geqdsk")
    tgen.main([out, "--n", "17"])
    assert "17x17" in capsys.readouterr().out
    g = tio.read_geqdsk(out)
    ref = jgen.solovev_geqdsk(nrbox=17, nzbox=17)
    np.testing.assert_allclose(g.psi, ref.psi, rtol=1e-8, atol=1e-12)
    assert g.psibound == pytest.approx(ref.psibound, rel=1e-8)


@pytest.mark.parametrize("profiles", sorted(PROFILES))
@pytest.mark.parametrize("mag", MAGS)
def test_from_namelist_matches_jax(eqdsk_file, mag, profiles):
    (jcfg, jparams), (pcfg, pparams) = tp.both_from_text(_text(mag, eqdsk_file, profiles))
    jd = dataclasses.asdict(jcfg)
    jd.pop("fused_kernel")
    assert dataclasses.asdict(pcfg) == jd
    assert type(pcfg.eq_static).__name__ == "AxisymToroidStatic"
    assert type(pcfg.rayinit_static).__name__ == "AxisymToroidInit"
    assert tp.assert_leaves_close(pparams, jparams, LEAF_TOL) > 35
    assert all(t.device.type == "cpu" and t.dtype == torch.float64
               for t in tree_leaves(pparams))
    # convert.py carries the JAX run across: the same Config, the JAX leaves
    assert convert.config_from_dict(dataclasses.asdict(jcfg)) == pcfg
    carried = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    assert tp.assert_leaves_close(carried, jparams, 0.0) > 35
    if mag == "eqdsk_magnetics_spline_interp":
        # a Solovev-made file has Q = 0: no rho machinery, None both sides
        assert pparams.eq.mag.rho_spline is None and carried.eq.mag.rho_spline is None
        assert pparams.eq.mag.psi_cells.cells.shape == (64, 64, 2, 4, 4)
        # the box of an EQDSK run is the file's
        g = tio.read_geqdsk(eqdsk_file)
        assert float(pparams.eq.box_rmin) == g.rboxlft
    # float32 on request, rounded once from float64
    _, p32 = tschema.from_namelist(tparse(_text(mag, eqdsk_file, profiles)),
                                   dtype=torch.float32)
    for a, b in zip(tree_leaves(p32), tree_leaves(pparams)):
        assert a.dtype == torch.float32 and torch.equal(a, b.float())


def test_build_spline_knots_normalises_by_first_value():
    vals = [2.0, 1.7, 1.1, 0.5, 0.1]
    t, j = tat.build_spline_knots(vals), jat.build_spline_knots(vals)
    assert t.shape == (2, 5) and float(t[0, 0]) == 1.0
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                               atol=LEAF_TOL * np.abs(np.asarray(j)).max())


# --------------------------------------------------------------------------
# fields, jacobians, psi, error codes, the whole EqPoint
# --------------------------------------------------------------------------


def _jax_fields_and_jac(jcfg, jparams, pts):
    model = jbase.get_eq_model("axisym_toroid")

    def f(x):
        return model.fields(jcfg.eq_static, jparams.eq, jparams.species, x)

    return jax.vmap(lambda x: (f(x), jax.jacfwd(f)(x)))(jnp.asarray(pts))


@pytest.mark.parametrize("profiles", sorted(PROFILES))
@pytest.mark.parametrize("mag", MAGS)
def test_fields_and_jac_match_jacfwd_of_jax_fields(eqdsk_file, mag, profiles):
    (jcfg, jparams), (pcfg, pparams) = _both(_text(mag, eqdsk_file, profiles))
    pts = _points()
    vals, jacs = _jax_fields_and_jac(jcfg, jparams, pts)
    x = torch.from_numpy(pts)
    tv, tj = tat.fields_and_jac(pcfg.eq_static, pparams.eq, pparams.species, x)
    names = ("bvec", "ns", "ts", "jb", "jn", "jt")
    for got, ref, name in zip(tv + tj, vals + jacs, names):
        tp.assert_rows_close(got, ref, FIELD_TOL[mag], f"{mag} {profiles} {name}")
    # fields alone and the fused form give the same numbers
    for got, ref, name in zip(tat.fields(pcfg.eq_static, pparams.eq, pparams.species, x),
                              vals, names):
        tp.assert_rows_close(got, ref, FIELD_TOL[mag], f"fields {name}")
    fused = tat.fields_jac_geom(pcfg.eq_static, pparams.eq, pparams.species, x)
    assert torch.equal(fused[2], tat.geom_err(pcfg.eq_static, pparams.eq, x))
    # outside psiN = 1 the profiles sit on their scrape-off values with
    # zero gradient (the kink the adaptive stepper meets there)
    if profiles == "parabolic_zero":
        assert float(tv[1][8, 0]) == pytest.approx(0.05) and float(tj[1][8].abs().max()) == 0.0


def test_fields_and_jac_without_cell_table(eqdsk_file):
    """``psi_cells = None``: the knot tables give the same values and
    jacobians (the JAX package falls back to forward-mode autodiff there)."""
    (jcfg, jparams), (pcfg, pparams) = _both(
        _text("eqdsk_magnetics_spline_interp", eqdsk_file, "splines"))
    jparams = jparams._replace(eq=jparams.eq._replace(
        mag=jparams.eq.mag._replace(psi_cells=None)))
    peq = pparams.eq._replace(mag=pparams.eq.mag._replace(psi_cells=None))
    pts = _points()
    vals, jacs = _jax_fields_and_jac(jcfg, jparams, pts)
    tv, tj = tat.fields_and_jac(pcfg.eq_static, peq, pparams.species, torch.from_numpy(pts))
    for got, ref, name in zip(tv + tj, vals + jacs, ("bvec", "ns", "ts", "jb", "jn", "jt")):
        tp.assert_rows_close(got, ref, 1e-11, f"no cells {name}")
    # and the cell table agrees with the knot tables
    cv, cj = tat.fields_and_jac(pcfg.eq_static, pparams.eq, pparams.species,
                                torch.from_numpy(pts))
    for got, ref in zip(cv + cj, tv + tj):
        tp.assert_rows_close(got, ref.numpy(), 1e-10, "cells against knots")


@pytest.mark.parametrize("mag", MAGS)
def test_psi_geom_err_and_eq_point_match_jax(eqdsk_file, mag):
    (jcfg, jparams), (pcfg, pparams) = _both(
        _text(mag, eqdsk_file, "constant_mixed"))
    pts = _points()
    x = torch.from_numpy(pts)
    tol = FIELD_TOL[mag]
    ref = jax.vmap(lambda r: jat.magnetics(jcfg.eq_static, jparams.eq, r))(jnp.asarray(pts))
    for got, r, name in zip(tat.magnetics(pcfg.eq_static, pparams.eq, x), ref,
                            ("bvec", "psi", "psiN")):
        tp.assert_rows_close(got, r, tol, f"magnetics {name}")
    ref = jax.vmap(lambda r: jat.psi_and_grad(jcfg.eq_static, jparams.eq, r))(jnp.asarray(pts))
    for got, r, name in zip(tat.psi_and_grad(pcfg.eq_static, pparams.eq, x), ref,
                            ("psi", "gradpsi", "psiN", "gradpsiN")):
        tp.assert_rows_close(got, r, tol, f"psi_and_grad {name}")
    geom = jax.vmap(lambda r: jat.geom_err(jcfg.eq_static, jparams.eq, r))(jnp.asarray(pts))
    got = tat.geom_err(pcfg.eq_static, pparams.eq, x)
    assert got.dtype == torch.int32 and got.tolist() == np.asarray(geom).tolist()
    # ok, out of plasma, R out of box and (in the file's tighter box) z out of box
    assert len(set(got.tolist())) >= (4 if "eqdsk" in mag else 3)
    full = jax.vmap(lambda r: jat.err(jcfg.eq_static, jparams.eq, jparams.species, r))(
        jnp.asarray(pts))
    assert tat.err(pcfg.eq_static, pparams.eq, pparams.species, x).tolist() == \
        np.asarray(full).tolist()
    jeq = jax.vmap(lambda r: jbase.equilibrium(jcfg, jparams, r))(jnp.asarray(pts))
    peq = tbase.equilibrium(pcfg, pparams, x)
    assert peq._fields == jeq._fields
    for name in peq._fields:
        got, r = getattr(peq, name), np.asarray(getattr(jeq, name))
        if name == "err":
            assert got.tolist() == r.tolist()
        else:
            tp.assert_rows_close(got, r, 10 * tol, f"EqPoint.{name}")


def test_spline_field_matches_closed_form_solovev(tmp_path):
    """compare_analyt_2_interp: B from the splined 129 x 129 file against
    the port's closed-form Solovev field, at the points and bars of
    tests/test_axisym.py."""
    path = tp.write_solovev_geqdsk(tmp_path / "s129.geqdsk", n=129)
    cfg_s, p_s = tschema.from_namelist(tparse(_text("eqdsk_magnetics_spline_interp", path)))
    cfg_a, p_a = tschema.from_namelist(tparse(_text("solovev_magnetics", path)))
    cfg_l, p_l = tschema.from_namelist(tparse(_text("eqdsk_magnetics_lin_interp", path)))
    pts = torch.tensor([[1.45, 0.0, 0.1], [1.2, 0.3, -0.2], [0.9, 0.2, 0.4],
                        [1.5, 0.0, 0.0]], dtype=torch.float64)
    es, ea, el = (tbase.equilibrium(c, p, pts)
                  for c, p in ((cfg_s, p_s), (cfg_a, p_a), (cfg_l, p_l)))
    np.testing.assert_allclose(es.bvec.numpy(), ea.bvec.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(es.gradb.numpy(), ea.gradb.numpy(), rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(es.ns.numpy(), ea.ns.numpy(), rtol=1e-4, atol=1e-6)
    # the closed form is that of models/solovev.py
    sv = tsolovev.magnetics_and_jac(p_a.eq.mag, pts)
    assert torch.equal(sv[0], ea.bvec)
    # the bilinear backend is the lower-order path, and converges
    err_lin = float((el.bvec - ea.bvec).abs().max())
    assert float((es.bvec - ea.bvec).abs().max()) < err_lin < 0.05


# --------------------------------------------------------------------------
# Q and rho
# --------------------------------------------------------------------------


def test_rho_maps_match_jax(eqdsk_file_q):
    (jcfg, jparams), (pcfg, pparams) = _both(
        _text("eqdsk_magnetics_spline_interp", eqdsk_file_q))
    assert pparams.eq.mag.rho_spline is not None
    own = tp.both_from_text(_text("eqdsk_magnetics_spline_interp", eqdsk_file_q))[1][1]
    assert tp.assert_leaves_close(own, jparams, LEAF_TOL) > 50
    psiN = np.linspace(0.0, 1.0, 41)
    t = torch.from_numpy(psiN)
    for tf, jf, name in ((tat.q_of_psiN, jat.q_of_psiN, "Q"),
                         (tat.rho_of_psiN, jat.rho_of_psiN, "rho"),
                         (tat.psiN_of_rho, jat.psiN_of_rho, "psiN(rho)")):
        ref = jax.vmap(lambda a: jf(jparams.eq, a))(jnp.asarray(psiN))
        for got, r, part in zip(tf(pparams.eq, t), ref, ("value", "slope")):
            np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-10 * np.abs(np.asarray(r)).max(),
                                       err_msg=f"{name} {part}")
    rho = tat.rho_of_psiN(pparams.eq, t)[0]
    assert float(rho[0]) == pytest.approx(0.0, abs=1e-12)
    assert float(rho[-1]) == pytest.approx(1.0, abs=1e-10)
    assert bool((rho[1:] > rho[:-1]).all())
    np.testing.assert_allclose(tat.psiN_of_rho(pparams.eq, rho)[0].numpy(), psiN, atol=5e-5)
    pts = _points()[:8]
    ref = jax.vmap(lambda r: jat.rho_and_grad(jcfg.eq_static, jparams.eq, r))(jnp.asarray(pts))
    for got, r, name in zip(tat.rho_and_grad(pcfg.eq_static, pparams.eq, torch.from_numpy(pts)),
                            ref, ("rho", "gradrho")):
        tp.assert_rows_close(got, r, 1e-10, name)
    assert tdep.profile_names_for_geometry("axisym_toroid", pcfg, pparams) == \
        jdep.profile_names_for_geometry("axisym_toroid", jcfg, jparams) == \
        ("Ptotal_psi", "Ptotal_rho")


@pytest.mark.parametrize("mag", ["eqdsk_magnetics_spline_interp", "eqdsk_magnetics_lin_interp",
                                 "solovev_magnetics"])
def test_rho_refused_without_q(eqdsk_file, mag):
    """A Solovev-made file has Q = 0, and the other backends define no rho:
    the maps refuse, and Ptotal_rho is not offered, as in the JAX package."""
    (jcfg, jparams), (pcfg, pparams) = tp.both_from_text(_text(mag, eqdsk_file))
    half = torch.tensor([0.5], dtype=torch.float64)
    x = torch.tensor([[1.4, 0.0, 0.1]], dtype=torch.float64)
    with pytest.raises(ValueError, match="rho coordinate maps unavailable"):
        tat.rho_of_psiN(pparams.eq, half)
    with pytest.raises(ValueError, match="rho coordinate maps unavailable"):
        tat.psiN_of_rho(pparams.eq, half)
    with pytest.raises(ValueError, match="only available for eqdsk"):
        tat.rho_and_grad(pcfg.eq_static, pparams.eq, x)
    with pytest.raises(ValueError):
        jat.rho_and_grad(jcfg.eq_static, jparams.eq, jnp.asarray([1.4, 0.0, 0.1]))
    names = tdep.profile_names_for_geometry("axisym_toroid", pcfg, pparams)
    assert names == jdep.profile_names_for_geometry("axisym_toroid", jcfg, jparams)
    assert names == ("Ptotal_psi",)


# --------------------------------------------------------------------------
# ray init and traces
# --------------------------------------------------------------------------

FAN = {"n_rindex_theta=2": "n_rindex_theta=3", "n_R_launch=1, R_launch0=1.5":
       "n_R_launch=3, R_launch0=1.4, dR_launch=0.1"}


# the analytic deck's Solovev init at the fan's launch points (R = 1.2 + r
# at theta = 0); it also launches the candidates at R = 1.6, in vacuum
ANALYTIC_FAN = {"n_r_launch=1, r_launch0=0.3, dr_launch=0.0":
                "n_r_launch=3, r_launch0=0.2, dr_launch=0.1",
                "n_theta_launch=4": "n_theta_launch=1", "n_rindex_theta=2": "n_rindex_theta=3"}
# the file backends' launch against the analytic field's, of each ray's
# scale: the spline's accuracy on the 65 x 65 file (1.2e-8 found), the
# bilinear backend's (its central differences; 2.7e-2 found, and
# test_spline_field_matches_closed_form_solovev holds its B within 0.05)
ANALYTIC_INIT_TOL = {"eqdsk_magnetics_spline_interp": 1e-6, "eqdsk_magnetics_lin_interp": 5e-2}


def _analytic_init():
    """(rvec0, rindex0) of the JAX package's analytic Solovev init
    (``rays_tpu.rayinit.solovev``) at the fan's points inside the plasma."""
    text = jex.SOLOVEV_ECH_90GHZ
    for old, new in ANALYTIC_FAN.items():
        assert old in text, old
        text = text.replace(old, new)
    (jcfg, jparams), _ = tp.both_from_text(text)
    assert jcfg.ray_init_model == "solovev_ray_init_nphi_ntheta"
    rvec, rindex, _ = (np.asarray(a) for a in jrun.init_rays(jcfg, jparams))
    inside = rvec[:, 0] < 1.55
    return rvec[inside], rindex[inside]


@pytest.mark.parametrize("mag", MAGS)
def test_ray_init_matches_jax(eqdsk_file, mag):
    """A 3 x 3 fan: the candidates at R = 1.6 lie outside the plasma and
    some others do not propagate; they are dropped, and count and order of
    the survivors are exact.  The file's psi falls outward (the converter's
    sign rule), and the port orients the launch along grad psiN, where the
    JAX package takes -grad(psi) as inward and launches outward (ROADMAP
    C13): on the file backends the launch is held to the JAX package's
    analytic Solovev init at the same points, within the backend's
    accuracy; on the analytic field, where psi rises, to the JAX package's
    R_Z init."""
    (jcfg, jparams), (pcfg, pparams) = _both(_text(mag, eqdsk_file, **FAN))
    pr, pn, pw = trun.init_rays(pcfg, pparams)
    assert 3 <= pr.shape[0] <= 6 and pr.dtype == torch.float64
    if mag == "solovev_magnetics":
        jr, jn, jw = jrun.init_rays(jcfg, jparams)
        assert pr.shape == jr.shape
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        tp.assert_rows_close(pn, jn, max(INIT_TOL, FIELD_TOL[mag] / 100), "rindex")
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=INIT_TOL)
    else:
        ar, an = _analytic_init()
        assert pr.shape == ar.shape
        np.testing.assert_allclose(pr.numpy(), ar, rtol=1e-15, atol=0)
        tp.assert_rows_close(pn, an, ANALYTIC_INIT_TOL[mag], "rindex")
        np.testing.assert_allclose(pw.numpy(), 1.0 / pr.shape[0], rtol=INIT_TOL)
    # launched in the y = 0 plane
    assert float(pr[:, 1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="nray_max"):
        trun.init_rays(dataclasses.replace(pcfg, nray_max=5), pparams)
    nowhere = dataclasses.replace(pcfg.rayinit_static, r_launch0=1.62, n_r_launch=1)
    with pytest.raises(RuntimeError, match="no successful ray"):
        trun.init_rays(dataclasses.replace(pcfg, rayinit_static=nowhere), pparams)


def _unoriented(monkeypatch):
    """Make the port's R_Z init take grad psi for grad psiN, which turns
    its orientation off: the init as it was before the orientation."""
    from rays_tpu_torch.rayinit import axisym_toroid as init_mod

    real = init_mod.at_mod.psi_and_grad

    def psi_and_grad(static, p, rvec):
        psi, gradpsi, psin, _ = real(static, p, rvec)
        return psi, gradpsi, psin, gradpsi

    monkeypatch.setattr(init_mod.at_mod, "psi_and_grad", psi_and_grad)


@pytest.mark.parametrize("mag", ["eqdsk_magnetics_spline_interp", "eqdsk_magnetics_lin_interp"])
def test_ray_init_psi_rising_file(eqdsk_file, tmp_path, monkeypatch, mag):
    """On the file with psi, PSIAXIS and PSIBOUND negated (psi rises
    outward, the poloidal field reversed) the orientation leaves the launch
    bit for bit as the init without it, which is the JAX package's R_Z init
    (held to it as on the analytic field); on the converter's file, where
    psi falls outward, the init without it is the JAX package's (outward)
    launch and the oriented one is not."""
    g = tio.read_geqdsk(eqdsk_file)
    rising = str(tmp_path / "rising.geqdsk")
    tio.write_geqdsk(rising, dataclasses.replace(g, psi=-g.psi, psiaxis=-g.psiaxis,
                                                  psibound=-g.psibound))
    for path, psi_rises in ((rising, True), (eqdsk_file, False)):
        (jcfg, jparams), (pcfg, pparams) = _both(_text(mag, path, **FAN))
        jr, jn, _ = jrun.init_rays(jcfg, jparams)
        pr, pn, _ = trun.init_rays(pcfg, pparams)
        with monkeypatch.context() as m:
            _unoriented(m)
            ur, un, _ = trun.init_rays(pcfg, pparams)
        np.testing.assert_array_equal(ur.numpy(), np.asarray(jr))
        tp.assert_rows_close(un, jn, max(INIT_TOL, FIELD_TOL[mag] / 100), "rindex")
        if psi_rises:
            assert torch.equal(pr, ur) and torch.equal(pn, un)
        else:   # the outward launch even propagates another set of candidates
            assert pn.shape != un.shape or not torch.equal(pn, un)


def _trace_both(text, **cfg_changes):
    (jcfg, jparams), (pcfg, pparams) = _both(text)
    jcfg = dataclasses.replace(jcfg, **cfg_changes)
    pcfg = dataclasses.replace(pcfg, **cfg_changes)
    v0, st, pwr = tp.jax_launch(jcfg, jparams)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(jcfg, p, v, s, w))(
        jparams, v0, st, pwr)
    # the JAX package's launch carried across: on a file whose psi falls
    # outward the port's own launch points the other way (ROADMAP C13)
    tv0, tst, tpw = (torch.from_numpy(np.array(a)) for a in (v0, st, pwr))
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
    # the residual is a determinant that cancels to ~0: it moves with the
    # trajectory's last digits
    np.testing.assert_allclose(got.max_residuals.numpy(), np.asarray(ref.max_residuals),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mag", ["eqdsk_magnetics_spline_interp", "eqdsk_magnetics_lin_interp"])
def test_rk4_trace_matches_jax(eqdsk_file, mag):
    """The 3 x 3 fan over 80 RK4 steps: the rays launched at R = 1.5 cross
    psiN = 1 on their way in or out and stop with OUT_OF_PLASMA."""
    (_, _, ref), (_, _, got) = _trace_both(_text(mag, eqdsk_file, **FAN), nstep_max=80)
    _assert_same_trace(ref, got, mag)
    assert got.npoints.min() > 5 and int(got.stop_flag.min()) < int(got.stop_flag.max())


def test_rk4_trace_matches_numpy_oracle(tmp_path):
    """The port's trace against the scalar NumPy transcription of the
    reference (tests/_oracle.py::EqdskToroidEq) on the 129 x 129 file of
    tests/test_parity.py, at that test's bar."""
    path = tp.write_solovev_geqdsk(tmp_path / "s129.geqdsk", n=129)
    (_, _, _), (cfg, params, res) = _trace_both(_text("eqdsk_magnetics_spline_interp", path))
    e, sp = params.eq, params.species
    p = {k: float(getattr(e, k)) for k in
         ("box_rmin", "box_rmax", "box_zmin", "box_zmax", "plasma_psi_limit", "alphan1",
          "alphan2", "d_scrape_off", "t_scrape_off")}
    p["alphat1"], p["alphat2"] = e.alphat1.numpy(), e.alphat2.numpy()
    models = dict(density_prof_model=cfg.eq_static.density_prof_model,
                  temperature_prof_model=cfg.eq_static.temperature_prof_model)
    n_phys = sp.n0s.numpy() * float(sp.n_ref)
    eq_fn = oracle.EqdskToroidEq(models, p, n_phys, sp.t0s.numpy(), tio.read_geqdsk(path))
    res = tree_map(lambda t: t.numpy(), res)
    _assert_parity(cfg, params, res, _oracle_cfg(cfg, params, eq_fn), rtol=1e-6)


def test_sg_ode_trace_matches_jax(eqdsk_file):
    """The adaptive stepper on the EQDSK toroid: the lockstep substep loop
    needs no change for the geometry, and rays that leave the plasma stop
    with OUT_OF_PLASMA at the point the JAX package stops them."""
    text = _text("eqdsk_magnetics_spline_interp", eqdsk_file, **FAN,
                 **{"ode_solver_name='RK4_ODE'": "ode_solver_name='SG_ODE'"})
    text += "\n&SG_ode_list\n rel_err0=1.e-7, abs_err0=1.e-7, SG_error_limit=0.1\n/\n"
    (_, _, ref), (_, _, got) = _trace_both(text, nstep_max=50)
    _assert_same_trace(ref, got, "SG_ODE")


# --------------------------------------------------------------------------
# deposition and the adjoint
# --------------------------------------------------------------------------

DAMPED = {"frf=90.e9": "frf=52.e9", "n0=8.0e19": "n0=2.0e19",
          "damping_model='no_damp'": "damping_model='damp_fund_ECH'",
          "temperature_prof_model=2*'zero'":
              "temperature_prof_model=2*'parabolic', alphat1=2*1.0, alphat2=2*2.0",
          **FAN}


@pytest.fixture(scope="module")
def damped_runs(eqdsk_file_q):
    """The fan with damp_fund_ECH at 52 GHz and 2e19 m^-3 on the file with
    a Q profile, 120 RK4 steps: the fundamental resonance lies on the way
    of the rays launched at R = 1.4, which lose 70-80% of their power before
    they leave the plasma."""
    return _trace_both(_text("eqdsk_magnetics_spline_interp", eqdsk_file_q, **DAMPED),
                       nstep_max=120)


@pytest.mark.parametrize("which", ["Ptotal_psi", "Ptotal_rho"])
def test_deposition_profiles_match_jax(damped_runs, which):
    (jcfg, jparams, ref), (pcfg, pparams, got) = damped_runs
    _assert_same_trace(ref, got, "damped")
    jprof = jdep.calculate_deposition_profile(jcfg, jparams, ref, which, n_bins=32)
    tprof = tdep.calculate_deposition_profile(pcfg, pparams, got, which, n_bins=32)
    jp = np.asarray(jprof.profile)
    assert tprof.name == which and jp.max() > 1e-3
    np.testing.assert_allclose(tprof.profile.numpy(), jp, rtol=PROFILE_RTOL,
                               atol=PROFILE_RTOL * np.abs(jp).max())
    np.testing.assert_allclose(tprof.grid.numpy(), np.asarray(jprof.grid), rtol=1e-15)


def test_deposition_files_hold_both_profiles(damped_runs, tmp_path):
    from scipy.io import netcdf_file

    (_, _, _), (pcfg, pparams, got) = damped_runs
    path = tdep.write_deposition_profiles_nc(pcfg, pparams, got, n_bins=16,
                                             path=str(tmp_path / "dep.nc"))
    f = netcdf_file(path, "r", mmap=False)
    try:
        names = [b"".join(row).decode().strip() for row in f.variables["profile_name"][:]]
        grids = [b"".join(row).decode().strip() for row in f.variables["grid_name"][:]]
        total = np.array(f.variables["Q_sum"][:])
    finally:
        f.close()
    assert names == ["Ptotal_psi", "Ptotal_rho"] and grids == ["psi", "rho"]
    assert total[0] == pytest.approx(total[1], rel=1e-6) and total[0] > 0.1


def test_ptotal_rho_refused_without_q(eqdsk_file, damped_runs):
    (_, _, _), (_, _, got) = damped_runs
    _, (pcfg, pparams) = tp.both_from_text(
        _text("eqdsk_magnetics_spline_interp", eqdsk_file, **DAMPED))
    with pytest.raises(ValueError, match="only available for eqdsk"):
        tdep.calculate_deposition_profile(pcfg, pparams, got, "Ptotal_rho")
    with pytest.raises(ValueError, match="not available"):
        tdep.calculate_deposition_profile(pcfg, pparams, got, "Ptotal_AphiN")


def test_adjoint_through_psi_cells_matches_jax_grad(eqdsk_file):
    """The loss of the JAX package's EQDSK bench row, sum(w * |x_end|^2),
    on 2 rays x 40 RK4 steps: gradients with respect to every leaf of the
    equilibrium parameters (the psi cell table and the profile parameters
    among them) against ``jax.grad``."""
    (jcfg, jparams), (pcfg, pparams) = _both(
        _text("eqdsk_magnetics_spline_interp", eqdsk_file))
    jcfg = dataclasses.replace(jcfg, nstep_max=40, save_trajectory=False)
    pcfg = dataclasses.replace(pcfg, nstep_max=40, save_trajectory=False)
    v0, st, pwr = tp.jax_launch(jcfg, jparams)
    assert v0.shape[0] == 2

    def jloss(eq):
        res = jtrace.trace_batch(jcfg, jparams._replace(eq=eq), v0, st, pwr)
        return jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None])

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jparams.eq)

    eq = tree_map(lambda t: t.clone().requires_grad_(True), pparams.eq)
    tv0, tst, tpw = (torch.from_numpy(np.array(a)) for a in (v0, st, pwr))
    res = ttrace.trace_rays(pcfg, pparams._replace(eq=eq), tv0, tst, tpw)
    loss = (res.end_ray_vec[:, 0:3] ** 2 * tpw[:, None]).sum()
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-10)
    leaves = tree_leaves(eq)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(jgrad)
    assert len(jleaves) == len(leaves)
    moved = 0
    for g, jg, leaf in zip(grads, jleaves, leaves):
        jg = np.asarray(jg)
        g = np.zeros(jg.shape) if g is None else g.numpy()
        scale = np.abs(jg).max()
        np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_TOL * max(scale, 1e-30))
        moved += scale > 0
    def grad_of(leaf):
        return next(g for g, t in zip(grads, leaves) if t is leaf)

    assert float(grad_of(eq.mag.psi_cells.cells).abs().max()) > 0 and moved >= 4
    assert float(grad_of(eq.alphan1).abs()) > 0
