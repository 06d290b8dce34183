"""rays_tpu_torch binning and deposition profiles against the JAX package:
``ops/binning.bin_to_uniform_grid`` batched over rays against the JAX
function vmapped, ``post/deposition.calculate_deposition_profile`` on the
damped trace, and the netCDF and list-directed writers.

Tolerances: binning rtol 1e-12 with a floor of 1e-14 of scale (the same
overlaps summed in the same order); the profile of the damped trace
rtol 1e-10 of its largest bin (the traces themselves agree to rounding,
tests/test_torch_damping.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.ops import binning as jbin
from rays_tpu.post import deposition as jdep
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch.ops import binning as tbin
from rays_tpu_torch.post import deposition as tdep
from rays_tpu_torch.tracing import trace as ttrace

BIN_RTOL, ATOL_OF_SCALE = 1e-12, 1e-14
PROFILE_RTOL = 1e-10
N_BINS = 32


def _segments(B=6, n=40, seed=11):
    """Cumulative Q and coordinates along B random paths over [-0.6, 0.6]
    (partly outside [-0.5, 0.5]), with repeated points (zero-extent
    segments), a reversing path and a path wholly out of range."""
    rng = np.random.default_rng(seed)
    Q = np.cumsum(rng.uniform(0.0, 1.0, (B, n)), axis=1)
    xQ = np.cumsum(rng.normal(0.0, 0.05, (B, n)), axis=1) + rng.uniform(-0.5, 0.5, (B, 1))
    xQ = np.clip(xQ, -0.6, 0.6)
    xQ[0, 5:9] = xQ[0, 4]            # zero extent inside the range
    xQ[1] = np.concatenate([np.linspace(-0.55, 0.3, n // 2),
                            np.linspace(0.3, -0.2, n - n // 2)])
    xQ[2] = 0.8                      # out of range, zero extent
    xQ[3, 10:] = xQ[3, 9]            # the tail of a stopped ray
    Q[3, 10:] = Q[3, 9]
    return Q, xQ


@pytest.mark.parametrize("n_bins", [1, 7, N_BINS])
def test_bin_to_uniform_grid_matches_jax(n_bins):
    Q, xQ = _segments()
    ref = jax.vmap(lambda q, x: jbin.bin_to_uniform_grid(q, x, -0.5, 0.5, n_bins))(
        jnp.asarray(Q), jnp.asarray(xQ))
    got = tbin.bin_to_uniform_grid(torch.from_numpy(Q), torch.from_numpy(xQ), -0.5, 0.5, n_bins)
    assert got.shape == (Q.shape[0], n_bins)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=BIN_RTOL,
                               atol=ATOL_OF_SCALE * np.abs(ref).max())
    # what falls inside the range is conserved; the out-of-range path adds nothing
    assert got[2].abs().max() == 0.0
    inside = (np.abs(xQ[:, 1:]) <= 0.5) & (np.abs(xQ[:, :-1]) <= 0.5)
    full = inside.all(axis=1)
    np.testing.assert_allclose(got.sum(1).numpy()[full], (Q[:, -1] - Q[:, 0])[full], rtol=1e-12)


def test_binning_gradients_match_jax():
    """d/dQ and d/dxQ of a weighted sum of the bins, as jax.grad gives."""
    Q, xQ = _segments(B=4, n=25, seed=5)
    w = np.linspace(1.0, 2.0, N_BINS)

    def jloss(q, x):
        return jnp.sum(jax.vmap(lambda a, b: jbin.bin_to_uniform_grid(
            a, b, -0.5, 0.5, N_BINS))(q, x) ** 2 * w)

    gq_ref, gx_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(Q), jnp.asarray(xQ))
    tq = torch.from_numpy(Q).requires_grad_(True)
    tx = torch.from_numpy(xQ).requires_grad_(True)
    loss = (tbin.bin_to_uniform_grid(tq, tx, -0.5, 0.5, N_BINS) ** 2
            * torch.from_numpy(w)).sum()
    gq, gx = torch.autograd.grad(loss, (tq, tx))
    for g, r in ((gq, gq_ref), (gx, gx_ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=ATOL_OF_SCALE * np.abs(r).max())


@pytest.fixture(scope="module")
def damped_runs():
    """The damped example traced by both packages (trajectories on)."""
    cfg, params, v0, st, pwr = tp.jax_case(jex.SLAB_ECH_DAMPED)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    return (cfg, params, ref), (pcfg, pp, ttrace.trace_batch(pcfg, pp, tv0, tst, tpw))


@pytest.fixture(scope="module")
def solovev_damped_runs():
    """The Solovev fan with damp_fund_ECH, traced by both packages with
    fixed-step RK4 over 120 steps (trajectories on), at 56 GHz and 2e19
    m^-3 so that the fundamental resonance lies on the rays' way: four of
    the eight rays are absorbed."""
    text = (jex.SOLOVEV_ECH_90GHZ.replace("frf=90.e9", "frf=56.e9")
            .replace("n0=8.0e19", "n0=2.0e19")
            .replace("damping_model='no_damp'", "damping_model='damp_fund_ECH'"))
    cfg, params, v0, st, pwr = tp.jax_case(text, ode_solver_name="RK4_ODE", nstep_max=120)
    assert v0.shape == (8, 8)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    return (cfg, params, ref), (pcfg, pp, ttrace.trace_batch(pcfg, pp, tv0, tst, tpw))


@pytest.mark.parametrize("chunk_elements", [None, 4000], ids=["one_chunk", "chunked"])
def test_deposition_profile_matches_jax(damped_runs, monkeypatch, chunk_elements):
    (cfg, params, ref), (pcfg, pp, got) = damped_runs
    if chunk_elements is not None:
        monkeypatch.setattr(tdep, "CHUNK_ELEMENTS", chunk_elements)
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)
    jprof = jdep.calculate_deposition_profile(cfg, params, ref, "Ptotal_x", n_bins=N_BINS,
                                              xmin=xmin, xmax=xmax)
    tprof = tdep.calculate_deposition_profile(pcfg, pp, got, "Ptotal_x", n_bins=N_BINS,
                                              xmin=xmin, xmax=xmax)
    assert tprof.name == "Ptotal_x" and tprof.profile.shape == (N_BINS,)
    jp = np.asarray(jprof.profile)
    np.testing.assert_allclose(tprof.profile.numpy(), jp, rtol=PROFILE_RTOL,
                               atol=PROFILE_RTOL * np.abs(jp).max())
    np.testing.assert_allclose(tprof.grid.numpy(), np.asarray(jprof.grid), rtol=1e-15)
    # nearly all launched power is deposited (every ray stops by absorption)
    assert float(tprof.profile.sum()) > 0.98 * float(got.initial_ray_power.sum())


@pytest.mark.parametrize("which,geometry,item", [
    ("Ptotal_psi", "solovev", "A12"), ("Ptotal_psi", "axisym_toroid", "A13"),
    ("Ptotal_rho", "axisym_toroid", "A13"), ("Ptotal_AphiN", "multiple_mirror", "A13")])
def test_deposition_profile_refusals(damped_runs, solovev_damped_runs, which, geometry, item,
                                     tmp_path):
    """Every geometry's coordinates are ported: the Solovev Ptotal_psi
    (ROADMAP A12) is held to JAX on the damped fan, and the coordinates of
    the spline geometries (ROADMAP A13, which used to be refused here)
    evaluate on their geometry and equal the geometry's own flux function
    (tests/test_torch_axisym.py and test_torch_mirror.py hold the binned
    profiles to JAX).  A coordinate the geometry lacks is an error, as in
    JAX."""
    (_, _, _), (pcfg, pp, got) = damped_runs
    if geometry == "solovev":
        (scfg, sparams, sref), (spcfg, spp, sgot) = solovev_damped_runs
        jprof = jdep.calculate_deposition_profile(scfg, sparams, sref, which, n_bins=N_BINS)
        tprof = tdep.calculate_deposition_profile(spcfg, spp, sgot, which, n_bins=N_BINS)
        jp = np.asarray(jprof.profile)
        assert tprof.name == which and jp.max() > 1e-3
        np.testing.assert_allclose(tprof.profile.numpy(), jp, rtol=PROFILE_RTOL,
                                   atol=PROFILE_RTOL * np.abs(jp).max())
        np.testing.assert_allclose(tprof.grid.numpy(), np.asarray(jprof.grid), rtol=1e-15)
    else:
        gcfg, gparams, coord_ref = _spline_geometry(geometry, which, tmp_path)
        pts = torch.tensor([[[1.45, 0.0, 0.1], [1.3, 0.2, -0.1]],
                            [[1.2, -0.3, 0.2], [1.5, 0.1, 0.0]]], dtype=torch.float64)
        if geometry == "multiple_mirror":
            pts = torch.tensor([[[0.05, 0.0, 1.0], [0.03, 0.04, 2.5]],
                                [[0.0, -0.08, 2.0], [0.02, 0.01, 3.4]]], dtype=torch.float64)
        coord = tdep._coordinate_fn(gcfg, gparams, which)(pts)
        assert coord.shape == (2, 2) and bool(torch.isfinite(coord).all())
        assert torch.equal(coord, coord_ref(pts.reshape(-1, 3)).reshape(2, 2))
        assert float(coord.min()) > 0.0 and float(coord.max()) < 1.2
    with pytest.raises(ValueError, match="not available"):
        tdep.calculate_deposition_profile(pcfg, pp, got, which)
    with pytest.raises(ValueError, match="damping model"):
        tdep.calculate_deposition_profile(dataclasses.replace(pcfg, damping_model="no_damp"),
                                          pp, got, "Ptotal_x")
    with pytest.raises(ValueError, match="unknown deposition profile"):
        tdep.calculate_deposition_profile(pcfg, pp, got, "Ptotal_q")
    for geom in ("slab", geometry, "other"):
        assert tdep.profile_names_for_geometry(geom) == jdep.profile_names_for_geometry(geom)


def _spline_geometry(geometry, which, tmp_path):
    """(cfg, params, the geometry's own coordinate function) of a small
    toroid (a 33 x 33 G-EQDSK with a Q profile) or mirror (a 21 x 81 field
    file), set up by the port's importer."""
    from rays_tpu_torch.config import schema as tschema
    from rays_tpu_torch.models import axisym_toroid as tat
    from rays_tpu_torch.models import multiple_mirror as tmir
    from test_axisym import AXISYM_TMPL

    if geometry == "axisym_toroid":
        path = tp.write_solovev_geqdsk(tmp_path / "q.geqdsk", n=33, with_q=True)
        from rays_tpu_torch.config.namelist import parse_namelist
        cfg, params = tschema.from_namelist(parse_namelist(
            AXISYM_TMPL.format(MAG="eqdsk_magnetics_spline_interp", EQDSK=path)))
        if which == "Ptotal_rho":
            return cfg, params, lambda r: tat.rho_and_grad(cfg.eq_static, params.eq, r)[0]
        return cfg, params, lambda r: tat.psi_and_grad(cfg.eq_static, params.eq, r)[2]
    cfg, params = tschema.from_file(tp.write_mirror_inputs(tmp_path))
    return cfg, params, lambda r: tmir.aphi_and_grad(cfg.eq_static, params.eq, r)[2]


def _read_nc(path):
    f = netcdf_file(str(path), "r", mmap=False)
    try:
        return ({k: np.array(v[:]) for k, v in f.variables.items()},
                dict(f.dimensions), f.RAYS_run_label)
    finally:
        f.close()


def test_write_deposition_profiles_nc_matches_jax(damped_runs, tmp_path):
    (cfg, params, ref), (pcfg, pp, got) = damped_runs
    jpath = jdep.write_deposition_profiles_nc(cfg, params, ref, n_bins=20,
                                              path=str(tmp_path / "jax.nc"))
    tpath = tdep.write_deposition_profiles_nc(pcfg, pp, got, n_bins=20,
                                              path=str(tmp_path / "port.nc"))
    (jv, jdims, jlabel), (tv, tdims, tlabel) = _read_nc(jpath), _read_nc(tpath)
    assert sorted(tv) == sorted(jv) and tdims == jdims and tlabel == jlabel
    for k in jv:
        assert tv[k].shape == jv[k].shape and tv[k].dtype == jv[k].dtype, k
        if jv[k].dtype.kind == "S":
            np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
        else:
            np.testing.assert_allclose(tv[k], jv[k], rtol=PROFILE_RTOL,
                                       atol=PROFILE_RTOL * np.abs(jv[k]).max(), err_msg=k)


def test_write_deposition_profiles_ld_matches_jax(damped_runs, tmp_path):
    (cfg, params, ref), (pcfg, pp, got) = damped_runs
    jpath = jdep.write_deposition_profiles_ld(cfg, params, ref, n_bins=20,
                                              path=str(tmp_path / "jax_ld"))
    tpath = tdep.write_deposition_profiles_ld(pcfg, pp, got, n_bins=20,
                                              path=str(tmp_path / "port_ld"))
    jl = [ln.split() for ln in open(jpath)]
    tl = [ln.split() for ln in open(tpath)]
    assert len(tl) == len(jl) == 6
    for i in (0, 2, 4):
        assert tl[i] == jl[i]
    for i in (1, 3, 5):
        j = np.asarray(jl[i], float)
        np.testing.assert_allclose(np.asarray(tl[i], float), j, rtol=PROFILE_RTOL,
                                   atol=PROFILE_RTOL * np.abs(j).max())
