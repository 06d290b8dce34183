"""rays_tpu_torch's numerical helpers of post-processing against the JAX
package: bisection, monotonic inversion, trapezoid quadrature, 3-vectors,
the cold dielectric tensor, the named-curve netCDF files and the carrying
of a RayResults across.  The same numpy inputs, made from a seed, go
through both packages.

Tolerances: bisection 1e-15 of the bracket (60 halvings of a bracket of
order 1; the two packages may round f(m) differently at the root, which
moves the answer by an ulp); inversion, quadrature, vectors and the
dielectric tensor 1e-14 of the reference's scale (the same arithmetic,
possibly summed in another order); files and carried results equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.ops import bisect as jbisect
from rays_tpu.ops import invert as jinvert
from rays_tpu.ops import quadrature as jquad
from rays_tpu.ops import vectors as jvec
from rays_tpu.post import xy_curves as jxy
from rays_tpu.tracing import trace as jtrace
from rays_tpu.wave import stix as jstix
from rays_tpu_torch import convert
from rays_tpu_torch.ops import bisect as tbisect
from rays_tpu_torch.ops import invert as tinvert
from rays_tpu_torch.ops import quadrature as tquad
from rays_tpu_torch.ops import vectors as tvec
from rays_tpu_torch.post import xy_curves as txy
from rays_tpu_torch.tracing.trace import RayResults
from rays_tpu_torch.wave import stix as tstix

TOL = 1e-14


def test_bisect_invert_quadrature_cases_of_the_jax_tests():
    """The cases of tests/test_numerics.py:86-98, on the port."""
    root, ok = tbisect.solve_bisection(lambda x: x**3 - 2.0, 0.0, 0.0, 2.0)
    assert bool(ok)
    np.testing.assert_allclose(float(root), 2.0 ** (1 / 3), rtol=1e-12)

    x = torch.linspace(0, 1, 101, dtype=torch.float64)
    y_out, x_of_y = tinvert.invert_monotonic(x, x**2)
    np.testing.assert_allclose(x_of_y.numpy(), np.sqrt(y_out.numpy()), atol=2e-4)

    ct = tquad.cumulative_trapezoid(3 * x**2, x)
    np.testing.assert_allclose(float(ct[-1]), 1.0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bisection_batches_match_jax(seed):
    """A batch of brackets at once against the JAX bisector vmapped over
    them: cubics with a root inside, and brackets with none (ok False)."""
    rng = np.random.default_rng(seed)
    n = 24
    c = rng.uniform(-2.0, 2.0, n)
    lo = rng.uniform(-3.0, -1.0, n)
    hi = rng.uniform(1.0, 3.0, n)
    lo[:4] = 2.5   # no root of x^3 + x - c in [2.5, hi] for |c| < 2
    hi[:4] = 3.5
    y = rng.uniform(-0.5, 0.5, n)

    def jf(cc):
        return lambda x: x**3 + x - cc

    jx, jok = jax.jit(jax.vmap(lambda cc, yy, a, b: jbisect.solve_bisection(jf(cc), yy, a, b)))(
        jnp.asarray(c), jnp.asarray(y), jnp.asarray(lo), jnp.asarray(hi))
    ct = torch.as_tensor(c)
    tx, tok = tbisect.solve_bisection(lambda x: x**3 + x - ct, torch.as_tensor(y),
                                      torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tok[:4].any() and tok[4:].all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-15 * 4)


@pytest.mark.parametrize("decreasing", [False, True], ids=["increasing", "decreasing"])
def test_invert_monotonic_matches_jax(decreasing):
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0.0, 2.0, 40))
    y = np.cumsum(rng.uniform(0.01, 0.2, 40))
    if decreasing:
        y = -y
    jy, jx = jinvert.invert_monotonic(jnp.asarray(x), jnp.asarray(y), n_out=57)
    ty, tx = tinvert.invert_monotonic(torch.as_tensor(x), torch.as_tensor(y), n_out=57)
    tp.assert_arrays_close(ty.numpy(), np.asarray(jy), TOL, "y_out")
    tp.assert_arrays_close(tx.numpy(), np.asarray(jx), TOL, "x(y)")
    # queries outside the samples take the end values, as jnp.interp does
    q = np.concatenate([[y.min() - 1.0, y.max() + 1.0], rng.uniform(y.min(), y.max(), 9)])
    _, jq = jinvert.invert_monotonic(jnp.asarray(x), jnp.asarray(y), y_out=jnp.asarray(q))
    _, tq = tinvert.invert_monotonic(torch.as_tensor(x), torch.as_tensor(y),
                                     y_out=torch.as_tensor(q))
    tp.assert_arrays_close(tq.numpy(), np.asarray(jq), TOL, "x(y) at queries")


def test_quadrature_matches_jax():
    """Held to 1e-14 of the integral of |y|: the sums cancel."""
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(-1.0, 3.0, 65))
    y = np.sin(3 * x) + rng.normal(0.0, 0.1, 65)
    atol = TOL * np.abs(y).max() * (x[-1] - x[0])
    np.testing.assert_allclose(tquad.trapezoid(torch.as_tensor(y), torch.as_tensor(x)).numpy(),
                               np.asarray(jquad.trapezoid(jnp.asarray(y), jnp.asarray(x))),
                               rtol=0, atol=atol)
    for initial in (0.0, 2.5):
        got = tquad.cumulative_trapezoid(torch.as_tensor(y), torch.as_tensor(x), initial)
        ref = np.asarray(jquad.cumulative_trapezoid(jnp.asarray(y), jnp.asarray(x), initial))
        assert got.shape == ref.shape and float(got[0]) == initial
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol + TOL * initial)


def test_vectors_match_jax():
    rng = np.random.default_rng(13)
    a, b, c = (rng.normal(size=(16, 3)) for _ in range(3))
    a[0] = 0.0   # unit() of the zero vector stays finite
    ta, tb, tc = (torch.as_tensor(v) for v in (a, b, c))
    for name, got, ref in (
            ("cross", tvec.cross(ta, tb), jax.vmap(jvec.cross)(a, b)),
            ("triple", tvec.triple_product(ta, tb, tc), jax.vmap(jvec.triple_product)(a, b, c)),
            ("unit", tvec.unit(ta), jax.vmap(jvec.unit)(a))):
        tp.assert_arrays_close(got.numpy(), np.asarray(ref), TOL, name)
    assert np.all(tvec.unit(ta)[0].numpy() == 0.0)


@pytest.mark.parametrize("n_species", [1, 2, 4])
def test_cold_eps_hermitian_matches_jax(n_species):
    """The complex (B, 3, 3) tensor of random plasmas, resonances included
    (gamma = +-1 gives poles in S and D, as in the JAX function)."""
    rng = np.random.default_rng(n_species)
    alpha = rng.uniform(0.0, 3.0, (12, n_species))
    gamma = rng.uniform(-2.0, 2.0, (12, n_species))
    gamma[0, 0] = 0.5
    ref = np.asarray(jax.vmap(jstix.cold_eps_hermitian)(jnp.asarray(alpha), jnp.asarray(gamma)))
    got = tstix.cold_eps_hermitian(torch.as_tensor(alpha), torch.as_tensor(gamma))
    assert got.dtype == torch.complex128 and got.shape == (12, 3, 3)
    tp.assert_arrays_close(got.numpy().real, ref.real, TOL, "Re eps")
    tp.assert_arrays_close(got.numpy().imag, ref.imag, TOL, "Im eps")
    # Hermitian: eps = eps^H
    g = got.numpy()
    np.testing.assert_array_equal(g, np.conj(np.swapaxes(g, 1, 2)))


def test_xy_curves_files_read_both_ways(tmp_path):
    """A file of named curves of unequal lengths written by either package
    is the same file, and each package reads the other's."""
    rng = np.random.default_rng(17)
    spec = [("x", "ne", 11), ("psiN", "gamma_e_long_name", 31), ("R", "T", 2)]
    made = {}
    for mod, tag in ((jxy, "jax"), (txy, "port")):
        curves = [mod.XYCurve(g, c, np.linspace(0, 1, n), rng.normal(size=n) if tag == "jax"
                              else made["jax"][i].curve)
                  for i, (g, c, n) in enumerate(spec)]
        made[tag] = curves
        mod.write_xy_curves_nc(curves, str(tmp_path / tag))
    tp.assert_nc_files_match(str(tmp_path / "port.nc"), str(tmp_path / "jax.nc"), 0.0)
    for reader, path in ((txy.read_xy_curves_nc, "jax.nc"), (jxy.read_xy_curves_nc, "port.nc")):
        back = reader(str(tmp_path / path))
        assert [(c.grid_name, c.curve_name) for c in back] == [(g, c) for g, c, _ in spec]
        for c, ref in zip(back, made["jax"]):
            np.testing.assert_array_equal(c.curve, ref.curve)
            np.testing.assert_array_equal(c.grid, ref.grid)


def test_results_from_numpy_carries_every_field():
    cfg, params, v0, st, pwr = jex.setup_example(jex.SLAB_ECH_DAMPED)
    cfg = dataclasses.replace(cfg, nstep_max=12)
    ref = jax.jit(lambda p, v, s, w: jtrace.trace_batch(cfg, p, v, s, w))(params, v0, st, pwr)
    got = tp.carry_results(ref)
    assert isinstance(got, RayResults) and ref.end_ray_comp is None
    # the compensated carry has its field in the port too (None: mode off)
    assert got._fields == ref._fields and got.end_ray_comp is None
    for name, g in zip(got._fields[:-1], got[:-1]):
        r = np.asarray(getattr(ref, name))
        assert g.device.type == "cpu"
        assert g.dtype == (torch.int32 if name in ("npoints", "stop_flag") else torch.float64)
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    got32 = convert.results_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                       dtype=torch.float32)
    assert got32.ray_vec.dtype == torch.float32 and got32.npoints.dtype == torch.int32
    with pytest.raises(ValueError, match="RayResults"):
        convert.results_from_numpy(tuple(ref))
    comp = np.arange(3 * 8, dtype=np.float64).reshape(3, 8)
    carried = convert.results_from_numpy(ref._replace(end_ray_comp=comp))
    np.testing.assert_array_equal(carried.end_ray_comp.numpy(), comp)
