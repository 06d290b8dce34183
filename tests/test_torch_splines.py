"""rays_tpu_torch.ops.splines against the JAX package: the not-a-knot
second-derivative matrix, every build function and every evaluator on the
same seeded knots and points, inside and outside the grid.

Tolerances: build functions 1e-12 of the table's scale (the same T applied
by a different matrix product); evaluators rtol 1e-12 with a floor of 1e-12 of
the result's scale (the same polynomial summed in another order);
gradients with respect to knot values 1e-10 of scale against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.ops import splines as jsp
from rays_tpu_torch.ops import splines as tsp

BUILD_TOL = 1e-12
EVAL_RTOL = 1e-12
GRAD_TOL = 1e-10
X0, DX, Y0, DY, NX, NY = -0.3, 0.07, 1.1, 0.045, 17, 23


def _close(got, ref, tol=EVAL_RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _knots_1d(seed=3, n=NX):
    rng = np.random.default_rng(seed)
    return np.cos(np.linspace(0.0, 3.0, n)) + 0.1 * rng.standard_normal(n)


def _knots_2d(seed=4):
    rng = np.random.default_rng(seed)
    x = X0 + DX * np.arange(NX)
    y = Y0 + DY * np.arange(NY)
    return (np.sin(2.0 * x)[:, None] * np.cos(1.5 * y)[None, :]
            + 0.05 * rng.standard_normal((NX, NY)))


def _points(seed=5, n=64):
    """Points inside the grid, on knots and up to a cell outside it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(X0 - DX, X0 + DX * NX, n)
    y = rng.uniform(Y0 - DY, Y0 + DY * NY, n)
    x[:4] = X0 + DX * np.array([0, 1, NX - 2, NX - 1])
    y[:4] = Y0 + DY * np.array([0, NY - 1, 3, NY - 2])
    return x, y


def _both_2d(seed=4):
    f = _knots_2d(seed)
    return (jsp.build_spline_2d(X0, DX, Y0, DY, f),
            tsp.build_spline_2d(X0, DX, Y0, DY, f))


@pytest.mark.parametrize("n", [4, 5, 17, 129])
def test_second_deriv_matrix_matches_jax(n):
    np.testing.assert_array_equal(tsp._second_deriv_matrix(n, 0.07),
                                  jsp._second_deriv_matrix(n, 0.07))
    with pytest.raises(ValueError, match="at least 4"):
        tsp._second_deriv_matrix(3, 0.1)


def test_build_spline_1d_matches_jax():
    f = _knots_1d()
    j, t = jsp.build_spline_1d(X0, DX, f), tsp.build_spline_1d(X0, DX, f)
    assert t._fields == j._fields and t.m.dtype == torch.float64
    for name in t._fields:
        _close(getattr(t, name), getattr(j, name), BUILD_TOL, name)


def test_build_spline_2d_matches_jax():
    j, t = _both_2d()
    assert t._fields == j._fields
    for name in t._fields:
        _close(getattr(t, name), getattr(j, name), BUILD_TOL, name)


@pytest.mark.parametrize("with_x_spline", [False, True], ids=["2d_only", "x_splines"])
def test_build_cell_spline_2d_matches_jax(with_x_spline):
    j1, t1 = _both_2d(4)
    j2, t2 = _both_2d(8)
    jx = [jsp.build_spline_1d(X0, DX, _knots_1d())] if with_x_spline else []
    tx = [tsp.build_spline_1d(X0, DX, _knots_1d())] if with_x_spline else []
    jc = jsp.build_cell_spline_2d([j1, j2], x_splines=jx)
    tc = tsp.build_cell_spline_2d([t1, t2], x_splines=tx)
    assert tuple(tc.cells.shape) == (NX - 1, NY - 1, 2 + with_x_spline, 4, 4)
    assert tc.cells.is_contiguous()
    for name in tc._fields:
        _close(getattr(tc, name), getattr(jc, name), BUILD_TOL, name)


def test_eval_1d_matches_jax():
    f = _knots_1d()
    j, t = jsp.build_spline_1d(X0, DX, f), tsp.build_spline_1d(X0, DX, f)
    x, _ = _points()
    _close(tsp.eval_1d(t, torch.from_numpy(x)), jax.vmap(lambda a: jsp.eval_1d(j, a))(x))
    jf, jfp = jax.vmap(lambda a: jsp.eval_1d_fp(j, a))(x)
    tf, tfp = tsp.eval_1d_fp(t, torch.from_numpy(x))
    _close(tf, jf, what="f")
    _close(tfp, jfp, what="fp")
    # the knot values are interpolated, outside points use the edge cubic
    np.testing.assert_allclose(
        tsp.eval_1d(t, torch.from_numpy(X0 + DX * np.arange(NX))).numpy(), f, rtol=1e-13)
    # any shape of points, scalars included
    assert tsp.eval_1d(t, torch.from_numpy(x).reshape(8, 8)).shape == (8, 8)
    assert tsp.eval_1d(t, torch.tensor(0.1, dtype=torch.float64)).shape == ()


def test_eval_2d_matches_jax():
    j, t = _both_2d()
    x, y = _points()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _close(tsp.eval_2d(t, tx, ty), jax.vmap(lambda a, b: jsp.eval_2d(j, a, b))(x, y))
    ref = jax.vmap(lambda a, b: jsp.eval_2d_fp(j, a, b))(x, y)
    for g, r, name in zip(tsp.eval_2d_fp(t, tx, ty), ref, ("f", "fx", "fy")):
        _close(g, r, what=name)


def test_eval_2d_second_matches_autodiff_of_jax():
    """The knot-table second derivatives (the path of a run without a cell
    table) against forward-over-forward autodiff of the JAX ``eval_2d``."""
    j, t = _both_2d()
    x, y = _points()

    def second(a, b):
        f = lambda p: jsp.eval_2d(j, p[0], p[1])
        h = jax.hessian(f)(jnp.stack([a, b]))
        return h[0, 0], h[0, 1], h[1, 1]

    ref = jax.vmap(second)(x, y)
    got = tsp.eval_2d_second(t, torch.from_numpy(x), torch.from_numpy(y))[3:]
    for g, r, name in zip(got, ref, ("fxx", "fxy", "fyy")):
        _close(g, r, 1e-10, name)


@pytest.mark.parametrize("with_x_spline", [False, True], ids=["2d_only", "x_splines"])
def test_eval_cell_2d_matches_jax(with_x_spline):
    j1, t1 = _both_2d(4)
    j2, t2 = _both_2d(8)
    jx = [jsp.build_spline_1d(X0, DX, _knots_1d())] if with_x_spline else []
    tx = [tsp.build_spline_1d(X0, DX, _knots_1d())] if with_x_spline else []
    jc = jsp.build_cell_spline_2d([j1, j2], x_splines=jx)
    tc = tsp.build_cell_spline_2d([t1, t2], x_splines=tx)
    x, y = _points()
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    ref = jax.vmap(lambda a, b: jsp.eval_cell_2d(jc, a, b))(x, y)
    got = tsp.eval_cell_2d(tc, px, py)
    for g, r, name in zip(got, ref, ("f", "fx", "fy")):
        _close(g, r, what=name)
    ref2 = jax.vmap(lambda a, b: jsp.eval_cell_2d_second(jc, a, b))(x, y)
    got2 = tsp.eval_cell_2d_second(tc, px, py)
    for g, r, name in zip(got2, ref2, ("f", "fx", "fy", "fxx", "fxy", "fyy")):
        _close(g, r, what=name)
    # the cell form against the knot-table form of the same spline
    for k, sp in enumerate((t1, t2)):
        for g, r in zip(got, tsp.eval_2d_fp(sp, px, py)):
            _close(g[:, k], r.numpy(), 1e-11)
    if with_x_spline:
        f1, fp1 = tsp.eval_1d_fp(tx[0], px)
        _close(got[0][:, 2], f1.numpy(), 1e-11, "x-spline value")
        _close(got[1][:, 2], fp1.numpy(), 1e-11, "x-spline slope")
        assert float(got[2][:, 2].abs().max()) == 0.0
    # leading shape is kept
    assert tsp.eval_cell_2d(tc, px.reshape(4, 16), py.reshape(4, 16))[0].shape == \
        (4, 16, 2 + with_x_spline)


def test_eval_cell_2d_matches_torch_autograd_of_eval_2d():
    """First and second derivatives of the cell form against
    ``torch.autograd`` through ``eval_2d`` (the polynomial is smooth inside
    a cell, so autograd is exact)."""
    _, t = _both_2d()
    tc = tsp.build_cell_spline_2d([t])
    x, y = _points()
    px = torch.from_numpy(x).requires_grad_(True)
    py = torch.from_numpy(y).requires_grad_(True)
    f = tsp.eval_2d(t, px, py)
    fx, fy = torch.autograd.grad(f.sum(), (px, py), create_graph=True)
    fxx, fxy = torch.autograd.grad(fx.sum(), (px, py), retain_graph=True)
    fyy, = torch.autograd.grad(fy.sum(), (py,))
    got = tsp.eval_cell_2d_second(tc, px.detach(), py.detach())
    for g, r, name in zip(got, (f, fx, fy, fxx, fxy, fyy),
                          ("f", "fx", "fy", "fxx", "fxy", "fyy")):
        _close(g[:, 0], r.detach().numpy(), 1e-10, name)


def test_float32_agrees_with_float64_to_rounding():
    """In float32 a point may fall in the neighbouring cell; the spline is
    C2, so the values agree to float32 rounding all the same."""
    _, t = _both_2d()
    tc = tsp.build_cell_spline_2d([t])
    tc32 = tsp.CellSpline2D(*(a.to(torch.float32) for a in tc))
    x, y = _points()
    f64 = tsp.eval_cell_2d(tc, torch.from_numpy(x), torch.from_numpy(y))[0]
    f32 = tsp.eval_cell_2d(tc32, torch.from_numpy(x).float(), torch.from_numpy(y).float())[0]
    assert f32.dtype == torch.float32
    assert float((f32.double() - f64).abs().max()) < 2e-5 * float(f64.abs().max())


def test_knot_value_gradients_match_jax():
    """d(loss)/d(knot values) through build and evaluation, 1-D and 2-D
    (cell form with an x-spline channel), against ``jax.grad``."""
    f1, f2 = _knots_1d(), _knots_2d()
    x, y = _points()
    w = np.linspace(0.5, 1.5, x.shape[0])

    def jloss(k1, k2):
        s1 = jsp.build_spline_1d(X0, DX, k1)
        cs = jsp.build_cell_spline_2d([jsp.build_spline_2d(X0, DX, Y0, DY, k2)],
                                      x_splines=[s1])
        fv, fx, fy = jax.vmap(lambda a, b: jsp.eval_cell_2d(cs, a, b))(x, y)
        v1, d1 = jax.vmap(lambda a: jsp.eval_1d_fp(s1, a))(x)
        return jnp.sum(w * (fv[:, 0] ** 2 + fx[:, 0] * fy[:, 0] + fv[:, 1] * fx[:, 1]
                            + v1 * d1))

    g1_ref, g2_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    k1 = torch.from_numpy(f1).requires_grad_(True)
    k2 = torch.from_numpy(f2).requires_grad_(True)
    s1 = tsp.build_spline_1d(X0, DX, k1)
    cs = tsp.build_cell_spline_2d([tsp.build_spline_2d(X0, DX, Y0, DY, k2)], x_splines=[s1])
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    fv, fx, fy = tsp.eval_cell_2d(cs, px, py)
    v1, d1 = tsp.eval_1d_fp(s1, px)
    loss = (torch.from_numpy(w) * (fv[:, 0] ** 2 + fx[:, 0] * fy[:, 0] + fv[:, 1] * fx[:, 1]
                                   + v1 * d1)).sum()
    g1, g2 = torch.autograd.grad(loss, (k1, k2))
    _close(g1, g1_ref, GRAD_TOL, "1-D knots")
    _close(g2, g2_ref, GRAD_TOL, "2-D knots")


def test_cell_table_is_a_leaf():
    """The gradient with respect to the cell table itself (the adjoint's
    leaf) is the scatter of the polynomial weights into the fetched rows."""
    _, t = _both_2d()
    tc = tsp.build_cell_spline_2d([t])
    cells = tc.cells.clone().requires_grad_(True)
    x, y = _points()
    f = tsp.eval_cell_2d(tc._replace(cells=cells), torch.from_numpy(x), torch.from_numpy(y))[0]
    g, = torch.autograd.grad(f.sum(), (cells,))
    assert g.shape == cells.shape
    # a cell no point falls in gets no gradient; the weights of one point sum
    # over (q, p) of u^p v^q
    i = np.clip(np.floor((x - X0) / DX), 0, NX - 2).astype(int)
    j = np.clip(np.floor((y - Y0) / DY), 0, NY - 2).astype(int)
    hit = np.zeros((NX - 1, NY - 1), bool)
    hit[i, j] = True
    assert float(g[torch.from_numpy(~hit)].abs().max()) == 0.0
    u, v = (x - X0) / DX - i, (y - Y0) / DY - j
    want = sum((u[n] ** np.arange(4)).sum() * (v[n] ** np.arange(4)).sum()
               for n in range(len(x)))
    assert float(g.sum()) == pytest.approx(want, rel=1e-12)
