"""Differentiable uniform-grid cubic splines, 1-D and 2-D tensor product
(``rays_tpu.ops.splines``; reference splines_lib/quick_cube_splines_m.f90:
uniform grid, not-a-knot boundary conditions, C2 continuity), batched over
points.

The second-derivative arrays are made at build time by a dense product
M = T @ f, with T = A^{-1} B of the not-a-knot tridiagonal system computed
on the host in float64.  M is linear in the knot values, so gradients with
respect to the knot values flow through build and evaluation.  Evaluation
is a row fetch and a cubic polynomial; points outside the grid evaluate the
polynomial of the edge cell (the cell index is clamped).

``CellSpline2D`` is the per-cell coefficient form of K splines on one grid:
a point fetches one row of K*16 coefficients with a single ``index_select``
of the ``(nxm*nym, K*16)`` view of the table, and values, first and second
derivatives all come from that row.

``EVALS`` counts the cell-form evaluations that Python runs (one row
fetch for a batch of points): eager ones, and those a CUDA graph captures
(tracing/graphed.py stores the count each piece's capture made on its
cache entry).  ``REPLAYED_EVALS`` counts those that graph replays make:
each replay adds its piece's stored count, since a replay runs no Python.

Every evaluator takes points of any shape and returns that shape (with a
trailing K axis for the cell form).  In float32 ``(x - x0) / dx`` can land
in the cell next to the one float64 finds for a point on a knot; the spline
is C2, so the values still agree to rounding.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

EVALS = 0            # cell-form evaluations run by Python (eager or captured)
REPLAYED_EVALS = 0   # cell-form evaluations run by graph replays


class Spline1D(NamedTuple):
    x0: Any   # grid origin
    dx: Any   # grid spacing
    f: Any    # (n,) knot values
    m: Any    # (n,) second derivatives at knots


class Spline2D(NamedTuple):
    x0: Any
    dx: Any
    y0: Any
    dy: Any
    f: Any     # (nx, ny)
    mx: Any    # d2/dx2
    my: Any    # d2/dy2
    mxy: Any   # d4/dx2dy2


class CellSpline2D(NamedTuple):
    """Per-cell bicubic coefficients of K stacked Spline2Ds on one grid.
    Coefficients are linear in the knot values (built with differentiable
    tensor operations), and the table is a leaf a gradient can be taken
    with respect to."""

    x0: Any
    dx: Any
    y0: Any
    dy: Any
    cells: Any   # (nxm, nym, K, 4, 4): axes (y-power q, x-power p)


def _second_deriv_matrix(n: int, h: float) -> np.ndarray:
    """T with M = T @ f for the uniform-grid not-a-knot cubic spline.

    Interior: M[i-1] + 4 M[i] + M[i+1] = 6 (f[i-1] - 2 f[i] + f[i+1]) / h^2.
    Not-a-knot (third derivative continuous at x1, x_{n-2}):
    M0 - 2 M1 + M2 = 0 and M_{n-3} - 2 M_{n-2} + M_{n-1} = 0.
    """
    if n < 4:
        raise ValueError("cubic spline needs at least 4 points")
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    for i in range(1, n - 1):
        A[i, i - 1] = 1.0
        A[i, i] = 4.0
        A[i, i + 1] = 1.0
        B[i, i - 1] = 6.0 / h**2
        B[i, i] = -12.0 / h**2
        B[i, i + 1] = 6.0 / h**2
    A[0, 0], A[0, 1], A[0, 2] = 1.0, -2.0, 1.0
    A[n - 1, n - 3], A[n - 1, n - 2], A[n - 1, n - 1] = 1.0, -2.0, 1.0
    return np.linalg.solve(A, B)


def _as_tensor(x, like=None):
    """Host value or tensor -> tensor (float64 unless ``like`` says else)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _t_matrix(n, h, like):
    return torch.as_tensor(_second_deriv_matrix(n, float(h))).to(
        device=like.device, dtype=like.dtype)


def build_spline_1d(x0, dx, f) -> Spline1D:
    """Build from knot values (..., n).  T is computed in numpy (host,
    float64) and applied to ``f`` with a tensor product, so knot-value
    gradients flow."""
    f = _as_tensor(f)
    T = _t_matrix(int(f.shape[-1]), dx, f)
    return Spline1D(x0=_as_tensor(x0, f), dx=_as_tensor(dx, f), f=f, m=f @ T.T)


def build_spline_2d(x0, dx, y0, dy, f) -> Spline2D:
    """f: (nx, ny) knot values; spline-of-splines tensor product."""
    f = _as_tensor(f)
    Tx = _t_matrix(int(f.shape[0]), dx, f)
    Ty = _t_matrix(int(f.shape[1]), dy, f)
    mx = Tx @ f          # d2f/dx2 at knots
    my = f @ Ty.T        # d2f/dy2 at knots
    mxy = Tx @ my        # d4f/dx2dy2
    return Spline2D(x0=_as_tensor(x0, f), dx=_as_tensor(dx, f),
                    y0=_as_tensor(y0, f), dy=_as_tensor(dy, f),
                    f=f, mx=mx, my=my, mxy=mxy)


def _local(fi, fi1, mi, mi1, u, h):
    """1-D cubic segment value from endpoint values/second derivs."""
    w = 1.0 - u
    return (fi * w + fi1 * u
            + (h * h / 6.0) * ((w**3 - w) * mi + (u**3 - u) * mi1))


def _local_du(fi, fi1, mi, mi1, u, h):
    w = 1.0 - u
    return (fi1 - fi
            + (h * h / 6.0) * ((-3.0 * w**2 + 1.0) * mi + (3.0 * u**2 - 1.0) * mi1))


def _local_d2u(mi, mi1, u, h):
    return (h * h) * ((1.0 - u) * mi + u * mi1)


def _cell(x0, dx, n, x):
    """(cell index int64 clamped to 0..n-2, local coordinate)."""
    t = (x - x0) / dx
    i = torch.floor(t).to(torch.int64).clamp(0, n - 2)
    return i, t - i.to(t.dtype)


def segment_table(f, m):
    """(n-1, 4) rows (f[i], f[i+1], m[i], m[i+1]) of a 1-D spline."""
    return torch.stack([f[..., :-1], f[..., 1:], m[..., :-1], m[..., 1:]], dim=-1)


def _seg_1d(sp: Spline1D, x):
    """(fi, fi1, mi, mi1, u): the segment endpoint data for x, fetched as
    one row of the segment table."""
    n = sp.f.shape[-1]
    i, u = _cell(sp.x0, sp.dx, n, x)
    row = segment_table(sp.f, sp.m).index_select(0, i.reshape(-1))
    row = row.reshape(*i.shape, 4)
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3], u


def eval_1d(sp: Spline1D, x):
    """Spline value at x (clamped-cell extrapolation outside the grid)."""
    fi, fi1, mi, mi1, u = _seg_1d(sp, x)
    return _local(fi, fi1, mi, mi1, u, sp.dx)


def eval_1d_fp(sp: Spline1D, x):
    """(f, df/dx)."""
    fi, fi1, mi, mi1, u = _seg_1d(sp, x)
    f = _local(fi, fi1, mi, mi1, u, sp.dx)
    fp = _local_du(fi, fi1, mi, mi1, u, sp.dx) / sp.dx
    return f, fp


def _corners(sp: Spline2D, x, y):
    """The four corners of the cell of (x, y) in each of (F, My, Mx, Mxy):
    four tensors (4 tables, *shape) for corners 00, 01, 10, 11, and the
    local coordinates (u, v)."""
    nx, ny = sp.f.shape
    i, u = _cell(sp.x0, sp.dx, nx, x)
    j, v = _cell(sp.y0, sp.dy, ny, y)
    flat = torch.stack([sp.f, sp.my, sp.mx, sp.mxy]).reshape(4, nx * ny)
    lin = (i * ny + j).reshape(-1)
    shape = (4,) + tuple(i.shape)
    c00, c01, c10, c11 = (flat.index_select(1, lin + off).reshape(shape)
                          for off in (0, 1, ny, ny + 1))
    return c00, c01, c10, c11, u, v


def eval_2d(sp: Spline2D, x, y):
    """Bicubic spline value at (x, y): the 1-D formula in y applied to
    (F, My) and (Mx, Mxy), then in x to the results."""
    c00, c01, c10, c11, u, v = _corners(sp, x, y)
    g0 = _local(c00[0], c01[0], c00[1], c01[1], v, sp.dy)   # f(x_i, y)
    g1 = _local(c10[0], c11[0], c10[1], c11[1], v, sp.dy)   # f(x_{i+1}, y)
    h0 = _local(c00[2], c01[2], c00[3], c01[3], v, sp.dy)   # fxx(x_i, y)
    h1 = _local(c10[2], c11[2], c10[3], c11[3], v, sp.dy)
    return _local(g0, g1, h0, h1, u, sp.dx)


def eval_2d_fp(sp: Spline2D, x, y):
    """(f, df/dx, df/dy)."""
    return eval_2d_second(sp, x, y)[:3]


def eval_2d_second(sp: Spline2D, x, y):
    """(f, fx, fy, fxx, fxy, fyy) from the four knot tables, for consumers
    that hold no cell table."""
    c00, c01, c10, c11, u, v = _corners(sp, x, y)
    dx, dy = sp.dx, sp.dy
    g0 = _local(c00[0], c01[0], c00[1], c01[1], v, dy)
    g1 = _local(c10[0], c11[0], c10[1], c11[1], v, dy)
    h0 = _local(c00[2], c01[2], c00[3], c01[3], v, dy)
    h1 = _local(c10[2], c11[2], c10[3], c11[3], v, dy)
    f = _local(g0, g1, h0, h1, u, dx)
    fx = _local_du(g0, g1, h0, h1, u, dx) / dx
    fxx = _local_d2u(h0, h1, u, dx) / (dx * dx)

    g0v = _local_du(c00[0], c01[0], c00[1], c01[1], v, dy) / dy
    g1v = _local_du(c10[0], c11[0], c10[1], c11[1], v, dy) / dy
    h0v = _local_du(c00[2], c01[2], c00[3], c01[3], v, dy) / dy
    h1v = _local_du(c10[2], c11[2], c10[3], c11[3], v, dy) / dy
    fy = _local(g0v, g1v, h0v, h1v, u, dx)
    fxy = _local_du(g0v, g1v, h0v, h1v, u, dx) / dx

    g0vv = _local_d2u(c00[1], c01[1], v, dy) / (dy * dy)
    g1vv = _local_d2u(c10[1], c11[1], v, dy) / (dy * dy)
    h0vv = _local_d2u(c00[3], c01[3], v, dy) / (dy * dy)
    h1vv = _local_d2u(c10[3], c11[3], v, dy) / (dy * dy)
    fyy = _local(g0vv, g1vv, h0vv, h1vv, u, dx)
    return f, fx, fy, fxx, fxy, fyy


def _seg_coef(fi, fi1, mi, mi1, h):
    """Cubic-segment monomial coefficients [a0..a3] in the local coordinate
    u in [0,1], stacked on a new last axis, from endpoint values/2nd derivs:
    f(u) = fi(1-u) + fi1 u + h^2/6 [((1-u)^3-(1-u)) mi + (u^3-u) mi1]."""
    c = h * h / 6.0
    return torch.stack([
        fi,
        (fi1 - fi) + c * (-2.0 * mi - mi1),
        3.0 * c * mi,
        c * (mi1 - mi),
    ], dim=-1)


def build_cell_spline_2d(sps, x_splines=()) -> CellSpline2D:
    """Fuse Spline2Ds (same grid) into one per-cell coefficient table.

    ``x_splines``: Spline1Ds on the same x grid, appended as further K
    channels whose cells carry the 1-D u-segment cubic in the q=0 row
    (constant in y), so that a co-gridded 1-D spline (the EQDSK toroid's
    R*Bphi(R)) rides on the same row fetch."""
    sps = list(sps)
    sp0 = sps[0]
    cells = []
    for sp in sps:
        F, Mx, My, Mxy = sp.f, sp.mx, sp.my, sp.mxy
        # along y first: value/fxx segment coefficients, (nx, nym, 4q)
        gy = _seg_coef(F[:, :-1], F[:, 1:], My[:, :-1], My[:, 1:], sp.dy)
        hy = _seg_coef(Mx[:, :-1], Mx[:, 1:], Mxy[:, :-1], Mxy[:, 1:], sp.dy)
        # then along x: (nxm, nym, 4q, 4p)
        cells.append(_seg_coef(gy[:-1], gy[1:], hy[:-1], hy[1:], sp.dx))
    for sp in x_splines:
        cu = _seg_coef(sp.f[..., :-1], sp.f[..., 1:],
                       sp.m[..., :-1], sp.m[..., 1:], sp.dx)   # (nxm, 4p)
        zeros = torch.zeros_like(cells[0][:, :, 1:, :])
        row0 = cu[:, None, None, :].expand(-1, cells[0].shape[1], -1, -1)
        cells.append(torch.cat([row0, zeros], dim=2))
    return CellSpline2D(x0=sp0.x0, dx=sp0.dx, y0=sp0.y0, dy=sp0.dy,
                        cells=torch.stack(cells, dim=2).contiguous())


def _cell_rows(cs: CellSpline2D, x, y):
    """Locate the cell of each point and fetch its K*16 coefficients with
    one row gather of the (nxm*nym, K*16) view of the table.  Returns
    (rows (N, K, 16), u (N,), v (N,)) for the N points of x."""
    global EVALS
    EVALS += 1
    nxm, nym, K = cs.cells.shape[0], cs.cells.shape[1], cs.cells.shape[2]
    i, u = _cell(cs.x0, cs.dx, nxm + 1, x.reshape(-1))
    j, v = _cell(cs.y0, cs.dy, nym + 1, y.reshape(-1))
    flat = cs.cells.view(nxm * nym, K * 16)
    return flat.index_select(0, i * nym + j).view(-1, K, 16), u, v


def _monomials(u, v, order):
    """Monomial weight vectors of u and v and their derivatives up to
    ``order``: a list of (N, 2, 4) tensors, [:, 0] for u and [:, 1] for v."""
    t = torch.stack([u, v], dim=-1)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    t2 = t * t
    out = [torch.stack([one, t, t2, t2 * t], dim=-1),
           torch.stack([zero, one, 2.0 * t, 3.0 * t2], dim=-1)]
    if order > 1:
        out.append(torch.stack([zero, zero, 2.0 * one, 6.0 * t], dim=-1))
    return out


def _contract(rows, a, b):
    """sum_{q,p} c[n, k, q, p] a[n, d, p] b[n, d, q] -> (N, K, D) for the
    D weight pairs stacked in a and b: one product and one sum."""
    w = (b[:, :, :, None] * a[:, :, None, :]).reshape(a.shape[0], 1, a.shape[1], 16)
    return (rows[:, :, None, :] * w).sum(-1)


def eval_cell_2d(cs: CellSpline2D, x, y):
    """(f, fx, fy), each of shape x.shape + (K,), from one coefficient
    fetch.  Clamped-cell extrapolation outside the grid like eval_2d."""
    rows, u, v = _cell_rows(cs, x, y)
    m0, m1 = _monomials(u, v, 1)
    up, vq, dup, dvq = m0[:, 0], m0[:, 1], m1[:, 0], m1[:, 1]
    out = _contract(rows, torch.stack([up, dup, up], 1), torch.stack([vq, vq, dvq], 1))
    shape = tuple(x.shape) + (rows.shape[1],)
    return (out[..., 0].reshape(shape), (out[..., 1] / cs.dx).reshape(shape),
            (out[..., 2] / cs.dy).reshape(shape))


def eval_cell_2d_second(cs: CellSpline2D, x, y):
    """(f, fx, fy, fxx, fxy, fyy), each of shape x.shape + (K,), from the
    same single fetch, for consumers that assemble field jacobians in
    closed form (the EQDSK toroid's gradB needs psi second derivatives)."""
    rows, u, v = _cell_rows(cs, x, y)
    m0, m1, m2 = _monomials(u, v, 2)
    up, vq, dup, dvq, d2up, d2vq = m0[:, 0], m0[:, 1], m1[:, 0], m1[:, 1], m2[:, 0], m2[:, 1]
    out = _contract(rows, torch.stack([up, dup, up, d2up, dup, up], 1),
                    torch.stack([vq, vq, dvq, vq, dvq, d2vq], 1))
    shape = tuple(x.shape) + (rows.shape[1],)
    dx, dy = cs.dx, cs.dy
    scale = (None, dx, dy, dx * dx, dx * dy, dy * dy)
    return tuple((out[..., d] if s is None else out[..., d] / s).reshape(shape)
                 for d, s in enumerate(scale))
