"""The EQDSK tokamak of the reference and its (R, Z) launch, as a
configuration names them: ``"reference_model": "eqdsk"``.

It imports nothing of the program under test.  From a G-EQDSK file
(eqdsk_utilities_m.f90's layout) it makes RAYS's eqdsk_magnetics_spline
_interp (eqdsk_magnetics_spline_interp_m.f90:160-283): psi shifted to 0
on axis, a not-a-knot bicubic spline of psi(R, Z) and a not-a-knot cubic
spline of R*Bphi(R) on the file's uniform grid (quick_cube_splines_m
.f90), B = (psi_Z / R, -psi_R / R, R Bphi / R) in (R, Z, phi), psiN =
psi / (PSIBOUND - PSIAXIS); the axisym_toroid parabolic profiles in
psiN (the configuration's; others are refused) and its
stops (axisym_toroid_eq_m.f90:215-363): out of plasma beyond
``plasma_psi_limit``, out of the file's box in R or Z; and the launch of
axisym_toroid_ray_init_R_Z_nphi_ntheta_m.f90.

The splines are evaluated, as the program's parameters hold them, from a
table of per-cell bicubic coefficients: for cell (i, j) and channel k
(0: psi; 1: R*Bphi, a cubic in R alone, in the row of power 0 in Z), a
4 x 4 block c[q, p] with f = sum c[q, p] u^p v^q in the cell's local
coordinates u = (R - R0) / dR - i, v = (Z - Z0) / dZ - j, the cell index
clamped to the grid (outside it the edge cell's cubic).  The table, the
grid's origin and spacing and PSIBOUND - PSIAXIS are leaves under the
program's names (``eq.mag.psi_cells.cells``, ``.x0``, ...), so the
gradient of a loss in them is compared leaf by leaf.  The knot tables are
leaves too (``eq.mag.psi_spline.f`` ...); nothing reads them once the cell
table is made, so their gradient is zero, as the program's is.  The
spatial derivatives of B and of the profiles are written out from the
table's first and second derivatives.

One departure from RAYS: the launch frame is oriented along grad psiN,
which rises outward whatever the sign of the file's psi, where RAYS takes
-grad(psi) as inward and so launches outward on a file whose psi falls
outward, as the Solovev converter's and many EFIT files' does (the
program's ROADMAP C13).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.reference import rays_plain

ROOT = Path(__file__).resolve().parents[2]
R_OUT_OF_BOX, Z_OUT_OF_BOX = 4, 5
AXIS_GUARD = 1e-12      # the smallest R a point is taken at
PROFILE_GUARD = 1e-30   # psiN below this is taken at it inside the profile's powers


# --- the file ------------------------------------------------------------


def read_geqdsk(path):
    """{name: value} of a G-EQDSK file: the grid, PSIAXIS, PSIBOUND and the
    arrays T (R Bphi on the R grid), psi (nr, nz) with psi[i, j] at
    (R_i, Z_j), and Q."""
    lines = Path(path).read_text().splitlines()
    nr, nz = (int(t) for t in lines[0][48:].split()[-2:])

    def fields():
        for line in lines[1:]:
            for k in range(0, len(line), 16):
                tok = line[k:k + 16].strip()
                if tok:
                    yield float(tok.replace("D", "E").replace("d", "e"))

    it = fields()

    def take(n):
        return np.array([next(it) for _ in range(n)])

    s = take(20)
    out = dict(nr=nr, nz=nz, rboxlen=s[0], zboxlen=s[1], rboxlft=s[3], zoff=s[4],
               psiaxis=s[7], psibound=s[8])
    out["T"] = take(nr)
    take(3 * nr)                                  # P, TT', P'
    out["psi"] = take(nr * nz).reshape(nz, nr).T  # written ((psi(i, j), i), j)
    out["Q"] = take(nr)
    return out


# --- the splines (quick_cube_splines_m.f90: uniform grid, not-a-knot) -----


def second_derivatives(f, h, axis):
    """The second derivatives at the knots of the not-a-knot cubic spline
    through ``f`` along ``axis``: M[i-1] + 4 M[i] + M[i+1] = 6 (f[i-1] -
    2 f[i] + f[i+1]) / h^2 inside, and a continuous third derivative at the
    second and the last but one knot (M0 - 2 M1 + M2 = 0 at each end)."""
    f = np.moveaxis(np.asarray(f, dtype=np.float64), axis, 0)
    n = f.shape[0]
    a = np.zeros((n, n))
    rhs = np.zeros_like(f)
    for i in range(1, n - 1):
        a[i, i - 1:i + 2] = (1.0, 4.0, 1.0)
        rhs[i] = 6.0 * (f[i - 1] - 2.0 * f[i] + f[i + 1]) / h**2
    a[0, 0:3] = a[n - 1, n - 3:n] = (1.0, -2.0, 1.0)
    m = np.linalg.solve(a, rhs.reshape(n, -1)).reshape(f.shape)
    return np.moveaxis(m, 0, axis)


def segment_weights(h):
    """W with (c0, c1, c2, c3) = W (f_a, f_b, M_a, M_b): the cubic on a
    segment of length h from its end values and second derivatives,
    f_a (1 - u) + f_b u + h^2 / 6 [((1 - u)^3 - (1 - u)) M_a + (u^3 - u) M_b],
    as powers of u."""
    c = h * h / 6.0
    return np.array([[1.0, 0.0, 0.0, 0.0],
                     [-1.0, 1.0, -2.0 * c, -c],
                     [0.0, 0.0, 3.0 * c, 0.0],
                     [0.0, 0.0, -c, c]])


def cell_table(psi, mr, mz, mrz, hr, hz, T, mT):
    """(nr-1, nz-1, 2, 4, 4): channel 0 the bicubic psi of each cell,
    channel 1 the cubic R Bphi(R) in its row of power 0 in Z."""
    nr, nz = psi.shape
    # corner data d[t, s]: t = (value at i, at i+1, d2/dR2 at i, at i+1),
    # s likewise in Z; the (d2/dR2, d2/dZ2) corner is the cross derivative
    kinds = {(0, 0): psi, (0, 1): mz, (1, 0): mr, (1, 1): mrz}
    d = np.empty((nr - 1, nz - 1, 4, 4))
    for t in range(4):
        for s in range(4):
            d[:, :, t, s] = kinds[t // 2, s // 2][t % 2:nr - 1 + t % 2, s % 2:nz - 1 + s % 2]
    wr, wz = segment_weights(hr), segment_weights(hz)
    cells = np.zeros((nr - 1, nz - 1, 2, 4, 4))
    cells[:, :, 0] = np.einsum("qs,pt,ijts->ijqp", wz, wr, d)
    seg = np.stack([T[:-1], T[1:], mT[:-1], mT[1:]], -1)
    cells[:, :, 1, 0, :] = (seg @ wr.T)[:, None, :]
    return cells


def _powers(t):
    """(t^p, d/dt, d2/dt2) for p = 0..3, each (B, 4)."""
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return (torch.stack([one, t, t * t, t * t * t], -1),
            torch.stack([zero, one, 2.0 * t, 3.0 * t * t], -1),
            torch.stack([zero, zero, 2.0 * one, 6.0 * t], -1))


def cell_eval(case, R, Z):
    """Each channel's value, d/dR, d/dZ, d2/dR2, d2/dRdZ and d2/dZ2 at
    (R, Z), from the cell table: six (B, 2) tensors."""
    c = case
    cells = c["eq.mag.psi_cells.cells"]
    nrm, nzm = cells.shape[0], cells.shape[1]
    hr, hz = c["eq.mag.psi_cells.dx"], c["eq.mag.psi_cells.dy"]
    tr = (R - c["eq.mag.psi_cells.x0"]) / hr
    tz = (Z - c["eq.mag.psi_cells.y0"]) / hz
    i = torch.floor(tr).long().clamp(0, nrm - 1)
    j = torch.floor(tz).long().clamp(0, nzm - 1)
    pr, dpr, d2pr = _powers(tr - i.to(tr.dtype))
    pz, dpz, d2pz = _powers(tz - j.to(tz.dtype))
    rows = cells[i, j]                                       # (B, 2, 4q, 4p)

    def contract(a, b):
        return torch.einsum("bkqp,bp,bq->bk", rows, a, b)

    return (contract(pr, pz), contract(dpr, pz) / hr, contract(pr, dpz) / hz,
            contract(d2pr, pz) / (hr * hr), contract(dpr, dpz) / (hr * hz),
            contract(pr, d2pz) / (hz * hz))


# --- the profiles (axisym_toroid_eq_m.f90) ---------------------------------


def parabolic(psin, floor, a1, a2):
    """(f, df/dpsiN) of (1 - |psiN|^a2)^a1 inside |psiN| < 1, 0 outside,
    raised to ``floor`` where it falls below it."""
    r = psin.abs()
    inside = r < 1.0
    rs = torch.where(inside, r, torch.full_like(r, 0.5)).clamp_min(PROFILE_GUARD)
    base = 1.0 - rs**a2
    f = torch.where(inside, base**a1, torch.zeros_like(r))
    fp = torch.where(inside, -a1 * a2 * rs ** (a2 - 1.0) * base ** (a1 - 1.0) * torch.sign(psin),
                     torch.zeros_like(r))
    low = f < floor
    return torch.where(low, floor + torch.zeros_like(f), f), torch.where(low, 0.0 * fp, fp)


# --- the builder ----------------------------------------------------------


def builder(case, nml):
    """The fields of the namelist's axisym_toroid equilibrium with
    eqdsk_magnetics_spline_interp, read from its G-EQDSK (a path relative
    to the checkout, or absolute)."""
    g = nml["axisym_toroid_eq_list"]
    if g.get("magnetics_model") != "eqdsk_magnetics_spline_interp":
        raise ValueError("the reference's toroid reads eqdsk_magnetics_spline_interp only")
    ns = case.static["ns"]
    models = [g.get("density_prof_model", "parabolic"),
              *rays_plain._per_species(g, "temperature_prof_model", ns, "zero")]
    if set(models) != {"parabolic"}:
        raise ValueError(f"the reference's toroid has parabolic profiles only, not {models}")
    path = Path(nml["eqdsk_magnetics_spline_interp_list"]["eqdsk_file_name"])
    eq = read_geqdsk(path if path.is_absolute() else ROOT / path)

    nr, nz = eq["nr"], eq["nz"]
    r0, hr = eq["rboxlft"], eq["rboxlen"] / (nr - 1)
    z0, hz = eq["zoff"] - eq["zboxlen"] / 2.0, eq["zboxlen"] / (nz - 1)
    psi = eq["psi"] - eq["psiaxis"]
    mr, mz = second_derivatives(psi, hr, 0), second_derivatives(psi, hz, 1)
    mrz = second_derivatives(mz, hr, 0)
    mT = second_derivatives(eq["T"], hr, 0)
    nq = len(eq["Q"])
    for name, value in (("psi_spline.x0", r0), ("psi_spline.dx", hr), ("psi_spline.y0", z0),
                        ("psi_spline.dy", hz), ("psi_spline.f", psi), ("psi_spline.mx", mr),
                        ("psi_spline.my", mz), ("psi_spline.mxy", mrz),
                        ("rbphi_spline.x0", r0), ("rbphi_spline.dx", hr),
                        ("rbphi_spline.f", eq["T"]), ("rbphi_spline.m", mT),
                        ("psib", eq["psibound"] - eq["psiaxis"]),
                        ("q_spline.x0", 0.0), ("q_spline.dx", 1.0 / (nq - 1)),
                        ("q_spline.f", eq["Q"]),
                        ("q_spline.m", second_derivatives(eq["Q"], 1.0 / (nq - 1), 0)),
                        ("psi_cells.x0", r0), ("psi_cells.dx", hr), ("psi_cells.y0", z0),
                        ("psi_cells.dy", hz),
                        ("psi_cells.cells", cell_table(psi, mr, mz, mrz, hr, hz, eq["T"], mT))):
        case.leaf("eq.mag." + name, value)
    for key, default in (("plasma_psi_limit", 1.0), ("alphan1", 1.0), ("alphan2", 2.0),
                         ("d_scrape_off", 0.0), ("t_scrape_off", 0.0)):
        case.leaf("eq." + key, float(g.get(key, default)))
    for key, default in (("alphat1", 1.0), ("alphat2", 2.0)):
        case.leaf("eq." + key, [float(v) for v in rays_plain._per_species(g, key, ns, default)])
    for key in ("ne_knots", "te_knots", "ti_knots"):     # no spline profile model here
        case.leaf("eq." + key, np.zeros((2, 4)))
    box = (r0, r0 + eq["rboxlen"], eq["zoff"] - eq["zboxlen"] / 2.0,
           eq["zoff"] + eq["zboxlen"] / 2.0)
    for key, value in zip(("box_rmin", "box_rmax", "box_zmin", "box_zmax"), box):
        case.leaf("eq." + key, value)

    def fields(x3):
        return toroid_fields(case, x3)

    return fields


def flux(case, x3):
    """(psi, grad psi (B, 3), the cell evaluation, R, cos phi, sin phi) at x3."""
    x, y, z = x3[:, 0], x3[:, 1], x3[:, 2]
    R = torch.sqrt(x * x + y * y).clamp_min(AXIS_GUARD)
    cx, cy = x / R, y / R
    ev = cell_eval(case, R, z)
    psi_r, psi_z = ev[1][:, 0], ev[2][:, 0]
    return ev[0][:, 0], torch.stack([psi_r * cx, psi_r * cy, psi_z], -1), ev, R, cx, cy


def toroid_fields(case, x3):
    """(bvec, gradb, ns, gradns, ts, gradts, err) at x3 (B, 3), gradb[b, i, j]
    = dB_j/dx_i, the gradients (B, S, 3)."""
    c = case
    psi, gradpsi, (f, fr, fz, frr, frz, fzz), R, cx, cy = flux(case, x3)
    psi_r, psi_z, psi_rr, psi_rz, psi_zz = fr[:, 0], fz[:, 0], frr[:, 0], frz[:, 0], fzz[:, 0]
    rbphi, rbphi_r = f[:, 1], fr[:, 1]
    br, bz, bphi = psi_z / R, -psi_r / R, rbphi / R
    zero = torch.zeros_like(R)

    def vec(a, b, d):
        return torch.stack([a, b, d], -1)

    # d/dx_i of R, cos phi and sin phi, and of the cylindrical components
    dR = vec(cx, cy, zero)
    dcx = vec((1.0 - cx * cx) / R, -cx * cy / R, zero)
    dcy = vec(-cx * cy / R, (1.0 - cy * cy) / R, zero)
    dbr = (psi_rz / R - psi_z / R**2)[:, None] * dR + vec(zero, zero, psi_zz / R)
    dbz = (-psi_rr / R + psi_r / R**2)[:, None] * dR + vec(zero, zero, -psi_rz / R)
    dbphi = (rbphi_r / R - rbphi / R**2)[:, None] * dR

    def col(t):
        return t[:, None]

    bvec = vec(br * cx - bphi * cy, br * cy + bphi * cx, bz)
    gradb = torch.stack([col(cx) * dbr + col(br) * dcx - col(cy) * dbphi - col(bphi) * dcy,
                         col(cy) * dbr + col(br) * dcy + col(cx) * dbphi + col(bphi) * dcx,
                         dbz], -1)

    psib = c["eq.mag.psib"]
    psin, gpsin = psi / psib, gradpsi / psib
    fn, fnp = parabolic(psin, c["eq.d_scrape_off"], c["eq.alphan1"], c["eq.alphan2"])
    ns = c["species.n0s"] * fn[:, None]
    gradns = c["species.n0s"][None, :, None] * (fnp[:, None] * gpsin)[:, None, :]
    t_d = [parabolic(psin, c["eq.t_scrape_off"], c["eq.alphat1"][i], c["eq.alphat2"][i])
           for i in range(case.static["ns"])]
    ts = torch.stack([c["species.t0s"][i] * t for i, (t, _) in enumerate(t_d)], -1)
    gradts = torch.stack([c["species.t0s"][i] * d[:, None] * gpsin
                          for i, (_, d) in enumerate(t_d)], 1)

    rr = torch.sqrt(x3[:, 0] ** 2 + x3[:, 1] ** 2)
    z = x3[:, 2]
    err = torch.zeros(R.shape, dtype=torch.int32, device=R.device)
    err = torch.where(psin > c["eq.plasma_psi_limit"], rays_plain.OUT_OF_PLASMA, err)
    err = torch.where((z < c["eq.box_zmin"]) | (z > c["eq.box_zmax"]), Z_OUT_OF_BOX, err)
    err = torch.where((rr < c["eq.box_rmin"]) | (rr > c["eq.box_rmax"]), R_OUT_OF_BOX, err)
    low = torch.where(ts.amin(-1) < 0.0, rays_plain.NEGATIVE_TEMP, 0)
    low = torch.where(ns.amin(-1) < 0.0, rays_plain.NEGATIVE_DENS, low)
    err = torch.where(err != 0, err, low)
    return bvec, gradb, ns, gradns, ts, gradts, err.to(torch.int32)


# --- the launch (axisym_toroid_ray_init_R_Z_nphi_ntheta_m.f90) ------------


def _unit(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def launch(case):
    """(v0 (B, nv), power weights (B,)) of the namelist's R_Z fan: at each
    (R, 0, Z), n_phi along phi and n_theta along the poloidal direction in
    the flux surface, and the component along grad psiN (inward) from the
    cold dispersion relation; candidates that do not propagate are
    dropped."""
    g = case.nml["axisym_toroid_ray_init_r_z_nphi_ntheta_list"]

    def axis(n, start, step):
        return [float(g.get(start, 0.0)) + float(g.get(step, 0.0)) * i
                for i in range(int(g.get(n, 1)))]

    rs = axis("n_r_launch", "r_launch0", "dr_launch")
    zs = axis("n_z_launch", "z_launch0", "dz_launch")
    nths = axis("n_rindex_theta", "rindex_theta0", "delta_rindex_theta")
    nphs = axis("n_rindex_phi", "rindex_phi0", "delta_rindex_phi")
    cand = case.t([(r, 0.0, z, nth, nph) for r in rs for z in zs for nth in nths
                   for nph in nphs])
    r, nth, nph = cand[:, 0:3], cand[:, 3:4], cand[:, 4:5]
    e = rays_plain.plasma_point(case, r)
    _, gradpsi, _, _, _, _ = flux(case, r)
    gpsin = gradpsi / case["eq.mag.psib"]
    zero = torch.zeros_like(nth[:, 0])
    psi_unit = _unit(gpsin)
    theta_unit = _unit(torch.stack([-gpsin[:, 2], zero, gpsin[:, 0]], -1))
    phi_unit = torch.stack([zero, zero + 1.0, zero], -1)
    rindex = nph * phi_unit + nth * theta_unit
    trans = torch.linalg.cross(e.bunit, psi_unit)
    n3, n2 = (e.bunit * rindex).sum(-1), (trans * rindex).sum(-1)
    roots, complex_pair = rays_plain.n1sq_roots(e.alpha, e.gamma, n3)
    rad = roots[case.static["wave_mode"]] - n2 * n2
    ok = (e.err == 0) & ~complex_pair & (rad >= 0.0)
    npsi = case.static["k0_sign"] * torch.sqrt(rad.clamp_min(0.0))
    rindex0 = (rindex - npsi[:, None] * psi_unit)[ok]
    v0 = torch.zeros((int(ok.sum()), case.static["nv"]), dtype=case.dtype, device=case.device)
    v0[:, 0:3] = r[ok]
    v0[:, 3:6] = case["rf.k0"] * rindex0
    return v0, torch.full((v0.shape[0],), 1.0 / v0.shape[0], dtype=case.dtype,
                          device=case.device)
