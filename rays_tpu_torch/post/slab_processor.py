"""Slab-geometry post-processor (``rays_tpu.post.slab_processor``).

Re-design of reference RAYS_project/post_process_lib/slab_processor_m.f90:

* resonance/cutoff scan over x (omega_ce, 2*omega_ce, hybrid S = 0,
  P-cutoff, H-cutoff, determinant zeros; slab_processor_m.f90:354-430),
  with sign-change detection and linearly interpolated crossings;
* equilibrium x-profiles to XY-curves netCDF ('eq_X_profiles.<label>.nc',
  :607-722);
* kx(x) dispersion-root profiles for each ray's (ny, nz)
  ('kx_profiles_slab.<label>', :729-769) as XY curves and as text;
* graphics description file 'graphics_description_slab.dat' (:840-866).

The JAX package loops over rays on the host, one device call (and one
compile) per ray.  Here the equilibrium is evaluated once on the x grid
and every ray's scan or roots are one (rays x grid) pass on the device the
parameters live on; the crossings of all rays come back to the host in one
copy.  Files, ray order and records are those of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from rays_tpu_torch.models import base
from rays_tpu_torch.post import grid
from rays_tpu_torch.post.xy_curves import XYCurve, write_xy_curves_nc
from rays_tpu_torch.wave import dispersion, stix

N_XPOINTS = 1000  # reference scan resolution (slab_processor_m.f90:381)
SCAN_NAMES = ("ce_res", "2ce_res", "hybrid_res", "P_cut", "H_cut", "det")
# (rays x grid points x quantities) scanned at once: 1 GiB at float64
CHUNK_ELEMENTS = 1 << 27


def _x_grid(params, n_points):
    """The uniform x grid of the box (numpy) and its points (x, 0, 0)."""
    xs = np.linspace(float(params.eq.xmin), float(params.eq.xmax), n_points)
    return xs, grid.plane_points(grid.like(params, xs), grid.like(params, 0.0))


def scan_quantities(cfg, params, xs, nz):
    """Scan values used for resonance/cutoff detection at the points
    (xs, 0, 0), for refractive index nz of any shape: (*nz.shape, N, 6),
    the quantities in the order of ``SCAN_NAMES``."""
    rvec = grid.plane_points(xs, torch.zeros_like(xs))
    alpha, gamma, _, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    S, D, P, R, L = stix.rlsdp(alpha, gamma)
    n3 = torch.as_tensor(nz, dtype=xs.dtype, device=xs.device)[..., None]
    # slab restriction: B has no shear, ky = 0 (:361-364)
    v_ce = gamma[:, 0] + 1.0
    v_2ce = gamma[:, 0] + 0.5
    # H cutoff: S^2 - D^2 - 2 S nz^2 + nz^4  (= (nz^2-R)(nz^2-L))
    v_h_cut = S**2 - D**2 - 2.0 * S * n3**2 + n3**4
    b = -R * L - P * S + n3**2 * (P + S)
    c = P * (n3**2 - R) * (n3**2 - L)
    v_det = b**2 - 4.0 * S * c
    return torch.stack(torch.broadcast_tensors(v_ce, v_2ce, S, P, v_h_cut, v_det), dim=-1)


def _crossings(xs, vals):
    """Zero crossings of vals (R, N, Q) along the grid xs (N,): (ray,
    interval, quantity) indices in row-major order and the linearly
    interpolated x of each, as numpy arrays."""
    s = torch.sign(vals)
    cross = s[:, :-1] * s[:, 1:] < 0
    x0, x1 = xs[:-1, None], xs[1:, None]
    v0, v1 = vals[:, :-1], vals[:, 1:]
    loc = x0 - v0 * (x1 - x0) / (v1 - v0)
    return cross.nonzero().cpu().numpy(), loc[cross].cpu().numpy()


def find_res_and_cuts(cfg, params, rindex_vec0, write_file=True):
    """Per-ray resonance/cutoff x locations.  Returns a list of dicts, one
    per ray, name -> numpy array of crossings in increasing x-grid order;
    optionally writes 'res_and_cut.<run_label>'."""
    xs_np, rvec = _x_grid(params, N_XPOINTS)
    xs = rvec[:, 0]
    nz = torch.as_tensor(rindex_vec0, dtype=xs.dtype, device=xs.device)[:, 2]
    n_rays, n_q = nz.shape[0], len(SCAN_NAMES)
    step = max(1, CHUNK_ELEMENTS // (N_XPOINTS * n_q))
    keys, locs = [], []
    for i in range(0, n_rays, step):
        idx, loc = _crossings(xs, scan_quantities(cfg, params, xs, nz[i:i + step]))
        keys.append((idx[:, 0] + i) * n_q + idx[:, 2])
        locs.append(loc)
    keys, locs = np.concatenate(keys), np.concatenate(locs)
    # group by (ray, quantity); a stable sort keeps each group in grid order
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n_rays * n_q)
    groups = np.split(locs[order], np.cumsum(counts)[:-1])
    results = [dict(zip(SCAN_NAMES, groups[r * n_q:(r + 1) * n_q])) for r in range(n_rays)]

    if write_file:
        fname = f"res_and_cut.{cfg.run_label}"
        with open(fname, "w") as f:
            for iray, entry in enumerate(results):
                f.write(f"\n ray {iray + 1}\n")
                for name in SCAN_NAMES:
                    locs_r = entry[name]
                    f.write(f" {name}: n = {len(locs_r)}  x = "
                            + " ".join(f"{v:.6f}" for v in locs_r) + "\n")
    return results


def write_eq_profiles(cfg, params, n_points=101, out_prefix=None):
    """Equilibrium x-profiles as XY curves ('eq_X_profiles.<label>.nc')."""
    xs, rvec = _x_grid(params, n_points)
    eq = base.equilibrium(cfg, params, rvec)
    alpha, gamma, _, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    ne, bmag, te, ae, ge = (grid.to_numpy(t) for t in (
        eq.ns[:, 0] * params.species.n_ref, eq.bmag, eq.ts[:, 0], alpha[:, 0], gamma[:, 0]))
    curves = [
        XYCurve("x", "ne", xs, ne),
        XYCurve("x", "Bmag", xs, bmag),
        XYCurve("x", "Te", xs, te),
        XYCurve("x", "alpha_e", xs, ae),
        XYCurve("x", "gamma_e", xs, ge),
    ]
    prefix = out_prefix or f"eq_X_profiles.{cfg.run_label}"
    return write_xy_curves_nc(curves, prefix)


def nx_squared(cfg, params, rindex_vec0, n_points):
    """nx^2 of the four cold roots (plus, minus, fast, slow) at each ray's
    (ny, nz) on the uniform x grid, and where the roots are a complex pair:
    (xs (numpy, N), nxsq (R, N, 4), evanescent (R, N))."""
    xs, rvec = _x_grid(params, n_points)
    alpha, gamma, bunit, _ = dispersion.alpha_gamma(cfg, params, rvec, params.rf.omgrf)
    n = torch.as_tensor(rindex_vec0, dtype=rvec.dtype, device=rvec.device)
    ny, nz = n[:, 1, None], n[:, 2, None]
    n2 = ny * bunit[:, 2] - nz * bunit[:, 1]        # (R, N)
    n3 = ny * bunit[:, 1] + nz * bunit[:, 2]
    shape = n3.shape + alpha.shape[-1:]
    roots, evan = dispersion.solve_cold_n1sq_vs_n3(alpha.expand(shape), gamma.expand(shape), n3)
    return xs, roots - (n2**2)[..., None], evan


def kx_profiles(cfg, params, rindex_vec0, n_points=201):
    """(xs, kx (R, N, 4)): real kx of the four roots where it propagates,
    0 where it is evanescent."""
    xs, nxsq, evan = nx_squared(cfg, params, rindex_vec0, n_points)
    live = (nxsq >= 0.0) & ~evan[..., None]
    kx = torch.where(live, torch.sqrt(nxsq.abs()), torch.zeros_like(nxsq)) * params.rf.k0
    return xs, kx


def write_kx_profiles(cfg, params, rindex_vec0, n_points=201, out_prefix=None):
    """kx(x) for the four cold roots at each ray's (ny, nz)
    ('kx_profiles_slab.<label>.nc' as XY curves)."""
    xs, kx = kx_profiles(cfg, params, rindex_vec0, n_points)
    kx = grid.to_numpy(kx)
    curves = [XYCurve("x", f"kx_{mode}_ray{iray + 1}", xs, kx[iray, :, k])
              for iray in range(kx.shape[0])
              for k, mode in enumerate(["plus", "minus", "fast", "slow"])]
    prefix = out_prefix or f"kx_profiles_slab.{cfg.run_label}"
    return write_xy_curves_nc(curves, prefix)


def write_kx_profiles_text(cfg, params, rindex_vec0, n_points=101, path=None):
    """'kx_profiles_slab.<run_label>' in the reference's TEXT layout
    (write_kx_profiles, slab_processor_m.f90:729-827): per ray a
    'ray <i> ny <ny> nz <nz>' line, a column-heading line starting with
    'x', then rows of x and (re, im) kx for the plus/minus/fast/slow
    roots — the file graphics_RAYS/plot_kx_profiles_slab.py parses."""
    xs, nxsq, _ = nx_squared(cfg, params, rindex_vec0, n_points)
    k0 = params.rf.k0
    re = grid.to_numpy(torch.sqrt(nxsq.clamp_min(0.0)) * k0)
    im = grid.to_numpy(torch.sqrt((-nxsq).clamp_min(0.0)) * k0)
    n = np.asarray(torch.as_tensor(rindex_vec0).cpu().double())
    names = ("x", "kx_real_plus", "kx_im_plus", "kx_real_minus",
             "kx_im_minus", "kx_real_fast", "kx_im_fast", "kx_real_slow",
             "kx_im_slow")
    fname = path or f"kx_profiles_slab.{cfg.run_label}"
    with open(fname, "w") as f:
        for iray in range(n.shape[0]):
            f.write(f" ray {iray + 1} ny {float(n[iray, 1]):.6g} nz {float(n[iray, 2]):.6g}\n")
            f.write(" " + " ".join(names) + "\n")
            for i, x in enumerate(xs):
                row = [x]
                for k in range(4):  # plus, minus, fast, slow
                    row.extend([re[iray, i, k], im[iray, i, k]])
                f.write(" " + " ".join(f"{v:.9g}" for v in row) + "\n")
    return fname


def write_graphics_description(cfg, params, path="graphics_description_slab.dat",
                               num_plot_k_vectors=5, scale_k_vec="max_len",
                               k_vec_base_length=0.05, set_xy_lim="true"):
    """Plotter hand-off file (slab_processor_m.f90:840-866)."""
    with open(path, "w") as f:
        f.write(f" run_description = {cfg.run_description}\n")
        f.write(f" run_label = {cfg.run_label}\n")
        f.write(f" xmin = {float(params.eq.xmin)}\n")
        f.write(f" xmax = {float(params.eq.xmax)}\n")
        f.write(f" ymin = {float(params.eq.ymin)}\n")
        f.write(f" ymax = {float(params.eq.ymax)}\n")
        f.write(f" zmin = {float(params.eq.zmin)}\n")
        f.write(f" zmax = {float(params.eq.zmax)}\n")
        f.write(f" num_plot_k_vectors = {num_plot_k_vectors}\n")
        f.write(f" scale_k_vec = {scale_k_vec}\n")
        f.write(f" k_vec_base_length = {k_vec_base_length}\n")
        f.write(f" set_XY_lim = {set_xy_lim}\n")
    return path


@torch.no_grad()
def process(cfg, params, results, rindex_vec0, knobs=None):
    """Full slab post-processing pass (the RAYS_P / post_process_RAYS
    equivalent for slab geometry).  ``knobs`` carries the
    &slab_processor_list namelist group (slab_processor_m.f90:56-59):
    plot-vector controls into the graphics description, ``n_X`` as the
    equilibrium-profile grid size, ``write_eq_X_profile_data`` as the
    profile-file gate."""
    k = {str(a).lower(): b for a, b in (knobs or {}).items()}
    out = {}
    out["res_and_cuts"] = find_res_and_cuts(cfg, params, rindex_vec0)
    if bool(k.get("write_eq_x_profile_data", True)):
        out["eq_profiles"] = write_eq_profiles(
            cfg, params, n_points=int(k.get("n_x", 101)))
    out["kx_profiles"] = write_kx_profiles(cfg, params, rindex_vec0)
    out["kx_profiles_text"] = write_kx_profiles_text(cfg, params, rindex_vec0)
    out["graphics_description"] = write_graphics_description(
        cfg, params,
        num_plot_k_vectors=int(k.get("num_plot_k_vectors", 5)),
        scale_k_vec=str(k.get("scale_k_vec", "max_len")),
        k_vec_base_length=float(k.get("k_vec_base_length", 0.05)),
        set_xy_lim=str(k.get("set_xy_lim", "true")),
    )
    return out
