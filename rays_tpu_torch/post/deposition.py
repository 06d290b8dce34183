"""Power-deposition profiles (``rays_tpu.post.deposition``; reference
post_process_lib/deposition_profiles_m.f90), batched over rays.

A per-geometry registry of profiles ('Ptotal_x' for the slab,
'Ptotal_psi' for the Solovev tokamak and the axisymmetric toroid,
'Ptotal_rho' for an EQDSK toroid whose file has a Q profile,
'Ptotal_AphiN' for the multiple mirror), a coordinate for each trajectory
point, the absorbed power per point (initial_ray_power *
v[:, damping_slot], frozen past npoints so that the tail adds nothing),
the uniform-grid binning of ``ops/binning.py`` for every ray, then the sum
over rays (:229-293).

The binning holds a (rays, segments, bins) tensor: 3.4 GB at float64 for
32,768 rays x 400 steps x 32 bins, several of which autograd would keep.
So rays go through in chunks of at most ``CHUNK_ELEMENTS`` such elements,
each chunk under ``torch.utils.checkpoint`` when gradients are on: the
backward pass keeps only the chunk's inputs and rebuilds the rest.

While spans record (utils/spans.py), the profile's forward is the span
``rays.post.deposition`` and its backward ``rays.post.deposition.backward``,
both with CUDA events on the card: the second opens when the profile's
gradient arrives and closes when the gradient into the trajectory's power
and coordinate is complete, by two identity autograd nodes around the
chunk loop (``_GradientArrives``, ``_GradientComplete``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from rays_tpu_torch.ops import binning
from rays_tpu_torch.utils import spans

# (rays x segments x bins) elements binned at once: 256 MB at float64
CHUNK_ELEMENTS = 1 << 25

_GRIDS = {"Ptotal_x": "x", "Ptotal_psi": "psi", "Ptotal_rho": "rho",
          "Ptotal_AphiN": "AphiN"}


class DepositionProfile(NamedTuple):
    name: str
    grid: Any      # (n_bins+1,) bin edges
    profile: Any   # (n_bins,) summed over rays


def _coordinate_fn(cfg, params, which: str):
    """Trajectory positions (..., 3) -> profile coordinate (...)."""
    if which == "Ptotal_x":
        return lambda r: r[..., 0]
    if which not in _GRIDS:
        raise ValueError(f"unknown deposition profile {which}")

    def on_points(fn):
        # the models take (B, 3); the trajectory is (B, n_pts, 3)
        return lambda r: fn(r.reshape(-1, 3)).reshape(r.shape[:-1])

    model = cfg.equilib_model
    if which == "Ptotal_psi" and model == "solovev":
        from rays_tpu_torch.models import solovev

        return lambda r: solovev.psi(params.eq, r)[2]
    if which == "Ptotal_psi" and model == "axisym_toroid":
        from rays_tpu_torch.models import axisym_toroid as at

        return on_points(lambda r: at.magnetics(cfg.eq_static, params.eq, r)[2])
    if which == "Ptotal_rho" and model == "axisym_toroid":
        # rho = sqrt(normalized toroidal flux); EQDSK spline magnetics with
        # a Q profile only (deposition_profiles_m.f90:479-499)
        from rays_tpu_torch.models import axisym_toroid as at

        return on_points(lambda r: at.rho_and_grad(cfg.eq_static, params.eq, r)[0])
    if which == "Ptotal_AphiN" and model == "multiple_mirror":
        from rays_tpu_torch.models import multiple_mirror as mm

        return on_points(lambda r: mm.magnetics(params.eq, r)[2])
    raise ValueError(f"{which} not available for {model}")


def calculate_deposition_profile(cfg, params, results, which: str,
                                 n_bins: int = 50, xmin=0.0, xmax=1.0):
    """Binned power deposition summed over rays
    (deposition_profiles_m.f90:229-293)."""
    if cfg.damping_slot < 0:
        raise ValueError("deposition profiles need a damping model")
    coord = _coordinate_fn(cfg, params, which)
    slot = cfg.damping_slot

    ray_vec = results.ray_vec           # (B, n_pts, nv)
    npoints = results.npoints           # (B,)
    pwr = results.initial_ray_power     # (B,)
    B, n_pts = ray_vec.shape[0], ray_vec.shape[1]

    with spans.span("rays.post.deposition", ray_vec.device):
        valid = torch.arange(n_pts, device=ray_vec.device) < npoints[:, None]
        last = (npoints.to(torch.int64) - 1)[:, None]
        xs = coord(ray_vec[..., 0:3])
        Q = pwr[:, None] * ray_vec[..., slot]
        # freeze beyond the last valid point: constant Q, constant x -> dQ = 0
        xs = torch.where(valid, xs, xs.gather(1, last))
        Q = torch.where(valid, Q, Q.gather(1, last))

        def bin_rays(q, x):
            return binning.bin_to_uniform_grid(q, x, xmin, xmax, n_bins).sum(0)

        grad = torch.is_grad_enabled() and (Q.requires_grad or xs.requires_grad)
        backward = _BackwardSpan(ray_vec.device) if grad and spans.on() else None
        if backward is not None:
            Q, xs = _GradientComplete.apply(backward, Q, xs)
        chunk = max(1, CHUNK_ELEMENTS // max(1, (n_pts - 1) * n_bins))
        total = None
        for i in range(0, B, chunk):
            q, x = Q[i:i + chunk], xs[i:i + chunk]
            part = (torch.utils.checkpoint.checkpoint(bin_rays, q, x, use_reentrant=False)
                    if grad else bin_rays(q, x))
            total = part if total is None else total + part
        if backward is not None:
            total = _GradientArrives.apply(backward, total)
    edges = torch.linspace(xmin, xmax, n_bins + 1, dtype=ray_vec.dtype,
                           device=ray_vec.device)
    return DepositionProfile(name=which, grid=edges, profile=total)


class _BackwardSpan:
    """The span ``rays.post.deposition.backward`` of one profile, opened by
    ``_GradientArrives`` and closed by ``_GradientComplete`` on the thread
    that runs the backward, with the forward's call id."""

    def __init__(self, device):
        self.device, self.call, self.open = device, spans.current_call(), None

    def enter(self):
        self.open = spans.span("rays.post.deposition.backward", self.device, self.call)
        self.open.__enter__()

    def exit(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


class _GradientArrives(torch.autograd.Function):
    """Identity on the profile; its backward opens the backward span."""

    @staticmethod
    def forward(ctx, backward, profile):
        ctx.backward = backward
        return profile.view_as(profile)

    @staticmethod
    def backward(ctx, grad):
        ctx.backward.enter()
        return None, grad


class _GradientComplete(torch.autograd.Function):
    """Identity on the binned power and coordinate; its backward, which
    runs once every chunk's gradient into them is summed, closes the
    backward span."""

    @staticmethod
    def forward(ctx, backward, q, x):
        ctx.backward = backward
        return q.view_as(q), x.view_as(x)

    @staticmethod
    def backward(ctx, grad_q, grad_x):
        ctx.backward.exit()
        return None, grad_q, grad_x


def _profiles(cfg, params, results, n_bins):
    """[(profile, grid_min, grid_max)] for every profile of the geometry."""
    out = []
    for nm in profile_names_for_geometry(cfg.equilib_model, cfg, params):
        if nm == "Ptotal_x":
            lo, hi = float(params.eq.xmin), float(params.eq.xmax)
        else:
            lo, hi = 0.0, 1.0
        out.append((calculate_deposition_profile(cfg, params, results, nm, n_bins,
                                                 lo, hi), lo, hi))
    return out


def _np(t):
    return t.detach().cpu().double().numpy()


def write_deposition_profiles_nc(cfg, params, results, n_bins: int = 50,
                                 path=None):
    """deposition_profiles.<label>.nc in the reference's schema
    (write_deposition_profiles_NC, deposition_profiles_m.f90:336-420):
    dims (n_profiles, n_bins, n_bins_p1, d20); per profile Q_sum,
    grid_min/max, 20-character profile_name/grid_name, the bin-edge grid
    and the binned profile; global attributes RAYS_run_label and
    date_vector."""
    import datetime

    import numpy as np
    from scipy.io import netcdf_file

    profs = _profiles(cfg, params, results, n_bins)
    fn = path or f"deposition_profiles.{cfg.run_label}.nc"
    now = datetime.datetime.now()
    f = netcdf_file(fn, "w")
    try:
        f.createDimension("n_profiles", len(profs))
        f.createDimension("n_bins", n_bins)
        f.createDimension("n_bins_p1", n_bins + 1)
        f.createDimension("d20", 20)
        f.createDimension("d8", 8)
        f.RAYS_run_label = cfg.run_label.encode()
        f.date_vector = np.array(
            [now.year, now.month, now.day, 0, now.hour, now.minute,
             now.second, 0], np.int32)

        def var(name, dtype, dims, data):
            v = f.createVariable(name, dtype, dims)
            v[:] = data
            return v

        def chars(strings):
            out = np.full((len(strings), 20), b" ", "S1")
            for i, s in enumerate(strings):
                b = s.encode()[:20]
                out[i, :len(b)] = np.frombuffer(b, "S1")
            return out

        var("Q_sum", np.float64, ("n_profiles",),
            [float(np.sum(_np(p.profile))) for p, _, _ in profs])
        var("grid_min", np.float64, ("n_profiles",), [lo for _, lo, _ in profs])
        var("grid_max", np.float64, ("n_profiles",), [hi for _, _, hi in profs])
        var("profile_name", "S1", ("n_profiles", "d20"),
            chars([p.name for p, _, _ in profs]))
        var("grid_name", "S1", ("n_profiles", "d20"),
            chars([_GRIDS[p.name] for p, _, _ in profs]))
        var("grid", np.float64, ("n_profiles", "n_bins_p1"),
            np.stack([_np(p.grid) for p, _, _ in profs]))
        var("profile", np.float64, ("n_profiles", "n_bins"),
            np.stack([_np(p.profile) for p, _, _ in profs]))
    finally:
        f.close()
    return fn


def write_deposition_profiles_ld(cfg, params, results, n_bins: int = 50,
                                 path=None):
    """deposition_profiles.<label> in the reference's list-directed layout
    (write_deposition_profiles_LD, deposition_profiles_m.f90:296-331): per
    profile a name line, the binned values, a grid-name line, the bin
    edges and the Q_sum total."""
    fn = path or f"deposition_profiles.{cfg.run_label}"
    with open(fn, "w") as f:
        for prof, _, _ in _profiles(cfg, params, results, n_bins):
            values = _np(prof.profile)
            f.write(f" profile_name = {prof.name}\n")
            f.write(" " + " ".join(f"{float(v):.17g}" for v in values) + "\n")
            f.write(f" grid_name = {_GRIDS[prof.name]}\n")
            f.write(" " + " ".join(f"{float(v):.17g}" for v in _np(prof.grid)) + "\n")
            f.write(" Ptotal_total_deposition\n")
            f.write(f" {float(values.sum()):.17g}\n")
    return fn


def profile_names_for_geometry(equilib_model: str, cfg=None, params=None):
    """Registry (deposition_profiles_m.f90:38-45).  Ptotal_rho joins the
    axisym_toroid list only when the magnetics backend defines rho (an
    EQDSK spline with a usable Q profile)."""
    if equilib_model == "slab":
        return ("Ptotal_x",)
    if equilib_model == "solovev":
        return ("Ptotal_psi",)
    if equilib_model == "axisym_toroid":
        names = ["Ptotal_psi"]
        if (cfg is not None and "eqdsk" in cfg.eq_static.magnetics_model
                and (params is None
                     or getattr(params.eq.mag, "rho_spline", None) is not None)):
            names.append("Ptotal_rho")
        return tuple(names)
    if equilib_model == "multiple_mirror":
        return ("Ptotal_AphiN",)
    return ()
