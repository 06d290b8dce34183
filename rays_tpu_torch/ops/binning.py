"""Uniform-grid binning of an extensive quantity along trajectories
(``rays_tpu.ops.binning``; reference bin_to_uniform_grid_m.f90), batched
over rays.

For each consecutive trajectory segment [x_{i-1}, x_i] the increment
dQ = Q_i - Q_{i-1} is spread over the bins the segment spans, in
proportion to the overlap in index space (bin_to_uniform_grid_m.f90:
80-148).  As in the JAX package, each segment's share of every bin is one
dense clipped interval overlap, a (B, n-1, n_bins) elementwise product
that autograd differentiates in Q and xQ; out-of-range parts fall out of
the clipped overlap, and a segment of zero extent puts its whole dQ into
the bin that contains it.
"""

from __future__ import annotations

import torch


def bin_to_uniform_grid(Q, xQ, xmin, xmax, n_bins: int):
    """Q, xQ: (B, n) cumulative quantity and its coordinate along each
    trajectory (a constant Q over a tail adds nothing).  Returns the binned
    Q, (B, n_bins)."""
    dx_bin = (xmax - xmin) / n_bins
    ix = (xQ - xmin) / dx_bin                             # index-space coords
    ix_lo = torch.minimum(ix[:, :-1], ix[:, 1:])          # (B, n-1)
    ix_hi = torch.maximum(ix[:, :-1], ix[:, 1:])
    dQ = Q[:, 1:] - Q[:, :-1]
    d_ix = ix_hi - ix_lo

    edges = torch.arange(n_bins + 1, dtype=Q.dtype, device=Q.device)  # bin b: [b, b+1)
    lo = torch.maximum(ix_lo[..., None], edges[:-1])
    hi = torch.minimum(ix_hi[..., None], edges[1:])
    overlap = (hi - lo).clamp_min(0.0)                    # (B, n-1, n_bins)

    wide = d_ix > 1e-12
    safe_dix = torch.where(wide, d_ix, torch.ones_like(d_ix))
    frac_wide = overlap / safe_dix[..., None]

    # zero-extent segment: all dQ into the containing bin (if in range)
    ibin = torch.floor(ix_lo).to(torch.int64).clamp(0, n_bins - 1)
    in_range = (ix_lo >= 0.0) & (ix_lo <= n_bins)
    bins = torch.arange(n_bins, device=Q.device)
    one_hot = (bins == ibin[..., None]) & in_range[..., None]

    frac = torch.where(wide[..., None], frac_wide, one_hot.to(Q.dtype))
    return (dQ[..., None] * frac).sum(-2)
