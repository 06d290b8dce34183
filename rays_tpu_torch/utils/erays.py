"""End-to-end pipeline: trace -> netCDF -> post-process -> plots -> run log
(``rays_tpu.utils.erays``).

The reference's RAYS_project/python_utilities/eRAYS.py runs RAYS, then
post_process_RAYS, then the plot scripts through subprocesses
(eRAYS.py:38-75); here the pipeline runs in one process.  The trace and
the post-processing run on ``device`` (the card unless the caller asks
for the CPU).  Plotting interoperates with the reference's committed
matplotlib scripts: run_results.<label>.nc has their netCDF schema, so
graphics_RAYS/plot_RAYS_*.py read it unchanged
(``plot_with_reference_scripts``, with this package's netCDF4 shim on
their path; ``RAYS_REFERENCE_GRAPHICS`` names their directory);
``plot_trajectories`` is a minimal built-in plot.
"""

from __future__ import annotations

import os
import subprocess
import sys

# the reference's graphics_RAYS directory, where a checkout of the
# reference exists beside this one (the JAX package reads it from a fixed
# path; here the environment names it)
REFERENCE_GRAPHICS = os.environ.get("RAYS_REFERENCE_GRAPHICS", "")


def run_pipeline(rays_in, post=True, netcdf=True, plots=False, log=True, device="cuda"):
    """Trace the namelist ``rays_in`` and write what the reference's eRAYS
    writes, in the working directory.  Returns a dict of what ran: cfg,
    results (on the CPU), wall, and the paths or outputs of "nc", "post",
    "plot" and "log"."""
    from rays_tpu_torch import run as runner
    from rays_tpu_torch.config.schema import from_file
    from rays_tpu_torch.core.types import tree_to
    from rays_tpu_torch.post.process import post_process
    from rays_tpu_torch.results.netcdf import write_results_nc

    diag = runner.make_diagnostics(rays_in) if log else None
    cfg, results, wall = runner.run(rays_in, device=device, diag=diag)
    out = {"cfg": cfg, "results": results, "wall": wall}
    if netcdf:
        out["nc"] = write_results_nc(
            cfg, results, total_trace_time=wall,
            ray_trace_time=runner.ray_trace_times(results, wall))
    if post:
        _, params = from_file(rays_in)
        out["post"] = post_process(cfg, tree_to(params, device), tree_to(results, device))
    if plots:
        out["plot"] = plot_trajectories(cfg, results)
    if diag is not None:
        out["log"] = diag.finalize()
    return out


def plot_trajectories(cfg, results, path=None):
    """Minimal built-in trajectory plot (x-z plane and residuals)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    rv = results.ray_vec.double().cpu().numpy()
    npts = results.npoints.cpu().numpy()
    resid = results.residual.double().cpu().numpy()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for i in range(rv.shape[0]):
        n = npts[i]
        ax1.plot(rv[i, :n, 0], rv[i, :n, 2], lw=1)
        ax2.semilogy(np.maximum(resid[i, :n], 1e-16), lw=1)
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("z [m]")
    ax1.set_title(f"ray trajectories ({cfg.run_label})")
    ax2.set_xlabel("step")
    ax2.set_ylabel("dispersion residual")
    fig.tight_layout()
    out = path or f"rays_{cfg.run_label}.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def run_reference_script(script, args=(), workdir="."):
    """Run one of the reference's committed graphics_RAYS scripts,
    unmodified, in ``workdir``.  This package's compat/ directory goes
    first on their PYTHONPATH, so its netCDF4 shim over scipy backs their
    ``import netCDF4`` where netCDF4-python is absent."""
    if not os.path.isdir(REFERENCE_GRAPHICS):
        raise FileNotFoundError(
            "the reference's graphics_RAYS directory is not there; name it in "
            f"RAYS_REFERENCE_GRAPHICS (now {REFERENCE_GRAPHICS!r})")
    env = dict(os.environ)
    compat = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "compat")
    env["PYTHONPATH"] = compat + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("MPLBACKEND", "Agg")
    return subprocess.run(
        [sys.executable, os.path.join(REFERENCE_GRAPHICS, script),
         *map(str, args)],
        cwd=workdir, capture_output=True, text=True, env=env)


def plot_with_reference_scripts(cfg, workdir="."):
    """The reference's geometry plotter on our netCDF output."""
    script = {
        "slab": "plot_RAYS_slab.py",
        "solovev": "plot_RAYS_solovev.py",
        "axisym_toroid": "plot_RAYS_axisym_toroid.py",
        "multiple_mirror": "plot_RAYS_mirror.py",
    }[cfg.equilib_model]
    return run_reference_script(script, workdir=workdir)
