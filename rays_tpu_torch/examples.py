"""Built-in example configurations (``rays_tpu.examples``): copies of the
reference's committed example inputs, so tests, the CLI and
``chip_smoke.py`` need no external files.  ``SLAB_ECH_90GHZ`` mirrors
examples_RAYS/ECH_90GHz_slab/slab_ECH_90GHz_case_1.in; ``SOLOVEV_ECH_90GHZ``
is the Solovev tokamak ECH fan, traced with the adaptive stepper.  The
namelist texts are identical to the JAX package's.
"""

import numpy as np
import torch

SLAB_ECH_90GHZ = """
&diagnostics_list
 verbosity=0,
 run_description='ECH in slab geometry 90Ghz'
 run_label='slab_demo'
 integrate_eq_gradients=.false.
/
&species_list
 n0=1.0e20,
 spec_name(0)='electron', spec_model(0)='cold', t0s(0)=5.0e3,
 spec_name(1)='deuterium', spec_model(1)='cold', t0s(1)=1.0e2, eta(1)=1.
/
&rf_list
 frf=90.e9, k0_sign=1, wave_mode='minus', ray_dispersion_model='cold',
 ray_param='time', dispersion_resid_limit=0.1
/
&damping_list
 damping_model='no_damp', multi_spec_damping=.false., total_damping_limit=0.99
/
&equilibrium_list
 equilib_model='slab'
/
&slab_eq_list
 bx_prof_model='zero', by_prof_model='constant', by0=0.0,
 bz_prof_model='constant', bz0=1.286, LBz_scale=1.125,
 dens_prof_model='linear', Ln_scale=0.714286,
 rmaj=1., rmin=.5, t_prof_model=2*'zero',
 xmin=-0.5, xmax=0.5, ymin=-0.5, ymax=0.5, zmin=-1., zmax=1.
/
&ray_init_list
 ray_init_model='simple_slab', nray_max=100
/
&simple_slab_ray_init_list
 n_x_launch=1, x_launch0=-0.08, dx_launch=0.4,
 n_z_launch=1, z_launch0=-0.6, dz_launch=0.,
 n_ky_launch=1, rindex_y0=0., delta_rindex_y0=.1,
 n_kz_launch=3, rindex_z0=0.4, delta_rindex_z0=0.1
/
&ode_list
 ode_solver_name='RK4_ODE', nstep_max=500, ds=5.e-11, s_max=1.0
/
&SG_ode_list
 rel_err0=1.e-4, abs_err0=1.e-4, SG_error_limit=0.1
/
"""

SOLOVEV_ECH_90GHZ = """
&diagnostics_list
 verbosity=0,
 run_description='ECH in Solovev model tokamak 90GHz'
 run_label='solovev_demo'
 integrate_eq_gradients=.false.
/
&species_list
 n0=8.0e19,
 spec_name(0)='electron', spec_model(0)='cold', t0s(0)=1.0e3,
 spec_name(1)='deuterium', spec_model(1)='cold', t0s(1)=1.0e2, eta(1)=1.
/
&rf_list
 frf=90.e9, k0_sign=1, wave_mode='minus', ray_dispersion_model='cold',
 ray_param='arcl', dispersion_resid_limit=0.1
/
&damping_list
 damping_model='no_damp'
/
&equilibrium_list
 equilib_model='solovev'
/
&solovev_eq_list
 rmaj=1.2, outer_bound=1.55, kappa=1.5, bphi0=2.2, iota0=0.3,
 dens_prof_model='parabolic', alphan1=1.0, alphan2=2.0,
 t_prof_model=2*'parabolic', alphat1=2*1.0, alphat2=2*2.0,
 box_rmin=0.2, box_rmax=2.5, box_zmin=-2.0, box_zmax=2.0
/
&ray_init_list
 ray_init_model='solovev_ray_init_nphi_ntheta', nray_max=100
/
&solovev_ray_init_nphi_ktheta_list
 n_r_launch=1, r_launch0=0.3, dr_launch=0.0,
 n_theta_launch=4, theta_launch0=0.0, dtheta_launch=0.7854,
 n_rindex_theta=2, rindex_theta0=0.0, delta_rindex_theta=0.2,
 n_rindex_phi=1, rindex_phi0=0.3, delta_rindex_phi=0.0
/
&ode_list
 ode_solver_name='SG_ODE', nstep_max=200, ds=2.e-3, s_max=4.0
/
&SG_ode_list
 rel_err0=1.e-7, abs_err0=1.e-7, SG_error_limit=0.1
/
"""


SLAB_ECH_DAMPED = """
&diagnostics_list
 verbosity=0,
 run_description='ECH slab with fundamental-ECH damping'
 run_label='slab_damped'
 integrate_eq_gradients=.false.
/
&species_list
 n0=5.0e19,
 spec_name(0)='electron', spec_model(0)='cold', t0s(0)=5.0e3,
 spec_name(1)='deuterium', spec_model(1)='cold', t0s(1)=1.0e3, eta(1)=1.
/
&rf_list
 frf=90.e9, k0_sign=1, wave_mode='minus', ray_dispersion_model='cold',
 ray_param='arcl', dispersion_resid_limit=0.1
/
&damping_list
 damping_model='damp_fund_ECH', multi_spec_damping=.true.,
 total_damping_limit=0.99
/
&equilibrium_list
 equilib_model='slab'
/
&slab_eq_list
 bx_prof_model='zero', by_prof_model='zero',
 bz_prof_model='linear', bz0=3.6, LBz_scale=-4.0,
 dens_prof_model='constant',
 rmaj=1., rmin=.5, t_prof_model=2*'constant',
 xmin=-0.5, xmax=0.5, ymin=-0.5, ymax=0.5, zmin=-1., zmax=1.
/
&ray_init_list
 ray_init_model='simple_slab', nray_max=100
/
&simple_slab_ray_init_list
 n_x_launch=1, x_launch0=-0.45,
 n_kz_launch=3, rindex_z0=0.1, delta_rindex_z0=0.1
/
&ode_list
 ode_solver_name='RK4_ODE', nstep_max=400, ds=2.5e-3, s_max=1.0
/
"""


def setup_example(text=SLAB_ECH_90GHZ, device="cuda", dtype=torch.float64):
    """Namelist text -> (cfg, params, v0, status0, pwr_wt) on ``device`` in
    ``dtype``.  Like ``run.setup`` it puts the run on the card unless asked
    for the CPU (``device="cpu"``), and raises where there is no CUDA
    device.  Ray init runs once on the CPU in float64, as in the JAX
    package, and its result is then cast and moved."""
    from rays_tpu_torch import run as runner
    from rays_tpu_torch.config import schema
    from rays_tpu_torch.config.namelist import parse_namelist

    cfg, params = schema.from_namelist(parse_namelist(text))
    return runner.setup_from(cfg, params, device, dtype)


def replicate_rays(v0, status0, pwr, n_total, jitter=1e-6):
    """Tile a small ray set up to n_total rays with tiny launch-point jitter
    in y, for throughput runs at production
    batch sizes.  The jitter is drawn with numpy from a fixed seed, so the
    rays equal the JAX package's ``replicate_rays`` rays."""
    B = v0.shape[0]
    reps = -(-n_total // B)
    v = np.tile(v0.cpu().double().numpy(), (reps, 1))[:n_total]
    rng = np.random.default_rng(0)
    v[:, 1] += jitter * rng.standard_normal(n_total)
    st = np.tile(status0.cpu().numpy(), reps)[:n_total]
    w = np.full((n_total,), 1.0 / n_total)
    return (torch.as_tensor(v).to(device=v0.device, dtype=v0.dtype),
            torch.as_tensor(st).to(device=status0.device),
            torch.as_tensor(w).to(device=pwr.device, dtype=pwr.dtype))
