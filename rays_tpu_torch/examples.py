"""Built-in example configurations (``rays_tpu.examples``): copies of the
reference's committed example inputs, so tests, the CLI and
``chip_smoke.py`` need no external files.  ``SLAB_ECH_90GHZ`` mirrors
examples_RAYS/ECH_90GHz_slab/slab_ECH_90GHz_case_1.in; ``SOLOVEV_ECH_90GHZ``
is the Solovev tokamak ECH fan, traced with the adaptive stepper.  Those
namelist texts are identical to the JAX package's.

The spline geometries read data files, so their examples are written into
a directory by the port's own tools: ``write_eqdsk_toroid_example`` (a
Solovev G-EQDSK from ``utils/solovev_2_eqdsk`` and the namelist of the JAX
package's EQDSK bench row) and ``write_mirror_example`` (a field file from
``utils/mirror_magnetics.generate_field_file``, a namelist and a ray-init
file); ``run.setup`` or the CLI then takes the ``rays.in`` they return.
"""

import os

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

# the EQDSK tokamak: psi(R, Z) and R*Bphi(R) splined from a G-EQDSK file
EQDSK_TOROID_ECH_90GHZ = """
&diagnostics_list
 run_label='eqdsk_demo', integrate_eq_gradients=.false.
/
&species_list
 n0=8.0e19, spec_name(0)='electron', t0s(0)=1.0e3,
 spec_name(1)='deuterium', t0s(1)=1.0e2, eta(1)=1.
/
&rf_list
 frf=90.e9, k0_sign=1, wave_mode='minus', ray_dispersion_model='cold',
 ray_param='arcl', dispersion_resid_limit=0.1
/
&damping_list
 damping_model='no_damp'
/
&equilibrium_list
 equilib_model='axisym_toroid'
/
&axisym_toroid_eq_list
 magnetics_model='eqdsk_magnetics_spline_interp',
 plasma_psi_limit=1.0,
 density_prof_model='parabolic', alphan1=1.0, alphan2=2.0, d_scrape_off=0.05,
 temperature_prof_model=2*'zero'
/
&eqdsk_magnetics_spline_interp_list
 eqdsk_file_name='{EQDSK}'
/
&ray_init_list
 ray_init_model='axisym_toroid_ray_init_R_Z_nphi_ntheta', nray_max=20
/
&axisym_toroid_ray_init_R_Z_nphi_ntheta_list
 n_R_launch=1, R_launch0=1.5, n_Z_launch=1, Z_launch0=0.0,
 n_rindex_theta=2, rindex_theta0=0.0, delta_rindex_theta=0.2,
 n_rindex_phi=1, rindex_phi0=0.3
/
&ode_list
 ode_solver_name='RK4_ODE', nstep_max=500, ds=2.e-3, s_max=4.0
/
"""

# a four-coil mirror cell: ECH at the second harmonic (56 GHz, 0.8-0.9 T
# between the coils), tanh profiles in AphiN, rays read from a file
MIRROR_ECH_56GHZ = """
&diagnostics_list
 run_label='mirror_demo', integrate_eq_gradients=.false.
/
&species_list
 n0=2.0e19, spec_name(0)='electron', t0s(0)=200.,
 spec_name(1)='deuterium', t0s(1)=50., eta(1)=1.
/
&rf_list
 frf=56.e9, k0_sign=1, wave_mode='plus', ray_dispersion_model='cold',
 ray_param='arcl', dispersion_resid_limit=0.1
/
&damping_list
 damping_model='no_damp'
/
&equilibrium_list
 equilib_model='multiple_mirror'
/
&multiple_mirror_eq_list
 magnetics_model='mirror_magnetics_spline_interp', plasma_AphiN_limit=1.0,
 density_prof_model='hyperbolic', AphiN0_d=0.5, delta_d=0.15, d_scrape_off=0.05,
 temperature_prof_model=2*'hyperbolic', AphiN0_t=2*0.5, delta_t=2*0.2, t_scrape_off=0.02
/
&mirror_magnetics_spline_interp_list
 mirror_field_NC_file='Brz_fields.mirror_demo.nc'
/
&ray_init_list
 ray_init_model='file_input_ray_init', nray_max=20
/
&ode_list
 ode_solver_name='RK4_ODE', nstep_max=500, ds=2.e-3, s_max=4.0
/
"""

# six candidates (Fortran column-major 3 x n); the third starts outside the
# last uninterrupted flux surface and is dropped
MIRROR_RAY_INIT = """
&file_input_ray_init_list
 n_rays_in=6,
 rvec_in = 0.01,0.0,1.7,  0.0,0.02,1.8,  0.19,0.0,1.45,  -0.02,0.01,1.9,
           0.03,0.0,2.0,  0.0,0.0,1.6,
 rindex_vec_in = 0.05,0.0,1.0,  0.0,0.02,1.0,  0.2,0.0,1.0,  -0.05,0.02,1.0,
                 0.0,0.05,1.0,  0.02,0.0,1.0,
 ray_pwr_wt_in = 1.0, 2.0, 1.0, 0.5, 1.0, 1.0
/
"""

MIRROR_COILS = dict(coil_r=[0.3, 0.3, 0.3, 0.3], coil_z=[0.5, 1.5, 2.5, 3.5],
                    coil_current=[6.0e5, 4.0e5, 4.0e5, 6.0e5])


def write_eqdsk_toroid_example(directory, n=129, text=EQDSK_TOROID_ECH_90GHZ):
    """Write ``solovev.geqdsk`` (n x n, the Solovev equilibrium of
    ``SOLOVEV_ECH_90GHZ``) and ``rays.in`` into ``directory``; returns the
    path of ``rays.in``."""
    from rays_tpu_torch.utils import eqdsk_io, solovev_2_eqdsk

    geqdsk = os.path.join(str(directory), "solovev.geqdsk")
    eqdsk_io.write_geqdsk(geqdsk, solovev_2_eqdsk.solovev_geqdsk(
        rmaj=1.2, kappa=1.5, bphi0=2.2, iota0=0.3, outer_bound=1.55, nrbox=n, nzbox=n))
    path = os.path.join(str(directory), "rays.in")
    with open(path, "w") as f:
        f.write(text.format(EQDSK=geqdsk))
    return path


def write_mirror_example(directory, n_r=51, n_z=201, text=MIRROR_ECH_56GHZ):
    """Write the field file of ``MIRROR_COILS`` on an (n_r, n_z) grid, the
    ray-init file and ``rays.in`` into ``directory``; returns the path of
    ``rays.in``."""
    from rays_tpu_torch.utils import mirror_magnetics

    directory = str(directory)
    mirror_magnetics.generate_field_file(
        os.path.join(directory, "Brz_fields.mirror_demo.nc"), n_r=n_r, n_z=n_z,
        **MIRROR_COILS)
    with open(os.path.join(directory, "ray_init_mirror_demo.in"), "w") as f:
        f.write(MIRROR_RAY_INIT)
    path = os.path.join(directory, "rays.in")
    with open(path, "w") as f:
        f.write(text)
    return path


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
