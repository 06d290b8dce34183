"""The damped slab of the reference: the slab (slab_eq_m.f90:125-309) and
its simple-slab launch (simple_slab_ray_init_m.f90:119-182) of
``rays_plain``, traced by ``rays_damped`` with damp_fund_ECH's absorption
slots, as a configuration names them: ``"reference_model": "slab_damped"``.
The launch state has the damped width (``case.static["nv"]``, set by
``rays_damped.build_case``), its absorption slots 0."""

from benchmark.reference import rays_plain

builder = rays_plain.slab_fields_builder
launch = rays_plain.launch_slab
