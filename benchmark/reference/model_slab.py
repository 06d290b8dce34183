"""The slab of the reference (slab_eq_m.f90:125-309) and its simple-slab
launch (simple_slab_ray_init_m.f90:119-182), as a configuration names
them: ``"reference_model": "slab"``."""

from benchmark.reference import rays_plain

builder = rays_plain.slab_fields_builder
launch = rays_plain.launch_slab
