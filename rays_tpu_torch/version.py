"""Package version (``rays_tpu.version``)."""

__version__ = "0.1.0"
