"""rays_tpu_torch — the PyTorch and CUDA port of ``rays_tpu``.

Cold-plasma RF geometrical-optics ray tracing on batched tensors.  The
layout mirrors ``rays_tpu`` module for module; the JAX package stays the
reference that every module here is tested against, and this package never
imports it (nor JAX).

Tensors carry the ray axis first: a batch of B rays has state ``v`` of shape
(B, nv).  float64 is the parity precision; float32 runs are for throughput
and are held to the float64 result.  On CPU tensors every function runs as
plain PyTorch.  On CUDA tensors the tracer runs the hand-written slab RK4
kernel in ``csrc/`` (see ``tracing/fused_slab.py``), and refuses configs
the kernel does not cover instead of running them elsewhere.
"""

from rays_tpu_torch import constants  # noqa: F401
from rays_tpu_torch.version import __version__  # noqa: F401
