"""Complete elliptic integrals K(m), E(m) (``rays_tpu.ops.elliptic``;
reference math_functions_lib/complete_elliptic_int_m.f90, used by the
mirror coil fields, mirror_magnetics_lib/B_loop_m.f90).

Computed by the arithmetic-geometric mean: a fixed 12-pass AGM reaches
machine precision for m in [0, 1) and is branch-free and differentiable.
Convention: parameter m = k^2 (K(m) = F(pi/2 | m))."""

import math

import torch

_N_AGM = 12


def ellipk_ellipe(m):
    """(K(m), E(m)) for parameter m in [0, 1), elementwise."""
    m = torch.as_tensor(m)
    a = torch.ones_like(m)
    b = torch.sqrt((1.0 - m).clamp_min(1e-30))
    s = 0.5 * m  # c0^2 * 2^{-1} with c0^2 = m, coefficient 2^{n-1}
    pw = 1.0
    for _ in range(_N_AGM):
        a, b, cn = 0.5 * (a + b), torch.sqrt(a * b), 0.5 * (a - b)
        s = s + pw * cn**2
        pw = 2.0 * pw
    K = math.pi / (2.0 * a)
    return K, K * (1.0 - s)


def ellipk(m):
    return ellipk_ellipe(m)[0]


def ellipe(m):
    return ellipk_ellipe(m)[1]
