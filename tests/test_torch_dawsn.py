"""The kernel's Dawson sum (csrc/slab_rk4.cuh::dawsn, built by g++ through
csrc/host_shim.cpp): it stops at the first term that cannot change the sum,
and must equal the sum of all 84 terms in the same order bit for bit, in
float64 and float32, and scipy's Dawson integral to 1e-14 (float64; the
84-term formula itself is good to ~1e-17, the rest is rounding of a sum of
up to 84 terms of order 1)."""

import ctypes
import shutil

import numpy as np
import pytest
import scipy.special
import torch

from rays_tpu_torch.ops import zfun
from rays_tpu_torch.tracing import fused_slab as tfused


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel body needs it")
    return tfused.load_host_libraries()[1]


def _grid(dtype):
    """[-6, 6]: 0, the smallest arguments, the mask's and the clip's edges,
    a regular grid and 1,000 seeded points."""
    rng = np.random.default_rng(7)
    special = [0.0, 1e-30, -1e-30, 5.0, -5.0, 6.0, -6.0, 0.25, -0.25, 1.2, -17.6 / 3]
    if dtype == np.float64:
        special += [1e-300, -1e-300]
    return np.concatenate([np.array(special), np.linspace(-6.0, 6.0, 481),
                           rng.uniform(-6.0, 6.0, 1000)]).astype(dtype)


def _dawsn(lib, x, full):
    suffix, ctype = (("f64", ctypes.c_double) if x.dtype == np.float64
                     else ("f32", ctypes.c_float))
    fn = getattr(lib, f"rays_dawsn_{suffix}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    fn.restype = None
    out = np.empty_like(x)
    fn(x.ctypes.data, out.ctypes.data, x.size, int(full))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_truncated_sum_equals_all_84_terms_bit_for_bit(host_lib, dtype):
    x = _grid(dtype)
    cut, full = _dawsn(host_lib, x, full=False), _dawsn(host_lib, x, full=True)
    assert np.isfinite(full).all()
    np.testing.assert_array_equal(cut.view(np.uint64 if dtype == np.float64 else np.uint32),
                                  full.view(np.uint64 if dtype == np.float64 else np.uint32))
    # odd, and exactly zero at zero
    assert (x == 0).any() and not cut[x == 0].any()
    np.testing.assert_array_equal(_dawsn(host_lib, -x, full=False), -cut)


def test_f64_sum_matches_scipy_and_the_plain_version(host_lib):
    x = _grid(np.float64)
    got = _dawsn(host_lib, x, full=False)
    np.testing.assert_allclose(got, scipy.special.dawsn(x), rtol=0, atol=1e-14)
    np.testing.assert_allclose(got, zfun.dawsn(torch.from_numpy(x)).numpy(), rtol=0, atol=1e-14)


def test_f32_sum_matches_scipy(host_lib):
    """float32: 84 terms of order 1 summed in float32."""
    x = _grid(np.float32)
    got = _dawsn(host_lib, x, full=False).astype(np.float64)
    np.testing.assert_allclose(got, scipy.special.dawsn(x.astype(np.float64)), rtol=0, atol=5e-7)


def test_sum_passes_nan_through(host_lib):
    for dtype in (np.float64, np.float32):
        assert np.isnan(_dawsn(host_lib, np.array([np.nan], dtype), full=False)).all()
