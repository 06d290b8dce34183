"""Minimal netCDF4-python compatibility shim over scipy.io.netcdf_file.

The reference's committed plotters (graphics_RAYS/plot_RAYS_*.py) import
``netCDF4``, which may not be installed; our results files are
NetCDF3-classic, which scipy reads natively.  Prepending this directory
(rays_tpu_torch/compat) to sys.path lets those scripts run
unmodified against rays_tpu_torch output.  A copy of
``rays_tpu/compat/netCDF4.py``: the port keeps its own, as it imports
nothing of the JAX package.

Only the surface those scripts use is provided: Dataset(file, mode,
format=...), .dimensions, .variables[name] yielding array-like data
(np.ma.getdata(var) works on plain ndarrays), and global attributes.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file


class _Var:
    def __init__(self, var):
        self._var = var

    def __getitem__(self, idx):
        data = self._var[idx] if self._var.shape else self._var.getValue()
        arr = np.asarray(data)
        if arr.dtype.kind == "S" and arr.ndim == 1:
            # a row of a NetCDF3 char matrix: netCDF4-python hands scripts
            # bytes (str(var[i], 'utf-8') in P_profiles.py et al.)
            return arr.tobytes()
        return arr

    def __array__(self, dtype=None):
        arr = np.asarray(self._var[:] if self._var.shape else self._var.getValue())
        return arr.astype(dtype) if dtype else arr

    @property
    def shape(self):
        return self._var.shape

    @property
    def dimensions(self):
        return self._var.dimensions


class _Dim:
    """netCDF4 Dimension stand-in: len(dim) gives the size."""

    def __init__(self, name, size):
        self.name = name
        self.size = int(size)

    def __len__(self):
        return self.size

    def __repr__(self):
        return f"<dimension {self.name} = {self.size}>"


class Dataset:
    def __init__(self, filename, mode="r", format=None):  # noqa: A002
        self._f = netcdf_file(filename, mode, mmap=False)
        self.variables = {k: _Var(v) for k, v in self._f.variables.items()}
        self.dimensions = {
            k: _Dim(k, v) for k, v in self._f.dimensions.items()
        }

    def ncattrs(self):
        return [k for k in self._f._attributes]

    def getncattr(self, name):
        v = self._f._attributes[name]
        return v.decode() if isinstance(v, bytes) else v

    def __getattr__(self, name):
        try:
            v = self._f._attributes[name]
        except (AttributeError, KeyError):
            raise AttributeError(name) from None
        return v.decode() if isinstance(v, bytes) else v

    def close(self):
        self._f.close()
