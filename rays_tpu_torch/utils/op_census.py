"""Census of the aten operations that plain PyTorch code issues: the
counterpart, for the port's eager paths, of the jaxpr census in
``scripts/vpu_roofline.py`` (which counted the primitives of the JAX
package's compiled step body by class).

A ``TorchDispatchMode`` sees every operation below autograd, as the
backend receives it, and records its aten name, its class and the
elements it writes.  What it gives:

* aten operations: the calls that reach a backend.  On a CUDA device each
  launches (about) one kernel, so their number per outer step is the
  host-independent "kernels per step" of a path without a kernel;
* elements written per ray, by class (``CLASSES``): the work of those
  operations, counted over the outputs whose first axis is the ray batch;
  an operation on tensors without that axis (a step counter, a scalar
  parameter) counts as an operation and writes no element per ray;
* views and metadata (``aten.view``, ``expand``, ``select``, ``detach``,
  ``empty``, ...) apart: they launch no kernel; reads of a device value by
  the host (``aten._local_scalar_dense``, behind ``.item()`` and
  ``bool(tensor)``) apart again: each waits for the device.

``step_census`` takes the census of one outer step of ``trace_batch`` as
the difference of runs of k + 1 and k steps.  The census runs on any
device; the tests hold it on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CLASSES = ("add", "mul", "div", "sqrt", "exp", "log", "pow", "compare", "select",
           "reduce", "copy", "other")

_NAMES = {
    "add": ("add", "sub", "rsub", "neg", "abs", "sign", "maximum", "minimum", "clamp",
            "clamp_min", "clamp_max", "floor", "ceil", "trunc", "round", "frac",
            "remainder", "fmod", "copysign", "lerp", "hypot"),
    "mul": ("mul", "addcmul", "linalg_cross"),
    "div": ("div", "reciprocal", "addcdiv"),
    "sqrt": ("sqrt", "rsqrt"),
    "exp": ("exp", "exp2", "expm1", "sigmoid", "tanh", "sin", "cos", "tan", "atan",
            "atan2", "asin", "acos", "sinh", "cosh", "erf", "erfc"),
    "log": ("log", "log2", "log10", "log1p"),
    "pow": ("pow", "square"),
    "compare": ("eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
                "logical_not", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not",
                "bitwise_xor", "isnan", "isinf", "isfinite"),
    "select": ("where", "masked_fill"),
    "reduce": ("sum", "mean", "prod", "amax", "amin", "max", "min", "any", "all", "bmm",
               "mm", "mv", "dot", "addmm", "baddbmm", "linalg_vector_norm", "cumsum",
               "argmax", "argmin", "sort", "searchsorted"),
    "copy": ("copy", "clone", "_to_copy", "cat", "stack", "zeros", "ones", "full",
             "zeros_like", "ones_like", "full_like", "fill", "index", "index_select",
             "gather", "scatter", "scatter_add", "index_put", "index_add", "repeat",
             "arange", "linspace", "eye", "scalar_tensor", "tensor", "_unsafe_index",
             "constant_pad_nd"),
}
CLASS_OF = {name: cls for cls, names in _NAMES.items() for name in names}

# operations that neither compute nor launch: allocation and metadata
_METADATA = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
             "lift_fresh", "_has_compatible_shallow_copy_type", "resize_", "set_",
             "_unsafe_view")
HOST_READ = "_local_scalar_dense"


def op_name(func) -> str:
    """The aten name of an overload without its in-place underscore:
    ``aten.add_.Tensor`` -> ``add``."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


@dataclasses.dataclass
class Census:
    """What one run issued.  ``ops`` and ``elements`` are by aten name
    (elements: those written per ray); ``views`` counts views and
    metadata by name; ``host_reads`` the device values read by the host;
    ``n_rays`` the batch it was taken at."""

    n_rays: int
    ops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    elements: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    views: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    host_reads: int = 0

    @property
    def n_ops(self) -> int:
        """aten operations that reach a backend (a kernel each on a card)."""
        return sum(self.ops.values())

    @property
    def n_views(self) -> int:
        return sum(self.views.values())

    def by_class(self):
        """{class: (operations, elements written per ray)} over CLASSES."""
        out = {c: [0, 0.0] for c in CLASSES}
        for name, n in self.ops.items():
            row = out[CLASS_OF.get(name, "other")]
            row[0] += n
            row[1] += self.elements[name]
        return {c: (n, e) for c, (n, e) in out.items()}

    def __sub__(self, other):
        """The operations of this run beyond those of ``other`` (entries
        may go negative where the runs took different branches)."""
        def diff(a, b):
            return collections.Counter({k: a[k] - b[k] for k in set(a) | set(b)
                                        if a[k] != b[k]})

        return Census(self.n_rays, diff(self.ops, other.ops),
                      diff(self.elements, other.elements), diff(self.views, other.views),
                      self.host_reads - other.host_reads)


class OpCensus(TorchDispatchMode):
    """Record every aten operation issued inside ``with OpCensus(n_rays)
    as c:`` into ``c.census``.  The operations still run."""

    def __init__(self, n_rays: int):
        super().__init__()
        self.census = Census(n_rays)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = op_name(func)
        c = self.census
        if name == HOST_READ:
            c.host_reads += 1
        elif func.is_view or name in _METADATA:
            c.views[name] += 1
        else:
            c.ops[name] += 1
            per_ray = sum(t.numel() for t in _tensors(out)
                          if t.dim() > 0 and t.shape[0] == c.n_rays) / c.n_rays
            if per_ray:
                c.elements[name] += per_ray
        return out


def census(fn, n_rays: int) -> Census:
    """Run ``fn()`` under the census; the Census of what it issued."""
    with OpCensus(n_rays) as mode:
        fn()
    return mode.census


def step_census(cfg, params, v0, status0, pwr_wt, k: int = 1) -> Census:
    """The census of one outer step of ``trace_batch``: the run of k + 1
    steps less the run of k steps, summaries only, on the tensors' own
    device."""
    from rays_tpu_torch.tracing.trace import trace_batch

    def run(n):
        c = dataclasses.replace(cfg, nstep_max=n, save_trajectory=False)
        return census(lambda: trace_batch(c, params, v0, status0, pwr_wt), v0.shape[0])

    return run(k + 1) - run(k)
