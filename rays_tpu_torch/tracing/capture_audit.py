"""What a piece of the captured tracers issues, seen by running it eagerly
under two modes: the host reads, the copies across devices and the
library products (``PieceAudit``, a dispatch mode), and the autograd nodes
of the tensors made inside (``BackwardAudit``, a function mode).

A CUDA graph replays device work only: a host read inside a piece (a
``.item()``, a ``nonzero``) breaks its capture or would be frozen into it,
and so would an autograd node whose backward formula reads the host when
the piece runs a backward pass.  The tests audit every built-in
configuration's pieces; ``require_capturable`` audits a model of the
caller's own (``models.base.register_eq_model``) before its first
capture, since the port cannot read the caller's code.
"""

from __future__ import annotations

import collections

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

HOST_READS = {"_local_scalar_dense", "is_nonzero", "nonzero", "masked_select", "lift_fresh",
              "lift_fresh_copy", "item"}
PRODUCTS = {"mm", "bmm", "addmm", "matmul", "baddbmm", "mv", "dot", "addmv"}
# autograd nodes whose backward formula reads the host (PyTorch's
# FunctionsManual: prod and cumprod look for zero factors, the others have
# data-dependent shapes).  A dispatch mode cannot see those reads: under
# one, autograd takes the formulas' slower branch without them.
HOST_READING_BACKWARDS = {"ProdBackward0", "ProdBackward1", "CumprodBackward0",
                          "MaskedSelectBackward0", "RepeatInterleaveBackward0",
                          "MedianBackward0", "MedianBackward1", "KthvalueBackward0",
                          "NonzeroBackward0", "UniqueBackward0"}


class BackwardAudit(TorchFunctionMode):
    """Counts, by name, the autograd nodes of the tensors made inside it
    (the autodiff derivatives' backward pass runs inside a step)."""

    def __init__(self):
        super().__init__()
        self.nodes = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                self.nodes[type(t.grad_fn).__name__] += 1
        return out


class PieceAudit(TorchDispatchMode):
    """Counts, by aten name, the host reads, the copies across devices and
    the library products issued inside it."""

    def __init__(self):
        super().__init__()
        self.reads, self.products = collections.Counter(), collections.Counter()
        self.crossings = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if name in HOST_READS:
            self.reads[name] += 1
        if name in PRODUCTS:
            self.products[name] += 1
        if name == "copy_" and args[0].device != args[1].device:
            self.crossings.append((name, args[1].device, args[0].device))
        if name == "_to_copy" and kwargs.get("device") not in (None, args[0].device):
            self.crossings.append((name, args[0].device, kwargs["device"]))
        return func(*args, **kwargs)


def require_capturable(loop):
    """Run each piece of ``loop`` (a ``graphed.StaticLoop`` or one of its
    kinds, its buffers loaded) once eagerly under both audits, in the
    order of ``loop.functions()``, and raise ValueError naming the model,
    the piece and the operation if a piece reads the host, copies across
    devices or makes an autograd node whose backward reads the host.  The
    pieces step the static buffers, which the caller loads again."""
    model = loop.cfg.equilib_model
    for name, fn in loop.functions().items():
        audit, backward = PieceAudit(), BackwardAudit()
        with backward, audit:
            loop.with_own_stats(fn)
        found = [f"reads the host ({op})" for op in audit.reads]
        found += [f"copies from {src} to {dst} ({op})" for op, src, dst in audit.crossings]
        found += [f"makes the autograd node {node}, whose backward reads the host"
                  for node in sorted(set(backward.nodes) & HOST_READING_BACKWARDS)]
        if found:
            raise ValueError(f"equilib_model {model!r} cannot be captured as a CUDA graph: "
                             f"its piece {name!r} " + "; ".join(found))
