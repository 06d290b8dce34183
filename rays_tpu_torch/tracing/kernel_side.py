"""What the adjoint graph's hand-written kernels share: a side of one
``StaticAdjoint`` (tracing/graphed_adjoint.py, ``loop.kernels``), made by
the slab kernels (tracing/slab_vjp.py) and the EQDSK step
(tracing/eqdsk_step.py).

A side holds the Params values packed on the device (``pack``, at each
run's load, from views of the loop's static leaves), the launch
arguments of each of its pieces on the loop's static buffers, and
``PIECES``: the names of the loop's pieces that its kernels replace, each
a method of the side (one launch, and the step index's move).  So a
captured launch reads the values of each run and nothing is read on the
host.  ``launch`` counts a launch made outside a capture when it is made,
and one made into a capture in ``captured`` and again at each replay of
its graph (``replayed``, from ``graphed_adjoint._replay``), in the
counters of the side's module (``count``).  A failed launch raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

# the carry's buffers, in trace.initial_carry's order
CARRY = ("v", "f1", "st1", "hstate", "status", "nstep", "end_res", "max_res")
_INTS = ("st1", "status", "nstep")


def ptr(t):
    return None if t is None else t.data_ptr()


class KernelSide:
    """The base of a side: ``lib`` a bound library whose code can address
    the loop's tensors (the CUDA library, or the host build on the CPU),
    ``sources`` the packed vector's rows.  A subclass fills ``fn`` and
    ``args`` by piece and says how its launches are counted (``count``)."""

    PIECES = ()

    def __init__(self, lib, loop, sources):
        v = loop.carry[0]
        for name, t in zip(CARRY, loop.carry):
            want = torch.int32 if name in _INTS else v.dtype
            if t.dtype != want or not t.is_contiguous():
                raise ValueError(f"carry {name}: {t.dtype}, want a contiguous {want}")
        self.lib, self.ns, self.device, self.k = lib, loop.cfg.ns, v.device, loop.k
        self.sources = sources
        self.params = torch.zeros((sum(t.numel() for t in sources),), dtype=v.dtype,
                                  device=v.device)
        self.fn, self.args = {}, {}
        self.captured = collections.Counter()   # launches made into a capture, by piece

    def pack(self):
        """The Params values into the packed vector, from the loop's static
        leaves, on the device (no host read)."""
        torch.cat(self.sources, out=self.params)

    def launch(self, piece):
        """One launch of ``piece``'s kernel on the current stream."""
        stream = (torch.cuda.current_stream(self.device).cuda_stream
                  if self.device.type == "cuda" else None)
        rc = self.fn[piece](ctypes.addressof(self.args[piece]), self.ns, stream)
        if rc != 0:
            raise RuntimeError(f"{type(self).__name__} {piece} launch failed with error {rc}")
        if self.device.type != "cuda":
            return
        if torch.cuda.is_current_stream_capturing():
            self.captured[piece] += 1
        else:
            self.count(piece, 1)

    def replayed(self, piece):
        """Count the launches captured into a piece's graph, at its replay."""
        self.count(piece, self.captured[piece])

    def count(self, piece, n):
        raise NotImplementedError

    def step(self):
        """The carry into the stack at k and one whole outer step as one
        launch, then k stepped up."""
        self.launch("step")
        self.k.add_(1)

    def start_backward(self):
        """Before a reverse sweep."""

    def finish_backward(self, acc):
        """After a reverse sweep: anything the side holds apart into the
        leaves' accumulators ``acc``."""
