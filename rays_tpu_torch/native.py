"""Build the port's hand-written kernels from ``csrc/`` into shared
libraries with a plain C interface, for loading with ``ctypes``.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name keyed by a hash of its
sources and its compiler command, so a changed source or flag rebuilds and
an unchanged one is reused.  Libraries asked for together build side by
side, one compiler process each, all started at once.  The compiler's
output is kept beside the library (``.log``): for nvcc it holds the
``-Xptxas -v`` register report.  ``nvcc`` and ``gxx`` find the compilers,
``NVCC_FLAGS`` and ``HOST_FLAGS`` are the flags every kernel library and
every host build of a kernel body shares, and ``occupancy`` reads what the
CUDA runtime grants a built kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# Hopper (sm_90a) shared libraries with the ptxas register report
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the host builds of the kernel bodies: no contraction into fused
# multiply-adds, so their arithmetic is the plain code's, operation by operation
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")


def nvcc():
    """The CUDA compiler's path; raises RuntimeError where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def gxx():
    """The host C++ compiler's path; raises RuntimeError where there is none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host builds of the kernel bodies need it")
    return found


def occupancy(query, *args):
    """What the CUDA runtime grants one kernel instantiation, through a
    library's query ``query(*args, int out[4])`` (int arguments; it writes
    threads per block, blocks per SM, registers, local bytes per thread and
    returns a CUDA error code): {threads, blocks_per_sm, warps_per_sm,
    registers, local_bytes}."""
    out = (ctypes.c_int * 4)()
    query.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    query.restype = ctypes.c_int
    rc = query(*args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{query.__name__} failed with CUDA error {rc}")
    threads, blocks, regs, local = out
    return {"threads": threads, "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "registers": regs, "local_bytes": local}


def _target(name, files, command):
    """(library path, log path) of a build, keyed by its inputs."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(repr(command(Path("<out>"))).encode())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    return out, out.with_suffix(".log")


def build_all(specs):
    """Build each ``(name, files, command)`` of ``specs`` unless it exists:
    ``lib<name>_<hash>.so``.

    ``files`` are every source and header the library depends on (paths in
    ``CSRC``); ``command(out)`` returns the compiler argv that writes the
    library to ``out`` and runs in ``CSRC``.  The missing libraries compile
    concurrently, and every compiler has exited before this returns or
    raises.  Returns [(library path, compiler output)] in the order of
    ``specs``.  Raises RuntimeError when a compiler fails."""
    results, running = [], []
    for name, files, command in specs:
        out, log = _target(name, files, command)
        results.append([out, None])
        if out.exists() and log.exists():
            results[-1][1] = log.read_text()
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        argv = command(tmp)
        proc = subprocess.Popen(argv, cwd=CSRC, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((len(results) - 1, name, argv, proc, tmp, out, log))

    failures = []
    for i, name, argv, proc, tmp, out, log in running:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failures.append(f"building {name} failed: {' '.join(argv)} exited "
                            f"{proc.returncode}\n{text}")
            continue
        # publish atomically: concurrent builds of the same hash race benignly
        tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
        tmp_log.write_text(text)
        os.replace(tmp, out)
        os.replace(tmp_log, log)
        results[i][1] = text
    if failures:
        raise RuntimeError("\n".join(failures))
    return [tuple(r) for r in results]

