"""Build the port's hand-written kernels from ``csrc/`` into shared
libraries with a plain C interface, for loading with ``ctypes``.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name keyed by a hash of its
sources and its compiler command, so a changed source or flag rebuilds and
an unchanged one is reused.  The compiler's output is kept beside the
library (``.log``): for nvcc it holds the ``-Xptxas -v`` register report.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"


def build(name, files, command):
    """Build ``lib<name>_<hash>.so`` unless it exists.

    ``files`` are every source and header the library depends on (paths in
    ``CSRC``); ``command(out)`` returns the compiler argv that writes the
    library to ``out`` and runs in ``CSRC``.  Returns (library path,
    compiler output).  Raises RuntimeError when the compiler fails."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(repr(command(Path("<out>"))).encode())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return out, log.read_text()

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    argv = command(tmp)
    proc = subprocess.run(argv, cwd=CSRC, capture_output=True, text=True, check=False)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed: {' '.join(argv)} exited "
            f"{proc.returncode}\n{text}")
    # publish atomically: concurrent builds of the same hash race benignly
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(text)
    os.replace(tmp, out)
    os.replace(tmp_log, log)
    return out, text
