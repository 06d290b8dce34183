"""Leveled run diagnostics/logging.

Copy of ``rays_tpu.utils.diagnostics`` (reference RAYS_lib/diagnostics_m.f90): a
single logging front end with a verbosity threshold (messages print when
threshold <= verbosity), optional stdout mirroring, and a message file
renamed to ``log.RAYS.<run_label>`` at finalize (finalize_run.f90:50).
Every parsed namelist group can be echoed for config provenance
(diagnostics_m.f90 behavior of writing each namelist back to the log).
"""

from __future__ import annotations

import os
import time


class Diagnostics:
    def __init__(self, run_label="run", verbosity=0, messages_to_stdout=False,
                 message_file="messages"):
        self.run_label = run_label
        self.verbosity = verbosity
        self.messages_to_stdout = messages_to_stdout
        self.message_file = message_file
        self._fh = open(message_file, "w")
        self._t0 = time.time()

    def message(self, text, value=None, threshold=1):
        if threshold > self.verbosity:
            return
        line = f" {text}" if value is None else f" {text} = {value}"
        self._fh.write(line + "\n")
        if self.messages_to_stdout:
            print(line)

    def echo_namelists(self, nml: dict):
        """Config provenance: write every parsed group back to the log."""
        if self.verbosity < 0:
            return
        for group, entries in nml.items():
            self._fh.write(f" &{group}\n")
            for k, v in entries.items():
                self._fh.write(f"  {k} = {v!r}\n")
            self._fh.write(" /\n")

    def finalize(self):
        wall = time.time() - self._t0
        self.message("Wall time total (s)", round(wall, 3), threshold=0)
        self._fh.close()
        target = f"log.RAYS.{self.run_label}"
        os.replace(self.message_file, target)
        return target
