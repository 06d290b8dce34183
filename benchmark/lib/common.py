"""What every part of the benchmark shares: where its files are, how a
cell, a configuration, a traffic mix, a driver and a metric reader are
found by name, and the inputs a seed makes.

The harness is driven by data.  ``BENCHMARK.json`` at the root of the
checkout names the cells; each name leads to files of its own:

    benchmark/workloads/<cell>.json     the cell: config, traffic, driver,
                                        warm-up, traced calls, limits
    benchmark/configs/<config>.json     the deployment, with its namelist
                                        copy beside it (``namelist`` key)
    benchmark/traffic/<traffic>.json    rays, the fan's scan, steps, trajectories
    benchmark/drivers/<driver>.py       one per kind of call the window drives
    benchmark/metrics/<metric>.py       one reader per per-layer metric
    benchmark/counts/<name>.json        frozen work counts

so a new cell, configuration, mix or metric is a new file and a new entry,
never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def read_json(path):
    return json.loads(Path(path).read_text())


def _named(kind, name, suffix):
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r}: {path.relative_to(ROOT)} is missing")
    return path


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name):
        entries = {w["name"]: w for w in manifest()["workloads"]}
        if name not in entries:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        self.name = name
        self.entry = entries[name]
        self.spec = read_json(_named("workloads", name, ".json"))
        self.config = read_json(_named("configs", self.entry["config"], ".json"))
        self.namelist = (HERE / "configs" / self.config["namelist"]).read_text()
        self.traffic = read_json(_named("traffic", self.entry["traffic"], ".json"))
        self.driver = load_module(_named("drivers", self.spec["driver"], ".py"))
        self.chips = int(self.entry["chips"])

    def metrics(self, trace):
        """The (entry, reader module or None) of each metric this cell
        reports: its end-to-end metrics with ``trace`` 0, else its
        per-layer metrics."""
        m = manifest()
        rows = m["per_layer"] if trace else m["end_to_end"]
        out = []
        for row in rows:
            if "workloads" in row and self.name not in row["workloads"]:
                continue
            if not trace and row["name"] not in ("setup_s", self.driver.METRIC):
                continue
            reader = load_module(_named("metrics", row["name"], ".py")) if trace else None
            out.append((row, reader))
        return out


def count(name):
    """A frozen work count of ``benchmark/counts/``."""
    return read_json(_named("counts", name, ".json"))


def fan(traffic, seed):
    """The traffic's ray fan as namelist entries, ``{group: {key: value}}``.

    Each scan axis of the traffic is a count, start and step of the
    namelist (RAYS's own scan parameters, such as ``n_kz_launch``,
    ``rindex_z0`` and ``delta_rindex_z0``): ``n`` points over ``range``,
    a lattice shifted by a fraction of a cell drawn from ``seed``.  So
    every seed traces other rays over the same range, with the same count
    and spacing.  The capacity key (``nray_max``) is set to the ray count.
    Values are written with every digit, so that both namelist readers
    get the same doubles."""
    shift = np.random.default_rng([seed, 2]).random(len(traffic["scan"]))
    out = {}
    for axis, u in zip(traffic["scan"], shift):
        lo, hi = (float(x) for x in axis["range"])
        step = (hi - lo) / int(axis["n"])
        out.setdefault(axis["group"], {}).update(
            {axis["count"]: int(axis["n"]), axis["start"]: lo + float(u) * step,
             axis["step"]: step})
    cap = traffic["capacity"]
    out.setdefault(cap["group"], {})[cap["key"]] = int(traffic["rays"])
    return out


def sample_index(seed, n):
    """The call of the window whose answer is compared, drawn from the
    seed among the first ``n`` calls."""
    return int(np.random.default_rng([seed, 1]).integers(0, max(1, n)))
