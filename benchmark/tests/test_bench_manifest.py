"""BENCHMARK.json parses, keeps to the contract's shape, and every name in
it leads to a file of its own."""

import json
import re

import pytest

from benchmark.lib import common

M = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    rows = M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]
    names = [r["name"] for r in rows]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({r["name"] for r in M[group]}) == len(M[group])
    metrics = [r["name"] for r in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(r["unit"]) for r in M["end_to_end"] + M["per_layer"])
    assert all(r["better"] in ("lower", "higher") for r in M["end_to_end"] + M["per_layer"])


def test_bounds_and_sources():
    e2e = {r["name"]: r for r in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= r["bound"] <= 0.25 for r in M["end_to_end"])
    assert all(r["source"] in ("host_clock", "device_trace") for r in M["end_to_end"])
    layers = {r["moves"] for r in M["per_layer"]}
    assert layers <= set(e2e)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found(cell):
    c = common.Cell(cell)
    assert c.chips in (1, 4)
    assert c.driver.METRIC in {r["name"] for r in M["end_to_end"]}
    assert c.spec["limits"], "a cell compares its answer against limits"
    e2e = [row["name"] for row, _ in c.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = c.metrics(True)
    assert per_layer and all(reader is not None and hasattr(reader, "read")
                             for _, reader in per_layer)
    for row, _ in per_layer:
        assert row["moves"] in e2e


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_config_files(config):
    row = next(c for c in M["configs"] if c["name"] == config)
    data = json.loads((common.ROOT / row["file"]).read_text())
    assert data["name"] == config
    assert (common.HERE / "configs" / data["namelist"]).is_file()
    assert data["reduced"] == row["reduced"]
    assert (common.HERE / "reference" / f"model_{data['reference_model']}.py").is_file()
    assert any(w["config"] == config for w in M["workloads"])
