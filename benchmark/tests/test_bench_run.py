"""The run command: it refuses to run without a card, it checks that
neither JAX nor the JAX package was loaded (top-level names compared
whole), and on the card it runs every cell (marked ``card``)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.lib import common


def _run(args, cwd=common.ROOT, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    p = _run(["--workload", "slab_ech.scan", "--seed", "1", "--seconds", "1", "--trace", "0"],
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "slab_ech.scan", "--seed", "1", "--seconds", "1", "--trace", "0"],
             cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rays_tpu_torchish", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rays_tpu.tracing", object())
    assert run.forbidden_modules() == ["rays_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, torch; torch.set_num_threads(2); sys.path.insert(0, '.');"
            "from benchmark import run\n"
            "from benchmark.tests.sizes import shrink\n"
            "r = run.run_cell('slab_ech.scan', 3, 0.1, False, 'cpu', "
            "adjust=lambda c: shrink(c, (2, 2), 20), "
            "log=lambda s: None)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "rays_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "rays_tpu"}


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in common.manifest()["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _run(["--workload", cell, "--seed", "2147483659", "--seconds", "2", "--trace", "0"])
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
