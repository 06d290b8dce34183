"""rays_tpu_torch's scans (``utils/ray_scan.py`` and the tools
``tools/run_ds_scan.py``, ``tools/run_batch_scan.py``) against the JAX
package's ``utils/ray_scan.py``.

* ``scan_values``: the same schedule for every algorithm, exactly.
* ``ds_scan`` on the slab example at float64, 40 steps, over three step
  sizes: end_x within 1e-9 of the JAX rows' scale (the traces agree to
  rounding), max_residual and mean_end_residual within 1e-9 of theirs,
  which is 1 (the residual is normalized by the dispersion relation's
  terms, and a difference of rounding in those terms is ~1e-16 of it),
  min_npoints equal.
* ``write_scan_summary``: byte for byte the JAX writer's file on the same
  rows.
* ``batch_scan``: the JAX rows' keys and batch sizes.
* The ds-scan tool over its five rungs: RK4's measured order of
  convergence within 0.5 of 4 on the first three; the batch-scan tool
  writes its summaries.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.utils import ray_scan as jscan
from rays_tpu_torch import examples as tex
from rays_tpu_torch.utils import ray_scan as tscan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
ALGORITHMS = ["fixed_increment", "pwr_of_2", "integer_divide", "factor"]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_scan_values_match_jax(algorithm):
    rng = np.random.default_rng(3)
    for start, n, inc, fac in zip(rng.uniform(1e-3, 2.0, 4), (1, 2, 5, 9),
                                  (None, 0.25, None, 1.5), (2.0, 0.5, 3.0, 1.1)):
        got = tscan.scan_values(float(start), n, algorithm, increment=inc, factor=fac)
        assert got == jscan.scan_values(float(start), n, algorithm, increment=inc, factor=fac)
    with pytest.raises(ValueError, match="unknown scan algorithm"):
        tscan.scan_values(1.0, 2, "nope")


@pytest.fixture(scope="module")
def ds_rows():
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=40, save_trajectory=False)
    ds0 = float(params.ode.ds)
    ds_values = [ds0, ds0 / 2, ds0 / 4]
    jrows = jscan.ds_scan(cfg, params, v0, st, pwr, ds_values)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    return jrows, tscan.ds_scan(pcfg, pp, tv0, tst, tpw, ds_values)


def test_ds_scan_rows_match_jax(ds_rows):
    jrows, trows = ds_rows
    assert len(trows) == len(jrows) == 3
    for g, r in zip(trows, jrows):
        assert list(g) == list(r)
        assert g["ds"] == r["ds"] and g["min_npoints"] == r["min_npoints"] == 41
        assert isinstance(g["wall_s"], float) and g["wall_s"] > 0
        for k in ("max_residual", "mean_end_residual"):
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=TOL, err_msg=k)
        assert isinstance(g["end_x"], np.ndarray) and g["end_x"].shape == r["end_x"].shape
        scale = np.abs(r["end_x"]).max()
        np.testing.assert_allclose(g["end_x"], r["end_x"], rtol=0, atol=TOL * scale)


def test_write_scan_summary_byte_equal(ds_rows, tmp_path):
    _, trows = ds_rows
    got = tscan.write_scan_summary(trows, str(tmp_path / "port.txt"))
    ref = jscan.write_scan_summary(trows, str(tmp_path / "jax.txt"))
    with open(got, "rb") as g, open(ref, "rb") as r:
        text = g.read()
        assert text == r.read()
    assert text.decode().splitlines()[0].split() == [
        "ds", "wall_s", "max_residual", "mean_end_residual", "min_npoints"]


def test_batch_scan_rows(tmp_path):
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=5, save_trajectory=False)
    sizes = [2, 5]
    jrows = jscan.batch_scan(cfg, params, v0, st, pwr, sizes)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    trows = tscan.batch_scan(pcfg, pp, tv0, tst, tpw, sizes)
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    assert [r["batch"] for r in trows] == [r["batch"] for r in jrows] == sizes
    for r in trows:
        assert r["rays_per_s"] == pytest.approx(r["batch"] / r["wall_s"])


def _tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ds_scan_tool_rk4_order(tmp_path):
    tool = _tool("run_ds_scan")
    assert tool.ladder(1.0) == [(1.0 / 2**i, 60 * 2**i) for i in range(5)]
    logged = []
    rows, orders, launches = tool.run("cpu", ("RK4_ODE",), log=logged.append)
    assert [r["nstep"] for r in rows] == [60, 120, 240, 480, 960]
    assert [r["min_npoints"] for r in rows] == [61, 121, 241, 481, 961]
    assert len(orders["RK4_ODE"]) == 3 and all(abs(o - 4.0) < 0.5 for o in orders["RK4_ODE"])
    assert launches == {"RK4_ODE": 0}   # the CPU runs the plain tracer
    assert rows[-1]["err_vs_finest"] == 0.0 and rows[0]["err_vs_finest"] > rows[1]["err_vs_finest"]
    path = tool.write_summary(rows, str(tmp_path / "ds.txt"))
    lines = open(path).read().splitlines()
    assert lines[0].split() == tool.KEYS and len(lines) == 6
    assert lines[1].split()[0] == "RK4_ODE"


def test_batch_scan_tool_writes_its_summaries(tmp_path, capsys):
    tool = _tool("run_batch_scan")
    assert tool.SIZES[-1] == 524288 and tool.SIZES[0] == 256
    assert tool.main(["--device", "cpu", "--sizes", "3", "--out", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "f32 batch       3:" in out and "f64 batch       3:" in out
    for name in ("f32", "f64"):
        lines = open(tmp_path / f"b_{name}.txt").read().splitlines()
        assert lines[0].split() == ["batch", "wall_s", "rays_per_s"] and len(lines) == 2


def test_ds_scan_takes_the_params_dtype_and_device():
    """The scan's ds goes in as a tensor of the Params' own dtype."""
    cfg, params, v0, st, pwr = tex.setup_example(device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(cfg, nstep_max=3, save_trajectory=False)
    rows = tscan.ds_scan(cfg, params, v0, st, pwr, [1e-11])
    assert rows[0]["ds"] == 1e-11 and rows[0]["min_npoints"] == 4
    assert rows[0]["end_x"].dtype == np.float64
