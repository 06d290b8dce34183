"""rays_tpu_torch stands alone: it imports neither JAX nor the JAX package,
and without a CUDA device its CUDA paths raise instead of running on the
CPU."""

import os
import subprocess
import sys

import pytest
import torch

from rays_tpu_torch import examples, run as trun
from rays_tpu_torch.tracing import fused_slab
from rays_tpu_torch.tracing import trace as trace_mod
from rays_tpu_torch.tracing.trace import route, trace_rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("modules", [
    "rays_tpu_torch",
    "rays_tpu_torch.run, rays_tpu_torch.tracing.fused_slab",
    "rays_tpu_torch.convert, rays_tpu_torch.examples, rays_tpu_torch.native",
    "rays_tpu_torch.post.deposition, rays_tpu_torch.ops.binning, "
    "rays_tpu_torch.ops.zfun, rays_tpu_torch.wave.damping",
    "rays_tpu_torch.models.solovev, rays_tpu_torch.rayinit.solovev, "
    "rays_tpu_torch.tracing.rk45, rays_tpu_torch.results.ascii, "
    "rays_tpu_torch.utils.diagnostics",
    "rays_tpu_torch.models.axisym_toroid, rays_tpu_torch.models.multiple_mirror, "
    "rays_tpu_torch.ops.splines, rays_tpu_torch.ops.elliptic, "
    "rays_tpu_torch.utils.eqdsk_io, rays_tpu_torch.utils.solovev_2_eqdsk, "
    "rays_tpu_torch.utils.mirror_magnetics, rays_tpu_torch.rayinit.axisym_toroid, "
    "rays_tpu_torch.rayinit.one_ray, rays_tpu_torch.rayinit.file_input",
    "rays_tpu_torch.ops.bisect, rays_tpu_torch.ops.invert, rays_tpu_torch.ops.quadrature, "
    "rays_tpu_torch.ops.vectors, rays_tpu_torch.wave.stix, rays_tpu_torch.post.xy_curves, "
    "rays_tpu_torch.post.ray_diags, rays_tpu_torch.post.slab_processor, "
    "rays_tpu_torch.post.process, rays_tpu_torch.post.toroid_processor, "
    "rays_tpu_torch.post.ox_conversion, rays_tpu_torch.post.mirror_processor, "
    "rays_tpu_torch.post.grid",
    "rays_tpu_torch.compat.netCDF4, rays_tpu_torch.version, rays_tpu_torch.utils.ray_scan, "
    "rays_tpu_torch.utils.erays, rays_tpu_torch.utils.doc_modules, "
    "rays_tpu_torch.tracing.compensated, rays_tpu_torch.parallel.sharded, "
    "rays_tpu_torch.parallel.multihost, rays_tpu_torch.entry",
    "rays_tpu_torch.utils.op_census, rays_tpu_torch.utils.op_rates, "
    "rays_tpu_torch.utils.measure",
])
def test_import_pulls_in_no_jax(modules):
    code = (f"import sys, {modules}\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax')"
            " or m == 'rays_tpu' or m.startswith('rays_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


NEW_TOOLS = ["step_profile", "op_roofline", "precision_probe", "profile_mirror"]


@pytest.mark.parametrize("tool", ["run_ds_scan", "run_batch_scan", "validate_all",
                                  "inverse_demo", *NEW_TOOLS])
def test_tools_pull_in_no_jax(tool):
    """The port's tools, imported as modules by their paths, load neither
    JAX nor the JAX package."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('t', 'tools/{tool}.py')\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert callable(mod.main)\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax')"
            " or m == 'rays_tpu' or m.startswith('rays_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")


def test_cuda_inputs_raise_without_cuda():
    _no_cuda()
    with pytest.raises((RuntimeError, AssertionError)):
        examples.setup_example(examples.SLAB_ECH_90GHZ, device="cuda")


def test_setup_example_defaults_to_cuda_and_raises_without_it():
    """The library example's first call puts the run on the card, like the
    CLI; the CPU has to be asked for."""
    _no_cuda()
    with pytest.raises((RuntimeError, AssertionError)):
        examples.setup_example()
    with pytest.raises((RuntimeError, AssertionError)):
        examples.setup_example(examples.SLAB_ECH_DAMPED)
    cfg, params, v0, st, pwr = examples.setup_example(device="cpu")
    assert v0.device.type == "cpu" and params.rf.omgrf.device.type == "cpu"


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    _no_cuda()
    path = tmp_path / "slab.in"
    path.write_text(examples.SLAB_ECH_90GHZ)
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        trun.main([str(path), "--netcdf"])
    assert not list(tmp_path.glob("run_results.*"))


def test_post_processor_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    """``python -m rays_tpu_torch.post.process`` puts the results on the
    card unless told otherwise, and without one fails before it reads or
    writes a file."""
    from rays_tpu_torch.post import process as tpp

    _no_cuda()
    (tmp_path / "rays.in").write_text(examples.SLAB_ECH_90GHZ)
    monkeypatch.chdir(tmp_path)
    opened = []
    monkeypatch.setattr(tpp, "load_results_nc", lambda *a, **k: opened.append(a))
    with pytest.raises((RuntimeError, AssertionError)):
        tpp.main(["rays.in"])
    with pytest.raises((RuntimeError, AssertionError)):
        tpp.main(["rays.in", "--device", "cuda"])
    assert not opened and sorted(p.name for p in tmp_path.iterdir()) == ["rays.in"]


def test_non_cpu_tensors_never_run_the_plain_tracer():
    """Tensors off the CPU go to the kernel or raise; 'meta' stands in for
    a device the port has no path for."""
    cfg, params, v0, st, pwr = examples.setup_example(examples.SLAB_ECH_90GHZ, device="cpu")
    before = fused_slab.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        trace_rays(cfg, params, v0.to("meta"), st.to("meta"), pwr.to("meta"))
    assert fused_slab.LAUNCHES == before
    # and for this config, which the gate accepts, the CUDA route is the
    # kernel: the plain tracer is not among its choices off the CPU
    assert fused_slab.supported(cfg) and route(cfg, False, "cuda") == "kernel"


@pytest.mark.parametrize("text", [examples.SLAB_ECH_90GHZ, examples.SLAB_ECH_DAMPED],
                         ids=["slab", "damped"])
def test_kernel_configs_never_take_the_plain_route_off_the_cpu(text, monkeypatch):
    """A config the gate accepts goes to the kernel on CUDA tensors, from
    the config alone; only a request for gradients takes the plain route
    there.  Without nvcc the kernel route raises: nothing runs in its place."""
    cfg, params, v0, st, pwr = examples.setup_example(text, device="cpu")
    assert fused_slab.supported(cfg)
    assert route(cfg, False, "cuda") == route(cfg, False, torch.device("cuda", 0)) == "kernel"
    assert route(cfg, True, "cuda") == "plain"
    assert route(cfg, False, "cpu") == route(cfg, True, "cpu") == "plain"
    with pytest.raises(ValueError, match="unsupported device"):
        route(cfg, False, "meta")
    _no_cuda()
    called = []
    monkeypatch.setattr(trace_mod, "trace_batch", lambda *a: called.append(a))
    with pytest.raises((RuntimeError, AssertionError)):
        trace_rays(cfg, params, v0.to("meta").to("cuda"), st, pwr)
    assert not called


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """No nvcc: the build raises (and nothing runs in the kernel's place)."""
    monkeypatch.setattr(fused_slab.shutil, "which", lambda name: None)
    monkeypatch.setattr(fused_slab.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        fused_slab._nvcc()


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_measurement_tools_default_to_cuda_and_raise_without_it(tool, tmp_path):
    """The measurement tools run on the card unless asked for the CPU;
    without one they fail before they measure or write anything."""
    _no_cuda()
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"iso_{tool}",
                                                  os.path.join(ROOT, "tools", f"{tool}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "report.txt"
    with pytest.raises((RuntimeError, AssertionError)):
        mod.main(["--out", str(out)])
    with pytest.raises((RuntimeError, AssertionError)):
        mod.run()
    assert not out.exists()
