"""The measurement tools of rays_tpu_torch (tools/step_profile.py,
op_roofline.py, precision_probe.py, profile_mirror.py)
and the modules under them (utils/op_census.py, utils/op_rates.py), held
on the CPU to what they count and to the JAX package's measurements.

* ``op_census`` of one plain RK4 slab step: the same operations and the
  same elements per ray by class at 3 rays and at 64, and on a second run
  (exactly: the census counts).
* The plain op-rate chains against the same chains written with jax.numpy
  (the fma and mul chains are scripts/vpu_roofline.py's own) and run
  through ``jax.lax.scan`` on the same inputs: float64 within 1e-12
  relative, float32 within 1e-5 (the tolerances the kernels are held to on
  the card; the library functions round differently in the last place).
* The plain fma rounds once, exactly as a fused one (checked in rational
  arithmetic), and every chain keeps every iteration and every chain at
  the full depth: its resolution stays far above the tolerance in float64
  and above a few ulp in float32.
* The pricing arithmetic of ``op_roofline`` on given rates and counts (fmas
  paired, each class net of its chain's add); every kind of
  ``fused_slab.OP_KINDS`` and every census class has a price.
* The precision probe against the same measurements built from the JAX
  package's functions on the same numpy inputs (the slab example at 100
  steps): the amplification within 1% of the JAX one, each f32 error
  within a factor of 3 (f32 rounding differs between XLA's CPU code and
  PyTorch's); the JAX side's module swap through ``monkeypatch``.
* ``profile_mirror``'s bare right-hand side, ``check_save`` and cell fetch
  on 16 rays equal what the trace computes at the same points (1e-12 of
  scale); its loops carry each piece's result.
* Every tool, with ``--device cpu`` at a tiny size, writes its report.
"""

import dataclasses
import importlib.util
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu.models import base as jbase
from rays_tpu.tracing import trace as jtrace
from rays_tpu.wave import deriv_cold as jdc
from rays_tpu_torch import examples
from rays_tpu_torch.tracing import fused_slab, rhs
from rays_tpu_torch.tracing.trace import trace_batch
from rays_tpu_torch.utils import op_census, op_rates

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_STEPS = 100
AMP_RTOL = 0.01
F32_FACTOR = 3.0
POINT_RTOL = 1e-12
CHAIN_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {name: _load(f"tools/{name}.py", f"torch_tool_{name}")
            for name in ("step_profile", "op_roofline", "precision_probe", "profile_mirror")}


def _census(n):
    cfg, params, v0, st, pwr = examples.setup_example(device="cpu")
    v, s, w = examples.replicate_rays(v0, st, pwr, n)
    return op_census.step_census(cfg, params, v, s, w)


def test_census_of_a_slab_step_is_batch_independent():
    a, b, again = _census(3), _census(64), _census(3)
    assert a.n_ops > 1000 and a.host_reads == 0
    for other in (b, again):
        assert other.n_ops == a.n_ops and other.n_views == a.n_views
        assert other.ops == a.ops
        assert other.by_class() == a.by_class()
    # every operation has a class, and the classes add up
    cls = a.by_class()
    assert sum(n for n, _ in cls.values()) == a.n_ops
    assert cls["other"][0] == 0, {k: v for k, v in a.ops.items()
                                 if k not in op_census.CLASS_OF}
    assert cls["mul"][1] > cls["div"][1] > 0 and cls["exp"] == (0, 0.0)


def test_census_counts_what_it_sees():
    """A hand-written batch: the classes, the elements per ray, views and
    host reads apart."""
    x = torch.linspace(1.0, 2.0, 12, dtype=torch.float64).reshape(4, 3)

    def fn():
        y = torch.sqrt(x * 2.0 + 1.0)           # mul, add, sqrt: 3 elements each per ray
        z = torch.where(y > 1.5, y, -y).sum(-1)  # gt, neg, where: 3; sum: 1
        bool(z[0] > 0)                           # select (view), gt on 0-d, a host read
        return y[:, :2].T                        # views only

    c = op_census.census(fn, n_rays=4)
    cls = c.by_class()
    assert cls["mul"] == (1, 3.0) and cls["sqrt"] == (1, 3.0) and cls["select"] == (1, 3.0)
    assert cls["add"] == (2, 6.0) and cls["reduce"] == (1, 1.0)
    assert cls["compare"] == (2, 3.0)           # the 0-d comparison writes no element per ray
    assert c.host_reads == 1 and c.n_views >= 3 and c.n_ops == 8


def _jax_chain(body, k, x, iters):
    def step(y, _):
        for _ in range(k):
            y = body(y)
        return y, None

    return np.asarray(jax.lax.scan(step, jnp.asarray(x), None, length=iters)[0])


# the op-rate chains in jax.numpy: the fma and mul chains are those of
# scripts/vpu_roofline.py:67-69; the others add each result to the running
# value, so that none settles at a fixed point
JAX_BODIES = {
    "fma": lambda y: y * 1.0000001 + 1e-9,
    "mul": lambda y: y * 1.0000001,
    "add": lambda y: y + 1e-3,
    "div": lambda y: y + 0.6 / y,
    "sqrt": lambda y: y + jnp.sqrt(y),
    "rsqrt": lambda y: y + jax.lax.rsqrt(y),
    "exp": lambda y: y + jnp.exp(-y),
    "log": lambda y: y + jnp.log(y),
    "cube": lambda y: y - y * y * y * 1e-4,
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("op", sorted(JAX_BODIES))
def test_plain_chain_matches_the_jax_script(op, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    x = op_rates.chain_inputs(w=2, n=64, dtype=tdt)
    got = op_rates.chain_reference(op, x, k=8, iters=6).numpy()
    ref = _jax_chain(JAX_BODIES[op], 8, x.numpy(), 6)
    assert got.dtype == ref.dtype == dtype
    np.testing.assert_allclose(got, ref, rtol=CHAIN_RTOL[dtype], atol=0)


def test_chain_wrappers_on_the_cpu_are_the_plain_chains():
    """The wrappers take the plain chains for CPU tensors, without a
    launch, and refuse what the kernels do not take."""
    before = sum(op_rates.LAUNCHES.values())
    x = op_rates.chain_inputs(w=8, n=16, dtype=torch.float64)
    for op in op_rates.OPS:
        assert torch.equal(op_rates.chain(op, x, iters=3),
                           op_rates.chain_reference(op, x, iters=3))
    # the chains are iterated maps: a depth of 3 is 2 and then 1
    assert torch.equal(op_rates.chain_reference("exp", x, iters=3), op_rates.chain_reference(
        "exp", op_rates.chain_reference("exp", x, iters=2), iters=1))
    m, v = op_rates.matvec_inputs(n=16)
    out = op_rates.matvec(m, v, iters=2)
    a = m.T.reshape(16, 3, 3).double()
    ref = v.double().T
    for _ in range(2):
        ref = 0.25 * torch.einsum("bij,bj->bi", a, ref) + 0.1
    np.testing.assert_allclose(out.T.double().numpy(), ref.numpy(), rtol=1e-6)
    assert sum(op_rates.LAUNCHES.values()) == before
    with pytest.raises(ValueError, match="operation class"):
        op_rates.chain("tan", x)
    with pytest.raises(ValueError, match="unsupported device"):
        op_rates.chain("mul", x.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_fma_rounds_once(dtype):
    """The plain fma chain's step is y * 1.0000001 + 1e-9 rounded once,
    as the kernel's fma(): checked in rational arithmetic on 2,000 values
    (both constants first rounded to the type, as the kernel's T(...))."""
    y = 1.1 + 1.2 * torch.rand(2000, generator=torch.Generator().manual_seed(3),
                               dtype=torch.float64)
    y = y.to(dtype)
    got = op_rates.fma_reference(y, 1.0000001, 1e-9)
    assert got.dtype == dtype
    npdt = np.float64 if dtype == torch.float64 else np.float32
    a, b = Fraction(float(npdt(1.0000001))), Fraction(float(npdt(1e-9)))
    # the exact value rounded to float64 and then to float32 is the
    # float32 rounding here: no exact value lies on a float32 midpoint
    want = [float(npdt(float(Fraction(v) * a + b))) for v in y.tolist()]
    assert got.tolist() == want
    # one rounding, not two: the fused value differs from y * a + b somewhere
    if dtype == torch.float64:
        assert not torch.equal(got, y * 1.0000001 + 1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_chains_keep_every_iteration_and_chain(dtype):
    """At the full depth no chain has settled: one iteration less, or the
    neighbouring chain of the thread, changes every output by far more
    than the float64 tolerance, and by several ulp in float32, so that a
    kernel that skipped work cannot equal its plain chain."""
    least = {np.float64: 1e-12 * 1e3, np.float32: 4 * 2.0 ** -23}[
        np.float64 if dtype == torch.float64 else np.float32]
    cases = [(op, op_rates.W, op_rates.K) for op in op_rates.OPS]
    cases += [("fma", w, k) for w, k in op_rates.ILP]
    for op, w, k in cases:
        x = op_rates.chain_inputs(w, 32, dtype)
        prev = op_rates.chain_reference(op, x, k, op_rates.ITERS - 1)
        out = op_rates.chain_reference(op, prev, k, 1)
        assert bool(torch.isfinite(out).all())
        assert op_rates.resolution(prev, out) > least, (op, w, k)
    m, v = op_rates.matvec_inputs(32, dtype)
    prev = op_rates.matvec_reference(m, v, op_rates.ITERS - 1)
    out = op_rates.matvec_reference(m, prev, 1)
    assert op_rates.resolution(prev, out, per_column=True) > least
    # a hand example: the least change over one iteration and neighbours
    a = torch.tensor([[1.0, 2.0], [1.5, 4.0]], dtype=torch.float64)
    b = torch.tensor([[1.1, 2.0 + 1e-3], [1.5 + 3e-6, 4.1]], dtype=torch.float64)
    assert op_rates.resolution(a, b) == pytest.approx(min(0.1 / 1.1, 1e-3 / 2.001,
                                                          3e-6 / 1.500003, 0.1 / 4.1,
                                                          0.400003 / 1.500003,
                                                          2.099 / 4.1))


def test_pricing_arithmetic():
    rates = {"fma": 4e12, "add": 2e12, "mul": 4e12, "div": 1e11, "sqrt": 5e10,
             "exp": 2.5e10, "log": 1e10}
    counts = {"add": 6e12, "mul": 4e12, "div": 1e11, "sqrt": 1e11, "exp": 5e10, "pow": 1e10}
    total, parts = op_rates.price(counts, rates)
    # 4e12 pairs fused at the fma rate; each class net of its chain's add
    assert parts == pytest.approx({"fma": 1.0, "add": 1.0, "mul": 0.0,
                                   "div": 1e11 * (1e-11 - 5e-13),
                                   "sqrt": 1e11 * (2e-11 - 5e-13),
                                   "exp": 5e10 * (4e-11 - 5e-13),
                                   "pow": 1e10 * (4e-11 - 5e-13 + 1e-10 - 5e-13)})
    assert total == pytest.approx(sum(parts.values()))
    # a class chain faster than its add costs nothing net, never less
    assert op_rates.unit_costs({"add": 1e12, "exp": 2e12})["exp"] == 0.0
    # every kind the kernel body counts, and every census class, has a price
    assert set(op_rates.PRICE_OF_KIND) == set(fused_slab.OP_KINDS)
    assert set(op_rates.PRICE_OF_CLASS) == set(op_census.CLASSES)
    for table in (op_rates.PRICE_OF_KIND, op_rates.PRICE_OF_CLASS):
        assert all(set(cs) <= set(op_rates.OPS) for cs in table.values())
    with pytest.raises(KeyError):
        op_rates.price({"tanh": 1}, rates)
    # the published-peak bound: the formula of chip_smoke.py's kernel line
    ops = [{"add": 10, "mul": 20, "div": 1, "sqrt": 1, "exp": 0, "pow": 0},
           {"add": 30, "mul": 40, "div": 1, "sqrt": 0, "exp": 0, "pow": 0}]
    total = op_rates.replicated_totals(ops, 5)
    # 5 rays tile the 2 launch rays 3 and 2 times
    assert total == {"add": 90, "mul": 140, "div": 5, "sqrt": 3, "exp": 0, "pow": 0}
    ms, by, detail = op_rates.published_bound(total, 5, 7, torch.float64)
    assert by == "bytes" and ms == pytest.approx(5 * (2 * 7 * 8 + 12 + 16) / 3.35e12 * 1e3)
    assert detail["flops"] == 238
    assert op_rates.per_ray_step(ops, [3, 5]) == {"add": 40 / 6, "mul": 60 / 6, "div": 2 / 6,
                                                  "sqrt": 1 / 6, "exp": 0, "pow": 0}


def _jax_probe(monkeypatch, noise, steps):
    """The probe's measurements built from the JAX package's functions."""
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=steps, save_trajectory=False)
    trace = lambda c: jax.jit(  # noqa: E731
        lambda p, v, s, w: jtrace.trace_batch(c, p, v, s, w))
    cast = lambda t, dt: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x.astype(dt) if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    f64 = trace(cfg)
    ref = np.asarray(f64(params, v0, st, pwr).end_ray_vec)

    def err(end):
        end = np.asarray(end, np.float64)
        return np.abs(end[:, :6] - ref[:, :6]).max() / np.abs(ref[:, :6]).max()

    out = {"divergence": err(f64(params, v0 * (1.0 + 1e-7 * noise), st, pwr).end_ray_vec)}
    p32, v32, w32 = cast(params, jnp.float32), v0.astype(jnp.float32), pwr.astype(jnp.float32)
    out["f32"] = err(trace(cfg)(p32, v32, st, w32).end_ray_vec)
    comp = trace(dataclasses.replace(cfg, compensated_sum=True))(p32, v32, st, w32)
    out["f32_compensated"] = err(comp.end_ray_vec)
    out["f32_compensated_resolved"] = err(
        np.asarray(comp.end_ray_vec, np.float64) + np.asarray(comp.end_ray_comp, np.float64))
    orig_dc, orig_eq = jdc.deriv_cold, jbase.equilibrium

    def dc64(eq, nvec, omgrf, k0):
        o = orig_dc(cast(eq, jnp.float64), nvec.astype(jnp.float64), jnp.float64(omgrf),
                    jnp.float64(k0))
        return tuple(x.astype(jnp.float32) for x in o)

    def eq64(c, p, rvec):
        return cast(orig_eq(c, cast(p, jnp.float64), rvec.astype(jnp.float64)), jnp.float32)

    for key, dc, eq in (("f32_deriv_cold_f64", True, False),
                        ("f32_equilibrium_f64", False, True), ("f32_both_f64", True, True)):
        monkeypatch.setattr(jdc, "deriv_cold", dc64 if dc else orig_dc)
        monkeypatch.setattr(jbase, "equilibrium", eq64 if eq else orig_eq)
        out[key] = err(trace(cfg)(p32, v32, st, w32).end_ray_vec)
    monkeypatch.undo()
    assert jdc.deriv_cold is orig_dc and jbase.equilibrium is orig_eq
    return out, (cfg, params, v0, st, pwr)


def test_precision_probe_matches_jax(monkeypatch, tools):
    noise = np.random.default_rng(7).standard_normal((3, 7))
    jax_out, case = _jax_probe(monkeypatch, noise, PROBE_STEPS)
    cfg, params, v0, st, pwr = tp.to_port(*case)
    probe = tools["precision_probe"]
    got = probe.probe(cfg, params, v0, st, pwr, noise=noise)
    # the swap is undone, here as in the JAX package
    from rays_tpu_torch.models import base as tbase
    from rays_tpu_torch.wave import deriv_cold as tdc
    assert tbase.equilibrium.__module__ == tbase.__name__
    assert tdc.deriv_cold.__module__ == tdc.__name__
    assert got["divergence"] == pytest.approx(jax_out["divergence"], rel=AMP_RTOL)
    assert got["amplification"] == pytest.approx(got["divergence"] / 1e-7)
    for key in ("f32", "f32_compensated", "f32_compensated_resolved", "f32_deriv_cold_f64",
                "f32_equilibrium_f64", "f32_both_f64"):
        assert 0 < got[key] and jax_out[key] / F32_FACTOR <= got[key] <= jax_out[key] * F32_FACTOR, \
            (key, got[key], jax_out[key])
    # the compensated carry keeps the state bit for bit: end_ray_vec is plain f32's
    assert got["f32_compensated"] == got["f32"]


def test_f64_inside_is_undone_on_an_error(tools):
    probe = tools["precision_probe"]
    from rays_tpu_torch.models import base as tbase
    from rays_tpu_torch.wave import deriv_cold as tdc

    orig = (tbase.equilibrium, tdc.deriv_cold)
    with pytest.raises(RuntimeError, match="inside"):
        with probe.f64_inside(True, True):
            assert (tbase.equilibrium, tdc.deriv_cold) != orig
            raise RuntimeError("inside")
    assert (tbase.equilibrium, tdc.deriv_cold) == orig


def test_mirror_components_equal_the_trace(tools, tmp_path):
    pm = tools["profile_mirror"]
    cfg, nodamp, params, v, st, pwr = pm.mirror_case(str(tmp_path), "cpu", n_rays=16, steps=1)
    assert cfg.damping_model == "damp_fund_ECH" and nodamp.nv == 7 and v.shape == (16, 8)
    # one step of the trace, with its rows
    res = trace_batch(dataclasses.replace(cfg, save_trajectory=True), params, v, st, pwr)
    assert bool((res.npoints == 2).all())
    v1 = res.ray_vec[:, 1]
    comps = pm.components(cfg, nodamp, params, v1)
    s0 = torch.zeros((), dtype=v.dtype)
    f1, st1, resid, chk = rhs.eqn_ray_and_check(cfg, params, s0, v1)
    dvds, status = comps["eqn_ray"]()
    tp.assert_rows_close(dvds, f1.numpy(), POINT_RTOL, "eqn_ray")
    assert torch.equal(status, st1)
    resid_bare, chk_bare = comps["check_save"]()
    # the residual the trace recorded at that point, and the one its
    # shared evaluation computes (the residual is normalized: its scale is 1)
    np.testing.assert_allclose(resid_bare.numpy(), res.residual[:, 1].numpy(), rtol=0,
                               atol=POINT_RTOL)
    np.testing.assert_allclose(resid_bare.numpy(), resid.numpy(), rtol=0, atol=POINT_RTOL)
    assert torch.equal(chk_bare, chk)
    f, fr, fz = comps["eval_cell_2d"]()
    x, y = v1[:, 0], v1[:, 1]
    r = torch.sqrt(x * x + y * y)
    bvec = torch.stack([x * f[:, 0] / r, y * f[:, 0] / r, f[:, 1]], dim=-1)
    eq = comps["equilibrium"]()
    tp.assert_rows_close(bvec, eq.bvec.numpy(), POINT_RTOL, "bvec from the cell fetch")
    ksi, ki = comps["equilibrium_damping"]()
    assert ki.shape == (16,) and bool(torch.isfinite(ki).all())


def test_mirror_loops_carry_each_piece(tools, tmp_path):
    """Every loop body of profile_mirror maps the (B, nv) carry to one of
    its shape, and the loops report each piece net of the null loop."""
    pm = tools["profile_mirror"]
    cfg, _, params, v, _, _ = pm.mirror_case(str(tmp_path), "cpu", n_rays=16, steps=1)
    bodies = pm.loop_bodies(cfg, params)
    for name, body in bodies.items():
        out = body(v)
        assert out.shape == v.shape and bool(torch.isfinite(out).all()), name
    # the right-hand side reaches the carry
    assert not torch.equal(bodies["1x eqn_ray"](v), bodies["null (+1e-12)"](v))
    loops = pm.run_loops(cfg, params, v, "cpu", iters=2, say=lambda msg: None)
    assert list(loops) == list(bodies) and loops["null (+1e-12)"][1] == 0.0


@pytest.mark.parametrize("tool,args", [
    ("step_profile", ["--rays", "4", "--steps", "1"]),
    ("op_roofline", ["--n", "16", "--iters", "1", "--rays", "4", "--census-rays", "4"]),
    ("precision_probe", ["--steps", "4"]),
    ("profile_mirror", ["--rays", "4", "--steps", "1", "--iters", "1"]),
])
def test_tool_writes_its_report_on_the_cpu(tool, args, tools, tmp_path, capsys):
    out = tmp_path / "report.txt"
    assert tools[tool].main(["--device", "cpu", *args, "--out", str(out)]) == 0
    text = out.read_text()
    assert "cpu (host clock; no device metric)" in text
    assert f"wrote {out}" in capsys.readouterr().out
