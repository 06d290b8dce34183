"""The kernel module rays_tpu_torch.tracing.fused_slab against the TPU
kernel it replaces, rays_tpu.tracing.fused_slab.trace_batch_fused, run in
Pallas interpret mode on the CPU (the JAX package itself is not edited:
the test wraps ``pl.pallas_call``).

Here, on CPU tensors, the wrapper runs its plain twin; the CUDA kernel's
own arithmetic is held to the same references by
tests/test_torch_kernel_host.py and on the card by chip_smoke.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.tracing import fused_slab as jfused
from rays_tpu_torch.core.types import Config, tree_to
from rays_tpu_torch.tracing import fused_slab as tfused
from rays_tpu_torch.tracing import trace as ttrace

SUMMARY_RTOL = 1e-9


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = jfused.pl.pallas_call
    monkeypatch.setattr(jfused.pl, "pallas_call", functools.partial(orig, interpret=True))


def _assert_summaries(got, ref, rtol):
    np.testing.assert_array_equal(got.npoints.numpy(), np.asarray(ref.npoints))
    np.testing.assert_array_equal(got.stop_flag.numpy(), np.asarray(ref.stop_flag))
    tp.assert_scaled_close(got.end_ray_vec, np.asarray(ref.end_ray_vec), rtol,
                           axis=-1, what="end_ray_vec")
    np.testing.assert_allclose(got.max_residuals.numpy(), np.asarray(ref.max_residuals),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.end_residuals.numpy(), np.asarray(ref.end_residuals),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("ray_param,ds", [("time", None), ("arcl", 2.5e-3)])
def test_plain_twin_matches_pallas_kernel(interpret_pallas, ray_param, ds):
    cfg, params, v0, st, pwr = tp.jax_case(
        ds=ds, ray_param=ray_param, nstep_max=40, save_trajectory=False)
    assert jfused.supported(cfg)
    ref = jfused.trace_batch_fused(cfg, params, v0, st, pwr)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    got = tfused.trace_batch_fused_reference(pcfg, pp, tv0, tst, tpw)
    _assert_summaries(got, ref, SUMMARY_RTOL)
    assert got.npoints.tolist() == [41] * 3


def test_cpu_wrapper_runs_plain_twin():
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=30)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    before = tfused.LAUNCHES
    got = tfused.trace_batch_fused(pcfg, pp, tv0, tst, tpw)
    assert tfused.LAUNCHES == before == 0
    ref = ttrace.trace_batch(pcfg, pp, tv0, tst, tpw)
    assert got.end_ray_comp is None and ref.end_ray_comp is None   # no compensated carry
    for a, b in zip(got[:-1], ref[:-1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("save", [False, True])
def test_supported_matches_jax(save):
    """On the configs of tests/test_fused.py the gate agrees with the JAX
    package's; trajectories and damping are the port's extensions (JAX
    refuses them), with or without the per-species slots."""
    cfg, params, *_ = tp.jax_case(save_trajectory=save)
    pcfg, _ = tp.to_port(cfg, params)
    assert tfused.supported(pcfg)
    assert jfused.supported(cfg) == (not save)

    damped, dparams, *_ = tp.jax_case(jex.SLAB_ECH_DAMPED, save_trajectory=save)
    assert not jfused.supported(damped)
    port_damped = tp.to_port(damped, dparams)[0]
    assert tfused.supported(port_damped)
    assert tfused.supported(dataclasses.replace(port_damped, multi_spec_damping=False))

    # the gate refuses the Solovev tokamak under either stepper, and the
    # adaptive stepper on the slab, in both packages
    sol, sparams, *_ = jex.setup_example(jex.SOLOVEV_ECH_90GHZ)
    sol = dataclasses.replace(sol, save_trajectory=save)
    port_sol = tp.to_port(sol, sparams)[0]
    assert isinstance(port_sol, Config) and port_sol.equilib_model == "solovev"
    for solver in ("SG_ODE", "RK4_ODE"):
        assert not jfused.supported(dataclasses.replace(sol, ode_solver_name=solver))
        assert not tfused.supported(dataclasses.replace(port_sol, ode_solver_name=solver))
    assert not jfused.supported(dataclasses.replace(cfg, ode_solver_name="SG_ODE"))
    assert not tfused.supported(dataclasses.replace(pcfg, ode_solver_name="SG_ODE"))


@pytest.mark.parametrize("combo", tp.MODEL_COMBOS,
                         ids=["-".join((c[0], c[1], c[2], *c[3])) for c in tp.MODEL_COMBOS])
def test_supported_profile_models(combo):
    cfg, params, *_ = tp.jax_case(combo=combo)
    pcfg, _ = tp.to_port(cfg, params)
    assert tfused.supported(pcfg) == (combo in tp.KERNEL_COMBOS)
    assert tfused.supported(pcfg) == jfused.supported(
        dataclasses.replace(cfg, save_trajectory=False))


def test_wrapper_checks_inputs():
    cfg, params, v0, st, pwr = tp.jax_case(nstep_max=5)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    bad = [
        (dict(v0=tv0[:, :6].contiguous()), "v0 must be"),
        (dict(v0=tv0[:0]), "empty"),
        (dict(v0=tv0.to(torch.float16)), "float32 or float64"),
        (dict(status0=tst.to(torch.int64)), "int32"),
        (dict(v0=torch.cat([tv0, tv0], 1)[:, ::2]), "contiguous"),
    ]
    for change, msg in bad:
        args = dict(v0=tv0, status0=tst)
        args.update(change)
        with pytest.raises(ValueError, match=msg):
            tfused.trace_batch_fused(pcfg, pp, args["v0"], args["status0"], tpw)
    with pytest.raises(ValueError, match="not supported"):
        tfused.trace_batch_fused(dataclasses.replace(pcfg, ode_solver_name="SG_ODE"),
                                 pp, tv0, tst, tpw)
    # a device that is neither the CPU nor CUDA is refused, never run
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.trace_batch_fused(pcfg, pp, tv0.to("meta"), tst.to("meta"), tpw)


def params_field(params, name):
    """The Params tensor of a field name, found in the one group that has it."""
    groups = [g for g in params._fields if name in getattr(params, g)._fields]
    assert len(groups) == 1, (name, groups)
    return getattr(getattr(params, groups[0]), name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("text", [jex.SLAB_ECH_90GHZ, jex.SLAB_ECH_DAMPED],
                         ids=["undamped", "damped"])
def test_packed_rows_hold_params(text, dtype):
    """Every row of the packed run constants holds, in the layout's order,
    what a read of its Params field on its own gives: a field of a scalar
    list its first value (ms: the electrons'), a per-species field its ns;
    and the model codes are the config's."""
    cfg, params, *_ = tp.jax_case(text)
    pcfg, pp = tp.to_port(cfg, params)
    pp = tree_to(pp, dtype=dtype)
    ns = pcfg.ns
    packed = torch.cat(tfused.run_rows(pcfg, pp))
    assert packed.dtype == dtype
    lists = (tfused.ROWS, tfused.SPECIES_ROWS, tfused.FORWARD_ROWS, tfused.FORWARD_SPECIES_ROWS)
    at = 0
    for rows, n in zip(lists, (1, ns, 1, ns)):
        for _, name in rows:
            want = params_field(pp, name).reshape(-1)
            assert want.numel() == (ns if name == "ms" else n), name
            assert packed[at:at + n].tolist() == want[:n].tolist(), name
            at += n
    assert at == packed.numel() == 26 + 7 * ns
    st = pcfg.eq_static
    assert list(tfused.model_codes(pcfg)) == [
        tfused._BY_MODELS[st.by_prof_model], tfused._BZ_MODELS[st.bz_prof_model],
        tfused._DENS_MODELS[st.dens_prof_model], int(pcfg.ray_param == "time"),
        *[tfused._T_MODELS[m] for m in st.t_prof_model], *[0] * (tfused.MAX_SPECIES - ns)]
