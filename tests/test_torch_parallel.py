"""rays_tpu_torch's split of the rays over processes (``parallel/sharded.py``,
``parallel/multihost.py``, ``entry.training_step``) against the JAX
package's ``parallel/`` and against one process.

* ``local_ray_slice`` and ``pad_rays`` equal the JAX package's over a grid
  of batch sizes, process counts and ranks (exactly).
* Two processes over gloo (``entry.dryrun_multiprocess(2)`` on the CPU,
  after tests/test_multihost.py::test_two_process_distributed_smoke):
  every process holds its split training step of ``__graft_entry__.py``
  (the damped slab, 120 steps with trajectories, Ptotal_x in 32 bins,
  loss sum |x_end|^2 P + sum profile^2) to the step on the whole batch:
  loss rtol 1e-12; profile and ray_vec rtol 1e-10, atol 1e-14;
  gradients rtol 1e-8, atol 1e-12 (``__graft_entry__.py``'s tolerances).
* One process: ``training_step`` against ``trace_batch`` and ``jax.grad``
  of the same loss on the same inputs (the damped slab at 60 steps of
  1.3e-2, which reach the resonance): loss rtol 1e-12, trajectories 1e-10
  of scale, every Params leaf's gradient within 1e-10 of its largest.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.parallel import multihost as jmh, sharded as jsh
from rays_tpu.post import deposition as jdep
from rays_tpu.tracing import trace as jtrace
from rays_tpu_torch import entry as tentry
from rays_tpu_torch.core.types import tree_leaves
from rays_tpu_torch.parallel import multihost as tmh, sharded as tsh
from rays_tpu_torch.tracing.stop import StopCode

GRAD_RTOL = 1e-10
N_GLOBAL = [0, 1, 3, 10, 17, 64, 32768]


@pytest.mark.parametrize("n_global", N_GLOBAL)
def test_local_ray_slice_matches_jax(n_global):
    for pc in (1, 2, 3, 4, 7, 8):
        slices = [tmh.local_ray_slice(n_global, pc, pi) for pi in range(pc)]
        assert slices == [jmh.local_ray_slice(n_global, pc, pi) for pi in range(pc)]
        # the slices tile the batch in order
        assert slices[0][0] == 0 and slices[-1][1] == n_global
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    with pytest.raises(ValueError, match="outside"):
        tmh.local_ray_slice(n_global, 2, 2)
    # without a group this process is the whole world
    assert tmh.local_ray_slice(n_global) == (0, n_global)


@pytest.mark.parametrize("batch", [1, 3, 8, 13])
def test_pad_rays_matches_jax(batch):
    rng = np.random.default_rng(batch)
    v0 = rng.standard_normal((batch, 8))
    st = rng.integers(0, 3, batch).astype(np.int32)
    pwr = rng.uniform(0.1, 1.0, batch)
    for n in (1, 2, 4, 5):
        got = tsh.pad_rays(torch.from_numpy(v0), torch.from_numpy(st), torch.from_numpy(pwr), n)
        ref = jsh.pad_rays(jnp.asarray(v0), jnp.asarray(st), jnp.asarray(pwr), n)
        assert got[3] == ref[3] == batch
        for g, r in zip(got[:3], ref[:3]):
            assert g.shape[0] % n == 0
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert got[0].dtype == torch.float64 and got[1].dtype == torch.int32
        assert (got[1][batch:] == int(StopCode.DID_NOT_START)).all()


def test_no_group_is_one_process():
    mesh = tmh.global_ray_mesh()
    assert mesh == tsh.make_ray_mesh() == tsh.RayMesh(None, 1, 0)
    assert tmh.initialize() == (0, 1)        # one process, no address: a no-op
    assert not tsh.distributed()
    t = torch.arange(3.0)
    assert tsh.all_reduce_sum(t, mesh) is t and t.tolist() == [0.0, 1.0, 2.0]
    assert tmh.process_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="init_method"):
        tmh.initialize(num_processes=2, process_id=0)
    v, s, w = tmh.distribute_rays(mesh, torch.zeros(2, 7), torch.zeros(2, dtype=torch.int32),
                                  torch.ones(2), device="cpu")
    assert v.device.type == "cpu" and v.is_contiguous()


def test_two_processes_split_equal_one(tmp_path):
    reports = tentry.dryrun_multiprocess(
        2, device="cpu", init_method="file://" + os.path.join(str(tmp_path), "rendezvous"),
        timeout=600)
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["processes"] == 2 and r["backend"] == "gloo" for r in reports)
    assert [r["rays"] for r in reports] == [[0, 2, 4], [2, 4, 4]]
    # both processes hold the same global loss, profile and gradients
    for k in ("loss", "grad_l1", "deposition_sum", "leaves"):
        assert reports[0][k] == reports[1][k], k
    assert reports[0]["nstep"] == tentry.DRYRUN_STEPS == 120


def test_dryrun_failure_raises(tmp_path):
    """A process that cannot join fails the run, with its output."""
    with pytest.raises(RuntimeError, match="rank 0 exit"):
        tentry.dryrun_multiprocess(1, device="cpu", backend="no-such-backend",
                                   init_method="file://" + str(tmp_path / "r"), timeout=120)


@pytest.fixture(scope="module")
def graft_case():
    return tp.jax_case(jex.SLAB_ECH_DAMPED, ds=1.3e-2, nstep_max=60, save_trajectory=True)


def test_one_process_step_matches_jax(graft_case):
    cfg, params, v0, st, pwr = graft_case
    xmin, xmax = float(params.eq.xmin), float(params.eq.xmax)

    def loss_fn(p):
        res = jtrace.trace_batch(cfg, p, v0, st, pwr)
        prof = jdep.calculate_deposition_profile(cfg, p, res, "Ptotal_x", n_bins=tentry.N_BINS,
                                                 xmin=xmin, xmax=xmax)
        return (jnp.sum(res.end_ray_vec[:, 0:3] ** 2 * pwr[:, None])
                + jnp.sum(prof.profile ** 2)), (res.ray_vec, prof.profile)

    (jl, (jrv, jprof)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pcfg, pp, tv0, tst, tpw = tp.to_port(cfg, params, v0, st, pwr)
    pp = tentry.with_grad(pp)
    loss, res, prof, grads = tentry.training_step(pcfg, pp, tv0, tst, tpw)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-12)
    np.testing.assert_allclose(prof.numpy(), np.asarray(jprof), rtol=1e-10, atol=1e-14)
    tp.assert_scaled_close(res.ray_vec.detach().numpy(), np.asarray(jrv), 1e-10, axis=1)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(ref) == len(tree_leaves(pp))
    for g, r in zip(grads, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_RTOL * np.abs(r).max())
    # and the plain autograd of the whole loss gives the same step
    loss0, _, prof0, grads0 = tentry.whole_step(pcfg, pp, tv0, tst, tpw, xmin, xmax)
    assert float(loss0) == pytest.approx(float(loss), rel=1e-14)
    for g, g0 in zip(grads, grads0):
        torch.testing.assert_close(g, g0, rtol=1e-12, atol=0)


def test_sharded_tracer_is_trace_rays(graft_case):
    """Each process's tracer is trace_rays on its own rays: a slice of the
    batch traces as in the whole batch."""
    cfg, params, v0, st, pwr = graft_case
    pcfg, pp, tv0, tst, tpw = tp.to_port(dataclasses.replace(cfg, nstep_max=20), params,
                                         v0, st, pwr)
    trace = tmh.make_multihost_tracer(pcfg, tmh.global_ray_mesh())
    whole = trace(pp, tv0, tst, tpw)
    part = trace(pp, tv0[1:], tst[1:], tpw[1:])
    assert torch.equal(part.ray_vec, whole.ray_vec[1:])
    assert torch.equal(part.npoints, whole.npoints[1:])
