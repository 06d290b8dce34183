"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a small size (the look
for a card is the command's, which these skip), through the program's
plain route, with one fault planted in the program: a step that returns
its state unchanged; half of the batch left out and the rest counted
twice, so that sums over rays come out as the mean of the rest times the
count; one ray's answer altered where it is produced.  The sound run of
the same size comes out correct.  (The cell runs on one chip: no
exchange between chips to leave out.)"""

import pytest
import torch

from benchmark import run

from benchmark.tests.sizes import shrink

SIZES = {"slab_ech.scan": ((4, 2), 500), "slab_ech.grad": ((2, 2), 60)}


def _result(cell):
    counts, steps = SIZES[cell]

    def adjust(c):
        shrink(c, counts, steps)
        c.spec = dict(c.spec, warmup_calls=1)

    return run.run_cell(cell, 2147483717, 0.0, False, "cpu", adjust=adjust,
                        log=lambda line: None)


def _frozen_step(cfg, params, k, *carry):
    # the state comes back unchanged, still joined to the Params, so that a
    # gradient can be taken through it
    v = carry[0] + 0.0 * params.ode.ds
    return (v, torch.zeros_like(v[:, 0]), v, *carry[1:])


def _half_batch(trace_rays):
    def traced(cfg, params, v0, status0, pwr):
        h = v0.shape[0] // 2
        res = trace_rays(cfg, params, v0[:h], status0[:h], pwr[:h])
        return type(res)(*[t if t is None else torch.cat([t, t])[:v0.shape[0]] for t in res])

    return traced


def _altered(trace_rays):
    def traced(cfg, params, v0, status0, pwr):
        res = trace_rays(cfg, params, v0, status0, pwr)
        bump = torch.zeros_like(res.end_ray_vec)
        bump[0, 0] = 1e-2
        return res._replace(end_ray_vec=res.end_ray_vec + bump)

    return traced


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    assert _result(cell)["correct"] is True


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", list(SIZES))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from rays_tpu_torch.tracing import trace

    if fault == "state_unchanged":
        monkeypatch.setattr(trace, "step", _frozen_step)
    elif fault == "half_batch":
        monkeypatch.setattr(trace, "trace_rays", _half_batch(trace.trace_rays))
    else:
        monkeypatch.setattr(trace, "trace_rays", _altered(trace.trace_rays))
    result = _result(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
