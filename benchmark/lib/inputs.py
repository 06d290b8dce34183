"""The inputs of a cell, made from its files and the seed, for the program
and for the reference alike.

Both sides read the same namelist text: the configuration's frozen copy
with the traffic's fan written into it from the seed (``common.fan``).
The program builds its run from that text with its own namelist reader,
Params and ray init (``examples.setup_example``: float64 on the CPU, then
cast and moved to the device); the reference builds its own from the
same text, launch rays included.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from benchmark.lib import common


def _fmt(value):
    return repr(value) if isinstance(value, float) else str(value)


def namelist_text(cell, seed):
    """The cell's namelist with the traffic's fan for ``seed`` appended to
    each group it sets (a later assignment wins in both namelist
    readers)."""
    text = cell.namelist
    for group, entries in common.fan(cell.traffic, seed).items():
        line = " " + ", ".join(f"{k}={_fmt(v)}" for k, v in entries.items()) + "\n"
        pattern = re.compile(rf"(&{group}\b.*?\n)(\s*/)", re.S | re.I)
        text, n = pattern.subn(lambda m: m.group(1) + line + m.group(2), text, count=1)
        if n != 1:
            raise ValueError(f"the namelist has no group {group!r} for the traffic's fan")
    return text


def nstep_max(cell, default):
    return int(cell.traffic.get("nstep_max", default))


def _check_count(cell, v0):
    if v0.shape[0] != int(cell.traffic["rays"]):
        raise ValueError(f"the fan launched {v0.shape[0]} rays, the traffic asks for "
                         f"{cell.traffic['rays']}: part of its range does not propagate")


def program(cell, seed, device, parts):
    """(cfg, params, launch rays on the CPU, v0, status0, pwr) of the
    program, on ``device`` in the cell's dtype."""
    with parts("imports"):
        from rays_tpu_torch import examples
    with parts("inputs"):
        dtype = getattr(torch, cell.spec["dtype"])
        cfg, params, v0, status0, pwr = examples.setup_example(
            namelist_text(cell, seed), device=device, dtype=dtype)
        _check_count(cell, v0)
        cfg = dataclasses.replace(cfg, save_trajectory=bool(cell.traffic["save_trajectory"]),
                                  nstep_max=nstep_max(cell, cfg.nstep_max))
        if device != "cpu":
            torch.cuda.synchronize()
    return cfg, params, v0.cpu(), v0, status0, pwr


def reference(cell, seed, device, dtype):
    """(case, launch rays on the CPU, v0, pwr) of the reference."""
    from benchmark.reference import rays_plain

    model = common.load_module(common.HERE / "reference" /
                               f"model_{cell.config['reference_model']}.py")
    case = rays_plain.build_case(namelist_text(cell, seed), dtype, device, fields=model.builder)
    case.static["nstep_max"] = nstep_max(cell, case.static["nstep_max"])
    v0, pwr = model.launch(case)
    _check_count(cell, v0)
    return case, v0.detach().cpu(), v0, pwr


def leaf_names(params):
    """The ``group.field`` name of every floating Params leaf, in the
    program's leaf order."""
    names = []

    def walk(t, path):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + [f])
        elif torch.is_tensor(t) and t.is_floating_point():
            names.append(".".join(path))

    walk(params, [])
    return names
