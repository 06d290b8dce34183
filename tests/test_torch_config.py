"""rays_tpu_torch config layer against the JAX package: the namelist
importer gives the same Config fields and identical Params leaves."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import rays_tpu  # noqa: F401  (x64 on)
from rays_tpu import examples as jex
from rays_tpu.config import schema as jschema
from rays_tpu.config.namelist import parse_namelist as jparse
from rays_tpu_torch import convert, examples as tex
from rays_tpu_torch.config import schema as tschema
from rays_tpu_torch.config.namelist import parse_namelist as tparse
from rays_tpu_torch.core.types import Config, tree_leaves
from rays_tpu_torch.tracing import stop as tstop
from rays_tpu.tracing import stop as jstop

TEXTS = {"slab_ech_90ghz": jex.SLAB_ECH_90GHZ, "slab_ech_damped": jex.SLAB_ECH_DAMPED}


def _jax_leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name, x in zip(tree._fields, tree):
            out.update(_jax_leaves(x, f"{prefix}.{name}" if prefix else name))
        return out
    return {prefix: np.asarray(tree)}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name, x in zip(tree._fields, tree):
            out.update(_port_leaves(x, f"{prefix}.{name}" if prefix else name))
        return out
    return {prefix: tree.numpy()}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_from_namelist_matches_jax(name):
    text = TEXTS[name]
    jcfg, jparams = jschema.from_namelist(jparse(text))
    pcfg, pparams = tschema.from_namelist(tparse(text))
    jd = dataclasses.asdict(jcfg)
    jd.pop("fused_kernel")
    assert dataclasses.asdict(pcfg) == jd
    assert pcfg.nv == jcfg.nv and pcfg.ns == jcfg.ns

    jl, pl = _jax_leaves(jparams), _port_leaves(pparams)
    assert list(jl) == list(pl)
    for k in jl:
        assert pl[k].dtype == np.float64, k
        np.testing.assert_array_equal(pl[k], jl[k], err_msg=k)
    assert all(t.device.type == "cpu" for t in tree_leaves(pparams))


def test_examples_text_identical():
    assert tex.SLAB_ECH_90GHZ == jex.SLAB_ECH_90GHZ
    assert tex.SLAB_ECH_DAMPED == jex.SLAB_ECH_DAMPED


def test_namelist_parser_identical():
    for text in TEXTS.values():
        assert tparse(text) == jparse(text)


def test_stop_codes_identical():
    assert {c.name: int(c) for c in tstop.StopCode} == \
        {c.name: int(c) for c in jstop.StopCode}
    for c in jstop.StopCode:
        assert tstop.flag_string(int(c)) == jstop.flag_string(int(c))
        s = jstop.flag_string(int(c))
        assert tstop.flag_code(s) == jstop.flag_code(s)
        assert tstop.flag_code(s.replace(" ", "_")) == jstop.flag_code(s.replace(" ", "_"))


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_convert_carries_jax_inputs(name):
    """convert.* rebuild exactly what the port's own importer builds."""
    jcfg, jparams = jschema.from_namelist(jparse(TEXTS[name]))
    pcfg, pparams = tschema.from_namelist(tparse(TEXTS[name]))
    assert convert.config_from_dict(dataclasses.asdict(jcfg)) == pcfg
    got = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    for a, b in zip(tree_leaves(got), tree_leaves(pparams)):
        assert torch.equal(a, b)


def test_float32_params_round_once_from_float64():
    jcfg, jparams = jschema.from_namelist(jparse(jex.SLAB_ECH_90GHZ))
    _, p32 = tschema.from_namelist(tparse(jex.SLAB_ECH_90GHZ), dtype=torch.float32)
    jl = _jax_leaves(jparams)
    for k, v in _port_leaves(p32).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, jl[k].astype(np.float32), err_msg=k)


def test_compensated_sum_rejected():
    with pytest.raises(ValueError, match="A18"):
        Config(compensated_sum=True)


def test_unported_models_raise():
    with pytest.raises(NotImplementedError, match="A12"):
        tschema.from_namelist(tparse(jex.SOLOVEV_ECH_90GHZ))
    text = jex.SLAB_ECH_90GHZ.replace("ray_init_model='simple_slab'",
                                      "ray_init_model='file_input_ray_init'")
    with pytest.raises(NotImplementedError, match="ray_init_model"):
        tschema.from_namelist(tparse(text))
