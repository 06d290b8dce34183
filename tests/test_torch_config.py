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

TEXTS = {"slab_ech_90ghz": jex.SLAB_ECH_90GHZ, "slab_ech_damped": jex.SLAB_ECH_DAMPED,
         "solovev_ech_90ghz": jex.SOLOVEV_ECH_90GHZ}


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
    assert tex.SOLOVEV_ECH_90GHZ == jex.SOLOVEV_ECH_90GHZ


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
    """The compensated carry is ported (tests/test_torch_compensated.py):
    the Config takes it, and the one place that rejects it is the slab
    RK4 kernel's gate, which has no carry, so such a run takes the plain
    tracer."""
    from rays_tpu_torch.tracing import fused_slab

    cfg, _ = tschema.from_namelist(tparse(jex.SLAB_ECH_90GHZ))
    assert fused_slab.supported(cfg)
    comp = dataclasses.replace(cfg, compensated_sum=True)
    assert comp.compensated_sum and Config(compensated_sum=True).compensated_sum
    assert not fused_slab.supported(comp)


def test_unported_models_raise():
    """Every equilibrium and ray-init model of the JAX package parses and
    is carried across by convert: the spline geometries and the three ray
    inits that used to name ROADMAP A13 are the positive cases now
    (tests/test_torch_axisym.py, test_torch_mirror.py and
    test_torch_rayinit.py hold their values).  Only a name neither package
    knows still raises, and no message names a ROADMAP item."""
    from rays_tpu.models import multiple_mirror as jmm

    cfg, params = tschema.from_namelist(tparse(jex.SOLOVEV_ECH_90GHZ))
    assert cfg.equilib_model == "solovev" and cfg.ode_solver_name == "SG_ODE"
    assert cfg.ray_init_model == "solovev_ray_init_nphi_ntheta"
    assert type(params.eq).__name__ == "SolovevParams"
    assert type(cfg.rayinit_static).__name__ == "SolovevInit"

    # the three ray inits, on the slab
    for name, want, static in (
            ("file_input_ray_init", "file_input_ray_init", "FileInputInit"),
            ("one_ray_init_XYZ_k_direction", "one_ray_init_XYZ_k_direction", "OneRayInit"),
            ("one_ray_init_XYZ_n_direction", "one_ray_init_XYZ_k_direction", "OneRayInit"),
            ("axisym_toroid_ray_init_R_Z_nphi_ntheta",
             "axisym_toroid_ray_init_R_Z_nphi_ntheta", "AxisymToroidInit")):
        text = jex.SLAB_ECH_90GHZ.replace("ray_init_model='simple_slab'",
                                          f"ray_init_model='{name}'")
        jcfg, _ = jschema.from_namelist(jparse(text), input_dir="somewhere")
        pcfg, _ = tschema.from_namelist(tparse(text), input_dir="somewhere")
        assert pcfg.ray_init_model == jcfg.ray_init_model == want
        assert type(pcfg.rayinit_static).__name__ == static
        assert dataclasses.asdict(pcfg.rayinit_static) == dataclasses.asdict(jcfg.rayinit_static)
        assert convert.config_from_dict(dataclasses.asdict(jcfg)) == pcfg

    # the toroid with the closed-form magnetics needs no file
    text = jex.SLAB_ECH_90GHZ.replace("equilib_model='slab'", "equilib_model='axisym_toroid'")
    jcfg, jparams = jschema.from_namelist(jparse(text))
    pcfg, pparams = tschema.from_namelist(tparse(text))
    assert pcfg.equilib_model == "axisym_toroid"
    assert pcfg.eq_static.magnetics_model == "solovev_magnetics"
    assert type(pparams.eq).__name__ == "AxisymToroidParams"
    assert type(pparams.eq.mag).__name__ == "SolovevMagParams"
    assert convert.config_from_dict(dataclasses.asdict(jcfg)) == pcfg
    jl, pl = _jax_leaves(jparams), _port_leaves(pparams)
    assert list(jl) == list(pl)
    for k in jl:
        np.testing.assert_array_equal(pl[k], jl[k], err_msg=k)
    got = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    for a, b in zip(tree_leaves(got), tree_leaves(pparams)):
        assert torch.equal(a, b)

    # the mirror asks for its field file, as the JAX package does
    text = jex.SLAB_ECH_90GHZ.replace("equilib_model='slab'", "equilib_model='multiple_mirror'")
    for schema, parse in ((jschema, jparse), (tschema, tparse)):
        with pytest.raises(ValueError, match="mirror_field_NC_file"):
            schema.from_namelist(parse(text))
    d = dataclasses.asdict(jschema.from_namelist(jparse(jex.SLAB_ECH_90GHZ))[0])
    mirror = convert.config_from_dict(dict(
        d, equilib_model="multiple_mirror",
        eq_static=dataclasses.asdict(jmm.MultipleMirrorStatic())))
    assert type(mirror.eq_static).__name__ == "MultipleMirrorStatic"

    # a name nobody knows
    for old, new in (("equilib_model='slab'", "equilib_model='stellarator'"),
                     ("ray_init_model='simple_slab'", "ray_init_model='beam'")):
        with pytest.raises(NotImplementedError) as exc:
            tschema.from_namelist(tparse(jex.SLAB_ECH_90GHZ.replace(old, new)))
        assert "A13" not in str(exc.value) and "ROADMAP" not in str(exc.value)
    for key in ("equilib_model", "ray_init_model"):
        with pytest.raises(NotImplementedError) as exc:
            convert.config_from_dict(dict(d, **{key: "unknown"}))
        assert "A13" not in str(exc.value)


def test_grad_diag_slot_matches_jax():
    """Config.nv, damping_slot and grad_diag_slot over the slot options."""
    jcfg, _ = jschema.from_namelist(jparse(jex.SLAB_ECH_DAMPED))
    pcfg, _ = tschema.from_namelist(tparse(jex.SLAB_ECH_DAMPED))
    for damp in ("no_damp", "damp_fund_ECH"):
        for multi in (False, True):
            for grads in (False, True):
                ch = dict(damping_model=damp, multi_spec_damping=multi,
                          integrate_eq_gradients=grads)
                j, p = dataclasses.replace(jcfg, **ch), dataclasses.replace(pcfg, **ch)
                assert (p.nv, p.damping_slot, p.grad_diag_slot) == \
                    (j.nv, j.damping_slot, j.grad_diag_slot), ch
