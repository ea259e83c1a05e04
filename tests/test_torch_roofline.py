"""The port's configs and roofline arithmetic (``repro_torch.configs``,
``repro_torch.roofline.analysis``) against the JAX package's, on the CPU.

Arithmetic only: every config's fields, parameter counts and model FLOPs
for every ``SHAPES`` entry, ``dtype_bytes``, and the ``Roofline`` terms on
fixed numbers once the JAX module's constants are set to the port's (H100)
ones.  Nothing here builds a tensor of a full-width config.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.paper import CONFIG as JPAPER
from repro.roofline import analysis as jan
from repro_torch.configs import base as tbase
from repro_torch.configs.paper import CONFIG as TPAPER
from repro_torch.roofline import analysis as tan

NAMES = jbase.ARCH_IDS


def test_arch_ids_and_shapes_match():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert dataclasses.asdict(TPAPER) == dataclasses.asdict(JPAPER)
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("gpt-2")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_and_counts_match_jax(name, reduced):
    j, t = jbase.get_config(name), tbase.get_config(name)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for attr in ("head_dim_", "padded_vocab", "is_attention_free",
                 "d_inner", "supports_decode", "sub_quadratic"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.shapes() == j.shapes()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for shape in jbase.SHAPES:
        assert tan.model_flops_for(t, tbase.SHAPES[shape]) == \
            jan.model_flops_for(j, jbase.SHAPES[shape]), shape


def test_qwen3_is_the_served_width():
    cfg = tbase.get_config("qwen3-1.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size) == \
        (28, 2048, 16, 8, 128, 6144, 151_936)
    assert cfg.tie_embeddings and cfg.qk_norm
    assert 1.7e9 < cfg.param_count() < 2.1e9


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16", "int8", "int32"])
def test_dtype_bytes_match_jax(dtype):
    torch_of = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16, "int8": torch.int8,
                "int32": torch.int32}
    jnp_of = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
              "int8": jnp.int8, "int32": jnp.int32}
    hlo = {"f32": "f32", "bf16": "bf16", "f16": "f16", "int8": "s8",
           "int32": "s32"}
    want = jan.dtype_bytes(jnp_of[dtype])
    assert tan.dtype_bytes(torch_of[dtype]) == want
    assert tan.dtype_bytes(hlo[dtype]) == jan.dtype_bytes(hlo[dtype]) == want
    assert tan.dtype_bytes(np.dtype(jnp_of[dtype])) == want
    with pytest.raises(ValueError, match="unknown dtype name"):
        tan.dtype_bytes("float99")


def test_h100_constants():
    assert (tan.PEAK_FLOPS, tan.PEAK_F32, tan.HBM_BW, tan.LINK_BW) == \
        (989.4e12, 67e12, 3.35e12, 450e9)


@pytest.mark.parametrize("cost,coll", [
    ({"flops": 3.2e15, "bytes accessed": 4.1e11}, {"all-reduce": 2.2e9}),
    ({"flops": 1.0e12, "bytes accessed": 8.0e12}, {}),
    ({"flops": 5.0e11, "bytes accessed": 1.0e9},
     {"all-gather": 7.0e11, "reduce-scatter": 1.0e10}),
    ({}, {}),
])
def test_roofline_matches_jax_with_h100_constants(cost, coll, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jan, name, getattr(tan, name))
    kw = dict(model_flops=2.5e15, peak_memory_bytes=3 * 2 ** 30)
    t = tan.from_costs("cell", 4, cost, coll, **kw)
    j = jan.from_costs("cell", 4, cost, coll, **kw)
    for attr in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "t_bound", "useful_flops_fraction", "mfu_bound"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.row() == j.row()


def test_extrapolate_costs_matches_jax():
    c1 = {"flops": 10.0, "bytes accessed": 4.0, "name": "skip"}
    c2 = {"flops": 16.0, "bytes accessed": 7.0, "transcendentals": 1.0}
    k1, k2 = {"all-reduce": 2.0}, {"all-reduce": 3.5, "all-gather": 1.0}
    assert tan.extrapolate_costs(c1, c2, k1, k2, 28) == \
        jan.extrapolate_costs(c1, c2, k1, k2, 28)
