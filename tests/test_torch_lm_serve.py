"""The port's serving steps and CLI on the CPU (``repro_torch.launch.steps``,
``repro_torch.launch.serve``): the bundles give the ``Model``'s own
results, their batches have the JAX package's input specs, the CLI serves
at the reduced size with ``--device cpu``, and nothing that defaults to the
card falls back to the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro_torch.configs.base import SHAPES, ShapeSpec, get_config
from repro_torch.launch import steps
from repro_torch.models.model import build_model, input_specs
from repro_torch.models.sharding import make_policy

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
#: every architecture that decodes
SERVED = ("qwen3-1.7b", "granite-3-2b", "h2o-danube-1.8b", "internvl2-26b",
          "qwen3-14b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
          "falcon-mamba-7b", "zamba2-2.7b")


def _model(name):
    cfg = get_config(name).reduced()
    return cfg, build_model(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg, B, S, seed=1):
    g = torch.Generator().manual_seed(seed)
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - n_img),
                                     generator=g, dtype=torch.int32)}
    if n_img:
        batch["image_embeds"] = 0.02 * torch.randn(
            (B, n_img, cfg.d_model), generator=g).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("name", SERVED)
def test_bundles_give_the_models_results(name):
    """prefill_bundle's fn is Model.prefill with caches of seq_len slots
    (a KV ring's clamped to the window or the attention chunk; the SSM
    caches hold a state, not positions); decode_step_bundle's fn is
    Model.decode_step; three greedy steps."""
    cfg, model = _model(name)
    B, S, cache_len = 2, 32, 40
    pre = steps.prefill_bundle(cfg, ShapeSpec("t", cache_len, B, "prefill"))
    dec = steps.decode_step_bundle(cfg, ShapeSpec("t", cache_len, B,
                                                  "decode"))
    batch = _batch(cfg, B, S)
    lg, caches = pre.fn(model, batch)
    lg_m, caches_m = model.prefill(batch, cache_len=cache_len)
    assert torch.equal(lg, lg_m)
    for c in caches["sub"] + [caches.get("shared")]:
        if hasattr(c, "k"):
            clamp = cfg.sliding_window or (
                cfg.attention_chunk if c is caches["sub"][0] else 0)
            assert c.k.shape[-3] == min(cache_len, clamp or 10 ** 9)
    assert set(caches) == set(caches_m)
    for c, cm in zip(caches["sub"] + [caches.get("shared", ())],
                     caches_m["sub"] + [caches_m.get("shared", ())]):
        assert all(torch.equal(a, b) for a, b in zip(c, cm))
    for i in range(3):
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        lg, caches = dec.fn(model, caches, tok, pos)
        lg_m, caches_m = model.decode_step(caches_m, tok, pos)
        assert torch.equal(lg, lg_m)
        assert lg.shape == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(lg[..., :cfg.vocab_size].float()).all()


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("name", SERVED + ("hubert-xlarge",))
def test_input_specs_match_jax(name, shape_name):
    """The batch each SHAPES entry takes: the JAX package's names, shapes
    and dtypes (at full width: specs allocate nothing)."""
    cfg = get_config(name)
    want = jbuild_model(jget_config(name)).input_specs(JSHAPES[shape_name])
    got = input_specs(cfg, SHAPES[shape_name])
    assert set(got) == set(want)
    for key, spec in got.items():
        assert tuple(spec.shape) == tuple(want[key].shape)
        assert str(spec.dtype).split(".")[-1] == str(want[key].dtype)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_bundle_for(shape_name):
    cfg = get_config("qwen3-1.7b")
    shape = SHAPES[shape_name]
    b = steps.bundle_for(cfg, shape_name)
    assert b.policy.kind == shape.kind
    want = {"decode": {"tokens", "positions"}, "prefill": {"tokens"},
            "train": {"tokens", "labels"}}
    assert set(b.input_specs) == want[shape.kind]
    assert b.input_specs["tokens"].shape[0] == shape.global_batch


def test_policy_is_one_card():
    """The policy's answers on a (data 2, model 1) mesh, and on one card:
    the batch over "data", nothing over the one-peer model axis."""
    class FakeMesh:
        shape = {"data": 2, "model": 1}
    p = make_policy(FakeMesh(), 4, "decode")
    assert p.batch_axes == ("data",) and p.data_parallel_size == 2
    assert p.model_size == 1 and p.seq_axis is None and not p.tensor_parallel
    assert p.batch_first((4, 8, 16)) == ("data", None, None)
    assert p.param_spec("groups.0.0.attn.wq", (128, 256)) == ("data", None)
    assert p.kv_cache_spec((2, 4, 64, 2, 32)) == (None, "data", None, None,
                                                  None)
    x = torch.ones(2, 3)
    assert p.constrain_tokens(x) is x
    with pytest.raises(ValueError, match="block"):
        p.constrain_tokens(torch.ones(4, 3))
    one = make_policy(None, 4, "decode")
    assert one.constrain_tokens(x) is x and one.model_size == 1
    assert one.batch_axes == () and one.param_spec("wq", (8, 8)) == (None,
                                                                     None)


def _cli(*args, timeout=120, ranks=0):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks)] if ranks else [sys.executable]
    return subprocess.run(run + ["-m", "repro_torch.launch.serve", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_serve_cli_on_the_cpu():
    """The CLI at its defaults (qwen3-1.7b, B = 4, prompt 64, generate 32),
    reduced since the device is the CPU."""
    p = _cli("--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 3, p.stdout
    assert "arch=qwen3-1.7b-smoke batch=4 prompt=64 gen=32" in lines[0]
    assert "prefill" in lines[1] and "decode" in lines[1]
    ids = ast.literal_eval(lines[2].split(":", 1)[1].strip())
    assert len(ids) == 16 and all(0 <= i < 512 for i in ids)


def test_serve_cli_serves_the_hybrid():
    """The CLI with no family check, on zamba2 at the reduced size (2
    groups of 6 Mamba2 layers + the shared block), a 64-token prompt in
    two SSM chunks of 32."""
    name = "zamba2-2.7b"
    p = _cli("--device", "cpu", "--arch", name)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 3, p.stdout
    assert f"arch={name}-smoke batch=4 prompt=64 gen=32" in lines[0]
    ids = ast.literal_eval(lines[2].split(":", 1)[1].strip())
    assert len(ids) == 16 and all(0 <= i < 512 for i in ids)


@pytest.mark.parametrize("args,message", [
    ((), "no CUDA device"),                 # the card by default
    # a vlm arch on a mesh of two ranks (torchrun): the mesh path serves
    # the dense, moe, ssm and hybrid families
    (("--device", "cpu", "--model-parallel", "2", "--arch",
      "internvl2-26b"), "next slice"),
    (("--device", "cpu", "--arch", "hubert-xlarge"), "encoder-only"),
])
def test_serve_cli_refuses(args, message):
    if not args and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    p = _cli(*args, ranks=2 if "--model-parallel" in args else 0)
    assert p.returncode != 0
    assert message in p.stderr + p.stdout
    assert "[serve]" not in p.stdout


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("qwen3-1.7b").reduced())
