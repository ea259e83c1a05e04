"""Shared helpers of the training-path tests (``tests/test_torch_train_*.py``,
``test_torch_trainer.py``, ``test_torch_optim.py``): numpy batches, the
JAX package's loss and train step on the Auto-axis mesh, and the
gradient-leaf bar.  The parameter trees come from
``test_torch_lm_model.numpy_params`` (the JAX package's structure drawn
with numpy) and cross with ``interop.lm_params`` / ``interop.lm_tree``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import interop
from test_torch_lm_model import _compute_dtype, mesh, numpy_params  # noqa: F401

B = 2


def train_batch(cfg, S, seed, mask=False):
    """A (B, S) training batch of numpy arrays: tokens and labels (the
    vlm's image prefix of cfg.num_image_tokens bf16 rows comes before its S
    text positions; an encoder takes bf16 frames), and with ``mask`` a
    0/1 ``loss_mask`` with about a quarter of the positions off."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend_stub and cfg.family != "vlm":
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        out["frames"] = np.asarray(jnp.asarray(x, jnp.bfloat16))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        img = 0.02 * rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model))
        out["image_embeds"] = np.asarray(jnp.asarray(img, jnp.bfloat16))
    if mask:
        out["loss_mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
    return out


def torch_batch(batch, device="cpu"):
    return {k: interop.tensor(v, device) for k, v in batch.items()}


def leaves_close(got, want, rel=1e-4, what="gradient"):
    """Every leaf of the numpy tree ``got`` within ``rel`` of its JAX leaf's
    own max |.|; the two trees must have one structure."""
    worst = []

    def one(path, g, w):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape, (jax.tree_util.keystr(path), g.shape,
                                    w.shape)
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        worst.append(err / scale if scale else err)
        assert err <= rel * scale, (
            f"{what} {jax.tree_util.keystr(path)}: max |diff| {err} over "
            f"{rel} x max |{what}| {scale}")
    jax.tree_util.tree_map_with_path(one, got, want)
    return max(worst)


def jax_grad_fn(cfg):
    """The JAX package's jitted (params, batch) -> ((loss, {"ce", "aux"}),
    grads) on the Auto mesh, for f32 compute (trace it under
    ``_compute_dtype(jnp.float32)``)."""
    from repro.models.model import build_model as jbuild_model
    from repro.models.sharding import make_policy as jmake_policy
    model = jbuild_model(cfg)
    policy = jmake_policy(mesh(), B, "train")
    return jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, policy), has_aux=True))


def run_f32(fn, *args):
    """``fn(*args)`` traced and run with the JAX package's compute dtype
    f32, on the Auto mesh; the outputs as numpy."""
    mp = _compute_dtype(jnp.float32)
    try:
        with mesh():
            return jax.tree.map(np.asarray, fn(*args))
    finally:
        mp.undo()


def port_model(cfg, params, dtype=torch.float32, device="cpu"):
    """The port's Model holding ``params``, with gradients on."""
    return interop.lm_params(params, cfg, device, dtype).requires_grad_(True)
