"""``interop.lm_params`` and ``interop.lm_caches`` on every architecture's
tree, on the CPU at the reduced sizes.

Each JAX parameter tree (shapes from ``jax.eval_shape`` of the JAX
package's init, values numpy draws) goes into a port ``Model`` and comes
back out, restacked on the group axis, bit for bit: attention sublayers
with ``mlp`` or ``moe`` (and its ``shared`` MLP), SSM sublayers (no
``ln2``) and zamba2's unstacked ``shared_block``.  A tree with a missing,
extra or misshaped leaf raises.  The JAX package's decode caches (KV,
Mamba1, Mamba2 and the hybrid's ``"shared"`` cache) cross bit for bit too.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro_torch import interop
from repro_torch.configs.base import ARCH_IDS, get_config

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")


def _tree(name, seed=0):
    """A numpy tree of the JAX package's structure for ``name``."""
    cfg = jget_config(name).reduced()
    shapes = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _restacked(model):
    """The port model's parameters as a JAX-structured numpy tree."""
    p = model.params
    out = {"final_norm": p.final_norm.numpy()}
    if p.embed is not None:
        out["embed"] = {"table": p.embed["table"].numpy()}
    if p.lm_head is not None:
        out["lm_head"] = p.lm_head.numpy()

    def nest(named):
        tree = {}
        for path, leaf in named:
            *up, last = path.split(".")
            node = tree
            for k in up:
                node = node.setdefault(k, {})
            node[last] = leaf
        return tree

    out["groups"] = [
        nest((path, np.stack([dict(grp[i].named_parameters())[path].numpy()
                              for grp in p.groups]))
             for path, _ in p.groups[0][i].named_parameters())
        for i in range(len(p.groups[0]))]
    if p.shared_block is not None:
        out["shared_block"] = nest((path, t.numpy()) for path, t
                                   in p.shared_block.named_parameters())
    return out


@pytest.mark.parametrize("name", ARCH_IDS)
def test_lm_params_round_trip(name):
    tree = _tree(name)
    model = interop.lm_params(tree, get_config(name).reduced(),
                              dtype=torch.float32)
    back = _restacked(model)
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def _drop(tree, path):
    node = tree
    for k in path[:-1]:
        node = node[k]
    del node[path[-1]]


def _reshape(tree, path):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = node[path[-1]][..., :-1]


def _extra(tree, path):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = np.zeros((1,), np.float32)


@pytest.mark.parametrize("edit", [_drop, _reshape, _extra])
@pytest.mark.parametrize("name,path", [
    ("falcon-mamba-7b", ("groups", 0, "ssm", "A_log")),
    ("zamba2-2.7b", ("groups", 3, "ssm", "conv_w")),
    ("qwen2-moe-a2.7b", ("groups", 0, "moe", "we_gate")),
    ("qwen2-moe-a2.7b", ("groups", 0, "moe", "shared", "wd")),
    ("llama4-scout-17b-a16e", ("groups", 2, "moe", "router")),
    ("zamba2-2.7b", ("shared_block", "attn", "wq")),
    ("zamba2-2.7b", ("shared_block", "mlp", "wg")),
])
def test_lm_params_refuses_a_bad_leaf(name, path, edit):
    """A missing or misshaped leaf raises, and so does a leaf the port does
    not have (``_extra`` adds one beside ``path``'s: ``path[-1] + "_x"``)."""
    tree = copy.deepcopy(_tree(name))
    if edit is _extra:
        path = path[:-1] + (path[-1] + "_x",)
    edit(tree, path)
    with pytest.raises(ValueError, match="lm_params"):
        interop.lm_params(tree, get_config(name).reduced())


def test_lm_params_refuses_a_missing_shared_block():
    tree = _tree("zamba2-2.7b")
    del tree["shared_block"]
    with pytest.raises(ValueError, match="shared_block"):
        interop.lm_params(tree, get_config("zamba2-2.7b").reduced())
    tree = _tree("falcon-mamba-7b")
    tree["shared_block"] = _tree("zamba2-2.7b")["shared_block"]
    with pytest.raises(ValueError, match="shared_block"):
        interop.lm_params(tree, get_config("falcon-mamba-7b").reduced())


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_lm_caches_round_trip(name):
    """The JAX package's empty decode caches, filled with numpy draws,
    cross as the port's types, leaf for leaf and bit for bit."""
    cfg = jget_config(name).reduced()
    shapes = jax.eval_shape(lambda: JT.init_caches(cfg, 2, 40))
    rng = np.random.default_rng(1)
    caches = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    got = interop.lm_caches(caches)
    assert set(got) == set(caches)
    pairs = list(zip(got["sub"], caches["sub"]))
    if "shared" in caches:
        pairs.append((got["shared"], caches["shared"]))
    for g, w in pairs:
        assert type(g).__name__ == type(w).__name__
        assert g._fields == w._fields
        for gl, wl in zip(g, w):
            assert tuple(gl.shape) == wl.shape
            assert str(gl.dtype).split(".")[-1] == str(wl.dtype)
            np.testing.assert_array_equal(gl.float().numpy(),
                                          np.asarray(wl, np.float32))


def test_lm_caches_refuses_an_unknown_cache():
    from typing import NamedTuple

    class OtherCache(NamedTuple):
        k: np.ndarray
    with pytest.raises(ValueError, match="OtherCache"):
        interop.lm_caches({"sub": [OtherCache(np.zeros((1, 2)))]})
