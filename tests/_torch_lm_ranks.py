"""The rank side of the port's LM mesh tests (``test_torch_lm_mesh.py``).

``spawn(world, cases)`` (``_torch_mesh_ranks.spawn`` with this module as
the rank side) starts ``world`` gloo ranks that serve every case on a
(data, model) mesh; a case is a plain dict (``run_lm``), so the ranks
import only torch, numpy and repro_torch, never JAX.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_ranks as mesh_ranks
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.steps import decode_step_bundle, prefill_bundle
from repro_torch.models import collectives as C
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T


def spawn(world: int, cases, timeout: float = 240.0):
    return mesh_ranks.spawn(world, cases, timeout, module="_torch_lm_ranks")


def cache_leaves(caches):
    """(name, numpy block) of every cache leaf, named and ordered as the
    JAX tree's flattened paths (``shared/k`` of the hybrid family's shared
    block first, then ``sub/i/k``)."""
    out = []
    if "shared" in caches:
        c = caches["shared"]
        out += [(f"shared/{f}", t.numpy()) for f, t in zip(c._fields, c)]
    for i, c in enumerate(caches["sub"]):
        out += [(f"sub/{i}/{f}", t.numpy()) for f, t in zip(c._fields, c)]
    return out


def run_lm(case, meshes):
    """Serve one batch on a mesh, in f32 compute.

    ``case``: ``mesh`` (data, model); ``arch`` and ``cfg`` (overrides of its
    reduced config); ``params`` the JAX-structured numpy tree; ``tokens``
    the global (B, S) prompts; ``gen`` the tokens to generate (a prefill,
    then gen - 1 decode steps).  Returns this rank's parameter blocks and
    specs, the prefill caches' blocks, each step's logits block and its
    spec, the greedy ids (B, gen), the prefill forward's aux loss, the
    (token, choice) rows this rank's MoE dropped in it, and the
    collectives' (kind, axes) -> (calls, bytes) of the prefill and of each
    decode step."""
    if case["mesh"] not in meshes:
        meshes[case["mesh"]] = make_mesh_for(int(np.prod(case["mesh"])),
                                             model_parallel=case["mesh"][1])
    mesh = meshes[case["mesh"]]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case.get("cfg", {}))
    tokens = torch.from_numpy(case["tokens"])
    B, S = tokens.shape
    gen = case["gen"]
    cache_len = S + gen
    pre = prefill_bundle(cfg, ShapeSpec("t", S, B, "prefill"), mesh)
    dec = decode_step_bundle(cfg, ShapeSpec("t", cache_len, B, "decode"),
                             mesh)
    model = interop.lm_params(case["params"], cfg, "cpu", torch.float32,
                              policy=dec.policy)
    named = dict(model.params.named_parameters())

    dropped = []
    saved = TM._dispatch_combine

    def counted(x, *args):
        out = saved(x, *args)
        dropped.append(int(out[2]))
        return out
    TM._dispatch_combine = counted
    try:
        with torch.no_grad():
            _, _, aux = T.forward(model.params, {"tokens": tokens}, cfg,
                                  pre.policy, mode="prefill",
                                  cache_len=cache_len, dtype=torch.float32)
    finally:
        TM._dispatch_combine = saved

    C.reset_counts()
    logits, caches = pre.fn(model, {"tokens": tokens}, cache_len=cache_len)
    counts = [C.counts()]
    pre_caches = cache_leaves(caches)
    out = [logits.numpy()]
    specs = [pre.policy.logits_spec((B, 1, cfg.padded_vocab))]
    tok = model.greedy(logits, pre.policy)
    ids = [tok.numpy()]
    for i in range(gen - 1):
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        C.reset_counts()
        logits, caches = dec.fn(model, caches, tok, pos)
        counts.append(C.counts())
        tok = model.greedy(logits, dec.policy)
        out.append(logits.numpy())
        specs.append(dec.policy.logits_spec((B, 1, cfg.padded_vocab)))
        ids.append(tok.numpy())
    return dict(params={n: p.detach().numpy() for n, p in named.items()},
                specs={n: p.spec for n, p in named.items()},
                caches=pre_caches, logits=out, logit_specs=specs,
                ids=np.concatenate(ids, 1), aux=float(aux), dropped=dropped,
                counts=counts, coords=dict(mesh.coords),
                batch_axes=pre.policy.batch_axes,
                seq_shard=pre.policy.seq_shard)


def main(argv) -> None:
    rank, world, store, cases, out = argv
    torch.set_num_threads(1)
    mesh_ranks._init(int(rank), int(world), store)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    meshes = {}
    results = [run_lm(c, meshes) for c in cases]
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1:])
