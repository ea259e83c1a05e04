"""The JAX package's LM serving on a mesh of several host devices, for the
port's multi-process LM mesh tests.  Run as a script in a process of its
own, whose XLA_FLAGS ask for the devices before JAX starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_lm_mesh_reference.py CASES OUT

CASES is a pickle of the cases of ``_torch_lm_ranks.run_lm``.  The mesh is
(data, model) with Auto axes, device r at row-major position r (rank r of
the port's mesh).  Per case OUT receives: the full logits of the prefill
and of each decode step and the greedy ids (the serve CLI's program:
prefill and serve_step jitted with the bundles' shardings, in f32
compute), the prefill forward's router aux loss and the (token, choice)
rows each device's MoE dropped past capacity (from the routing, recorded
by a debug callback with the device's mesh coordinates), and, leaf by
leaf, the full parameters and prefill caches with the slice
``devices_indices_map`` gives each device under the decode policy.
"""

import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding

from repro.configs.base import ShapeSpec
from repro.configs.base import get_config as jget_config
from repro.launch.steps import decode_step_bundle, prefill_bundle
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.model import build_model


def _slices(sharding, shape, devices):
    m = sharding.devices_indices_map(shape)
    return [tuple((s.start or 0, shape[d] if s.stop is None else s.stop)
                  for d, s in enumerate(m[dev])) for dev in devices]


def _drops(idx, cfg):
    """Rows of one routing call (T, k) that ``_local_moe`` drops."""
    flat = idx.reshape(-1)
    onehot = flat[:, None] == np.arange(cfg.n_experts)[None, :]
    pos = (np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat]
    return int((pos >= JM._capacity(cfg, idx.shape[0])).sum())


def run(case):
    data, model = case["mesh"]
    devices = list(jax.devices()[:data * model])
    mesh = Mesh(np.array(devices).reshape(data, model), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = dataclasses.replace(jget_config(case["arch"]).reduced(),
                              **case.get("cfg", {}))
    tokens = case["tokens"]
    B, S = tokens.shape
    gen = case["gen"]
    cache_len = S + gen
    m = build_model(cfg)
    pre = prefill_bundle(cfg, ShapeSpec("t", S, B, "prefill"), mesh)
    dec = decode_step_bundle(cfg, ShapeSpec("t", cache_len, B, "decode"),
                             mesh)
    params = jax.tree.map(jnp.asarray, case["params"])
    pre_psh = pre.policy.param_shardings(params)
    dec_psh = dec.policy.param_shardings(params)
    caches_abs = jax.eval_shape(
        lambda p, b: m.prefill(p, b, pre.policy, cache_len=cache_len)[1],
        params, {"tokens": tokens})
    cache_sh = dec.policy.cache_shardings(caches_abs, cfg.ssm_version)

    prefill = jax.jit(
        lambda p, b: m.prefill(p, b, pre.policy, cache_len=cache_len),
        in_shardings=(pre_psh, pre.in_shardings[1]),
        out_shardings=(pre.out_shardings[0], cache_sh))
    step = jax.jit(dec.fn, in_shardings=dec.in_shardings,
                   out_shardings=(dec.out_shardings[0], cache_sh))
    forward = jax.jit(lambda p, b: JT.forward(
        p, b, cfg, pre.policy, mode="prefill", cache_len=cache_len)[2],
        in_shardings=(pre_psh, pre.in_shardings[1]))

    routes = []
    saved_route, saved = JM._route, (JL.COMPUTE_DTYPE, JT.COMPUTE_DTYPE)

    def route(logits, cfg_):
        gate, idx, aux = saved_route(logits, cfg_)
        jax.debug.callback(
            lambda i, d, mm: routes.append((int(d), int(mm), np.asarray(i))),
            idx, jax.lax.axis_index("data"), jax.lax.axis_index("model"))
        return gate, idx, aux

    JL.COMPUTE_DTYPE = JT.COMPUTE_DTYPE = jnp.float32
    try:
        with mesh:
            batch = {"tokens": jnp.asarray(tokens)}
            p_pre = jax.device_put(params, pre_psh)
            logits, caches = prefill(p_pre, batch)
            caches_np = jax.tree.map(np.asarray, caches)
            p_dec = jax.device_put(params, dec_psh)
            out = [np.asarray(logits)]
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            ids = [np.asarray(tok)]
            for i in range(gen - 1):
                pos = jax.device_put(jnp.full((B, 1), S + i, jnp.int32),
                                     dec.in_shardings[3])
                tok = jax.device_put(tok, dec.in_shardings[2])
                logits, caches = step(p_dec, caches, tok, pos)
                tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
                out.append(np.asarray(logits))
                ids.append(np.asarray(tok))
            JM._route = route
            # the router aux of the prefill forward (``aux``: False skips
            # it, for a family without a router)
            aux = float(forward(p_pre, batch)) if case.get("aux", True) \
                else 0.0
            jax.effects_barrier()
    finally:
        JM._route = saved_route
        JL.COMPUTE_DTYPE, JT.COMPUTE_DTYPE = saved

    drops = {}
    for d, mm, idx in routes:
        drops[(d, mm)] = drops.get((d, mm), 0) + _drops(idx, cfg)

    def leaves(tree, shardings):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        sh = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        out = []
        for (path, leaf), s in zip(flat, sh):
            keys = [str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in path]
            leaf = np.asarray(leaf)
            out.append(("/".join(keys), leaf,
                        _slices(s, leaf.shape, devices)))
        return out

    return dict(logits=out, ids=np.concatenate(ids, 1), aux=aux,
                drops=drops, n_routes=len(routes),
                params=leaves(case["params"], dec_psh),
                caches=leaves(caches_np, cache_sh))


def main(argv):
    jax.config.update("jax_platform_name", "cpu")
    with open(argv[0], "rb") as f:
        cases = pickle.load(f)
    out = [run(c) for c in cases]
    with open(argv[1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
