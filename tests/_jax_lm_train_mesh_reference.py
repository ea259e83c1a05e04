"""The JAX package's LM train step on a mesh of several host devices, for
the port's multi-process training tests.  Run as a script in a process of
its own, whose XLA_FLAGS ask for the devices before JAX starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_lm_train_mesh_reference.py CASES OUT

CASES is a pickle of the cases of ``_torch_train_ranks.run_train``.  The
mesh is (data, model) with Auto axes, device r at row-major position r
(rank r of the port's mesh).  Per case OUT receives each step's metrics of
``train_step_bundle``'s step, jitted with the bundle's shardings in f32
compute, and, leaf by leaf (the path in the parameters' tree), the whole
parameters and moments after the last step with the slice
``devices_indices_map`` gives each device under the train policy.
"""

import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh

from repro.configs.base import ShapeSpec
from repro.configs.base import get_config as jget_config
from repro.launch.steps import train_step_bundle
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw


def _slices(sharding, shape, devices):
    m = sharding.devices_indices_map(shape)
    return [tuple((s.start or 0, shape[d] if s.stop is None else s.stop)
                  for d, s in enumerate(m[dev])) for dev in devices]


def _leaves(tree, shardings, devices):
    """{path: (whole leaf, each device's slice)}."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sh = jax.tree_util.tree_leaves(shardings)
    out = {}
    for (path, leaf), s in zip(flat, sh):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaf = np.asarray(leaf)
        out["/".join(keys)] = (leaf, _slices(s, leaf.shape, devices))
    return out


def run(case):
    data, model = case["mesh"]
    devices = list(jax.devices()[:data * model])
    mesh = Mesh(np.array(devices).reshape(data, model), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = dataclasses.replace(jget_config(case["arch"]).reduced(),
                              **case["cfg"])
    B, S = case["batches"][0]["tokens"].shape
    bundle = train_step_bundle(cfg, ShapeSpec("t", S, B, "train"), mesh,
                               adamw.AdamWConfig(**case["opt"]))
    step = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                   out_shardings=bundle.out_shardings)
    init = jax.jit(adamw.init, out_shardings=bundle.in_shardings[1])
    saved = (JL.COMPUTE_DTYPE, JT.COMPUTE_DTYPE)
    JL.COMPUTE_DTYPE = JT.COMPUTE_DTYPE = jnp.float32
    try:
        with mesh:
            params = jax.device_put(jax.tree.map(jnp.asarray, case["params"]),
                                    bundle.in_shardings[0])
            opt = init(params)
            metrics = []
            for b in case["batches"]:
                batch = jax.device_put({k: jnp.asarray(v)
                                        for k, v in b.items()},
                                       bundle.in_shardings[2])
                params, opt, m = step(params, opt, batch)
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        JL.COMPUTE_DTYPE, JT.COMPUTE_DTYPE = saved
    psh = bundle.in_shardings[0]
    return dict(metrics=metrics, batch_axes=bundle.policy.batch_axes,
                seq_shard=bundle.policy.seq_shard,
                params=_leaves(params, psh, devices),
                m=_leaves(opt.m, psh, devices),
                v=_leaves(opt.v, psh, devices))


def main(argv):
    jax.config.update("jax_platform_name", "cpu")
    with open(argv[0], "rb") as f:
        cases = pickle.load(f)
    out = [run(c) for c in cases]
    with open(argv[1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
