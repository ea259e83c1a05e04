"""The JAX package's LM serving and train steps on a mesh of several host
devices, in one process, for the port's ssm / hybrid mesh tests.  Run as
a script in a process of its own, whose XLA_FLAGS ask for the devices
before JAX starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_lm_ssm_mesh_reference.py CASES OUT

CASES is a pickle of cases, each of kind "serve" (run by
``_jax_lm_mesh_reference.run``) or "step" (``_jax_lm_train_mesh_reference
.run``); OUT receives their results in order.
"""

import pickle
import sys

import jax

import _jax_lm_mesh_reference as serve
import _jax_lm_train_mesh_reference as train


def main(argv):
    jax.config.update("jax_platform_name", "cpu")
    with open(argv[0], "rb") as f:
        cases = pickle.load(f)
    out = [(serve.run if c["kind"] == "serve" else train.run)(c)
           for c in cases]
    with open(argv[1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
