"""The port's ShardingPolicy (``repro_torch.models.sharding``) against the
JAX package's ``repro.models.sharding``, with no devices and no ranks.

Both policies read a mesh only through its ``shape``, so a stub mesh with a
``.shape`` dict stands in for a device mesh.  For every architecture of
``ARCH_IDS``, at its full-size abstract shapes (``jax.eval_shape`` of the
JAX init, and of its decode caches), on meshes (16, 16), (2, 16, 16),
(2, 2), (1, 4), (4, 1) and (1, 8), for kinds train, prefill and decode and
with ``pure_fsdp`` and ``head_fsdp`` each on and off, the port must answer
exactly as the JAX package: ``param_spec`` leaf by leaf (and, through the
port's parameter names, on each group's unstacked leaf), ``batch_axes``,
``seq_shard``, ``seq_axis``, ``batch_first``, ``kv_cache_spec`` and
``ssm_cache_spec``.  A JAX spec is compared as the tuple of its entries.
"""

import functools
import itertools

import jax
import pytest

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_config
from repro_torch.models import sharding as TS

jax.config.update("jax_platform_name", "cpu")

MESHES = {
    (16, 16): ("data", "model"),
    (2, 16, 16): ("pod", "data", "model"),
    (2, 2): ("data", "model"),
    (1, 4): ("data", "model"),
    (4, 1): ("data", "model"),
    (1, 8): ("data", "model"),
}
KINDS = ("train", "prefill", "decode")
BATCHES = (1, 4, 256)
CACHE_LEN = 4096


class StubMesh:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


@functools.lru_cache(maxsize=None)
def abstract(name):
    """(flat params [(path, shape)], flat caches by batch [(field, shape)])
    of the JAX init at full size."""
    cfg = jget_config(name)
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    params = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        params.append(("/" + "/".join(keys), tuple(leaf.shape)))
    caches = {}
    if cfg.supports_decode:
        for b in BATCHES:
            c = jax.eval_shape(lambda b=b: JT.init_caches(cfg, b, CACHE_LEN))
            caches[b] = [(str(getattr(p[-1], "name", getattr(p[-1], "key",
                                                              p[-1]))),
                          tuple(leaf.shape))
                         for p, leaf in
                         jax.tree_util.tree_flatten_with_path(c)[0]]
    return params, caches


def spec(p):
    return tuple(p)


def port_name(path):
    """The port's parameter name of a JAX path, and whether the leaf is
    stacked on the groups' leading G axis (``interop.lm_params``'s path
    mapping: ``/groups/i/<path>`` is ``groups.g.i.<path>`` for every g)."""
    parts = path.strip("/").split("/")
    if parts[0] == "groups":
        return "groups.0." + ".".join(parts[1:]), True
    return ".".join(parts), False


def policies(mesh_shape, batch):
    names = MESHES[mesh_shape]
    for kind, pure, head in itertools.product(KINDS, (False, True),
                                              (False, True)):
        kw = dict(kind=kind, head_fsdp=head, pure_fsdp=pure)
        yield (kw, JS.make_policy(StubMesh(mesh_shape, names), batch, **kw),
               TS.make_policy(StubMesh(mesh_shape, names), batch, **kw))


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_spec_matches_jax(name, mesh_shape):
    params, _ = abstract(name)
    n = 0
    for kw, jp, tp in policies(mesh_shape, 4):
        for path, shape in params:
            want = spec(jp.param_spec(path, shape))
            assert tp.param_spec(path, shape) == want, (kw, path, shape)
            pname, stacked = port_name(path)
            if stacked:
                # the port holds each group's leaf unstacked
                assert want[0] is None, (kw, path)
                got = tp.param_spec(pname, shape[1:])
                assert got == want[1:], (kw, path, pname)
            else:
                assert tp.param_spec(pname, shape) == want, (kw, pname)
            n += 1
    assert n == len(params) * len(KINDS) * 4


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("name", ARCH_IDS)
def test_batch_and_cache_specs_match_jax(name, mesh_shape):
    _, caches = abstract(name)
    cfg = get_config(name)
    S = 4096
    for b in BATCHES:
        for kw, jp, tp in policies(mesh_shape, b):
            assert tp.batch_axes == jp.batch_axes, kw
            assert tp.data_parallel_size == jp.data_parallel_size, kw
            assert tp.model_size == jp.model_size, kw
            assert tp.seq_shard == jp.seq_shard, kw
            assert tp.seq_axis == jp.seq_axis, kw
            for shape in ((b, S), (b, S, cfg.d_model), (b, 1, 1)):
                assert tp.batch_first(shape) == spec(jp.batch_first(shape))
            for field, shape in caches.get(b, ()):
                if field in ("k", "v"):
                    want = spec(jp.kv_cache_spec(shape))
                    assert tp.kv_cache_spec(shape) == want, (kw, field)
                elif field == "conv":
                    want = spec(jp.ssm_cache_spec(shape, "conv"))
                    assert tp.ssm_cache_spec(shape, "conv") == want
                elif field == "h":
                    k = "h2" if cfg.ssm_version == 2 else "h1"
                    want = spec(jp.ssm_cache_spec(shape, k))
                    assert tp.ssm_cache_spec(shape, k) == want, (kw, k)


def test_block_tiles_the_leaf():
    """``sharding.block`` cuts a dim over a tuple of axes with the first
    axis major, as ``NamedSharding`` does; the blocks tile the leaf."""
    shape = {"data": 2, "model": 2}
    seen = []
    for d in range(2):
        for m in range(2):
            sl = TS.block((8, 6), (("data", "model"), "model"), shape,
                          {"data": d, "model": m})
            assert sl[0] == slice((2 * d + m) * 2, (2 * d + m + 1) * 2)
            assert sl[1] == slice(3 * m, 3 * m + 3)
            seen.append(sl)
    assert len(set(s[0].start for s in seen)) == 4


@pytest.mark.parametrize("family", ["ssm", "hybrid", "vlm", "audio"])
def test_other_families_refuse_a_mesh(family):
    """The dense, moe, ssm and hybrid families run on more than one rank;
    the vlm and audio families raise, naming the next slice, and never run
    replicated."""
    name = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b",
            "vlm": "internvl2-26b", "audio": "hubert-xlarge"}[family]
    cfg = get_config(name)
    assert cfg.family == family
    if family in ("ssm", "hybrid"):
        assert family in TS.MESH_FAMILIES
        TS.check_family(cfg, StubMesh((2, 2), ("data", "model")))
    else:
        with pytest.raises(NotImplementedError, match="next slice"):
            TS.check_family(cfg, StubMesh((2, 2), ("data", "model")))
    TS.check_family(cfg, StubMesh((1, 1), ("data", "model")))
    TS.check_family(cfg, None)
    for ok in ("qwen3-1.7b", "qwen2-moe-a2.7b"):
        TS.check_family(get_config(ok), StubMesh((2, 2), ("data", "model")))
