"""Carrying data across from the JAX side.

The system has no weights: what crosses is numpy data (the corpus sharded
(m, n/m, d) with its ids and validity, the coverage oracles' optional (d,)
weights, FacilityLocation's and ExemplarClustering's (r, d) reference set,
SaturatedCoverage's and GraphCut's (d,) ground-set total, a log-det
oracle's (U, logdet, size) state, a knapsack's costs and budget or a
partition matroid's labels and caps, the sample rounds' U[0, 1) draws on
the sim and on the mesh, a query batch's budgets and hyper-parameters, a
fault plan, the Theorem-4 instance's oracle, and a streaming sieve's spec
and live state).  The LM stack does have weights: ``lm_params`` and
``lm_caches`` carry a JAX parameter tree and KV caches across,
``adamw_state`` an optimizer state, and ``lm_tree`` carries the port's
parameters or gradients back into the JAX tree.  On a mesh of several
ranks ``lm_params`` and ``lm_caches`` give a rank only its block of each
leaf (the slice that JAX's ``NamedSharding(mesh, spec)`` puts on the
device at the same mesh coordinates, device r being rank r, row-major),
and ``gather`` rebuilds a whole leaf from every rank's block.  These
helpers turn such arrays into the port's tensors and oracle on a given
device, so a test can feed the same inputs to both packages.  numpy
bfloat16 arrays (the ``ml_dtypes`` type that JAX hands out) arrive as
torch.bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.constraints import Knapsack, PartitionMatroid
from repro_torch.core.faults import FaultPlan
from repro_torch.core.functions import (AdversarialThreshold,
                                        ExemplarClustering, FacilityLocation,
                                        FeatureCoverage, GraphCut,
                                        LogDetDiversity,
                                        MutualInformationGaussian,
                                        SaturatedCoverage, WeightedCoverage)
from repro_torch.core.mapreduce import QueryBatch
from repro_torch.models import layers as LM
from repro_torch.models import ssm as SSM
from repro_torch.models.model import Model
from repro_torch.models.sharding import assemble, block, mesh_ranks
from repro_torch.optim.adamw import OptState
from repro_torch.streaming.sieve import SieveSpec, SieveState


def tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``, keeping its dtype; bfloat16 is carried bit for bit."""
    a = np.array(a)  # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _f32(a, device):
    return None if a is None else tensor(np.asarray(a, np.float32), device)


def shard(feats_mk, ids_mk, valid_mk, device="cpu"):
    """The sharded corpus (m, n/m, d), ids (m, n/m) int32 and validity
    (m, n/m) bool, as the sim drivers take them."""
    return (tensor(feats_mk, device),
            tensor(np.asarray(ids_mk, np.int32), device),
            tensor(np.asarray(valid_mk, bool), device))


def feature_coverage(feat_dim: int, weights=None, use_kernel: bool = False,
                     device="cpu") -> FeatureCoverage:
    """The FeatureCoverage oracle with the JAX side's optional weights."""
    return FeatureCoverage(feat_dim=feat_dim, weights=_f32(weights, device),
                           use_kernel=use_kernel, device=torch.device(device))


def facility_location(feat_dim: int, reference, use_kernel: bool = False,
                      device="cpu") -> FacilityLocation:
    """The FacilityLocation oracle over the JAX side's (r, d) reference
    set, kept in its dtype (a bf16 set is carried bit for bit)."""
    return FacilityLocation(feat_dim=feat_dim,
                            reference=tensor(reference, device),
                            use_kernel=use_kernel, device=torch.device(device))


def exemplar(feat_dim: int, reference, use_kernel: bool = False,
             device="cpu") -> ExemplarClustering:
    """The ExemplarClustering oracle over the JAX side's (r, d) reference
    set, kept in its dtype (a bf16 set is carried bit for bit)."""
    return ExemplarClustering(feat_dim=feat_dim,
                              reference=tensor(reference, device),
                              use_kernel=use_kernel,
                              device=torch.device(device))


def knapsack(costs, budget: float, device="cpu") -> Knapsack:
    """The Knapsack constraint over the JAX side's (n,) costs, float32,
    and its budget."""
    return Knapsack(budget=float(budget),
                    costs=_f32(np.asarray(costs).reshape(-1), device))


def partition_matroid(parts, caps, device="cpu") -> PartitionMatroid:
    """The PartitionMatroid constraint over the JAX side's (n,) part labels
    and (P,) capacities, int32."""
    return PartitionMatroid(
        capacities=tensor(np.asarray(caps, np.int32).reshape(-1), device),
        parts=tensor(np.asarray(parts, np.int32).reshape(-1), device))


def weighted_coverage(feat_dim: int, weights=None, use_kernel: bool = False,
                      device="cpu") -> WeightedCoverage:
    """The WeightedCoverage oracle with the JAX side's optional (U,) item
    weights, kept float32 (None: all ones)."""
    return WeightedCoverage(feat_dim=feat_dim, weights=_f32(weights, device),
                            use_kernel=use_kernel, device=torch.device(device))


def saturated_coverage(feat_dim: int, total, alpha: float = 0.25,
                       weights=None, use_kernel: bool = False,
                       device="cpu") -> SaturatedCoverage:
    """The SaturatedCoverage oracle with the JAX side's (d,) ground-set
    total and optional (d,) weights, both kept float32, so the cap
    alpha * total is the same f32 product in both packages."""
    return SaturatedCoverage(feat_dim=feat_dim, total=_f32(total, device),
                             alpha=alpha, weights=_f32(weights, device),
                             use_kernel=use_kernel, device=torch.device(device))


def graph_cut(feat_dim: int, total, lam: float = 0.5,
              use_kernel: bool = False, device="cpu") -> GraphCut:
    """The GraphCut oracle with the JAX side's (d,) ground-set total, kept
    float32."""
    return GraphCut(feat_dim=feat_dim, total=_f32(total, device), lam=lam,
                    use_kernel=use_kernel, device=torch.device(device))


def log_det(feat_dim: int, k_max: int, alpha: float = 1.0,
            use_kernel: bool = False, device="cpu") -> LogDetDiversity:
    """The LogDetDiversity oracle with the JAX side's k_max and alpha."""
    return LogDetDiversity(feat_dim=feat_dim, k_max=k_max, alpha=alpha,
                           use_kernel=use_kernel, device=torch.device(device))


def mutual_information(feat_dim: int, k_max: int, noise: float = 1.0,
                       use_kernel: bool = False,
                       device="cpu") -> MutualInformationGaussian:
    """The MutualInformationGaussian oracle with the JAX side's k_max and
    noise."""
    return MutualInformationGaussian(feat_dim=feat_dim, k_max=k_max,
                                     noise=noise, use_kernel=use_kernel,
                                     device=torch.device(device))


def logdet_state(U, logdet, size, device="cpu"):
    """A JAX log-det state (U (k, d) f32, logdet () f32, size () int32),
    or one stacked over lanes ((L, k, d), (L,), (L,)), as the port's tuple
    state."""
    return (_f32(U, device), _f32(logdet, device),
            tensor(np.asarray(size, np.int32), device))


def uniforms(draws, device="cpu") -> torch.Tensor:
    """The sample rounds' draws, (E, m, n/m) or (m, n/m), as float32."""
    return _f32(draws, device)


def mesh_uniforms(rows, device="cpu") -> torch.Tensor:
    """The mesh's draws as the port's (E, m, n/m) float32 block:
    ``rows[e][c]`` is machine c's (n/m,) draw of epoch e, which the JAX
    mesh drivers make from ``jax.random.fold_in(epoch_key, c)`` (where the
    sim splits the epoch key over the machines)."""
    return _f32(np.stack([np.stack([np.asarray(r, np.float32) for r in rs])
                          for rs in rows]), device)


def fault_plan(plan):
    """A JAX ``FaultPlan`` (or any object with its fields) as the port's;
    None stays None.  The masks are the same numpy draws in both
    packages."""
    if plan is None:
        return None
    return FaultPlan(**{f: getattr(plan, f) for f in (
        "loss_rate", "drop_rate", "corrupt_rate", "straggler_rate",
        "straggler_deadline_ms", "seed")})


def adversarial(k: int, vstar: float = 1.0,
                device="cpu") -> AdversarialThreshold:
    """The Theorem-4 instance's oracle with the JAX side's k and v*."""
    return AdversarialThreshold(feat_dim=2, k=k, vstar=vstar,
                                device=torch.device(device))


def query_batch(qb, device="cpu") -> QueryBatch:
    """A JAX QueryBatch (or any triple of (Q,) arrays: budgets,
    GraphCut's lam, LogDetDiversity's alpha) as the port's, the budgets
    int32 and the hyper-parameters float32."""
    k, lam, alpha = qb
    return QueryBatch(tensor(np.asarray(k, np.int32).reshape(-1), device),
                      _f32(np.asarray(lam).reshape(-1), device),
                      _f32(np.asarray(alpha).reshape(-1), device))


def sieve_spec(spec, constraint=None) -> SieveSpec:
    """A JAX ``SieveSpec`` (or any object with its fields) as the port's.
    ``constraint`` is the port's constraint (``knapsack`` or
    ``partition_matroid`` above carry the JAX one's data), or None."""
    return SieveSpec(**{f: getattr(spec, f) for f in (
        "k", "eps", "n_lanes", "top_cap", "accept", "engine", "chunk",
        "precision")}, constraint=constraint)


def sieve_state(state, spec: SieveSpec, device="cpu") -> SieveState:
    """A JAX ``SieveState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's, so both packages can go on from one mid-stream
    state: every leaf bit for bit (bfloat16 feature pools included), a
    log-det oracle state as the port's tuple, and the feasibility states
    only where the port's constraint keeps one.  Raises ValueError when a
    leaf's shape or dtype is not what ``spec`` gives."""
    want = SieveState._fields
    st = dict(zip(want, state))
    ost = st["oracle_states"]
    oracle_states = (tuple(tensor(a, device) for a in ost)
                     if isinstance(ost, (tuple, list)) else tensor(ost, device))
    cn = spec.constraint
    keeps = cn is not None and cn.init_state(1) is not None
    out = SieveState(
        oracle_states=oracle_states,
        **{f: tensor(st[f], device) for f in want
           if f not in ("oracle_states", "cstates")},
        cstates=tensor(st["cstates"], device) if keeps else ())
    L, k, T = spec.lanes, spec.k, spec.tops
    sdt = spec.precision_policy.storage
    for name, shape, dtype in (
            ("sol_ids", (L, k), torch.int32),
            ("sol_feats", (L, k, out.sol_feats.shape[-1]), sdt),
            ("sol_sizes", (L,), torch.int32), ("exps", (L,), torch.int32),
            ("v_max", (), torch.float32), ("n_seen", (), torch.int32),
            ("top_feats", (T, out.top_feats.shape[-1]), sdt),
            ("top_ids", (T,), torch.int32), ("top_vals", (T,), torch.float32)):
        got = getattr(out, name)
        if tuple(got.shape) != shape or got.dtype != dtype:
            raise ValueError(f"sieve_state: {name} is {tuple(got.shape)} "
                             f"{got.dtype}, the spec gives {shape} {dtype}")
    return out


def _flat(tree, prefix=""):
    """A nested dict's leaves by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def lm_params(tree, cfg, device="cpu", dtype=torch.bfloat16,
              policy=None) -> Model:
    """A ``Model`` of ``cfg`` holding the JAX package's parameter tree
    (``repro.models.transformer.init_params``; numpy or JAX leaves): the
    embedding table, the groups' leaves stacked on a leading G axis (one
    dict per sublayer: ``tree["groups"][i][...][g]`` is group g's sublayer
    i, an attention sublayer with ``mlp`` or ``moe`` or an SSM one), the
    hybrid family's unstacked ``shared_block``, the final norm and the
    untied head, each bit for bit in f32.  A leaf of the wrong shape, and a
    leaf that one tree has and the other lacks, raise ValueError.
    ``dtype`` is the port model's compute dtype; ``policy`` places the
    parameters on a mesh (``Model(..., policy=)``): each parameter gets this
    rank's block of its leaf."""
    model = Model(cfg, torch.Generator(device=device).manual_seed(0), device,
                  dtype, policy)
    p = model.params
    mesh = model.mesh

    def put(dst, src):
        src = np.asarray(src)
        spec = getattr(dst, "spec", None)
        if spec is not None:
            src = src[block(src.shape, spec, mesh.shape, mesh.coords)]
        src = tensor(src, device)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"lm_params: a leaf of shape {tuple(src.shape)}"
                             f" for a parameter of {tuple(dst.shape)}")
        dst.data.copy_(src)

    def put_module(where, module, sub, g=None):
        dst = dict(module.named_parameters())
        src = _flat(sub)
        if set(dst) != set(src):
            raise ValueError(f"lm_params: {where} holds {sorted(src)}, the "
                             f"port's {sorted(dst)}")
        for name, leaf in src.items():
            put(dst[name], leaf if g is None else leaf[g])

    if p.embed is not None:
        put(p.embed["table"], tree["embed"]["table"])
    if len(tree["groups"]) != len(p.groups[0]):
        raise ValueError(f"lm_params: {len(tree['groups'])} sublayers a "
                         f"group, the port's {len(p.groups[0])}")
    for g, group in enumerate(p.groups):
        for i, (blk, sub) in enumerate(zip(group, tree["groups"])):
            put_module(f"sublayer {i}", blk, sub, g)
    if (p.shared_block is None) != ("shared_block" not in tree):
        raise ValueError("lm_params: a shared_block in one tree only")
    if p.shared_block is not None:
        put_module("shared_block", p.shared_block, tree["shared_block"])
    put(p.final_norm, tree["final_norm"])
    if p.lm_head is not None:
        put(p.lm_head, tree["lm_head"])
    return model


def _jax_leaf(tree, name: str):
    """The leaf of a JAX-layout tree (``init_params``'s structure, groups
    stacked on a leading G) for the port's parameter ``name``
    (``Model.params.named_parameters()``'s dotted names): group g's
    sublayer i's ``groups.g.i.<path>`` is ``tree["groups"][i][<path>][g]``."""
    parts = name.split(".")
    if parts[0] != "groups":
        node = tree
        for k in parts:
            node = node[k]
        return node
    g, i, rest = int(parts[1]), int(parts[2]), parts[3:]
    node = tree["groups"][i]
    for k in rest:
        node = node[k]
    return node[g]


def adamw_state(jax_opt, model: Model):
    """A JAX ``adamw.OptState`` (step, and m, v in the parameters' tree) as
    the port's: the step an int32 0-d tensor, m and v f32 by the port's
    parameter names, on the model's device; on a mesh each moment is this
    rank's block of its leaf, as its parameter is (ZeRO-3 under the train
    policy)."""
    named = dict(model.params.named_parameters())
    dev, mesh = model.device, model.mesh

    def leaf(tree, n):
        a = np.asarray(_jax_leaf(tree, n), np.float32)
        spec = getattr(named[n], "spec", None)
        if spec is not None:
            a = a[block(a.shape, spec, mesh.shape, mesh.coords)]
        return tensor(a, dev)

    def moments(tree):
        return {n: leaf(tree, n) for n in named}
    return OptState(step=tensor(np.asarray(jax_opt.step, np.int32), dev),
                    m=moments(jax_opt.m), v=moments(jax_opt.v))


def _nest(flat):
    """Dotted names -> nested dicts."""
    out = {}
    for name, leaf in flat.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def lm_tree(model: Model, grads: bool = False):
    """The port's parameters (or, with ``grads``, their ``.grad``; None
    reads as zeros) as numpy arrays in the JAX package's tree: the groups'
    leaves re-stacked on a leading G axis, one dict a sublayer; the inverse
    of ``lm_params``.  On a mesh each leaf is this rank's block
    (``gather_named`` rebuilds the whole leaves from every rank's)."""
    def host(p):
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().cpu().numpy()

    named = dict(model.params.named_parameters())
    flat = {n: host(p) for n, p in named.items()
            if not n.startswith("groups.")}
    tree = _nest(flat)
    G, n_sub = len(model.params.groups), len(model.params.groups[0])
    subs = []
    for i in range(n_sub):
        pre = f"groups.0.{i}."
        rel = [n[len(pre):] for n in named if n.startswith(pre)]
        subs.append(_nest({r: np.stack([host(named[f"groups.{g}.{i}.{r}"])
                                        for g in range(G)]) for r in rel}))
    tree["groups"] = subs
    return tree


#: the port's cache types by the JAX package's NamedTuple names
_CACHES = {"KVCache": LM.KVCache, "Mamba1Cache": SSM.Mamba1Cache,
           "Mamba2Cache": SSM.Mamba2Cache}


def _cache(c, device, policy):
    kind = _CACHES.get(type(c).__name__)
    if kind is None or len(c) != len(kind._fields):
        raise ValueError(f"lm_caches: a {type(c).__name__} of {len(c)} "
                         f"leaves; the port knows {sorted(_CACHES)}")
    if policy is None or mesh_ranks(policy.mesh) == 1:
        return kind(*(tensor(t, device) for t in c))
    mesh = policy.mesh
    h = "h1" if kind is SSM.Mamba1Cache else "h2"
    out = []
    for field, t in zip(kind._fields, c):
        t = np.asarray(t)
        # as cache_shardings: k, v by kv_cache_spec, conv and h by
        # ssm_cache_spec; slot_pos replicated
        if field in ("k", "v"):
            spec = policy.kv_cache_spec(t.shape)
        elif field in ("conv", "h"):
            spec = policy.ssm_cache_spec(t.shape,
                                         "conv" if field == "conv" else h)
        else:
            spec = (None,) * t.ndim
        out.append(tensor(t[block(t.shape, spec, mesh.shape, mesh.coords)],
                          device))
    return kind(*out)


def lm_caches(caches, device="cpu", policy=None):
    """The JAX package's decode caches (``{"sub": [KVCache | Mamba1Cache |
    Mamba2Cache, ...]}`` and the hybrid family's ``"shared"`` KVCache,
    leaves stacked on a leading G axis) as the port's, each leaf bit for
    bit; with a ``policy`` on a mesh of more than one rank, this rank's
    block of each leaf (``ShardingPolicy.kv_cache_spec`` and
    ``ssm_cache_spec``, as the JAX package's ``cache_shardings``)."""
    out = {"sub": [_cache(c, device, policy) for c in caches["sub"]]}
    if "shared" in caches:
        out["shared"] = _cache(caches["shared"], device, policy)
    return out


def gather(blocks, spec, mesh_shape):
    """The whole array from every rank's block under ``spec``: ``blocks``
    in rank order (row-major over ``mesh_shape``, a dict of axis sizes in
    the mesh's order), each a numpy array; the inverse of the placement."""
    return assemble([np.asarray(b) for b in blocks], spec, mesh_shape)


def gather_named(blocks, specs, mesh_shape):
    """Whole arrays by the port's parameter names from every rank's blocks:
    ``blocks`` in rank order, each a {name: numpy block} dict (a
    parameter's, its moment's or its gradient's), ``specs`` {name: spec}
    (``p.spec``), ``mesh_shape`` the axis sizes in the mesh's order."""
    return {n: gather([b[n] for b in blocks], specs[n], mesh_shape)
            for n in blocks[0]}
