"""ShardingPolicy: one object that answers every "which axis?" question.

The port of the JAX package's ``repro.models.sharding``, its rule tables
verbatim.  Scheme:
  * batch   -> ("pod", "data")  (pod only on the multi-pod mesh)
  * TP      -> "model" on heads / d_ff / experts / vocab
  * FSDP    -> "data" on the d_model dim of weights (gathered just before
               use, then dropped)
  * ZeRO-3 (``pure_fsdp``): batch over every axis, each weight sharded over
    ("data", "model") on one dim; vocab stays on "model"
  * decode caches: batch over the batch axes, else the sequence over
    "data"; head_dim over "model"

A spec is a plain tuple with one entry a dimension: an axis name, a tuple
of axis names (the dimension split over them jointly, the first axis
major, as in JAX's ``PartitionSpec``) or None.  Every spec is validated
against divisibility (``_fit``): a non-dividing axis is dropped to None.
The policy reads the mesh only through ``launch.mesh.Mesh``'s ``shape``
(and, where tensors are placed, ``coords`` and ``group(axes)``); ``None``
is a mesh of one rank.

Where the JAX package lets GSPMD insert the collectives, the port's
layers call them (``models.collectives``).  Every tensor of the LM stack
on a rank is its block of one of these specs; ``place`` cuts a global
tensor into this rank's block and ``collectives.reshard`` moves a block
from one spec to another.  The mesh path covers the dense, moe, ssm and
hybrid families, serving and training (ZeRO-3 for ``parallelism="fsdp"``,
TP + FSDP for "tp"); ``check_family`` refuses the vlm and audio families
on more than one rank, and ``check_train`` a train step the port cannot
shard (a batch that leaves an axis idle).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

Spec = Tuple

#: families that run on a mesh of more than one rank
MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def mesh_ranks(mesh) -> int:
    """Ranks of ``mesh`` (1 for None)."""
    return 1 if mesh is None else math.prod(mesh.shape.values())


def check_family(cfg, mesh) -> None:
    """Raise NotImplementedError for a family the mesh path does not cover
    when ``mesh`` holds more than one rank: nothing runs replicated."""
    if mesh_ranks(mesh) > 1 and cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh of "
            f"{mesh_ranks(mesh)} ranks; the port shards the "
            f"{', '.join(MESH_FAMILIES)} families only; the vlm and audio "
            f"families' inputs on a mesh come with the next slice "
            f"(ROADMAP.md queue 1)")


def check_train(cfg, policy) -> None:
    """Raise for a train step on a mesh of several ranks that the port
    does not shard: a family off the mesh path, a policy that is not the
    config's ``parallelism`` (ZeRO-3 for "fsdp", TP + FSDP for "tp"), a
    mesh axis that carries no tokens and splits no layer's work (its ranks
    would repeat one another's work, and the weight gradients' sums over
    it would count that work more than once; under TP the model axis
    carries none but splits the layers, its ranks' partial gradients
    summed by the Megatron pair), or a vocabulary the model axis does not
    split (the CE is vocab-parallel)."""
    mesh = policy.mesh
    if mesh_ranks(mesh) == 1:
        return
    check_family(cfg, mesh)
    if cfg.parallelism not in ("fsdp", "tp") or \
            policy.pure_fsdp != (cfg.parallelism == "fsdp"):
        raise ValueError(
            f"{cfg.name}: a {'ZeRO-3' if policy.pure_fsdp else 'TP'} "
            f"policy for parallelism={cfg.parallelism!r}; the port trains "
            f"\"fsdp\" under ZeRO-3 and \"tp\" under TP + FSDP")
    splits = (policy.model_axis,) if policy.tensor_parallel else ()
    idle = [a for a, n in mesh.shape.items()
            if n > 1 and a not in policy.token_axes and a not in splits]
    if idle:
        raise ValueError(
            f"{cfg.name}: a micro-batch of {policy.global_batch} rows leaves "
            f"the mesh's {idle} axes without tokens; pick a batch the "
            f"(pod, data) axes divide")
    if cfg.padded_vocab % policy.model_size:
        raise ValueError(f"{cfg.name}: the vocabulary {cfg.padded_vocab} "
                         f"does not split over the model axis of "
                         f"{policy.model_size}")


def axes_of(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, in order (empty for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def split_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec splits a dim over, in the spec's order."""
    return tuple(a for entry in spec for a in axes_of(entry))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Optional[object]
    global_batch: int
    kind: str = "train"            # train | prefill | decode
    model_axis: str = "model"
    fsdp: bool = True
    head_fsdp: bool = True         # False: vocab-parallel lm_head (None, m)
    pure_fsdp: bool = False        # ZeRO-3: batch over ALL axes, weights
                                   # sharded over ("data","model") on one dim,
                                   # no tensor parallelism (vocab stays on
                                   # "model" for the CE)
    seq_shard: Optional[str] = None  # axis carrying the SEQUENCE dim of
                                   # activations: set for prefill when the
                                   # request batch cannot fill the mesh —
                                   # attention all-gathers K/V, everything
                                   # else stays local

    @property
    def shape(self):
        """The mesh's axis sizes ({} for a mesh of one rank)."""
        return {} if self.mesh is None else self.mesh.shape

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        cand = ("pod", "data", "model") if self.pure_fsdp else ("pod", "data")
        axes = tuple(a for a in cand if a in self.shape)
        size = 1
        out = []
        for a in axes:
            if self.global_batch % (size * self.shape[a]) == 0:
                out.append(a)
                size *= self.shape[a]
        return tuple(out)

    @property
    def data_parallel_size(self) -> int:
        s = 1
        for a in self.batch_axes:
            s *= self.shape[a]
        return s

    @property
    def model_size(self) -> int:
        return self.shape.get(self.model_axis, 1)

    @property
    def seq_axis(self) -> Optional[str]:
        """Axis for KV-cache sequence sharding when batch can't fill 'data'
        (the long_500k path)."""
        if "data" in self.batch_axes or "data" not in self.shape:
            return None
        return "data"

    @property
    def token_axes(self) -> Tuple[str, ...]:
        """The axes over which the ranks' token blocks differ: the batch
        axes, and the sequence axis under ``seq_shard``."""
        ax = self.batch_axes
        if self.seq_shard and self.seq_shard not in ax:
            ax = ax + (self.seq_shard,)
        return ax

    def replicated_axes(self, spec) -> Tuple[str, ...]:
        """The token-carrying axes that ``spec`` (a leaf's fitted spec)
        does not split, in the mesh's order: a leaf's gradient from
        backward holds only this rank's tokens' share over them, so it is
        summed over them before the clip.  Under tensor parallelism the
        model axis carries no tokens: a leaf whole over it (a norm,
        ``conv_b``, ``norm_w``, ``A_log2``) already holds its whole
        gradient on each of its ranks (the layers' ``replicate`` summed
        the partial ones), so it is summed over "data" only."""
        split = set(split_axes(spec))
        return tuple(a for a in self.shape
                     if a in self.token_axes and a not in split)

    @property
    def tensor_parallel(self) -> bool:
        """Whether the layers split heads, d_ff and experts over the model
        axis (else every weight is gathered whole before use)."""
        return self.model_size > 1 and not self.pure_fsdp

    # -- spec helpers ------------------------------------------------------
    def _fit(self, spec: Spec, shape) -> Spec:
        fixed = []
        for dim, entry in enumerate(spec):
            if entry is None:
                fixed.append(None)
                continue
            size = 1
            for a in axes_of(entry):
                size *= self.shape.get(a, 1)
            if dim < len(shape) and shape[dim] % size == 0 and size > 1:
                fixed.append(entry)
            else:
                fixed.append(None)
        return tuple(fixed)

    def spec(self, *entries, shape=None) -> Spec:
        return self._fit(entries, shape) if shape is not None else entries

    def _entry(self, axes) -> object:
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    def batch_first(self, shape) -> Spec:
        ba = self.batch_axes
        rest = [None] * (len(shape) - 1)
        if self.seq_shard and len(shape) >= 2 and \
                self.seq_shard not in ba:
            rest[0] = self.seq_shard  # dim 1 = sequence
        return self._fit((self._entry(ba), *rest), shape)

    def logits_spec(self, shape) -> Spec:
        """(B, S, V) logits: batch over the batch axes but the model axis,
        the vocab over the model axis (``transformer.logits_fn``)."""
        ba = tuple(a for a in self.batch_axes if a != self.model_axis)
        return self._fit((self._entry(ba), None, self.model_axis), shape)

    def constrain_tokens(self, x):
        """(B, S, ...) activations as this rank holds them: its block of
        ``batch_first`` (batch over batch_axes, the sequence over
        seq_shard).  Raises when the batch dim is not the block's."""
        want = self.global_batch // self.data_parallel_size
        if self.mesh is not None and x.shape[0] != want:
            raise ValueError(f"constrain_tokens: a block of {x.shape[0]} "
                             f"rows, the batch_first block holds {want}")
        return x

    def for_decode(self) -> "ShardingPolicy":
        """The decode policy of the same mesh and batch (the serve bundles'
        cache layout)."""
        return dataclasses.replace(self, kind="decode", pure_fsdp=False,
                                   seq_shard=None)

    # -- parameter rules ---------------------------------------------------
    def param_spec(self, path: str, shape) -> Spec:
        """Rule table keyed on leaf-name substrings; `path` is the
        '/'- or '.'-joined tree path.  Stacked layer dims (leading
        n_groups dims) are detected by the base rank."""
        fsdp = "data" if self.fsdp else None
        m = self.model_axis
        leaf = path.replace(".", "/").split("/")[-1]

        if self.pure_fsdp:
            return self._pure_fsdp_rule(leaf, shape)

        def base_rule() -> Tuple:
            if leaf in ("table",):                    # embedding (V, D)
                # head_fsdp=False: vocab-parallel table; non-dividing
                # vocabs keep the D sharding
                if not self.head_fsdp and shape[-2] % self.model_size == 0:
                    return (m, None)
                return (None, m)
            if leaf in ("lm_head",):                  # (D, V)
                if not self.head_fsdp and shape[-1] % self.model_size == 0:
                    return (None, m)
                return (fsdp, m)
            if leaf in ("wq", "wk", "wv", "wg", "wu", "in_proj", "router"):
                return (fsdp, m)
            if leaf in ("wo", "wd", "out_proj"):
                return (m, fsdp)
            if leaf in ("x_proj",):                   # (di, R+2N)
                return (m, None)
            if leaf in ("dt_proj",):                  # (R, di)
                return (None, m)
            if leaf in ("conv_w", "A_log"):           # (ch, ...) / (H,)...
                return (m,) + (None,) * 16
            if leaf in ("dt_bias", "D_skip"):
                return (m,)
            if leaf in ("we_gate", "we_up"):          # (E, D, F)
                if self.n_experts_divisible(shape[-3]):
                    return (m, None, None)
                return (None, fsdp, m)
            if leaf == "we_down":                     # (E, F, D)
                if self.n_experts_divisible(shape[-3]):
                    return (m, None, None)
                return (None, m, fsdp)
            return (None,) * 16

        rule = base_rule()
        base_rank = _BASE_RANK.get(leaf)
        if base_rank is None:
            if leaf == "A_log":
                base_rank = min(len(shape), 2)
            else:
                base_rank = min(len(shape), 1)  # norms/biases: 1-D leaves
        n_stack = max(0, len(shape) - base_rank)
        entries = (None,) * n_stack + tuple(rule[: len(shape) - n_stack])
        return self._fit(entries, shape)

    def _pure_fsdp_rule(self, leaf: str, shape) -> Spec:
        """ZeRO-3 rules: one dim of every weight sharded over
        ("data","model") jointly; the vocab dim of table/lm_head stays on
        "model" so the logits remain vocab-sharded."""
        m = self.model_axis
        all_ax = tuple(a for a in ("data", m) if a in self.shape)
        aa = all_ax if len(all_ax) > 1 else (all_ax[0] if all_ax else None)
        base = {
            "table": (m, "data") if len(shape) == 2 and
            shape[0] % max(self.model_size, 1) == 0 else (None, aa),
            "lm_head": (None, m) if len(shape) == 2 and
            shape[1] % max(self.model_size, 1) == 0 else (aa, None),
            "wq": (aa, None), "wk": (aa, None), "wv": (aa, None),
            "wg": (aa, None), "wu": (aa, None), "in_proj": (aa, None),
            "router": (aa, None),
            "wo": (aa, None), "wd": (aa, None), "out_proj": (aa, None),
            "x_proj": (aa, None), "dt_proj": (None, aa),
            "conv_w": (aa,) + (None,) * 16,
            "A_log": (aa,) + (None,) * 16,
            "dt_bias": (aa,), "D_skip": (aa,),
            # a2a-EP layout: experts over "model", ZeRO dim over "data"
            "we_gate": (m, "data", None), "we_up": (m, "data", None),
            "we_down": (m, "data", None),
        }
        rule = base.get(leaf)
        base_rank = _BASE_RANK.get(leaf)
        if rule is None or base_rank is None:
            if leaf == "A_log":
                rule, base_rank = base["A_log"], min(len(shape), 2)
            else:
                rule, base_rank = (aa,), min(len(shape), 1)
        n_stack = max(0, len(shape) - base_rank)
        entries = (None,) * n_stack + tuple(rule[: len(shape) - n_stack])
        return self._fit(entries, shape)

    def n_experts_divisible(self, n_experts: int) -> bool:
        return self.model_size > 1 and n_experts % self.model_size == 0 or \
            self.model_size == 1

    # -- cache rules -------------------------------------------------------
    def kv_cache_spec(self, shape) -> Spec:
        """(B, C, KV, hd) (+ leading stack dims).  Batch over batch_axes when
        divisible; else sequence over 'data'. head_dim over 'model'."""
        ba = self.batch_axes
        entries = [None] * (len(shape) - 4) + [self._entry(ba), self.seq_axis,
                                               None, self.model_axis]
        return self._fit(tuple(entries), shape)

    def ssm_cache_spec(self, shape, kind: str) -> Spec:
        bentry = self._entry(self.batch_axes)
        if kind == "conv":   # (B, cw-1, ch)
            entries = [None] * (len(shape) - 3) + [bentry, None,
                                                   self.model_axis]
        elif kind == "h1":   # (B, di, N)
            entries = [None] * (len(shape) - 3) + [bentry, self.model_axis,
                                                   None]
        else:                # h2: (B, H, hd, N)
            entries = [None] * (len(shape) - 4) + [bentry, self.model_axis,
                                                   None, None]
        return self._fit(tuple(entries), shape)


_BASE_RANK = {"table": 2, "lm_head": 2, "wq": 2, "wk": 2, "wv": 2,
              "wg": 2, "wu": 2, "in_proj": 2, "router": 2, "wo": 2,
              "wd": 2, "out_proj": 2, "x_proj": 2, "dt_proj": 2,
              "conv_w": 2, "dt_bias": 1, "D_skip": 1,
              "we_gate": 3, "we_up": 3, "we_down": 3}


def make_policy(mesh, global_batch: int, kind: str = "train",
                fsdp: bool = True, head_fsdp: bool = True,
                pure_fsdp: bool = False) -> ShardingPolicy:
    p = ShardingPolicy(mesh=mesh, global_batch=global_batch, kind=kind,
                       fsdp=fsdp, head_fsdp=head_fsdp, pure_fsdp=pure_fsdp)
    if pure_fsdp and kind in ("train", "prefill") and \
            p.model_axis in p.shape and \
            p.model_axis not in p.batch_axes:
        # batch can't fill the mesh: spill the sequence onto the idle
        # model axis (sequence/context parallelism)
        p = dataclasses.replace(p, seq_shard=p.model_axis)
    return p


# -- blocks of a spec ---------------------------------------------------------

def block(shape, spec: Spec, mesh_shape, coords):
    """The slices of ``shape`` that the rank at ``coords`` holds under
    ``spec``: dim d split into prod(sizes of its axes) equal blocks, the
    rank's block the row-major index of its coordinates along the axes
    (JAX's ``NamedSharding`` layout)."""
    out = []
    for d, n in enumerate(shape):
        axes = axes_of(spec[d]) if d < len(spec) else ()
        parts, idx = 1, 0
        for a in axes:
            parts *= mesh_shape[a]
            idx = idx * mesh_shape[a] + coords[a]
        size = n // parts
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def assemble(blocks, spec: Spec, mesh_shape):
    """The global tensor (or numpy array) from every rank's block under
    ``spec``, ``blocks`` in rank order (row-major over ``mesh_shape``, the
    axis sizes in the mesh's order); the inverse of ``place``."""
    names = list(mesh_shape)
    dims = tuple(mesh_shape[a] for a in names)
    b0 = blocks[0]
    shape = tuple(n * math.prod(mesh_shape[a] for a in axes_of(
        spec[d] if d < len(spec) else None)) for d, n in enumerate(b0.shape))
    out = b0.new_empty(shape) if hasattr(b0, "new_empty") else \
        np.empty(shape, b0.dtype)
    for r, b in enumerate(blocks):
        coords = dict(zip(names, (int(c) for c in np.unravel_index(r, dims))))
        out[block(shape, spec, mesh_shape, coords)] = b
    return out


def place(t, spec: Spec, mesh):
    """This rank's block of the global tensor ``t`` under ``spec`` (a copy
    that owns its storage; ``t`` itself on a mesh of one rank)."""
    if mesh_ranks(mesh) == 1:
        return t
    return t[block(t.shape, spec, mesh.shape, mesh.coords)].clone()
