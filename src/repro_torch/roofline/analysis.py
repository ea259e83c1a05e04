"""Three-term roofline arithmetic on one NVIDIA H100.

    compute    = flops            / (chips * PEAK_FLOPS)
    memory     = bytes            / (chips * HBM_BW)
    collective = collective_bytes / (chips * LINK_BW)

The JAX package reads flops and bytes from a compiled XLA program's
``cost_analysis()`` and parses collectives out of its HLO text.  The port
has no XLA program: its callers count the bytes and operations of their own
work (a decode step's weights and caches, ``model_flops_for``) and hand
them to ``from_costs``.  The HLO parser (``collective_bytes``,
``from_dryrun``) has no counterpart yet; it comes with the dry-run.

Hardware constants: the H100 SXM, from NVIDIA's H100 Tensor Core GPU data
sheet (dense rates, no sparsity, at the full 700 W power limit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989.4e12      # bf16 dense tensor-core FLOP/s per card
PEAK_F32 = 67e12           # f32 FLOP/s per card off the tensor cores
HBM_BW = 3.35e12           # HBM3 B/s per card
LINK_BW = 450e9            # NVLink 4 B/s per card, one direction (900 GB/s
#                            both ways)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def dtype_bytes(dtype) -> int:
    """Bytes per element, accepting a dtype name ("bf16", "f32": the HLO
    spelling, which the precision policy names share), a ``torch.dtype``,
    or anything numpy can make a dtype of."""
    if isinstance(dtype, str):
        if dtype in _DTYPE_BYTES:
            return _DTYPE_BYTES[dtype]
        raise ValueError(f"unknown dtype name {dtype!r}; "
                         f"known: {sorted(_DTYPE_BYTES)}")
    itemsize = getattr(dtype, "itemsize", None)
    if isinstance(itemsize, int):   # torch.dtype, numpy dtype
        return itemsize
    import numpy as np
    return int(np.dtype(dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class Roofline:
    name: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_type: Dict[str, float]
    model_flops: float = 0.0          # 6*N*D (active) — global, all chips
    peak_memory_bytes: float = 0.0    # per device

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-optimal step time = max of the three terms (perfect
        overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs over all chips — catches remat and
        redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.chips / self.t_bound) / PEAK_FLOPS

    def row(self) -> Dict:
        return {
            "name": self.name, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.flops_per_device,
            "useful_flops_frac": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "peak_memory_gb": self.peak_memory_bytes / 2 ** 30,
            "coll_by_type": self.coll_by_type,
        }


def from_costs(name: str, chips: int, cost: Dict, coll_by_type: Dict,
               model_flops: float = 0.0,
               peak_memory_bytes: float = 0.0) -> Roofline:
    """A Roofline from counted costs: ``cost`` holds "flops" and "bytes
    accessed" per device (the keys of XLA's cost analysis), ``coll_by_type``
    the collective operand bytes per device by kind."""
    return Roofline(
        name=name, chips=chips,
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_device=float(sum(coll_by_type.values())),
        coll_by_type=dict(coll_by_type),
        model_flops=model_flops,
        peak_memory_bytes=peak_memory_bytes)


def extrapolate_costs(cost_1g: Dict, cost_2g: Dict, coll_1g: Dict,
                      coll_2g: Dict, n_groups: int):
    """Per-layer-group linear extrapolation of counted costs:

        total(G) = cost(1g) + (G - 1) * (cost(2g) - cost(1g))

    which is exact for homogeneous layer groups (all assigned archs) —
    the constant part (embed / logits / loss / their optimizer update)
    lives in cost(1g) and the per-group part in the delta.
    """
    def _extr(a, b):
        keys = set(a) | set(b)
        return {k: float(a.get(k, 0.0)) +
                (n_groups - 1) * (float(b.get(k, 0.0)) - float(a.get(k, 0.0)))
                for k in keys}
    return (_extr({k: v for k, v in cost_1g.items()
                   if isinstance(v, (int, float))},
                  {k: v for k, v in cost_2g.items()
                   if isinstance(v, (int, float))}),
            _extr(coll_1g, coll_2g))


def model_flops_for(cfg, shape) -> float:
    """6*N_active*D per trained token; 2*N_active*D per generated/prefilled
    token (fwd only).  D = tokens processed in the step.

    Prefill computes logits only for the LAST position, so the lm-head's
    2*V*d_model flops are charged once per sequence, not per token."""
    n = cfg.active_param_count()
    # the head matmul costs 2*V*D per scored position whether or not its
    # weights are tied to the embedding table
    head = cfg.d_model * cfg.vocab_size
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * (n - head) * toks + 2.0 * head * shape.global_batch
    toks = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * toks
