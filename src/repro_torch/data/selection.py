"""The paper's technique in the input path: submodular batch curation.

The port of the JAX package's ``repro.data.selection``.  Every
``select_every`` steps, a candidate pool of ``pool_factor * batch``
documents is drawn, embedded (``doc_embeddings``), and the MapReduce
selector picks the most diverse/covering ``batch`` of them in two rounds.
On one card (``policy.mesh`` None) the selector runs the sim substrate with
one machine, and its tensor-parallel oracle is inert; on the training mesh
it runs on the ``("pod", "data")`` axes there are, one machine a rank
there, the oracle's features split over "model" (``oracle_tp``): every rank
draws the same pool, takes its shard of the embeddings, and gets the same
ids back.  The sample round draws from a
generator derived from (seed + 77, step), so a curated batch, like a plain
one, is a pure function of the step.
"""

from __future__ import annotations

import torch

from repro_torch.core.selector import DistributedSelector, SelectorSpec
from repro_torch.data.pipeline import SyntheticLM, doc_embeddings, \
    step_generator
from repro_torch.models.sharding import ShardingPolicy


class SelectionPipeline:
    """Wraps SyntheticLM with paper-powered batch curation."""

    def __init__(self, base: SyntheticLM, policy: ShardingPolicy,
                 emb_dim: int = 64, oracle: str = "feature_coverage"):
        self.base = base
        self.policy = policy
        self.emb_dim = emb_dim
        d = base.data
        self.pool = d.pool_factor * d.global_batch
        spec = SelectorSpec(k=d.global_batch, oracle=oracle,
                            algorithm="two_round", oracle_tp=True)
        self.selector = DistributedSelector(
            spec, n_total=self.pool, feat_dim=emb_dim, device=base.device,
            mesh=policy.mesh, axes=("pod", "data"))
        self._last_sel = None

    def batch_at(self, step: int):
        d = self.base.data
        if not d.select_every or step % d.select_every:
            return self.base.batch_at(step)
        # draw pool_factor candidate batches, embed, select k=batch docs
        pools = [self.base.batch_at(step * d.pool_factor + i + 10_000)
                 for i in range(d.pool_factor)]
        cat = {k: torch.cat([p[k] for p in pools], dim=0) for k in pools[0]}
        emb = doc_embeddings(cat, self.emb_dim)
        opt_est = self.selector.opt_upper_bound(emb)
        if self.policy.mesh is not None:
            emb = self.selector.data_sharding(emb)
        res = self.selector.select(
            emb, opt_est,
            generator=step_generator(d.seed + 77, step, self.base.device))
        idx = torch.where(res.sol_ids >= 0, res.sol_ids, 0).long()
        self._last_sel = res
        return {k: v[idx] for k, v in cat.items()}
