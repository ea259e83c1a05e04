"""Streaming selection: the one-pass sieve, distributed sieve-and-merge,
and out-of-core / online corpus ingestion with checkpoint and restore.

The MapReduce drivers (``repro_torch.core.mapreduce``) select k from a
materialized corpus; this package serves the companion regimes: corpora
that arrive over time, exceed device memory, or live as per-machine
streams.  It reuses the oracle zoo, the ThresholdGreedy engines and their
CUDA kernels unchanged.
"""

from repro_torch.streaming.distributed_sieve import (sieve_and_merge_mesh,
                                                     sieve_and_merge_sim)
from repro_torch.streaming.ingest import (HostCorpus, StreamingSelector,
                                          prefetch_to_device)
from repro_torch.streaming.persist import (CheckpointCorruptError,
                                           restore_selector,
                                           selector_template,
                                           snapshot_selector)
from repro_torch.streaming.sieve import (SieveSpec, SieveState, merge_pool,
                                         sieve_best, sieve_chunks,
                                         sieve_finish, sieve_init, sieve_run,
                                         sieve_update)

__all__ = [
    "SieveSpec", "SieveState", "merge_pool", "sieve_best", "sieve_chunks",
    "sieve_finish", "sieve_init", "sieve_run", "sieve_update",
    "sieve_and_merge_mesh", "sieve_and_merge_sim",
    "HostCorpus", "StreamingSelector", "prefetch_to_device",
    "CheckpointCorruptError",
    "restore_selector", "selector_template", "snapshot_selector",
]
