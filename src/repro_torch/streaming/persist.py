"""State codec for the streaming and serving stack: a live
``StreamingSelector`` (sieve state + host-corpus cursor) through
``repro_torch.checkpoint.Checkpointer``, so a killed service restores
mid-stream.

The one-pass contract keeps the format small: rows the sieve has absorbed
are never read again, so a snapshot carries only

  * ``sieve``: the whole ``SieveState`` (lane oracle states, solution
    buffers and feature rows, exponent window, v_max, the top-singleton
    reservoir, the feasibility states);
  * ``cursor``: ``n_streamed`` / ``n_total`` / ``chunk_elems`` (chunk
    boundaries derive from the cursor, so the chunk size is part of the
    replay);
  * ``tail``: the un-streamed host rows [n_streamed, n_total), at the
    storage dtype, O(partial chunk).

Restore guarantee: with the same oracle / spec / chunk_elems,
``restore_selector`` followed by any sequence of ingest()/select() calls is
bit for bit the uninterrupted run of the same sequence.
"""

from __future__ import annotations

import numpy as np
import torch

# re-exported: the checkpoint layer raises it for truncated or corrupted
# files, and restore_selector for a snapshot whose tail disagrees with its
# own cursor, so serving callers catch one error type either way
from repro_torch.checkpoint.checkpointer import (CheckpointCorruptError,
                                                 flatten, unflatten)
from repro_torch.streaming.ingest import HostCorpus, StreamingSelector

__all__ = ["CheckpointCorruptError", "snapshot_selector",
           "selector_template", "restore_selector"]


def snapshot_selector(sel: StreamingSelector) -> dict:
    """Checkpointable snapshot of a live selector (read-only: it does not
    flush the tail or otherwise advance the stream)."""
    n_streamed, n_total = sel.n_streamed, sel.corpus.n_total
    tail = (sel.corpus._rows(n_streamed, n_total) if n_total > n_streamed
            else torch.zeros((0, sel.corpus.feat_dim),
                             dtype=sel.corpus.dtype))
    return {
        "sieve": sel.state,
        "cursor": {
            "n_streamed": np.asarray(n_streamed, np.int64),
            "n_total": np.asarray(n_total, np.int64),
            "chunk_elems": np.asarray(sel.corpus.chunk_elems, np.int64),
        },
        "tail": tail,
    }


def selector_template(sel: StreamingSelector) -> dict:
    """Restore template for ``Checkpointer.restore``: the leaf paths of
    ``snapshot_selector`` on any selector built from the same spec (the
    stored shapes win, so a fresh selector's empty tail is fine)."""
    return snapshot_selector(sel)


def restore_selector(sel: StreamingSelector, snap: dict) -> None:
    """Overwrite ``sel``'s live state with a snapshot.  ``sel`` must be
    freshly built from the same oracle / spec / feat_dim / chunk_elems; a
    chunk size, tree, leaf shape or dtype, or tail dtype mismatch raises
    ValueError (a silent mismatch would corrupt the stream), and a tail
    that disagrees with the cursor raises CheckpointCorruptError."""
    cur = snap["cursor"]
    chunk_elems = int(cur["chunk_elems"])
    if chunk_elems != sel.corpus.chunk_elems:
        raise ValueError(
            f"restore_selector: checkpoint streamed with chunk_elems="
            f"{chunk_elems} but this selector uses "
            f"{sel.corpus.chunk_elems}; chunk boundaries are part of the "
            f"replay, so restoring across chunk sizes breaks bit identity")
    fresh = [v for _, v in flatten(sel.state)]
    incoming = [v for _, v in flatten(snap["sieve"])]
    if len(fresh) != len(incoming):
        raise ValueError("restore_selector: sieve-state tree mismatch "
                         "(different spec?)")
    for a, b in zip(fresh, incoming):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(
                f"restore_selector: sieve leaf mismatch {tuple(a.shape)}/"
                f"{a.dtype} vs checkpoint {tuple(b.shape)}/{b.dtype}: the "
                f"selector must be built from the spec that produced the "
                f"checkpoint")
    n_streamed, n_total = int(cur["n_streamed"]), int(cur["n_total"])
    tail = torch.as_tensor(snap["tail"])
    # a policy mismatch would silently re-quantize the tail and break the
    # replay's bit identity, so fail loudly instead
    if tail.dtype != sel.corpus.dtype:
        raise ValueError(
            f"restore_selector: checkpoint tail is {tail.dtype} but this "
            f"selector's precision policy stores {sel.corpus.dtype}; the "
            f"selector must be built with the precision that produced the "
            f"checkpoint")
    if n_streamed + tail.shape[0] != n_total:
        # the cursor and the tail were written together; disagreement
        # means the snapshot is damaged, not a spec mismatch
        raise CheckpointCorruptError(
            f"snapshot tail holds {tail.shape[0]} rows but the cursor "
            f"promises [{n_streamed}, {n_total}): truncated or damaged "
            f"checkpoint")
    sel.state = unflatten(sel.state, [b.to(a.device)
                                      for a, b in zip(fresh, incoming)])
    corpus = HostCorpus(sel.corpus.feat_dim, chunk_elems, base=n_streamed,
                        dtype=sel.corpus.dtype)
    if tail.shape[0]:
        corpus.append(tail)
    sel.corpus = corpus
    sel.n_streamed = n_streamed
