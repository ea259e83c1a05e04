"""Out-of-core ingestion: the corpus lives in host memory in fixed-size
chunks and is double-buffer prefetched through the sieve, so selection runs
on n far larger than device memory, and new documents can arrive between
selections.

Memory model: the device holds ONE (B, d) chunk in flight, plus the next
chunk being copied, plus the O(L k d) sieve state.  The full (n, d) corpus
exists only as host tensors inside ``HostCorpus``.

Warm starts: the sieve is one-pass and its state is fixed-shape, so
``StreamingSelector.ingest()`` absorbs new documents incrementally (each
element streamed exactly once, ever) and ``select()`` is a cheap read of
the live state, O(L k) pool completion independent of n.

Determinism: replaying the same sequence of ingest()/select() calls with
the same data is bit for bit the same (chunk boundaries are part of the
replay: a select() flushes the partial tail chunk, which advances the
stream exactly as it does on the replay).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.mapreduce import SelectionResult
from repro_torch.streaming.sieve import (SieveSpec, sieve_finish, sieve_init,
                                         sieve_update)


class HostCorpus:
    """A growing host-resident corpus, handed out as fixed-size chunks.

    Rows get global ids in arrival order.  ``chunks(start)`` yields
    (feats (B, d), ids (B,) int32, valid (B,) bool) CPU tensors, the tail
    chunk zero-padded and masked invalid.  Rows are held at ``dtype``, the
    precision policy's storage dtype (torch.float32 or torch.bfloat16).

    Chunk assembly is O(log P + rows copied) in the number of appended
    parts P: a cumulative-offset index (``np.searchsorted`` over the parts'
    first global ids) finds the overlapping parts directly, so a
    long-lived service ingesting many small batches stays linear overall.

    ``base`` is the global id of the first row still held: ``prune(upto)``
    releases whole parts the one-pass consumer has finished with, and a
    checkpoint-restored corpus is rebuilt from the un-streamed tail with
    ``base`` = the stream cursor, so ids keep their arrival-order meaning
    across restarts."""

    def __init__(self, feat_dim: int, chunk_elems: int = 512, base: int = 0,
                 dtype=torch.float32):
        self.feat_dim = int(feat_dim)
        self.chunk_elems = int(chunk_elems)
        self.base = int(base)
        self.dtype = dtype
        self._parts: List[torch.Tensor] = []
        self._starts = np.empty((8,), np.int64)  # global id of part i's row 0
        self.n_total = int(base)

    def append(self, feats) -> int:
        """Add rows (a tensor or anything ``torch.as_tensor`` takes; kept on
        the host at the corpus dtype); returns the first global id of the
        appended block."""
        feats = torch.as_tensor(feats).to(device="cpu", dtype=self.dtype)
        if feats.dim() != 2 or feats.shape[1] != self.feat_dim:
            raise ValueError(f"HostCorpus.append: expected (m, "
                             f"{self.feat_dim}) rows, got "
                             f"{tuple(feats.shape)}")
        first = self.n_total
        if len(self._parts) == self._starts.shape[0]:   # amortized doubling
            self._starts = np.concatenate(
                [self._starts, np.empty_like(self._starts)])
        self._starts[len(self._parts)] = first
        self._parts.append(feats)
        self.n_total += feats.shape[0]
        return first

    def _part_range(self, start: int, stop: int) -> tuple:
        """[i0, i1) indices of the parts overlapping global rows
        [start, stop): the searchsorted index lookup."""
        starts = self._starts[: len(self._parts)]
        i0 = int(np.searchsorted(starts, start, side="right")) - 1
        i1 = int(np.searchsorted(starts, stop, side="left"))
        return max(i0, 0), i1

    def _rows(self, start: int, stop: int) -> torch.Tensor:
        """Global rows [start, stop): a view of one part when they lie in
        one, else a new tensor."""
        if start < self.base:
            raise ValueError(
                f"rows [{start}, {stop}) reach below base={self.base}: they "
                f"were pruned after the one-pass stream consumed them")
        i0, i1 = self._part_range(start, stop)
        spans = []
        for idx in range(i0, i1):
            lo = int(self._starts[idx])
            a, b = max(start, lo), min(stop, lo + self._parts[idx].shape[0])
            if a < b:
                spans.append(self._parts[idx][a - lo:b - lo])
        if len(spans) == 1:
            return spans[0]
        if not spans:
            return torch.empty((0, self.feat_dim), dtype=self.dtype)
        return torch.cat(spans)

    def prune(self, upto: int) -> int:
        """Release whole parts entirely below global id ``upto`` (rows a
        one-pass consumer never reads again); returns the parts dropped.
        A part straddling ``upto`` is kept whole."""
        drop = 0
        while drop < len(self._parts) and \
                int(self._starts[drop]) + self._parts[drop].shape[0] <= upto:
            drop += 1
        if drop:
            self._parts = self._parts[drop:]
            n = len(self._parts)
            self._starts[:n] = self._starts[drop: drop + n]
            self.base = int(self._starts[0]) if n else self.n_total
        return drop

    def chunks(self, start: int, stop: Optional[int] = None,
               full_only: bool = False) -> Iterator[tuple]:
        """Yield (feats, ids, valid) host chunks covering [start, stop)."""
        B = self.chunk_elems
        stop = self.n_total if stop is None else stop
        at = start
        while at < stop:
            hi = min(at + B, stop)
            if full_only and hi - at < B:
                return
            feats = self._rows(at, hi)
            ids = torch.arange(at, hi, dtype=torch.int32)
            valid = torch.ones((hi - at,), dtype=torch.bool)
            if hi - at < B:     # padded tail
                pad = B - (hi - at)
                feats = torch.cat([feats, feats.new_zeros((pad,
                                                           self.feat_dim))])
                ids = torch.cat([ids, ids.new_full((pad,), -1)])
                valid = torch.cat([valid, valid.new_zeros((pad,))])
            yield feats, ids, valid
            at = hi


class _Staging:
    """One pinned host buffer per chunk tensor, and the event of the last
    copy that read it."""

    def __init__(self, chunk):
        self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in chunk]
        self.done: Optional[torch.cuda.Event] = None


def prefetch_to_device(chunks: Iterable[tuple], device=None
                       ) -> Iterator[tuple]:
    """Double-buffered host -> device transfer of a stream of host chunk
    tuples: chunk t + 1 is on its way while chunk t is consumed.

    On a CUDA device every chunk goes through one of two pinned staging
    buffers and is copied with ``non_blocking=True`` on a side stream; the
    consumer's stream waits on that copy's event before it gets the chunk.
    A staging buffer is refilled only after the event of the copy that last
    read it: writing pinned memory that a copy still reads would corrupt a
    chunk, and only sometimes.  On the CPU the chunks pass through as they
    are (nothing to pin or copy)."""
    dev = torch.device("cuda" if device is None else device)
    it = iter(chunks)
    if dev.type != "cuda":
        for c in it:
            yield tuple(t.to(dev) for t in c)
        return
    side = torch.cuda.Stream(device=dev)
    staging: List[_Staging] = []

    def issue(slot: int, chunk):
        if len(staging) <= slot:
            staging.append(_Staging(chunk))
        st = staging[slot]
        if st.done is not None:
            st.done.synchronize()     # the last copy out of it has ended
        for buf, t in zip(st.bufs, chunk):
            buf.copy_(t)
        with torch.cuda.stream(side):
            out = tuple(buf.to(dev, non_blocking=True) for buf in st.bufs)
            st.done = torch.cuda.Event()
            st.done.record(side)
        return out, st.done

    def hand_over(out, done):
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(done)
        for t in out:
            t.record_stream(cur)      # freed only after the consumer's use
        return out

    try:
        nxt = issue(0, next(it))
    except StopIteration:
        return
    slot = 0
    for c in it:
        slot ^= 1
        cur, nxt = nxt, issue(slot, c)
        yield hand_over(*cur)
    yield hand_over(*nxt)


class StreamingSelector:
    """Online selection over a host-resident, growing corpus.

    ``ingest(docs)`` appends documents and streams every newly completed
    chunk through the sieve update; ``select()`` flushes the partial tail
    chunk and reads a selection out of the live sieve state.  Selection
    cost is O(L k), independent of how much has been ingested: the
    warm-start win over re-running a MapReduce driver on the whole corpus.
    Runs on the oracle's device (the CUDA card unless it was built with
    ``device="cpu"``).
    """

    def __init__(self, oracle, spec: SieveSpec, feat_dim: int,
                 chunk_elems: int = 512, retain_streamed: bool = False):
        self.oracle = oracle
        self.spec = spec
        self.device = oracle.device
        # host chunks are held at the policy's storage dtype, so the bytes
        # crossing host -> device per chunk already reflect the policy
        self.corpus = HostCorpus(feat_dim, chunk_elems,
                                 dtype=spec.precision_policy.storage)
        self.state = sieve_init(oracle, spec, feat_dim)
        self.n_streamed = 0      # rows already absorbed by the sieve
        # the sieve is one-pass, so by default fully consumed host parts
        # are pruned after streaming: a long-lived service holds
        # O(unstreamed tail), not O(history)
        self.retain_streamed = retain_streamed

    def _update(self, state, feats, ids, valid):
        return sieve_update(self.oracle, self.spec, state, feats, ids, valid)

    def _finish(self, state, k_dyn):
        return sieve_finish(self.oracle, self.spec, state, k_dyn=k_dyn)

    @property
    def n_total(self) -> int:
        return self.corpus.n_total

    def ingest(self, docs) -> dict:
        """Append document feature rows and absorb every newly completed
        chunk (full chunks only: the tail waits for more documents or for
        the next select()'s flush).  Returns ingest stats."""
        first = self.corpus.append(docs)
        info = self.absorb()
        info["first_id"] = first
        return info

    def _stream(self, full_only: bool) -> int:
        n_chunks = 0
        for f, i, v in prefetch_to_device(
                self.corpus.chunks(self.n_streamed, full_only=full_only),
                self.device):
            self.state = self._update(self.state, f, i, v)
            self.n_streamed = min(self.n_streamed + f.shape[0],
                                  self.n_total)
            n_chunks += 1
        if not self.retain_streamed:
            self.corpus.prune(self.n_streamed)
        return n_chunks

    def absorb(self) -> dict:
        """Stream every newly completed chunk through the sieve.  Split out
        from ingest() so a serving layer can retry it: absorb is driven by
        the ``n_streamed`` cursor, so calling it again after a failed or
        partial absorb continues where it stopped; no row is ever streamed
        twice (the append happened once, outside any retry loop)."""
        n_chunks = self._stream(full_only=True)
        return {"n_total": self.n_total, "streamed": self.n_streamed,
                "chunks": n_chunks}

    def select(self, budget: Optional[int] = None) -> SelectionResult:
        """Warm selection from the live sieve state (flushes the pending
        tail first).  ``budget`` <= spec.k serves a smaller per-request
        cardinality from the same buffers."""
        if budget is not None and budget > self.spec.k:
            # the lane and solution buffers are spec.k wide: a larger
            # budget would silently truncate, so fail loudly instead
            raise ValueError(
                f"select: budget {budget} exceeds the sieve buffer "
                f"capacity spec.k={self.spec.k}; build the "
                f"StreamingSelector with a larger k")
        self._stream(full_only=False)
        return self._finish(self.state,
                            self.spec.k if budget is None else int(budget))
