"""Continuous-batching selection service on PyTorch: many concurrent
(oracle, k) queries against one corpus, served by the batched two-round
driver, with deadline-aware admission, an online ingestion path that admits
new documents between serve steps, and checkpoint/restore of the online
state so a killed service warm-starts instead of re-ingesting.

    PYTHONPATH=src python -m repro_torch.launch.select_serve --n 4096 \
        --k 32 --slots 8 --requests 24 --oracle graph_cut [--engine lazy] \
        [--use-kernel] [--deadline-ms 500] \
        [--ingest-docs 512 --ingest-every 2] \
        [--checkpoint-dir ck --checkpoint-every 4] [--restore]

Requests occupy a fixed number of SLOTS.  Each step the admission queue
fills free slots **earliest-deadline-first**; a request whose deadline
cannot be met even if served this step (the per-step latency EWMA says the
step would finish too late) is SHED: reported with a reason and counted,
never silently dropped.  Every occupied slot is answered by ONE
``DistributedSelector.select_batch`` call (one shared sample round, one
gather round, Q answers) and retired the same step; unfilled slots are
masked with k = 0.

Corpus statistics (the graph-cut / saturated-coverage feature sum
``total`` and the facility / exemplar reference set) are computed ONCE from
the initial corpus and pinned for the service's life, so the live sieve
state stays valid as the corpus grows.

``SelectionService.ingest()`` is the online path: new documents stream
host -> device through the out-of-core sieve (``repro_torch.streaming``),
each document once, ever, and ``select_warm()`` reads the answer out of the
live sieve state in O(L k) work.  ``save()`` / ``restore()`` persist the
online state (sieve state, host-corpus cursor and tail, service stats)
through ``repro_torch.checkpoint.Checkpointer``: a restarted service
continues mid-stream bit for bit.

The service sits on the port's ``DistributedSelector``: the sim substrate
of one machine, or under ``torchrun`` a mesh of every rank
(NCCL on the card, gloo with ``--device cpu``), as ``launch/select.py``
builds it.  Runs on the CUDA card unless ``--device cpu`` is given.  The
corpus, the ingested documents and the constraint data are drawn with
torch generators, so they are not the JAX CLI's draws; the synthetic
requests are (``synth_requests`` keeps numpy's generator).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import heapq
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.constraints import CONSTRAINT_NAMES, make_constraint
from repro_torch.core.grids import SCHEDULE_KINDS
from repro_torch.core.mapreduce import make_query_batch
from repro_torch.core.precision import PRECISION_NAMES
from repro_torch.core.selector import (OPT_FREE_ALGORITHMS, ORACLE_NAMES,
                                       DistributedSelector, SelectorSpec,
                                       make_oracle)
from repro_torch.core.threshold import ENGINES
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.streaming import SieveSpec, StreamingSelector, persist


def step_seed(seed: int, step: int) -> int:
    """A generator seed for step ``step`` of a run seeded ``seed`` (the
    port's counterpart of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class SelectionService:
    """One corpus, two serve paths, shared statistics.

    * ``select_batch(queries, generator)``: the batched slot path, Q
      concurrent queries against the materialized corpus in one call.
    * ``ingest(docs)`` / ``select_warm(budget)``: the online path; new
      documents are absorbed into a live one-pass sieve (host-resident
      corpus, the device sees one chunk at a time) and selections
      warm-start from its state.
    * ``save(ckpt, step)`` / ``restore(ckpt)``: online-state persistence.

    ``mesh`` is a ``launch.mesh.Mesh``, or None for the sim substrate of
    one machine (what the JAX CLI runs on one device).  Corpus statistics (reference / total) are
    computed once from the initial corpus (in float32 on the host) and
    pinned.  The host copy of the initial corpus is released once BOTH
    serve paths have consumed it.
    """

    def __init__(self, spec: SelectorSpec, mesh, init_corpus,
                 reference=None, total=None, stream_chunk: int = 512,
                 constraint=None, retry_attempts: int = 3,
                 retry_backoff_s: float = 0.05, device=None):
        # the statistics are accumulate-plane quantities: computed from the
        # f32 corpus, whose host copy is then held at the storage dtype
        host = np.asarray(torch.as_tensor(init_corpus).detach().cpu()
                          .float())
        n0, d = host.shape
        self.spec, self.mesh, self.feat_dim = spec, mesh, d
        self.device = resolve_device(device)
        if reference is None and spec.oracle in ("facility_location",
                                                 "exemplar"):
            step = max(1, n0 // spec.reference_size)
            reference = torch.from_numpy(
                host[::step][:spec.reference_size].copy())
        if total is None and spec.oracle in ("graph_cut",
                                             "saturated_coverage"):
            total = torch.from_numpy(host.sum(axis=0))
        self.reference, self.total = reference, total
        init = torch.from_numpy(host).to(spec.precision_policy.storage)

        self.selector = DistributedSelector(
            spec, n_total=n0, feat_dim=d, device=self.device,
            reference=reference, total=total, mesh=mesh)
        self._emb = None          # materialized (device) corpus, batch path

        # the online path is built eagerly (cheap: an empty state); the
        # initial corpus streams through the sieve on FIRST use of
        # ingest()/select_warm(), so a static-corpus serve never pays it.
        # The constraint rides the online path only: the batched query
        # path stays unconstrained (the batch drivers refuse constraints)
        ref_s = (None if reference is None else
                 spec.precision_policy.cast_storage(
                     torch.as_tensor(reference, device=self.device)))
        oracle = make_oracle(spec, d, self.device, reference=ref_s,
                             total=None if total is None else
                             torch.as_tensor(total, dtype=torch.float32,
                                             device=self.device))
        sieve_spec = SieveSpec(k=spec.k, eps=spec.eps, accept=spec.accept,
                               engine=spec.engine, chunk=spec.chunk,
                               precision=spec.precision,
                               constraint=constraint)
        self.stream = StreamingSelector(oracle, sieve_spec, d,
                                        chunk_elems=stream_chunk)
        self._init_corpus = init
        self._stream_started = False
        self._init_used_batch = False
        self._init_used_stream = False
        # transient-failure policy of the serving paths (ingest absorb,
        # checkpoint writes): bounded retries with exponential backoff,
        # every retry and every exhausted failure counted
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_backoff_s = float(retry_backoff_s)
        self.stats = {"served": 0, "shed": 0, "deadline_miss": 0,
                      "tau_fallback_batch": 0, "tau_fallback_warm": 0,
                      "n_dropped": 0, "ingested": int(n0),
                      "warm_selects": 0, "ingest_retries": 0,
                      "ingest_failures": 0, "checkpoint_retries": 0}

    def _maybe_release_init(self):
        """Both serve paths hold their own copy now (device corpus; sieve
        state + host tail), so drop the host copy of the initial corpus."""
        if self._init_used_batch and self._init_used_stream:
            self._init_corpus = None

    # ---- batched slot path ---------------------------------------------
    def materialize(self):
        """The initial corpus on the device, as the selector takes it: the
        whole corpus on the sim, this rank's shard on a mesh."""
        if self._emb is None:
            self._emb = (self._init_corpus.to(self.device)
                         if self.mesh is None
                         else self.selector.data_sharding(self._init_corpus))
            self._init_used_batch = True
            self._maybe_release_init()
        return self._emb

    def _ensure_stream(self):
        """First online-path use: absorb the initial corpus into the sieve
        (deferred from __init__ so static-corpus serving never pays it)."""
        if not self._stream_started:
            self._stream_started = True
            self.stream.ingest(self._init_corpus)
            self._init_used_stream = True
            self._maybe_release_init()

    def select_batch(self, queries, generator=None, uniforms=None):
        return self.selector.select_batch(self.materialize(), queries,
                                          generator=generator,
                                          uniforms=uniforms)

    def account(self, res, n_active: int):
        """Fold one step's per-request outcomes into the service stats.
        Slots fill front-first, so only the first ``n_active`` lanes are
        real requests: the k = 0 filler slots would inflate the counts."""
        self.stats["served"] += n_active
        self.stats["tau_fallback_batch"] += int(
            res.tau_fallback[:n_active].sum())
        self.stats["n_dropped"] += int(res.n_dropped[:n_active].sum())

    def account_shed(self, n_shed: int, n_miss: int = 0):
        """Deadline outcomes: ``n_shed`` requests refused at admission and
        ``n_miss`` served late; both reported, neither silent."""
        self.stats["shed"] += n_shed
        self.stats["deadline_miss"] += n_miss

    # ---- online ingestion path -----------------------------------------
    def _retrying(self, what: str, fn):
        """``fn`` with bounded retry and exponential backoff: each retried
        failure bumps ``<what>_retries``; exhaustion bumps
        ``<what>_failures`` and re-raises."""
        for attempt in range(self.retry_attempts):
            try:
                return fn()
            except Exception:       # noqa: BLE001
                if attempt == self.retry_attempts - 1:
                    self.stats[f"{what}_failures"] += 1
                    raise
                self.stats[f"{what}_retries"] += 1
                time.sleep(self.retry_backoff_s * (2 ** attempt))

    def ingest(self, docs) -> dict:
        """Admit new documents between serve steps: one host-side append
        (outside the retry loop: retrying it would duplicate documents),
        then the cursor-driven absorb, which a retry never re-streams."""
        self._ensure_stream()
        first = self.stream.corpus.append(docs)
        info = self._retrying("ingest", self.stream.absorb)
        info["first_id"] = first
        self.stats["ingested"] = info["n_total"]
        return info

    def select_warm(self, budget=None):
        """Answer from the live sieve state: O(L k) central completion,
        independent of how much has been ingested."""
        self._ensure_stream()
        res = self.stream.select(budget)
        self.stats["warm_selects"] += 1
        self.stats["tau_fallback_warm"] += int(res.tau_fallback)
        return res

    # ---- persistence ----------------------------------------------------
    def save(self, ckpt: Checkpointer, step: int, blocking: bool = True):
        """Checkpoint the online state: the SieveState, the host-corpus
        cursor and un-streamed tail, and the service stats.  Read-only, so
        saving mid-stream never perturbs the replay."""
        self._ensure_stream()   # the snapshot must cover the initial corpus
        self.stats["checkpoint_retries"] = int(ckpt.n_retries)
        state = {"stream": persist.snapshot_selector(self.stream),
                 "stats": {k: np.asarray(v, np.int64)
                           for k, v in self.stats.items()}}
        ckpt.save(step, state, blocking=blocking)
        self.stats["checkpoint_retries"] = int(ckpt.n_retries)

    def restore(self, ckpt: Checkpointer, step: Optional[int] = None) -> int:
        """Warm-start from a checkpoint: the service continues mid-stream
        (nothing absorbed is re-ingested) and every later ingest() /
        select_warm() is bit for bit the uninterrupted run's.  The service
        must be built from the same spec and stream_chunk."""
        tmpl = {"stream": persist.selector_template(self.stream),
                "stats": {k: np.zeros((), np.int64) for k in self.stats}}
        state, step = ckpt.restore(tmpl, step)
        persist.restore_selector(self.stream, state["stream"])
        self.stats = {k: int(v) for k, v in state["stats"].items()}
        self._stream_started = True
        self._init_used_stream = True
        self._maybe_release_init()
        return step

    def summary(self) -> str:
        s = self.stats
        return (f"[service] served={s['served']} shed={s['shed']} "
                f"deadline_miss={s['deadline_miss']} "
                f"warm={s['warm_selects']} ingested={s['ingested']} docs; "
                f"events: tau_fallback_batch={s['tau_fallback_batch']} "
                f"tau_fallback_warm={s['tau_fallback_warm']} "
                f"n_dropped={s['n_dropped']}; retries: "
                f"ingest={s['ingest_retries']}"
                f"(+{s['ingest_failures']} failed) "
                f"checkpoint={s['checkpoint_retries']}")


# ---------------------------------------------------------------------------
# deadline-aware admission
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One selection request.  ``deadline_ms`` is relative to arrival; None
    is best-effort (admitted after every deadlined request, EDF)."""
    id: int
    k: int
    lam: Optional[float] = None       # graph_cut per-query knob
    alpha: Optional[float] = None     # log_det per-query knob
    deadline_ms: Optional[float] = None
    arrival_s: float = 0.0            # monotonic clock, set at submit

    @property
    def abs_deadline_s(self) -> float:
        if self.deadline_ms is None:
            return math.inf
        return self.arrival_s + self.deadline_ms / 1e3


class AdmissionQueue:
    """Pending requests, admitted earliest-deadline-first.

    ``admit`` pops up to ``n_slots`` requests in deadline order; a popped
    request whose deadline cannot be met even if served THIS step
    (now + est_step_s > deadline) is returned in the shed list instead of
    taking a slot it would waste.  Best-effort requests sort after every
    deadlined one and are never shed."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0               # FIFO tie-break among equal deadlines

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        req.arrival_s = time.monotonic() if now is None else now
        heapq.heappush(self._heap, (req.abs_deadline_s, self._seq, req))
        self._seq += 1

    def __len__(self) -> int:
        return len(self._heap)

    def admit(self, n_slots: int, now: float,
              est_step_s: Optional[float]) -> tuple:
        """-> (admitted <= n_slots by EDF, shed).  Until a step-latency
        estimate exists only already-expired deadlines shed."""
        admitted, shed = [], []
        est = est_step_s or 0.0
        while self._heap and len(admitted) < n_slots:
            _, _, req = heapq.heappop(self._heap)
            if now + est > req.abs_deadline_s:
                shed.append(req)
            else:
                admitted.append(req)
        return admitted, shed


class ServeLoop:
    """Admission -> serve -> retire around a SelectionService.

    One ``run_step()`` admits free slots EDF (shedding infeasible requests,
    reported), answers every occupied slot with one select_batch call
    (its sample drawn from a generator seeded from (seed, step)), and
    retires them with per-request latency and deadline outcome.  The
    clock stops only once the answer is on the host, so the per-step
    latency EWMA (step 0, which builds the kernels, excluded) measures the
    card's work and not only its launch."""

    def __init__(self, svc: SelectionService, slots: int, seed: int = 0,
                 est_step_s: Optional[float] = None, ewma_alpha: float = 0.3):
        self.svc, self.slots, self.seed = svc, slots, seed
        self.queue = AdmissionQueue()
        self.est_step_s = est_step_s
        self.ewma_alpha = ewma_alpha
        self.step = 0
        self.t_first: Optional[float] = None   # first step's seconds
        self.first_step_served = 0
        self.step_s: list = []      # every step's seconds
        self.done: list = []        # served rows (status="ok")
        self.shed: list = []        # shed rows (status="shed", with reason)

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        self.queue.submit(req, now)

    def run_step(self) -> list:
        """One serve step; returns the rows retired this step."""
        svc, spec = self.svc, self.svc.spec
        now = time.monotonic()
        active, shed = self.queue.admit(self.slots, now, self.est_step_s)
        for req in shed:
            self.shed.append({
                "id": req.id, "k": req.k, "status": "shed",
                "latency_s": now - req.arrival_s,
                "reason": (f"deadline {req.deadline_ms:.0f}ms unmeetable "
                           f"(est step "
                           f"{(self.est_step_s or 0.0) * 1e3:.0f}ms)")})
        svc.account_shed(len(shed))
        if not active:
            return []

        pad = self.slots - len(active)
        ks_q = [r.k for r in active] + [0] * pad
        lam_q = [r.lam if r.lam is not None else spec.graph_cut_lam
                 for r in active] + [spec.graph_cut_lam] * pad
        alpha_q = [r.alpha if r.alpha is not None else spec.logdet_alpha
                   for r in active] + [spec.logdet_alpha] * pad
        dev = svc.selector.device
        qb = make_query_batch(ks_q, graph_cut_lam=lam_q,
                              logdet_alpha=alpha_q, device=dev)

        t0 = time.monotonic()
        res = svc.select_batch(qb, generator=torch.Generator(device=dev)
                               .manual_seed(step_seed(self.seed, self.step)))
        values = res.value.tolist()       # waits for the device
        finish = time.monotonic()
        dt = finish - t0
        self.step_s.append(dt)
        if self.step == 0 and self.t_first is None:
            # the step that builds the kernels: reported, kept out of the
            # EWMA
            self.t_first = dt
            self.first_step_served = len(active)
        elif self.est_step_s is None:
            self.est_step_s = dt
        else:
            a = self.ewma_alpha
            self.est_step_s = (1 - a) * self.est_step_s + a * dt

        sizes, dropped = res.sol_size.tolist(), res.n_dropped.tolist()
        fallback = res.tau_fallback.tolist()
        rows, n_miss = [], 0
        for slot, req in enumerate(active):
            missed = finish > req.abs_deadline_s
            n_miss += int(missed)
            rows.append({"id": req.id, "k": req.k, "status": "ok",
                         "size": int(sizes[slot]), "value": values[slot],
                         "dropped": int(dropped[slot]),
                         "tau_fallback": int(fallback[slot]),
                         "latency_s": finish - req.arrival_s,
                         "deadline_miss": missed})
        self.done.extend(rows)
        svc.account(res, len(active))
        svc.account_shed(0, n_miss)
        self.step += 1
        return rows


def synth_requests(n_requests: int, k_max: int, oracle: str, seed: int,
                   deadline_ms: Optional[float] = None):
    """A synthetic request stream: per-request budget and hyper-parameters
    (and a jittered deadline when ``deadline_ms`` is set), drawn with
    numpy's generator, so they equal the JAX CLI's request for request."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        req = Request(id=rid,
                      k=int(rng.integers(max(1, k_max // 4), k_max + 1)))
        if oracle == "graph_cut":
            req.lam = float(rng.uniform(0.1, 0.5))
        if oracle == "log_det":
            req.alpha = float(rng.uniform(0.5, 2.0))
        if deadline_ms is not None:
            req.deadline_ms = float(rng.uniform(0.5, 1.5) * deadline_ms)
        reqs.append(req)
    return reqs


def synth_docs(seed: int, step: int, n_docs: int, d: int,
               device=None) -> torch.Tensor:
    """Fresh documents U[0, 1)^2 for ingest step ``step``, drawn on
    ``device`` from a generator seeded from (seed, step) and returned on
    the host, so every cadence step streams NEW rows.  They are torch's
    draws, not the JAX CLI's documents."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    return (torch.rand((n_docs, d), generator=gen, device=dev) ** 2).cpu()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="batched selection service")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=32,
                    help="max per-request budget (= slot buffer capacity)")
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8,
                    help="request slots Q (the batch dimension)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--oracle", default="feature_coverage",
                    choices=list(ORACLE_NAMES))
    ap.add_argument("--engine", default="dense", choices=list(ENGINES))
    ap.add_argument("--use-kernel", action="store_true",
                    help="route oracle marginals/accepts through the CUDA "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--precision", default="f32",
                    choices=list(PRECISION_NAMES),
                    help="storage precision of the corpus, gather messages "
                         "and sieve pools (accumulators stay f32)")
    ap.add_argument("--algorithm", default="two_round",
                    choices=list(OPT_FREE_ALGORITHMS),
                    help="OPT-free driver backing the service (the batch "
                         "path always runs the 1-epoch pipeline)")
    ap.add_argument("--constraint", default="cardinality",
                    choices=list(CONSTRAINT_NAMES),
                    help="feasibility constraint on the ONLINE (sieve) "
                         "path's warm selections; the batched query path "
                         "stays unconstrained.  The launcher draws "
                         "synthetic per-element costs / part labels over "
                         "the largest corpus the service can grow to")
    ap.add_argument("--budget", type=float, default=None,
                    help="knapsack cost budget (default: k * mean cost / 2)")
    ap.add_argument("--n-parts", type=int, default=8,
                    help="partition_matroid: number of parts (capacities "
                         "split k evenly)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="multi_epoch threshold levels; None derives "
                         "ceil(1/eps)")
    ap.add_argument("--schedule", default="paper",
                    choices=list(SCHEDULE_KINDS))
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline budget (jittered 0.5-1.5x "
                         "per request); unmeetable requests are shed and "
                         "reported")
    ap.add_argument("--ingest-docs", type=int, default=0,
                    help="admit this many new docs between serve steps "
                         "(0 = static corpus)")
    ap.add_argument("--ingest-every", type=int, default=2,
                    help="ingest cadence in serve steps")
    ap.add_argument("--stream-chunk", type=int, default=512,
                    help="out-of-core sieve chunk (device footprint rows)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist the online state (sieve + cursor + "
                         "stats) here")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="serve steps between async checkpoints")
    ap.add_argument("--restore", action="store_true",
                    help="warm-start the online state from the latest "
                         "checkpoint in --checkpoint-dir (no re-ingest)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    mesh = None
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        # one machine a rank: NCCL on this rank's card, gloo on the CPU
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh_for(dist.get_world_size(), model_parallel=1)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    emb = (torch.rand((args.n, args.d), generator=gen, device=device)
           ** 2).cpu()

    # ---- per-CORPUS statistics: computed once, cached for every request --
    t0 = time.time()
    spec = SelectorSpec(k=args.k, oracle=args.oracle,
                        algorithm=args.algorithm, epochs=args.epochs,
                        schedule_kind=args.schedule, engine=args.engine,
                        use_kernel=args.use_kernel,
                        precision=args.precision)
    # synthetic per-element constraint data sized for the LARGEST corpus
    # the service can reach, so the plane lookup covers every id the sieve
    # will see
    constraint = None
    if args.constraint != "cardinality":
        n_max = args.n + args.ingest_docs * max(1, args.requests)
        gc = torch.Generator(device=device).manual_seed(step_seed(args.seed,
                                                                  7))
        costs = parts = caps = budget = None
        if args.constraint == "knapsack":
            costs = 0.5 + 1.5 * torch.rand(n_max, generator=gc,
                                           device=device)
            budget = (args.budget if args.budget is not None
                      else args.k * 1.25 / 2.0)
        else:
            parts = torch.randint(0, args.n_parts, (n_max,), generator=gc,
                                  device=device)
            caps = torch.full((args.n_parts,), max(1, args.k // args.n_parts),
                              dtype=torch.int32)
        constraint = make_constraint(args.constraint, n_max, costs=costs,
                                     budget=budget, parts=parts,
                                     capacities=caps, device=device)
    svc = SelectionService(spec, mesh, emb, stream_chunk=args.stream_chunk,
                           constraint=constraint, device=device)
    del emb
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    if args.restore:
        if ckpt is None:
            raise SystemExit("--restore needs --checkpoint-dir")
        step0 = svc.restore(ckpt)
        print(f"[select_serve] restored online state @ checkpoint step "
              f"{step0}: corpus={svc.stream.n_total} docs already absorbed "
              f"(no re-ingest)")
    svc.materialize()
    print(f"[select_serve] corpus ready: n={args.n} d={args.d} "
          f"oracle={args.oracle} constraint={args.constraint} "
          f"device={device} stats cached in {(time.time() - t0) * 1e3:.0f}ms")

    loop = ServeLoop(svc, args.slots, args.seed)
    for req in synth_requests(args.requests, args.k, args.oracle, args.seed,
                              deadline_ms=args.deadline_ms):
        loop.submit(req)
    t_online = 0.0     # ingest/warm time, kept out of the serving qps
    t_serve = time.time()
    while len(loop.queue):
        # ---- the online path between steps, on its own cadence ---------
        if args.ingest_docs and loop.step and \
                loop.step % args.ingest_every == 0:
            t0o = time.time()
            docs = synth_docs(args.seed, loop.step, args.ingest_docs,
                              args.d, device)
            try:
                info = svc.ingest(docs)
                warm = svc.select_warm()
                print(f"[select_serve] step {loop.step}: ingested "
                      f"{args.ingest_docs} docs (corpus={info['n_total']}), "
                      f"warm f(S)={float(warm.value):.4f} "
                      f"|S|={int(warm.sol_size)}")
            except Exception as e:      # noqa: BLE001
                # retries exhausted: report the reason and keep serving the
                # batch path; the cursor-driven absorb catches up next time
                print(f"[select_serve] step {loop.step}: INGEST FAILED "
                      f"after {svc.retry_attempts} attempts "
                      f"({type(e).__name__}: {e}); continuing, absorb "
                      f"resumes at the stream cursor")
            t_online += time.time() - t0o

        # ---- admit (EDF, shed infeasible) / serve / retire --------------
        loop.run_step()

        # ---- async checkpoint on its own cadence ------------------------
        if ckpt and args.checkpoint_every and loop.step and \
                loop.step % args.checkpoint_every == 0:
            try:
                svc.save(ckpt, loop.step, blocking=False)
            except RuntimeError as e:
                # a PREVIOUS async save exhausted its retries: report it and
                # try again; the final blocking save re-raises if it persists
                print(f"[select_serve] step {loop.step}: CHECKPOINT FAILED "
                      f"({e}); retrying this step")
                svc.save(ckpt, loop.step, blocking=False)
    if ckpt:
        svc.save(ckpt, max(loop.step, 1))   # final blocking save (waits out
        #                                     and surfaces async errors)
    t_total = time.time() - t_serve

    done, shed, step = loop.done, loop.shed, loop.step
    # steady state leaves the first step out of both numerator and
    # denominator; with one step there is no steady-state window
    t_first = loop.t_first or 0.0
    if step > 1:
        qps = (len(done) - loop.first_step_served) \
            / max(t_total - t_first - t_online, 1e-9)
        rate = f"steady-state {qps:.1f} queries/s"
    else:
        rate = (f"{len(done) / max(t_total, 1e-9):.1f} queries/s incl. the "
                f"first step (single step: no steady-state window)")
    print(f"[select_serve] slots={args.slots} served={len(done)} "
          f"shed={len(shed)} steps={step} first-step "
          f"{t_first * 1e3:.0f}ms, {rate}")
    if done:
        lat = np.asarray([r["latency_s"] for r in done])
        steps_ms = np.asarray(loop.step_s) * 1e3
        print(f"[select_serve] latency p50={np.percentile(lat, 50) * 1e3:.0f}"
              f"ms p99={np.percentile(lat, 99) * 1e3:.0f}ms; step "
              f"p50={np.percentile(steps_ms, 50):.3f}ms "
              f"p99={np.percentile(steps_ms, 99):.3f}ms")
        print(svc.selector.round_log_batch.summary())
    print(svc.summary())
    for r in done[: min(8, len(done))]:
        print(f"[select_serve]   req {r['id']:3d}: k={r['k']:3d} "
              f"|S|={r['size']:3d} f(S)={r['value']:.4f} "
              f"dropped={r['dropped']} tau_fallback={r['tau_fallback']} "
              f"lat={r['latency_s'] * 1e3:.0f}ms")
    for r in shed[: min(4, len(shed))]:
        print(f"[select_serve]   req {r['id']:3d}: SHED ({r['reason']})")
    if len(done) + len(shed) != args.requests:
        raise RuntimeError("requests lost: every submitted request must be "
                           "served or reported shed")
    bad = [r for r in done if r["size"] > r["k"]]
    if bad:
        raise RuntimeError(f"slots exceeded their budget: {bad}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
