"""The port's selection service (``launch/select_serve.py``) on the CPU: the
service cases of the JAX package's test_serving_persist.py and
test_streaming.py, on the port.

* EDF admission and shedding, and the deadline-shed regression of the
  serve loop;
* ``synth_requests`` equal to the JAX package's request for request, and
  ``synth_docs`` fresh at every step;
* ingest, warm select and the stats split between the batch and warm
  paths; ``save`` is read-only; the initial corpus is released once both
  paths hold it; ingest retries are idempotent and their exhaustion is
  reported; a service checkpoint restores bit for bit;
* the CLI as a subprocess with ``--device cpu`` (n 2048, d 16, k 8), with
  ingest, checkpoints and a second run with ``--restore``.

The corpus is U[0, 1)^2 from numpy; the JAX package is called only for the
synthetic requests.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import select_serve as jserve
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.mapreduce import make_query_batch
from repro_torch.core.selector import SelectorSpec
from repro_torch.launch.select_serve import (AdmissionQueue, Request,
                                             SelectionService, ServeLoop,
                                             synth_docs, synth_requests)
from test_torch_streaming import leaves

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _corpus(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)).astype(np.float32)) ** 2


def _service(spec, corpus, **kw):
    return SelectionService(spec, None, corpus, device="cpu", **kw)


def _qb(ks):
    return make_query_batch(ks, device="cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_admission_earliest_deadline_first():
    q = AdmissionQueue()
    q.submit(Request(id=0, k=4, deadline_ms=None), now=0.0)   # best-effort
    q.submit(Request(id=1, k=4, deadline_ms=900.0), now=0.0)
    q.submit(Request(id=2, k=4, deadline_ms=200.0), now=0.0)
    q.submit(Request(id=3, k=4, deadline_ms=500.0), now=0.0)
    admitted, shed = q.admit(3, now=0.0, est_step_s=None)
    assert [r.id for r in admitted] == [2, 3, 1] and not shed
    admitted, shed = q.admit(3, now=0.0, est_step_s=None)
    assert [r.id for r in admitted] == [0] and not shed


def test_admission_sheds_unmeetable_deadlines():
    q = AdmissionQueue()
    q.submit(Request(id=0, k=4, deadline_ms=50.0), now=0.0)
    q.submit(Request(id=1, k=4, deadline_ms=5000.0), now=0.0)
    q.submit(Request(id=2, k=4), now=0.0)
    admitted, shed = q.admit(4, now=1.0, est_step_s=0.5)
    assert [r.id for r in shed] == [0] and [r.id for r in admitted] == [1, 2]
    q.submit(Request(id=3, k=4, deadline_ms=0.0), now=0.0)
    q.submit(Request(id=4, k=4, deadline_ms=1e7), now=0.0)
    admitted, shed = q.admit(4, now=1.0, est_step_s=None)
    assert [r.id for r in shed] == [3] and [r.id for r in admitted] == [4]


def test_serve_loop_deadline_shed_regression():
    n, d, k, Q = 256, 8, 8, 4
    svc = _service(SelectorSpec(k=k), _corpus(n, d, 1))
    loop = ServeLoop(svc, Q, seed=0)
    for rid in range(Q):
        loop.submit(Request(id=rid, k=k))
    loop.submit(Request(id=99, k=k, deadline_ms=0.0))   # expired on arrival
    while len(loop.queue):
        loop.run_step()
    assert len(loop.done) == Q and len(loop.shed) == 1
    assert loop.shed[0]["id"] == 99 and "deadline" in loop.shed[0]["reason"]
    assert svc.stats["shed"] == 1 and svc.stats["served"] == Q
    assert all(r["latency_s"] > 0 for r in loop.done)
    assert all(r["size"] <= r["k"] for r in loop.done)
    assert len(loop.step_s) == loop.step and loop.est_step_s is None


@pytest.mark.parametrize("oracle,deadline", [("graph_cut", 400.0),
                                             ("log_det", None),
                                             ("feature_coverage", 50.0)])
def test_synth_requests_equal_jax(oracle, deadline):
    got = synth_requests(16, 32, oracle, seed=3, deadline_ms=deadline)
    want = jserve.synth_requests(16, 32, oracle, seed=3, deadline_ms=deadline)
    assert [(r.id, r.k, r.lam, r.alpha, r.deadline_ms) for r in got] == \
        [(r.id, r.k, r.lam, r.alpha, r.deadline_ms) for r in want]
    if deadline is not None:
        assert all(deadline / 2 <= r.deadline_ms <= 1.5 * deadline
                   for r in got)


def test_synth_docs_fresh_per_step():
    d0, d1 = synth_docs(3, 1, 32, 8, "cpu"), synth_docs(3, 2, 32, 8, "cpu")
    assert not torch.equal(d0, d1)
    assert torch.equal(d0, synth_docs(3, 1, 32, 8, "cpu"))
    svc = _service(SelectorSpec(k=4), _corpus(128, 8, 2), stream_chunk=32)
    i1, i2 = svc.ingest(d0), svc.ingest(d1)
    assert i1["first_id"] == 128 and i2["first_id"] == 160
    assert i2["n_total"] == 128 + 64


# ---------------------------------------------------------------------------
# the service's two paths
# ---------------------------------------------------------------------------

def test_service_ingest_warm_and_stats_split():
    n, d, k = 256, 8, 8
    rng = np.random.default_rng(8)
    svc = _service(SelectorSpec(k=k), _corpus(n, d, 8), stream_chunk=64)
    qb = _qb([k, k // 2])
    res = svc.select_batch(qb, generator=_gen(0))
    svc.account(res, 2)
    assert svc.stats["served"] == 2
    info = svc.ingest((rng.random((64, d)).astype(np.float32)) ** 2)
    assert info["n_total"] == n + 64 and svc.stats["ingested"] == n + 64
    warm = svc.select_warm()
    assert int(warm.sol_size) > 0 and float(warm.value) > 0
    assert svc.stats["warm_selects"] == 1
    s = svc.summary()
    assert "tau_fallback_batch=" in s and "tau_fallback_warm=" in s
    assert "shed=" in s
    log1 = svc.selector.round_log_batch
    assert "tau_fallback" in log1.summary()
    svc.select_batch(qb, generator=_gen(2))
    assert svc.selector.round_log_batch is log1     # counters accumulate
    assert svc.selector.runtime_events()["tau_fallback"] == \
        svc.stats["tau_fallback_batch"]


def test_service_statistics_are_pinned_from_the_initial_corpus():
    n, d = 256, 8
    X = _corpus(n, d, 3)
    svc = _service(SelectorSpec(k=4, oracle="graph_cut"), X)
    np.testing.assert_array_equal(svc.total.numpy(), X.sum(axis=0))
    fac = _service(SelectorSpec(k=4, oracle="facility_location",
                                reference_size=32), X)
    np.testing.assert_array_equal(fac.reference.numpy(), X[::8][:32])
    fac.ingest(_corpus(64, d, 4))
    assert int(fac.select_warm().sol_size) > 0


def test_service_save_is_read_only():
    n, d, k = 192, 8, 8
    emb, docs = _corpus(n, d, 9), _corpus(70, d, 10)
    plain = _service(SelectorSpec(k=k), emb, stream_chunk=64)
    plain.ingest(docs)
    res_plain = plain.select_warm()
    saver = _service(SelectorSpec(k=k), emb, stream_chunk=64)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        saver.save(ck, step=1)
        saver.ingest(docs)
        saver.save(ck, step=2, blocking=False)
        ck.wait()
        res_saver = saver.select_warm()
    assert torch.equal(res_plain.sol_ids, res_saver.sol_ids)
    assert res_plain.value.numpy().tobytes() == \
        res_saver.value.numpy().tobytes()


def test_service_releases_the_initial_corpus():
    n, d, k = 128, 8, 4
    svc = _service(SelectorSpec(k=k), _corpus(n, d, 11), stream_chunk=64)
    assert svc._init_corpus is not None
    svc.materialize()
    assert svc._init_corpus is not None   # the sieve still needs it
    svc.ingest(_corpus(64, d, 12))
    assert svc._init_corpus is None
    res = svc.select_batch(_qb([k]), generator=_gen(0))
    assert int(res.sol_size[0]) > 0 and int(svc.select_warm().sol_size) > 0
    # a restore stands in for the stream's use of it
    with tempfile.TemporaryDirectory() as tmp:
        svc.save(Checkpointer(tmp), step=1)
        svc2 = _service(SelectorSpec(k=k), _corpus(n, d, 11),
                        stream_chunk=64)
        svc2.materialize()
        svc2.restore(Checkpointer(tmp))
    assert svc2._init_corpus is None


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_service_checkpoint_restores_bit_for_bit(engine):
    n, d, k = 256, 8, 8
    emb = _corpus(n, d, 6)
    docs_a, docs_b = _corpus(96, d, 7), _corpus(80, d, 8)
    spec = SelectorSpec(k=k, engine=engine, use_kernel=True)
    svc = _service(spec, emb, stream_chunk=64)
    svc.ingest(docs_a)
    with tempfile.TemporaryDirectory() as tmp:
        svc.save(Checkpointer(tmp), step=3)
        svc.ingest(docs_b)
        res_full = svc.select_warm()
        svc2 = _service(spec, emb, stream_chunk=64)
        assert svc2.restore(Checkpointer(tmp)) == 3
    assert svc2.stream.n_total == n + 96 and svc2.stats["ingested"] == n + 96
    svc2.ingest(docs_b)
    res_rest = svc2.select_warm()
    assert torch.equal(res_full.sol_ids, res_rest.sol_ids)
    assert res_full.value.numpy().tobytes() == res_rest.value.numpy().tobytes()
    for a, b in zip(leaves(svc.stream.state), leaves(svc2.stream.state)):
        assert a.tobytes() == b.tobytes()


def test_service_ingest_retry_is_idempotent(monkeypatch):
    n, d, k = 128, 8, 4
    emb, docs = _corpus(n, d, 20), _corpus(96, d, 21)
    plain = _service(SelectorSpec(k=k), emb, stream_chunk=32)
    plain.ingest(docs)
    res_plain = plain.select_warm()
    flaky = _service(SelectorSpec(k=k), emb, stream_chunk=32,
                     retry_backoff_s=0.0)
    flaky._ensure_stream()
    real = flaky.stream._update
    fails = {"left": 2}

    def flaky_update(st, f, i, v):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("transient device error")
        return real(st, f, i, v)

    monkeypatch.setattr(flaky.stream, "_update", flaky_update)
    info = flaky.ingest(docs)
    assert flaky.stats["ingest_retries"] == 2
    assert flaky.stats["ingest_failures"] == 0
    assert info["n_total"] == n + 96
    res_flaky = flaky.select_warm()
    assert torch.equal(res_plain.sol_ids, res_flaky.sol_ids)
    assert res_plain.value.numpy().tobytes() == \
        res_flaky.value.numpy().tobytes()
    assert flaky.stream.n_streamed == plain.stream.n_streamed


def test_service_ingest_retry_exhaustion_is_reported(monkeypatch):
    svc = _service(SelectorSpec(k=4), _corpus(128, 8, 22), stream_chunk=32,
                   retry_attempts=2, retry_backoff_s=0.0)
    svc._ensure_stream()

    def always_fail(st, f, i, v):
        raise RuntimeError("device gone")

    monkeypatch.setattr(svc.stream, "_update", always_fail)
    with pytest.raises(RuntimeError, match="device gone"):
        svc.ingest(_corpus(64, 8, 23))
    assert svc.stats["ingest_retries"] == 1
    assert svc.stats["ingest_failures"] == 1
    assert "ingest=1(+1 failed)" in svc.summary()


def test_service_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SelectionService(SelectorSpec(k=4), None, _corpus(64, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth_docs(0, 1, 4, 8)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_runs_and_restores_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "repro_torch.launch.select_serve",
                "--device", "cpu", "--n", "2048", "--d", "16", "--k", "8",
                "--slots", "4", "--requests", "10", "--ingest-docs", "256",
                "--ingest-every", "2", "--stream-chunk", "256",
                "--checkpoint-dir", os.path.join(tmp, "ck"),
                "--checkpoint-every", "2", "--use-kernel"]
        outs = []
        for extra in ([], ["--restore"]):
            p = subprocess.run(base + extra, env=env, cwd=tmp,
                               capture_output=True, text=True, timeout=300)
            assert p.returncode == 0, p.stderr[-3000:]
            outs.append(p.stdout)
        steps = sorted(os.listdir(os.path.join(tmp, "ck")))
    first, again = outs
    assert "served=10 shed=0" in first and "[service]" in first
    assert "ingested 256 docs (corpus=2304)" in first
    assert "restored online state @ checkpoint step 3" in again
    # the restored service goes on from 2304 documents (nothing re-ingested)
    assert "ingested 256 docs (corpus=2560)" in again
    assert steps == ["step_2", "step_3"]
