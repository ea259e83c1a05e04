"""The port's out-of-core ingestion, checkpointer and selector codec, on
the CPU.

* ``HostCorpus``: chunking, many small appends (the searchsorted index),
  ``prune`` and ``base``, chunk for chunk against the JAX ``HostCorpus``;
  bf16 storage without ml_dtypes.
* ``prefetch_to_device`` on the CPU hands the chunks over unchanged.
* ``StreamingSelector``: JAX's ids and value (rtol 1e-5); incremental
  ingest bit for bit the one-shot ingest; pruning consumed parts; budgets.
* ``Checkpointer``: atomic save and rotation, orphaned temporaries removed,
  async save, retries counted, exhaustion raised from ``wait``, a
  bit-flipped and a truncated archive refused as CheckpointCorruptError,
  bf16 leaves round-tripped bit for bit.
* ``snapshot_selector`` / ``restore_selector``: a restored selector goes on
  bit for bit, and every mismatch is refused.

FeatureCoverage and GraphCut run on dyadic rows (a/8)^2 and a/8.
"""

import glob
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
from test_torch_streaming import instance, leaves

from repro.streaming import HostCorpus as JHostCorpus
from repro.streaming import SieveSpec as JSieveSpec
from repro.streaming import StreamingSelector as JStreamingSelector
from repro_torch import interop
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.streaming import (CheckpointCorruptError, HostCorpus,
                                   SieveSpec, StreamingSelector,
                                   prefetch_to_device, restore_selector,
                                   selector_template, snapshot_selector)

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

D, K = 8, 8


def _same_chunks(tc, jc):
    tc, jc = list(tc), list(jc)
    assert len(tc) == len(jc)
    for (tf, ti, tv), (jf, ji, jv) in zip(tc, jc):
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(tv.numpy(), jv)


# ---------------------------------------------------------------------------
# HostCorpus and the prefetch
# ---------------------------------------------------------------------------

def test_host_corpus_chunks_match_jax():
    tc, jc = HostCorpus(4, chunk_elems=8), JHostCorpus(4, chunk_elems=8)
    for c in (tc, jc):
        c.append(np.ones((5, 4), np.float32))
        c.append(2 * np.ones((13, 4), np.float32))
    assert tc.n_total == jc.n_total == 18
    _same_chunks(tc.chunks(0, full_only=True), jc.chunks(0, full_only=True))
    _same_chunks(tc.chunks(0), jc.chunks(0))
    _same_chunks(tc.chunks(3, 17), jc.chunks(3, 17))
    f, i, v = list(tc.chunks(0))[-1]
    assert f.shape == (8, 4) and int(v.sum()) == 2 and int(i[-1]) == -1


def test_host_corpus_many_small_appends():
    d, P = 4, 600
    rng = np.random.default_rng(0)
    parts = [rng.random((int(rng.integers(1, 5)), d)).astype(np.float32)
             for _ in range(P)]
    tc, jc = HostCorpus(d, chunk_elems=16), JHostCorpus(d, chunk_elems=16)
    for p in parts:
        tc.append(torch.from_numpy(p))
        jc.append(p)
    ref = np.concatenate(parts)
    for a, b in [(0, 7), (3, 64), (100, 101), (len(ref) - 9, len(ref))]:
        np.testing.assert_array_equal(tc._rows(a, b).numpy(), ref[a:b])
    _same_chunks(tc.chunks(0), jc.chunks(0))
    i0, i1 = tc._part_range(128, 144)
    assert (i0, i1) == jc._part_range(128, 144) and i1 - i0 <= 17


def test_host_corpus_prune_and_base():
    d = 4
    tc, jc = HostCorpus(d, chunk_elems=8), JHostCorpus(d, chunk_elems=8)
    for i in range(5):
        for c in (tc, jc):
            c.append(np.full((6, d), i, np.float32))
    assert tc.prune(14) == jc.prune(14) == 2
    assert tc.base == jc.base == 12 and tc.n_total == 30
    _same_chunks(tc.chunks(14), jc.chunks(14))
    with pytest.raises(ValueError, match="pruned"):
        tc._rows(5, 10)
    rc = HostCorpus(d, chunk_elems=8, base=14)
    rc.append(tc._rows(14, 30))
    _same_chunks(rc.chunks(14), jc.chunks(14))


def test_host_corpus_holds_bf16_without_ml_dtypes():
    tc = HostCorpus(D, chunk_elems=16, dtype=torch.bfloat16)
    X = torch.rand(40, D)
    tc.append(X)
    got = torch.cat([f[v] for f, _, v in tc.chunks(0)])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, X.to(torch.bfloat16))


def test_prefetch_on_the_cpu_passes_chunks_through():
    tc = HostCorpus(D, chunk_elems=16)
    tc.append(torch.rand(50, D))
    want = list(tc.chunks(0))
    got = list(prefetch_to_device(iter(want), "cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.device.type == "cpu" and torch.equal(a, b)
    assert list(prefetch_to_device(iter([]), "cpu")) == []


# ---------------------------------------------------------------------------
# StreamingSelector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,engine", [("feature_coverage", "dense"),
                                         ("graph_cut", "fused")])
def test_streaming_selector_matches_jax(name, engine):
    X, jo, to = instance(name, seed=6, n=300)
    jsel = JStreamingSelector(jo, JSieveSpec(k=K, eps=0.1, engine=engine,
                                             chunk=16), D, chunk_elems=64)
    tsel = StreamingSelector(to, interop.sieve_spec(jsel.spec), D,
                             chunk_elems=64)
    for a, b in ((0, 100), (100, 230), (230, 300)):
        ji, ti = jsel.ingest(X[a:b]), tsel.ingest(X[a:b])
        assert ji == ti
    for budget in (None, 3):
        jres, tres = jsel.select(budget), tsel.select(budget)
        np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                      np.asarray(jres.sol_ids))
        np.testing.assert_allclose(float(tres.value), float(jres.value),
                                   rtol=1e-5)
    assert tsel.n_streamed == jsel.n_streamed == 300
    with pytest.raises(ValueError, match="budget"):
        tsel.select(budget=K + 1)


def test_incremental_ingest_is_one_shot_bit_for_bit():
    X, _, to = instance("feature_coverage", seed=6, n=256)
    spec = SieveSpec(k=K, eps=0.1)
    one = StreamingSelector(to, spec, D, chunk_elems=64)
    one.ingest(X)
    inc = StreamingSelector(to, spec, D, chunk_elems=64, retain_streamed=True)
    inc.ingest(X[:64])
    inc.ingest(X[64:192])
    assert int(inc.select().sol_size) > 0   # a warm read mid-stream...
    inc.ingest(X[192:])                     # ...does not perturb the stream
    r1, r2 = one.select(), inc.select()
    assert torch.equal(r1.sol_ids, r2.sol_ids)
    assert r1.value.numpy().tobytes() == r2.value.numpy().tobytes()
    for a, b in zip(leaves(one.state), leaves(inc.state)):
        assert a.tobytes() == b.tobytes()
    # the pruner holds only the unstreamed tail; the keeper everything
    assert sum(p.shape[0] for p in one.corpus._parts) == 0
    assert sum(p.shape[0] for p in inc.corpus._parts) == 256


# ---------------------------------------------------------------------------
# the Checkpointer
# ---------------------------------------------------------------------------

def _state():
    return {"a": torch.arange(6, dtype=torch.float32),
            "b": {"c": torch.tensor([1.5, -2.25]).to(torch.bfloat16),
                  "n": np.asarray(7, np.int64)},
            "t": (torch.tensor([True, False]), torch.arange(3).int())}


def _template():
    return {"a": torch.zeros(6), "b": {"c": torch.zeros(2),
                                       "n": np.zeros((), np.int64)},
            "t": (torch.zeros(2, dtype=torch.bool), torch.zeros(3))}


def test_checkpointer_round_trip_rotation_and_orphans():
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, ".tmp_step_9"))
        ck = tck.Checkpointer(tmp, keep=2)
        assert not os.path.exists(os.path.join(tmp, ".tmp_step_9"))
        for step in (1, 2, 3):
            ck.save(step, _state())
        assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
        got, step = ck.restore(_template())
        assert step == 3
        want = _state()
        assert got["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(got["b"]["c"].view(torch.int16),
                           want["b"]["c"].view(torch.int16))
        assert torch.equal(got["a"], want["a"])
        assert isinstance(got["b"]["n"], np.ndarray) and int(got["b"]["n"]) == 7
        assert got["t"][0].dtype == torch.bool and torch.equal(got["t"][1],
                                                               want["t"][1])
        with pytest.raises(ValueError, match="mismatch"):
            ck.restore({"a": torch.zeros(6)})
        with pytest.raises(FileNotFoundError):
            tck.Checkpointer(os.path.join(tmp, "empty")).restore(_template())


def test_checkpointer_async_save_copies_leaves_first():
    with tempfile.TemporaryDirectory() as tmp:
        ck = tck.Checkpointer(tmp)
        st = _state()
        ck.async_save(4, st)
        st["a"].add_(100.0)             # after the call: not in the file
        ck.wait()
        got, step = ck.restore(_template())
        assert step == 4 and torch.equal(got["a"], torch.arange(6.0))


def test_checkpointer_retries_transient_write_failures(monkeypatch):
    fails = {"left": 2}
    real = np.savez

    def flaky(path, **kw):
        if fails["left"]:
            fails["left"] -= 1
            raise OSError("disk hiccup")
        real(path, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        ck = tck.Checkpointer(tmp, retry_attempts=3, retry_backoff_s=0.0)
        monkeypatch.setattr(np, "savez", flaky)
        ck.save(1, _state())
        monkeypatch.setattr(np, "savez", real)
        assert ck.n_retries == 2
        got, _ = ck.restore(_template())
        assert torch.equal(got["a"], _state()["a"])


def test_checkpointer_async_exhaustion_raises_from_wait(monkeypatch):
    def always_fail(path, **kw):
        raise OSError("disk gone")

    with tempfile.TemporaryDirectory() as tmp:
        ck = tck.Checkpointer(tmp, retry_attempts=3, retry_backoff_s=0.0)
        monkeypatch.setattr(np, "savez", always_fail)
        ck.async_save(1, _state())
        with pytest.raises(RuntimeError, match="3 attempts"):
            ck.wait()
        assert ck.n_retries == 2 and ck.latest_step() is None
        assert not glob.glob(os.path.join(tmp, ".tmp_step_*"))


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_damaged_checkpoint_is_refused(damage):
    state = {"a": torch.arange(512, dtype=torch.float32),
             "b": torch.ones(64)}
    tmpl = {"a": torch.zeros(512), "b": torch.zeros(64)}
    with tempfile.TemporaryDirectory() as tmp:
        tck.Checkpointer(tmp).save(1, state)
        npz = os.path.join(tmp, "step_1", "arrays.npz")
        blob = bytearray(open(npz, "rb").read())
        if damage == "flip":
            blob[len(blob) // 2] ^= 0xFF
        else:
            blob = blob[: len(blob) // 2]
        open(npz, "wb").write(bytes(blob))
        with pytest.raises(CheckpointCorruptError):
            tck.Checkpointer(tmp).restore(tmpl)


# ---------------------------------------------------------------------------
# the selector codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,precision", [("feature_coverage", "f32"),
                                            ("graph_cut", "bf16"),
                                            ("log_det", "f32")])
def test_snapshot_restore_is_bit_for_bit(name, precision):
    X, _, to = instance(name, seed=4, n=256)
    a, b = X[:144], X[144:]
    spec = SieveSpec(k=K, eps=0.1, precision=precision)
    one = StreamingSelector(to, spec, D, chunk_elems=64)
    one.ingest(a)                       # 2 full chunks + a tail of 16
    with tempfile.TemporaryDirectory() as tmp:
        ck = tck.Checkpointer(tmp)
        ck.save(1, snapshot_selector(one))
        one.ingest(b)
        res_one = one.select()
        two = StreamingSelector(to, spec, D, chunk_elems=64)
        snap, step = ck.restore(selector_template(two))
        restore_selector(two, snap)
    assert step == 1 and two.n_streamed == 128 and two.n_total == 144
    assert two.corpus.dtype == spec.precision_policy.storage
    two.ingest(b)
    res_two = two.select()
    assert torch.equal(res_one.sol_ids, res_two.sol_ids)
    assert res_one.value.numpy().tobytes() == res_two.value.numpy().tobytes()
    for x, y in zip(leaves(one.state), leaves(two.state)):
        assert x.tobytes() == y.tobytes()


def test_restore_selector_refuses_mismatches():
    X, _, to = instance("feature_coverage", seed=5, n=100)
    sel = StreamingSelector(to, SieveSpec(k=K), D, chunk_elems=64)
    sel.ingest(X)
    snap = snapshot_selector(sel)
    with pytest.raises(ValueError, match="chunk_elems"):
        restore_selector(StreamingSelector(to, SieveSpec(k=K), D,
                                           chunk_elems=32), snap)
    with pytest.raises(ValueError, match="mismatch"):
        restore_selector(StreamingSelector(to, SieveSpec(k=4), D,
                                           chunk_elems=64), snap)
    with pytest.raises(ValueError, match="mismatch"):
        restore_selector(StreamingSelector(
            to, SieveSpec(k=K, precision="bf16"), D, chunk_elems=64), snap)
    bad_tail = dict(snap, tail=snap["tail"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="tail"):
        restore_selector(StreamingSelector(to, SieveSpec(k=K), D,
                                           chunk_elems=64), bad_tail)
    short = dict(snap, tail=snap["tail"][:-1])
    with pytest.raises(CheckpointCorruptError, match="cursor"):
        restore_selector(StreamingSelector(to, SieveSpec(k=K), D,
                                           chunk_elems=64), short)


def test_bf16_snapshot_restores_where_the_jax_checkpointer_cannot():
    """A fault of the reference (ROADMAP queue 3): the JAX Checkpointer
    saves a bf16 selector's snapshot (npz keeps bfloat16 as raw 2-byte
    records) but cannot restore it ("No cast function available"), so a
    bf16 service never warm-starts there.  The port stores the bits as
    int16 with the dtype in the manifest and restores them."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.core import FeatureCoverage as JFeatureCoverage
    from repro.streaming import selector_template as jtemplate
    from repro.streaming import snapshot_selector as jsnapshot

    X, _, to = instance("feature_coverage", seed=7, n=100)
    jo = JFeatureCoverage(feat_dim=D)
    jbf = JStreamingSelector(jo, JSieveSpec(k=4, precision="bf16"), D,
                             chunk_elems=64)
    jbf.ingest(X)
    with tempfile.TemporaryDirectory() as tmp:
        ck = JCheckpointer(tmp)
        ck.save(1, jsnapshot(jbf))
        fresh = JStreamingSelector(jo, JSieveSpec(k=4, precision="bf16"), D,
                                   chunk_elems=64)
        with pytest.raises(ValueError, match="cast"):
            ck.restore(jtemplate(fresh))
    spec = SieveSpec(k=4, precision="bf16")
    tbf = StreamingSelector(to, spec, D, chunk_elems=64)
    tbf.ingest(X)
    with tempfile.TemporaryDirectory() as tmp:
        tck.Checkpointer(tmp).save(1, snapshot_selector(tbf))
        fresh = StreamingSelector(to, spec, D, chunk_elems=64)
        snap, _ = tck.Checkpointer(tmp).restore(selector_template(fresh))
        restore_selector(fresh, snap)
    for a, b in zip(leaves(tbf.state), leaves(fresh.state)):
        assert a.tobytes() == b.tobytes()
    assert fresh.corpus._rows(64, 100).dtype == torch.bfloat16
