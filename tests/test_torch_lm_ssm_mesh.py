"""The ssm and hybrid families on a (data, model) mesh of four gloo ranks,
serving and training, against the JAX package on its mesh of four host
devices (Auto axes) and against the port's own one-rank runs, on the CPU
at the reduced sizes, in f32 compute, from the same numpy parameters and
batches.

Serving (a 16-token prompt, then 3 decode steps): falcon-mamba-7b (Mamba1;
``parallelism="tp"``, so prefill and decode both run under TP + FSDP) on
(2, 2) and (1, 4); zamba2-2.7b cut to one group (6 Mamba2 layers and the
shared attention block; prefill under ZeRO-3, decode under TP) on (2, 2)
and (1, 4), and at B = 1 on (2, 2), where the prefill shards the sequence
over "model" (``seq_shard``: the scan and the conv cross the split).
  * Each rank holds exactly its ``NamedSharding`` slice of every
    parameter (bit for bit) and of every prefill cache leaf (within 1e-4),
    and ``interop.lm_caches(..., policy=)`` cuts its slice of the JAX
    caches bit for bit; ``in_proj``, ``conv_w``, ``out_proj`` and the
    state ``h`` really are split over "model" at these sizes.
  * Every step's logits within rtol = atol = 1e-4 of the JAX mesh's and
    of one rank's, the same greedy ids on every rank.

Training (one step, AdamW lr 1e-3): falcon-mamba under
``parallelism="tp"`` with two micro-batches (the Megatron pair over
d_inner), zamba2 under ZeRO-3, and qwen3-1.7b with
``dataclasses.replace(cfg, parallelism="tp")`` (attention, the MLP and
the tied vocab-parallel head under TP).  Against the JAX mesh step:
loss, ce, aux, lr and grad_norm within rtol 1e-5, each rank's moment
blocks within 1e-4 of their leaf's max (the first moment is 0.1 g), the
parameters within 2 lr (99.9 % of the elements within 1e-5 of their
leaf's max).  Against one rank: the same, and every gradient gathered
from the ranks' blocks within 1e-4 of its leaf's max; so do zamba2
under ``parallelism="tp"`` (the Mamba2 blocks split over d_inner) and the
MoE's TP modes (llama4-scout's ``ep``, qwen2-moe's ``tp`` with 3
experts), held to one rank only, the MoE with capacity E / k and the aux
out of the loss.
Without the pair's backward ``all_reduce``, or with a leaf whole over
"model" summed over it too, the TP gradients miss these bars.

The ranks (``_torch_train_ranks``, serving through
``_torch_lm_ranks.run_lm``) run as one spawn of four processes, beside
one JAX subprocess (``_jax_lm_ssm_mesh_reference.py``).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_lm_ranks as lm_ranks
import _torch_train_ranks as ranks
from repro.configs.base import get_config as jget_config
from repro.models import ssm as JSSM
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.steps import decode_step_bundle, prefill_bundle, \
    train_step_bundle
from repro_torch.models.sharding import check_train, make_policy
from repro_torch.optim import adamw
from test_torch_lm_mesh import numpy_params
from test_torch_lm_train_mesh import KNOBS, StubMesh, _jax_block, \
    _jax_path, _leaf_close, _metrics_close, _one_rank, _params_close

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

HERE = Path(__file__).resolve().parent
TOL = 1e-4
S, GEN = 16, 4
#: zamba2 cut to one group of 2 Mamba2 layers and the shared block
ZAMBA = {"n_layers": 2, "shared_attn_every": 2}

#: name -> (arch, config overrides, batch, mesh (data, model))
SERVE = {
    "falcon_22": ("falcon-mamba-7b", {}, 4, (2, 2)),
    "falcon_14": ("falcon-mamba-7b", {}, 4, (1, 4)),
    "zamba2_22": ("zamba2-2.7b", ZAMBA, 4, (2, 2)),
    "zamba2_14": ("zamba2-2.7b", ZAMBA, 4, (1, 4)),
    "zamba2_seq": ("zamba2-2.7b", ZAMBA, 1, (2, 2)),
}
#: name -> (arch, config overrides, batch); all on (2, 2)
TRAIN = {
    "falcon_tp": ("falcon-mamba-7b", {"microbatches": 2}, 4),
    "zamba2_zero3": ("zamba2-2.7b", ZAMBA, 4),
    "qwen3_tp": ("qwen3-1.7b", {"parallelism": "tp"}, 4),
}
#: training under TP held to one rank only: zamba2's Mamba2 blocks split
#: over d_inner (the gated norm's sum over "model", the slices of conv_b,
#: norm_w and A_log2), and the MoE's TP modes (capacity E / k, so nothing
#: drops, and the aux out of the loss: on a mesh it is the mean of each
#: token block's aux): llama4's 4 experts over model = 2 (``ep``: the slot
#: buffer replicated into each rank's experts, their outputs gathered
#: alike) and qwen2-moe's 3 (``tp``: each rank's d_ff shard)
MOE_TP = {"parallelism": "tp", "router_aux_coef": 0.0}
TRAIN_ONE_RANK = {
    "zamba2_tp": ("zamba2-2.7b", {**ZAMBA, "parallelism": "tp"}, 4),
    "llama4_tp": ("llama4-scout-17b-a16e",
                  {**MOE_TP, "capacity_factor": 4.0}, 4),
    "qwen2_moe_tp": ("qwen2-moe-a2.7b",
                     {**MOE_TP, "n_experts": 3, "capacity_factor": 1.5}, 4),
}


#: the Trainer under TP (falcon-mamba, one micro-batch): saved on (2, 2)
#: after a step, resumed there and re-meshed to (1, 4)
RESUME = dict(kind="resume", mesh=(2, 2), remesh=(1, 4),
              arch="falcon-mamba-7b", cfg={"microbatches": 1}, batch=4,
              seq=16, opt=KNOBS)


def _jcfg(arch, over):
    return dataclasses.replace(jget_config(arch).reduced(), **over)


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _cases():
    out = []
    for i, (name, (arch, over, B, mesh)) in enumerate(SERVE.items()):
        rng = np.random.default_rng(500 + i)
        jcfg = _jcfg(arch, over)
        out.append(dict(
            kind="serve", name=name, mesh=mesh, arch=arch, cfg=over,
            gen=GEN, aux=False, params=numpy_params(jcfg, 50 + i),
            tokens=rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)))
    for i, (name, (arch, over, B)) in enumerate(
            {**TRAIN, **TRAIN_ONE_RANK}.items()):
        rng = np.random.default_rng(600 + i)
        jcfg = _jcfg(arch, over)
        batch = {k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        out.append(dict(kind="step", name=name, mesh=(2, 2), arch=arch,
                        cfg=over, opt=KNOBS, params=numpy_params(jcfg, 60 + i),
                        batches=[batch]))
    return out


@pytest.fixture(scope="module")
def ran():
    """(cases by name, {name: [rank] result}, {name: JAX result}).  The
    JAX side runs the serving and the training cases in two processes
    beside the ranks."""
    cases = _cases()
    parts = [[c for c in cases if c["kind"] == k and c["name"] not in
              TRAIN_ONE_RANK] for k in ("serve", "step")]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(HERE.parent / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        resume = dict(RESUME, dir=os.path.join(tmp, "ck"))
        os.makedirs(resume["dir"])
        procs = []
        for i, part in enumerate(parts):
            cin, cout = (os.path.join(tmp, f"{x}{i}.pkl")
                         for x in ("in", "out"))
            with open(cin, "wb") as f:
                pickle.dump(part, f)
            log = open(os.path.join(tmp, f"jax{i}.log"), "w+b")
            procs.append((subprocess.Popen(
                [sys.executable, str(HERE / "_jax_lm_ssm_mesh_reference.py"),
                 cin, cout], env=env, stdout=log, stderr=subprocess.STDOUT),
                log, cout))
        try:
            port = ranks.spawn(4, cases + [resume])
            for p, _, _ in procs:
                p.wait(timeout=240)
        finally:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        jout = []
        for p, log, cout in procs:
            log.seek(0)
            assert p.returncode == 0, log.read().decode()[-3000:]
            log.close()
            with open(cout, "rb") as f:
                jout += pickle.load(f)
    names = [c["name"] for part in parts for c in part]
    by_name = {c["name"]: [r[i] for r in port] for i, c in enumerate(cases)}
    by_name["resume"] = [r[len(cases)] for r in port]
    return {c["name"]: c for c in cases}, by_name, dict(zip(names, jout))


def _shape(mesh):
    return dict(zip(("data", "model"), mesh))


def _logits(res, mesh):
    """Every step's whole logits (B, 1, V) from the ranks' blocks."""
    return [interop.gather([r["logits"][s] for r in res],
                           res[0]["logit_specs"][s], _shape(mesh))
            for s in range(len(res[0]["logits"]))]


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _slice(full, slices, r):
    return full[tuple(slice(a, b) for a, b in slices[r])]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SERVE))
def test_serving_matches_the_jax_mesh(ran, name):
    _, port, jout = ran
    res, want = port[name], jout[name]
    got = _logits(res, SERVE[name][3])
    assert len(got) == len(want["logits"]) == GEN
    for g, w in zip(got, want["logits"]):
        _close(g, w)
    np.testing.assert_array_equal(res[0]["ids"], want["ids"])


@pytest.mark.parametrize("name", list(SERVE))
def test_each_rank_holds_its_named_sharding_slice(ran, name):
    """Parameters bit for bit (the groups' leaves stacked on G in the JAX
    tree, one module a group here; the hybrid's shared block unstacked),
    the Mamba and KV prefill caches within 1e-4."""
    _, port, jout = ran
    res = port[name]
    n = 0
    for path, full, slices in jout[name]["params"]:
        parts = path.split("/")
        for r, rr in enumerate(res):
            blk = _slice(full, slices, r)
            if parts[0] == "groups":
                assert slices[r][0] == (0, full.shape[0])
                for g in range(full.shape[0]):
                    pname = ".".join(["groups", str(g)] + parts[1:])
                    np.testing.assert_array_equal(rr["params"][pname],
                                                  blk[g], err_msg=pname)
                    n += 1
            else:
                np.testing.assert_array_equal(rr["params"][".".join(parts)],
                                              blk, err_msg=path)
                n += 1
    assert n == sum(len(rr["params"]) for rr in res)
    kinds = set()
    for k, (path, full, slices) in enumerate(jout[name]["caches"]):
        kinds.add(path.split("/")[-1])
        for r, rr in enumerate(res):
            pname, blk = rr["caches"][k]
            assert pname == path, (pname, path)
            want = _slice(full, slices, r)
            assert blk.shape == want.shape, (path, r)
            _close(blk, want)
    assert {"conv", "h"} <= kinds


class _RankMesh:
    """Rank r's place on a mesh, without a process group: what a policy
    reads of a mesh to place a block."""

    def __init__(self, r, mesh):
        self.shape = _shape(mesh)
        self.coords = dict(zip(self.shape, np.unravel_index(r, mesh)))


@pytest.mark.parametrize("name", list(SERVE))
def test_lm_caches_places_mamba_caches(ran, name):
    """``interop.lm_caches(..., policy=)`` of the JAX prefill's whole
    Mamba caches gives rank r, under the decode policy, exactly the slice
    ``devices_indices_map`` gives device r (``cache_shardings`` with the
    config's ``ssm_version``)."""
    _, _, jout = ran
    arch, over, B, mesh = SERVE[name]
    cfg = _cfg(arch, over)
    kind = JSSM.Mamba1Cache if cfg.ssm_version == 1 else JSSM.Mamba2Cache
    whole = {}
    for path, full, _ in jout[name]["caches"]:
        if path.startswith("sub/"):
            _, i, field = path.split("/")
            whole.setdefault(int(i), {})[field] = full
    assert sorted(whole) == list(range(len(whole))), sorted(whole)
    tree = {"sub": [kind(**whole[i]) for i in sorted(whole)]}
    want = {p: (full, slices) for p, full, slices in jout[name]["caches"]}
    for r in range(int(np.prod(mesh))):
        policy = decode_step_bundle(
            cfg, ShapeSpec("t", S + GEN, B, "decode"),
            _RankMesh(r, mesh)).policy
        got = lm_ranks.cache_leaves(
            interop.lm_caches(tree, "cpu", policy=policy))
        assert [p for p, _ in got] == [p for p in want
                                       if p.startswith("sub/")]
        for path, blk in got:
            full, slices = want[path]
            np.testing.assert_array_equal(blk, _slice(full, slices, r),
                                          err_msg=path)


@pytest.mark.parametrize("name", [n for n in SERVE if n != "zamba2_seq"])
def test_ssm_blocks_really_split_over_model(ran, name):
    """At the reduced sizes the rule table's SSM leaves and the state are
    split over "model" (``_fit`` has not replicated them): the ranks'
    specs name it and their blocks are the leaf's share."""
    _, port, jout = ran
    res = port[name]
    n = SERVE[name][3][1]
    spec = res[0]["specs"]
    for leaf, dim in (("in_proj", 1), ("conv_w", 0), ("out_proj", 0)):
        pname = f"groups.0.0.ssm.{leaf}"
        assert spec[pname][dim] == "model", (pname, spec[pname])
        whole = [full for path, full, _ in jout[name]["params"]
                 if path == f"groups/0/ssm/{leaf}"][0]
        assert res[0]["params"][pname].shape[dim] * n == whole.shape[1 + dim]
    for path, full, slices in jout[name]["caches"]:
        if path.endswith("/h"):
            a, b = slices[0][2]          # (G, B, channels, ...)
            assert (b - a) * n == full.shape[2], (path, slices[0])


def _one_rank_serve(case):
    """The port's one-rank serving of a case: its logits by step, ids."""
    cfg = _cfg(case["arch"], case["cfg"])
    tokens = torch.from_numpy(case["tokens"])
    B = tokens.shape[0]
    model = interop.lm_params(case["params"], cfg, "cpu", torch.float32)
    pre = prefill_bundle(cfg, ShapeSpec("t", S, B, "prefill"))
    dec = decode_step_bundle(cfg, ShapeSpec("t", S + GEN, B, "decode"))
    logits, caches = pre.fn(model, {"tokens": tokens}, cache_len=S + GEN)
    out, tok = [logits.numpy()], model.greedy(logits, pre.policy)
    ids = [tok]
    for i in range(GEN - 1):
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        logits, caches = dec.fn(model, caches, tok, pos)
        tok = model.greedy(logits, dec.policy)
        out.append(logits.numpy())
        ids.append(tok)
    return out, torch.cat(ids, 1).numpy()


@pytest.mark.parametrize("name", list(SERVE))
def test_serving_matches_one_rank(ran, name):
    cases, port, _ = ran
    want, ids = _one_rank_serve(cases[name])
    for g, w in zip(_logits(port[name], SERVE[name][3]), want):
        _close(g, w)
    for r in port[name]:
        np.testing.assert_array_equal(r["ids"], ids)


def test_serving_modes_and_collectives(ran):
    """Each case takes its branch: falcon's prefill and decode under TP
    (batch over "data" only; each layer's projection block all-gathered
    over "model", x_proj's and out_proj's partial sums all-reduced),
    zamba2's prefill under ZeRO-3 with the batch over both axes, or the
    sequence over "model" at B = 1; serving runs no ``replicate`` (no
    gradient)."""
    _, port, _ = ran

    def calls(counts, kind, axes):
        return counts.get((kind, axes), (0, 0))[0]
    f = port["falcon_22"][0]
    layers = get_config("falcon-mamba-7b").reduced().n_layers
    assert f["batch_axes"] == ("data",) and f["seq_shard"] is None
    for counts in f["counts"]:
        assert calls(counts, "all_gather", ("model",)) >= layers
        assert calls(counts, "all_reduce", ("model",)) >= 2 * layers
    z, zs = port["zamba2_22"][0], port["zamba2_seq"][0]
    assert z["batch_axes"] == ("data", "model") and z["seq_shard"] is None
    assert zs["batch_axes"] == () and zs["seq_shard"] == "model"
    # the sequence gathered before each Mamba2 layer
    nl = ZAMBA["n_layers"]
    assert calls(zs["counts"][0], "all_gather", ("model",)) >= nl
    # decode: two gathers over "model" a Mamba2 layer (the projection, the
    # conv's output), the norm's squares and out_proj all-reduced
    assert calls(z["counts"][1], "all_gather", ("model",)) >= 2 * nl
    assert calls(z["counts"][1], "all_reduce", ("model",)) >= 2 * nl
    for name in SERVE:
        for counts in port[name][0]["counts"]:
            assert not any(k[0] == "replicate" for k in counts), name


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_the_jax_mesh(ran, name):
    _, port, jout = ran
    res, want = port[name], jout[name]
    assert res[0]["batch_axes"] == want["batch_axes"]
    assert res[0]["seq_shard"] == want["seq_shard"]
    for got, w in zip(res[0]["metrics"], want["metrics"]):
        assert set(got) == set(w) == {"ce", "aux", "loss", "lr",
                                      "grad_norm"}
        _metrics_close(got, w, w)
    lrs = [m["lr"] for m in want["metrics"]]
    near = total = 0
    for key in ("params", "m", "v"):
        for n in res[0][key]:
            leaf, slices = want[key][_jax_path(n)]
            scale = float(np.abs(leaf).max())
            for r, rr in enumerate(res):
                blk = _jax_block(leaf, slices, r, n)
                got = rr[key][n]
                assert got.shape == blk.shape, (key, n, r)
                if key == "params":
                    a, b = _params_close(got, blk, lrs, (n, r))
                    near, total = near + a, total + b
                else:
                    err = float(np.abs(got - blk).max())
                    assert err <= TOL * scale, (key, n, r, err, scale)
    assert near >= 0.999 * total, (near, total)


@pytest.mark.parametrize("name", list(TRAIN) + list(TRAIN_ONE_RANK))
def test_train_step_matches_one_rank(ran, name):
    cases, port, _ = ran
    res = port[name]
    shape = _shape((2, 2))
    metrics, grads, params, m, v = _one_rank(cases[name])

    def whole(key, step=None):
        blocks = [r[key] if step is None else r[key][step] for r in res]
        return interop.gather_named(blocks, res[0]["specs"], shape)
    keys = ("ce", "loss", "lr", "grad_norm") + (
        () if name in TRAIN_ONE_RANK else ("aux",))
    for got, want in zip(res[0]["metrics"], metrics):
        _metrics_close(got, want, keys)
    for s, want in enumerate(grads):
        for n, g in whole("grads", s).items():
            _leaf_close(g, want[n], ("gradient", s, n))
    for key, want in (("m", m), ("v", v)):
        for n, got in whole(key).items():
            _leaf_close(got, want[n], (key, n))
    near = total = 0
    for n, got in whole("params").items():
        a, b = _params_close(got, params[n], [x["lr"] for x in metrics], n)
        near, total = near + a, total + b
    assert near >= 0.999 * total, (near, total)


@pytest.mark.parametrize("name", list(TRAIN) + list(TRAIN_ONE_RANK))
def test_every_rank_holds_the_same_metrics(ran, name):
    _, port, _ = ran
    res = port[name]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    assert all(np.isfinite(m["loss"]) for m in res[0]["metrics"])


def test_train_collectives_by_parallelism(ran):
    """Under TP the Megatron pair runs in backward (``replicate``'s sums
    over "model"), the FSDP weights' gradients are reduce-scattered over
    "data" only, and the leaves whole over "model" are summed over "data";
    under ZeRO-3 nothing is replicated and the weights are gathered over
    both axes."""
    _, port, _ = ran

    def calls(name, kind, axes):
        return port[name][0]["counts"][0].get((kind, axes), (0, 0))[0]
    for name in ("falcon_tp", "qwen3_tp", *TRAIN_ONE_RANK):
        assert port[name][0]["batch_axes"] == ("data",)
        assert calls(name, "replicate", ("model",)) > 0, name
        assert calls(name, "reduce_scatter", ("data",)) > 0, name
        assert calls(name, "all_reduce", ("data",)) > 0, name
        assert calls(name, "all_gather", ("data", "model")) == 0, name
    # falcon: a replicate for each layer's input, x_proj's sums and
    # conv_b's slice, in each of the 2 micro-batches (remat re-runs none:
    # replicate moves data in backward only)
    layers = get_config("falcon-mamba-7b").reduced().n_layers
    assert calls("falcon_tp", "replicate", ("model",)) >= 2 * 3 * layers
    assert calls("zamba2_zero3", "replicate", ("model",)) == 0
    assert calls("zamba2_zero3", "all_gather", ("data", "model")) > 0
    assert calls("zamba2_zero3", "reduce_scatter", ("data", "model")) > 0
    # the MoE under TP: no all_to_all; ep's gathered outputs hand back
    # each rank's block (no reduce_scatter over "model")
    for name in ("llama4_tp", "qwen2_moe_tp"):
        assert calls(name, "all_to_all", ("model",)) == 0, name
        assert calls(name, "reduce_scatter", ("model",)) == 0, name
    assert calls("llama4_tp", "all_gather", ("model",)) > 0


def test_train_step_accepts_tp_and_refuses_an_idle_data_axis():
    """``check_train`` takes a TP policy, whose model axis carries no
    tokens but splits the layers' work, and still refuses a data axis
    that carries none (B = 1 on data = 2)."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              microbatches=1)
    b = train_step_bundle(cfg, ShapeSpec("t", 16, 2, "train"), StubMesh())
    assert not b.policy.pure_fsdp and b.policy.tensor_parallel
    assert b.policy.batch_axes == ("data",)
    with pytest.raises(ValueError, match="without tokens"):
        train_step_bundle(cfg, ShapeSpec("t", 16, 1, "train"), StubMesh())
    zero = make_policy(StubMesh(), 4, "train", pure_fsdp=True)
    with pytest.raises(ValueError, match="ZeRO-3"):
        check_train(cfg, zero)


def test_tp_checkpoint_resumes_bit_equal_and_re_meshes(ran):
    """The Trainer under TP: saved on (2, 2) after a step (every block
    gathered to rank 0), its second step resumed there is bit for bit the
    straight run's, also where only rank 0's directory holds the
    checkpoint; re-meshed to (1, 4) (rank 0 scatters the TP blocks of the
    other mesh) it is within the f32 bars."""
    _, port, _ = ran
    res = port["resume"]
    for r in res:
        for run in ("resumed", "rank0_only"):
            assert r[run]["steps"] == [1]
            assert r[run]["losses"] == r["straight"]["losses"][1:]
            for n, p in r["straight"]["params"].items():
                np.testing.assert_array_equal(r[run]["params"][n], p,
                                              err_msg=(run, n))
    re = [r["remeshed"] for r in res]
    assert re[0]["shape"] == {"data": 1, "model": 4}
    np.testing.assert_allclose(re[0]["losses"],
                               res[0]["straight"]["losses"][1:], rtol=1e-5)
    got = interop.gather_named([r["params"] for r in re], re[0]["specs"],
                               re[0]["shape"])
    want = interop.gather_named([r["straight"]["params"] for r in res],
                                res[0]["straight"]["specs"], _shape((2, 2)))
    lr = float(adamw.schedule(adamw.AdamWConfig(**KNOBS), 2))
    for n, w in want.items():
        _params_close(got[n], w, [lr], n)
    assert res[0]["straight"]["specs"]["groups.0.0.ssm.in_proj"] == \
        ("data", "model")
