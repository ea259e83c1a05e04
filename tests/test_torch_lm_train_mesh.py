"""LM training on a (data, model) mesh of four gloo ranks against the JAX
package's train step on its (2, 2) mesh of four host devices, and against
the port's own one-rank step, on the CPU at the reduced sizes, in f32
compute, two steps from the same numpy parameters on the same numpy
batches.

Cases (every dense and moe config sets ``parallelism="fsdp"``, so the
step is ZeRO-3): qwen3-1.7b at B = 4 (the batch over both axes; 32
positions in CE chunks of 16) and at B = 2 (the sequence over "model",
``seq_shard``); llama4-scout (4 experts over model = 2: the all-to-all
dispatch; its untied ``lm_head`` (None, "model") is replicated over
"data"); qwen2-moe with n_experts = 3 and two micro-batches of B = 8, so
each micro-batch of 4 rows spans both axes while the 3 experts stay
replicated over "model".

Against the JAX mesh (``_jax_lm_train_mesh_reference.py``), at the
configured capacity: loss, ce, aux, lr and grad_norm within rtol 1e-5;
each rank's parameter and moment blocks the ``NamedSharding`` slices of
JAX's new state, the moments within 1e-4 of their leaf's max |.|, the
parameters within 2 * sum(lr_t) (and 99.9 % of the elements within 1e-5
of their leaf's max).  Against the one-rank port, with capacity raised to
E / k (nothing drops): the same bars, and every step's gradient, gathered
from the ranks' blocks, within 1e-4 of its leaf's max.  On a mesh the MoE
aux is the mean over the token blocks of each block's aux (as the JAX
package's ``shard_map``), not the aux of the whole batch, so these MoE
cases set ``router_aux_coef`` to 0 (the aux itself is held against the
JAX mesh above).  Every rank's metrics are equal.

The Trainer saves on (2, 2) after one step; the second step resumed on
(2, 2) is bit for bit the straight run's (also where only rank 0's
directory holds the checkpoint), re-meshed to (1, 4) and on one rank
within the bars.  The Trainer with curation on the four ranks: every rank
the same losses and the same curated rows.  ``launch/train.py`` runs
under ``torch.distributed.run`` on four gloo ranks with
``--model-parallel 2 --select``.  A family off the mesh path (vlm,
audio) refuses to train on a mesh, and so does a batch that leaves an
axis without tokens (the ssm and hybrid families and training under a
tensor-parallel policy: ``test_torch_lm_ssm_mesh.py``).  The ranks (``_torch_train_ranks``) run
as one spawn of four processes, beside the JAX subprocess.
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

import _torch_train_ranks as ranks
from _torch_train_common import numpy_params
from repro.configs.base import get_config as jget_config
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.steps import train_step_bundle
from repro_torch.models.model import Model
from repro_torch.models.sharding import make_policy
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

HERE = Path(__file__).resolve().parent
MESH = (2, 2)
SHAPE = dict(zip(("data", "model"), MESH))
KNOBS = dict(lr=1e-3, warmup_steps=1, total_steps=10)
RTOL = 1e-5          # the metrics
LEAF = 1e-4          # gradients and moments, of their leaf's max |.|
NO_AUX = {"router_aux_coef": 0.0}

#: name -> (arch, config overrides, batch, sequence, held against)
CASES = {
    "qwen3_b4": ("qwen3-1.7b", {"loss_chunk": 16}, 4, 32, ("jax", "one")),
    "qwen3_b2_seq": ("qwen3-1.7b", {}, 2, 16, ("jax", "one")),
    "llama4": ("llama4-scout-17b-a16e", {}, 4, 16, ("jax",)),
    "llama4_no_drop": ("llama4-scout-17b-a16e",
                       {"capacity_factor": 4.0, **NO_AUX}, 4, 16, ("one",)),
    "qwen2_moe": ("qwen2-moe-a2.7b", {"n_experts": 3, "microbatches": 2}, 8,
                  16, ("jax",)),
    "qwen2_moe_no_drop": ("qwen2-moe-a2.7b",
                          {"n_experts": 3, "microbatches": 2,
                           "capacity_factor": 1.5, **NO_AUX}, 8, 16,
                          ("one",)),
}
JAX_CASES = [n for n, c in CASES.items() if "jax" in c[4]]
ONE_RANK = [n for n, c in CASES.items() if "one" in c[4]]
RESUME = dict(kind="resume", mesh=MESH, remesh=(1, 4), arch="qwen3-1.7b",
              cfg={}, batch=4, seq=16, opt=KNOBS)
CURATE = dict(kind="curate", mesh=MESH, steps=2, batch=4, seq=32)


def _jcfg(arch, over):
    return dataclasses.replace(jget_config(arch).reduced(), **over)


def _seed(name):
    """The configured case and its no-drop twin share parameters and
    batches."""
    return list(CASES).index(name.replace("_no_drop", ""))


def _case(name):
    arch, over, B, S, _ = CASES[name]
    rng = np.random.default_rng(300 + _seed(name))
    vocab = get_config(arch).reduced().vocab_size
    batches = [{k: rng.integers(0, vocab, (B, S)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    return dict(name=name, mesh=MESH, arch=arch, cfg=over, opt=KNOBS,
                params=numpy_params(_jcfg(arch, over), _seed(name)),
                batches=batches)


@pytest.fixture(scope="module")
def trained():
    """(cases by name, {name: [rank] result}, {name: JAX result}, the
    resume case's [rank] results and directory, the curation's [rank]
    results)."""
    cases = {n: _case(n) for n in CASES}
    with tempfile.TemporaryDirectory() as tmp:
        resume = dict(RESUME, dir=os.path.join(tmp, "ck"))
        os.makedirs(resume["dir"])
        cin, cout = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(cin, "wb") as f:
            pickle.dump([cases[n] for n in JAX_CASES], f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=str(HERE.parent / "src"))
        with open(os.path.join(tmp, "jax.log"), "w+b") as jlog:
            jproc = subprocess.Popen(
                [sys.executable, str(HERE / "_jax_lm_train_mesh_reference.py"),
                 cin, cout], env=env, stdout=jlog, stderr=subprocess.STDOUT)
            try:
                port = ranks.spawn(4, list(cases.values()) + [resume, CURATE])
                jproc.wait(timeout=240)
            finally:
                if jproc.poll() is None:
                    jproc.kill()
                    jproc.wait()
            jlog.seek(0)
            assert jproc.returncode == 0, jlog.read().decode()[-3000:]
        with open(cout, "rb") as f:
            jout = dict(zip(JAX_CASES, pickle.load(f)))
        n = len(cases)
        by_name = {name: [r[i] for r in port] for i, name in enumerate(cases)}
        yield (cases, by_name, jout, [r[n] for r in port], resume["dir"],
               [r[n + 1] for r in port])


def _whole(res, key, step=None):
    """The whole arrays by port name from every rank's blocks."""
    blocks = [r[key] if step is None else r[key][step] for r in res]
    return interop.gather_named(blocks, res[0]["specs"], SHAPE)


def _leaf_close(got, want, what):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= LEAF * scale, (what, err, scale)


def _params_close(got, want, lrs, what):
    """Within 2 * sum(lr_t) (Adam steps about lr an element whatever the
    gradient's size); 99.9 % of the elements within 1e-5 of the leaf's
    max."""
    d = np.abs(got - want)
    assert float(d.max()) <= 2 * sum(lrs), (what, float(d.max()))
    return int((d <= RTOL * np.abs(want).max()).sum()), d.size


def _metrics_close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-8,
                                   err_msg=k)


def _jax_block(leaf, slices, r, name):
    """Device r's slice of a JAX leaf for the port's parameter ``name``
    (a stacked group leaf: group g's row of it)."""
    blk = leaf[tuple(slice(a, b) for a, b in slices[r])]
    parts = name.split(".")
    if parts[0] == "groups":
        assert slices[r][0] == (0, leaf.shape[0])
        blk = blk[int(parts[1])]
    return blk


def _jax_path(name):
    """The JAX tree's path of the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "groups":
        return "/".join(["groups", parts[2]] + parts[3:])
    return "/".join(parts)


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_step_matches_the_jax_mesh(trained, name):
    _, port, jout, *_ = trained
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
                    assert err <= LEAF * scale, (key, n, r, err, scale)
    assert near >= 0.999 * total, (near, total)


def _one_rank(case):
    """The port's one-rank steps of a case: (metrics, gradients by step,
    parameters, m, v)."""
    cfg = ranks.config(case)
    B, S = case["batches"][0]["tokens"].shape
    bundle = train_step_bundle(cfg, ShapeSpec("t", S, B, "train"),
                               opt_cfg=adamw.AdamWConfig(**KNOBS))
    model = interop.lm_params(case["params"], cfg, "cpu", torch.float32)
    opt = adamw.init(dict(model.params.named_parameters()))
    grads, saved, metrics = [], adamw.update, []

    def update(c, params, g, state, **kw):
        grads.append(ranks.blocks(g))
        return saved(c, params, g, state, **kw)
    adamw.update = update
    try:
        for b in case["batches"]:
            model, opt, m = bundle.fn(model, opt, {
                k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        adamw.update = saved
    named = dict(model.params.named_parameters())
    return (metrics, grads, ranks.blocks(named), ranks.blocks(opt.m),
            ranks.blocks(opt.v))


@pytest.mark.parametrize("name", ONE_RANK)
def test_mesh_step_matches_one_rank(trained, name):
    cases, port, *_ = trained
    res = port[name]
    metrics, grads, params, m, v = _one_rank(cases[name])
    keys = ("ce", "loss", "lr", "grad_norm") + \
        (("aux",) if get_config(CASES[name][0]).family == "dense" else ())
    for got, want in zip(res[0]["metrics"], metrics):
        _metrics_close(got, want, keys)
    for s, want in enumerate(grads):
        for n, g in _whole(res, "grads", s).items():
            _leaf_close(g, want[n], ("gradient", s, n))
    for key, want in (("m", m), ("v", v)):
        for n, got in _whole(res, key).items():
            _leaf_close(got, want[n], (key, n))
    lrs = [x["lr"] for x in metrics]
    near = total = 0
    for n, got in _whole(res, "params").items():
        a, b = _params_close(got, params[n], lrs, n)
        near, total = near + a, total + b
    assert near >= 0.999 * total, (near, total)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_metrics(trained, name):
    _, port, *_ = trained
    res = port[name]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    assert all(np.isfinite(m["loss"]) for m in res[0]["metrics"])


def test_collectives_by_branch(trained):
    """Each case takes its branch, seen in its first step's collectives:
    the weights' gathers and their gradients' reduce-scatters over both
    axes; the loss's token sums over "data"; B = 2's K/V gathers over
    "model" (seq_shard); llama4's all-to-all dispatch in forward, its
    inverse in backward and remat's re-run (six a layer), and its untied
    head's gradient summed over "data"; qwen2-moe's three experts'
    gradients summed over "model"."""
    _, port, *_ = trained

    def calls(name, kind, axes):
        return port[name][0]["counts"][0].get((kind, axes), (0, 0))[0]

    for name in CASES:
        assert calls(name, "reduce_scatter", ("data", "model")) > 0, name
        assert calls(name, "all_gather", ("data", "model")) > 0, name
    b4, b2 = port["qwen3_b4"][0], port["qwen3_b2_seq"][0]
    assert b4["batch_axes"] == ("data", "model") and b4["seq_shard"] is None
    assert b2["batch_axes"] == ("data",) and b2["seq_shard"] == "model"
    # each layer's K and V in forward, again in remat, and the CE's hidden
    assert calls("qwen3_b2_seq", "all_gather", ("model",)) >= 4 * 2 + 1
    layers = get_config("llama4-scout-17b-a16e").reduced().n_layers
    assert calls("llama4", "all_to_all", ("model",)) == 6 * layers
    assert calls("llama4", "all_reduce", ("data",)) >= 2
    assert calls("qwen2_moe", "all_to_all", ("model",)) == 0
    # the routed experts' three leaves a layer, beside the CE's sums
    assert calls("qwen2_moe", "all_reduce", ("model",)) >= 3 * 2


def test_resume_on_the_same_mesh_is_bit_equal(trained):
    *_, res, _, _ = trained
    for r in res:
        assert r["resumed"]["steps"] == [1]
        assert r["resumed"]["losses"] == r["straight"]["losses"][1:]
        for n, p in r["straight"]["params"].items():
            np.testing.assert_array_equal(r["resumed"]["params"][n], p,
                                          err_msg=n)


def test_resume_when_only_rank_0_holds_the_checkpoint(trained):
    """The other ranks' checkpoint directories are empty (disks local to
    each node): rank 0's listing decides, and the step is bit for bit the
    straight run's."""
    *_, res, _, _ = trained
    for r in res:
        assert r["rank0_only"]["steps"] == [1]
        assert r["rank0_only"]["losses"] == r["straight"]["losses"][1:]
        for n, p in r["straight"]["params"].items():
            np.testing.assert_array_equal(r["rank0_only"]["params"][n], p,
                                          err_msg=n)


def _straight(res):
    return interop.gather_named([r["straight"]["params"] for r in res],
                                res[0]["straight"]["specs"], SHAPE)


def test_resume_re_meshed_within_bars(trained):
    """The step-1 checkpoint of (2, 2) restored on (1, 4) by
    ``elastic_remesh``: its second step within the bars of the straight
    run's."""
    *_, res, _, _ = trained
    re = [r["remeshed"] for r in res]
    assert re[0]["shape"] == {"data": 1, "model": 4}
    assert re[0]["steps"] == [1]
    for r in re[1:]:
        assert r["losses"] == re[0]["losses"]
    np.testing.assert_allclose(re[0]["losses"], res[0]["straight"]["losses"]
                               [1:], rtol=RTOL)
    got = interop.gather_named([r["params"] for r in re], re[0]["specs"],
                               re[0]["shape"])
    lr = float(adamw.schedule(adamw.AdamWConfig(**KNOBS), 2))
    for n, want in _straight(res).items():
        _params_close(got[n], want, [lr], n)


def test_resume_on_one_rank_within_bars(trained):
    """The same (2, 2) checkpoint, its leaves written whole, resumed by a
    Trainer of one rank."""
    *_, res, ck, _ = trained
    cfg = get_config(RESUME["arch"]).reduced()
    t = ranks.f32(Trainer(
        cfg, ShapeSpec("t", RESUME["seq"], RESUME["batch"], "train"),
        train=TrainConfig(steps=2, ckpt_dir=os.path.join(ck, "c"),
                          ckpt_async=False, log_every=100),
        opt=adamw.AdamWConfig(**KNOBS), device="cpu"))
    model, _ = t.run()
    assert [r.step for r in t.history] == [1]
    np.testing.assert_allclose([r.loss for r in t.history],
                               res[0]["straight"]["losses"][1:], rtol=RTOL)
    lr = float(adamw.schedule(adamw.AdamWConfig(**KNOBS), 2))
    named = dict(model.params.named_parameters())
    for n, want in _straight(res).items():
        _params_close(named[n].detach().numpy(), want, [lr], n)


def test_curated_trainer_on_the_mesh(trained):
    """The Trainer with curation on four ranks: the same losses on every
    rank, and every rank gets the same curated rows from the selector on
    the training mesh."""
    *_, cur = trained
    assert len(cur[0]["losses"]) == 2
    assert all(np.isfinite(cur[0]["losses"]))
    for r in cur[1:]:
        assert r["losses"] == cur[0]["losses"]
        np.testing.assert_array_equal(r["ids"], cur[0]["ids"])
        np.testing.assert_array_equal(r["tokens"], cur[0]["tokens"])
    ids = cur[0]["ids"]
    assert len(set(ids.tolist())) == len(ids) == 8 and (ids >= 0).all()


def test_train_cli_on_the_mesh(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train
    --model-parallel 2 --select --device cpu``: each rank's own log (the
    launcher's ``--log-dir``) shows the job on the (2, 2) mesh, rank 0
    alone prints, and its losses are finite."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "--log-dir", str(tmp_path),
         "--redirects", "1", "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--model-parallel", "2", "--steps", "2",
         "--batch", "4", "--seq", "32", "--select", "--select-every", "2"],
        env=env, cwd=HERE.parent, capture_output=True, text=True,
        timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    logs = {int(f.parent.name): f.read_text()
            for f in tmp_path.rglob("stdout.log")}
    assert sorted(logs) == [0, 1, 2, 3], sorted(tmp_path.rglob("*"))
    assert all(logs[r] == "" for r in (1, 2, 3)), logs
    lines = logs[0].splitlines()
    assert lines[0].startswith("[train] mesh={'data': 2, 'model': 2}"), lines
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
              if ln.startswith("[train] step=")]
    assert len(losses) == 1 and np.isfinite(losses).all(), lines
    assert lines[-1].startswith("[train] done: steps=2"), lines


class StubMesh:
    """What a policy and a placement read of a (2, 2) mesh."""
    shape = {"data": 2, "model": 2}
    coords = {"data": 0, "model": 1}


@pytest.mark.parametrize("arch,over,error,match", [
    ("internvl2-26b", {}, NotImplementedError, "next slice"),
    ("hubert-xlarge", {}, NotImplementedError, "next slice"),
    # B = 1 leaves "data" without tokens
    ("qwen3-1.7b", {}, ValueError, "without tokens"),
])
def test_train_step_refuses_what_it_cannot_shard(arch, over, error, match):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    B = 1 if error is ValueError else 4
    with pytest.raises(error, match=match):
        train_step_bundle(cfg, ShapeSpec("t", 16, B, "train"), StubMesh())


def test_a_zero3_placement_refuses_decode():
    """A model placed by the train policy (ZeRO-3 blocks, the norms split
    too) holds its blocks and refuses a decode step before any collective;
    the one-rank train policy places nothing."""
    cfg = get_config("qwen3-1.7b").reduced()
    policy = make_policy(StubMesh(), 4, "train", pure_fsdp=True)
    model = Model(cfg, torch.Generator().manual_seed(0), "cpu",
                  torch.float32, policy)
    assert model.params.final_norm.shape == (cfg.d_model // 4,)
    assert model.params.final_norm.spec == (("data", "model"),)
    with pytest.raises(ValueError, match="ZeRO-3"):
        model.decode_step(None, torch.zeros((4, 1), dtype=torch.int32),
                          torch.zeros((4, 1), dtype=torch.int32))
    one = train_step_bundle(cfg, ShapeSpec("t", 16, 4, "train"))
    assert Model(cfg, torch.Generator().manual_seed(0), "cpu",
                 policy=one.policy).placement is None
