"""LM serving on a (data, model) mesh of four gloo ranks against the JAX
package on its (2, 2) mesh of four host devices, and against the port's
own one-rank serving, on the CPU at the reduced sizes, in f32 compute.

Cases: qwen3-1.7b at B = 4 (prefill under ZeRO-3 with the batch over both
axes, decode under TP + FSDP) and at B = 1 (prefill with the sequence
sharded over "model", decode from caches sharded over "data" on their
sequence); llama4-scout (4 experts over model = 2: prefill's all-to-all
dispatch, decode's ``ep``); qwen2-moe with n_experts = 3 (prefill's ZeRO
without EP, decode's ``tp``); qwen3 with a TP prefill and ``head_fsdp``,
and llama4 with ``head_fsdp`` (the D-split table and head).  Each serves a
16-token prompt and 4 decode steps.

Against the JAX mesh (``_jax_lm_mesh_reference.py``, one subprocess with
four host devices, Auto axes), at the configured capacity, where both
drop the same rows: every step's logits within rtol = atol = 1e-4, the
same greedy ids, each device's dropped (token, choice) rows and the aux
loss; and each rank holds exactly its ``NamedSharding`` slice of every
parameter (bit for bit) and of every prefill cache leaf (within 1e-4),
and ``interop.lm_caches(..., policy=)`` cuts each rank's slice of the JAX
caches bit for bit.
Against the one-rank port with capacity raised to E / k (nothing drops):
the logits within 1e-4 and the same ids.  The ranks (``_torch_lm_ranks``)
run as one spawn of four processes, beside the JAX subprocess.
"""

import ast
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

import _torch_lm_ranks as ranks
from repro.configs.base import get_config as jget_config
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.models.model import build_model as jbuild_model
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.steps import decode_step_bundle, prefill_bundle

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

HERE = Path(__file__).resolve().parent
TOL = 1e-4
S, GEN = 16, 5
MESH = (2, 2)

#: name -> (arch, config overrides, batch, compared with the JAX mesh)
CASES = {
    "qwen3_b4": ("qwen3-1.7b", {}, 4, True),
    "qwen3_b1_seq": ("qwen3-1.7b", {}, 1, True),
    "llama4": ("llama4-scout-17b-a16e", {}, 4, True),
    "qwen2_moe": ("qwen2-moe-a2.7b", {"n_experts": 3}, 4, True),
    # the TP prefill (parallelism "tp": heads split, caches handed from
    # the heads' split to head_dim's) with the D-split tied table
    # (head_fsdp): partial-sum logits, reduce-scattered
    "qwen3_tp_head_fsdp": ("qwen3-1.7b", {"parallelism": "tp",
                                          "head_fsdp": True}, 4, True),
    # the untied head split (data, model) and the D-split table under
    # ZeRO-3 (the lookup's all_to_all)
    "llama4_head_fsdp": ("llama4-scout-17b-a16e", {"head_fsdp": True}, 4,
                         True),
    "llama4_no_drop": ("llama4-scout-17b-a16e", {"capacity_factor": 4.0},
                       4, False),
    "qwen2_moe_no_drop": ("qwen2-moe-a2.7b",
                          {"n_experts": 3, "capacity_factor": 1.5}, 4,
                          False),
}
#: the cases held against the one-rank port: the dense ones, and the MoE
#: ones with capacity E / k
ONE_RANK = ("qwen3_b4", "qwen3_b1_seq", "llama4_no_drop",
            "qwen2_moe_no_drop")


def numpy_params(cfg, seed):
    """A parameter tree of the JAX package's structure drawn with numpy:
    tables N(0, 0.02^2), matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2)."""
    shapes = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "table":
            a = 0.02 * rng.normal(size=s.shape)
        elif name in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
            a = 1 + 0.1 * rng.normal(size=s.shape)
        else:
            a = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _cases():
    out = []
    for i, (name, (arch, over, B, _)) in enumerate(CASES.items()):
        jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
        rng = np.random.default_rng(100 + i)
        out.append(dict(
            name=name, mesh=MESH, arch=arch, cfg=over, gen=GEN,
            params=numpy_params(jcfg, i),
            tokens=rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def served():
    """(cases, [rank][case] port results, {name: JAX result})."""
    cases = _cases()
    jcases = [c for c in cases if CASES[c["name"]][3]]
    with tempfile.TemporaryDirectory() as tmp:
        cin, cout = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(cin, "wb") as f:
            pickle.dump(jcases, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=str(HERE.parent / "src"))
        with open(os.path.join(tmp, "jax.log"), "w+b") as jlog:
            jproc = subprocess.Popen(
                [sys.executable, str(HERE / "_jax_lm_mesh_reference.py"),
                 cin, cout], env=env, stdout=jlog, stderr=subprocess.STDOUT)
            try:
                port = ranks.spawn(4, cases)
                jproc.wait(timeout=240)
            finally:
                if jproc.poll() is None:
                    jproc.kill()
                    jproc.wait()
            jlog.seek(0)
            assert jproc.returncode == 0, jlog.read().decode()[-3000:]
        with open(cout, "rb") as f:
            jout = dict(zip([c["name"] for c in jcases], pickle.load(f)))
    return cases, port, jout


def _index(name):
    return list(CASES).index(name)


def _logits(port, i):
    """Every step's whole logits (B, 1, V) from the ranks' blocks."""
    shape = dict(zip(("data", "model"), MESH))
    steps = len(port[0][i]["logits"])
    return [interop.gather([r[i]["logits"][s] for r in port],
                           port[0][i]["logit_specs"][s], shape)
            for s in range(steps)]


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


JAX_CASES = [n for n, c in CASES.items() if c[3]]


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_matches_the_jax_mesh(served, name):
    cases, port, jout = served
    i, want = _index(name), jout[name]
    got = _logits(port, i)
    assert len(got) == len(want["logits"]) == GEN
    for g, w in zip(got, want["logits"]):
        _close(g, w)
    np.testing.assert_array_equal(port[0][i]["ids"], want["ids"])
    assert port[0][i]["aux"] == pytest.approx(want["aux"], rel=1e-5,
                                              abs=1e-6)
    # each device's dropped rows: the port's rank r at the JAX device of
    # the same mesh coordinates
    for r in port:
        c = r[i]["coords"]
        assert sum(r[i]["dropped"]) == want["drops"].get(
            (c["data"], c["model"]), 0), (name, c)
    if "moe" in name or "llama4" in name:
        assert want["n_routes"] > 0 and len(port[0][i]["dropped"]) > 0
    print(name, "drops by device", want["drops"], "aux", want["aux"])


@pytest.mark.parametrize("name", JAX_CASES)
def test_each_rank_holds_its_named_sharding_slice(served, name):
    """Parameters bit for bit, prefill caches within 1e-4: rank r's block
    is the slice ``devices_indices_map`` gives device r."""
    _, port, jout = served
    i = _index(name)
    n = 0
    for path, full, slices in jout[name]["params"]:
        parts = path.split("/")
        for r, res in enumerate(port):
            blk = full[tuple(slice(a, b) for a, b in slices[r])]
            if parts[0] == "groups":
                # stacked on G: group g's unstacked leaf is blk[g]
                assert slices[r][0] == (0, full.shape[0])
                for g in range(full.shape[0]):
                    pname = ".".join(["groups", str(g)] + parts[1:])
                    np.testing.assert_array_equal(res[i]["params"][pname],
                                                  blk[g])
                    n += 1
            else:
                np.testing.assert_array_equal(res[i]["params"][
                    ".".join(parts)], blk)
                n += 1
    assert n == sum(len(r[i]["params"]) for r in port)
    for (path, full, slices), k in zip(jout[name]["caches"],
                                       range(len(jout[name]["caches"]))):
        for r, res in enumerate(port):
            pname, blk = res[i]["caches"][k]
            assert pname == path, (pname, path)
            want = full[tuple(slice(a, b) for a, b in slices[r])]
            assert blk.shape == want.shape, (path, r)
            _close(blk, want)


class _RankMesh:
    """Rank r's place on the (2, 2) mesh, without a process group: what a
    policy reads of a mesh to place a block."""

    def __init__(self, r):
        self.shape = dict(zip(("data", "model"), MESH))
        self.coords = dict(zip(self.shape, np.unravel_index(r, MESH)))


@pytest.mark.parametrize("name", JAX_CASES)
def test_lm_caches_places_each_rank_block(served, name):
    """``interop.lm_caches(..., policy=)`` of the JAX prefill's whole
    caches gives rank r, under the decode policy, exactly the slice
    ``devices_indices_map`` gives device r."""
    _, _, jout = served
    arch, over, B, _ = CASES[name]
    cfg = _cfg(arch, over)
    fields = {}
    for path, full, _ in jout[name]["caches"]:
        _, i, field = path.split("/")
        fields.setdefault(int(i), {})[field] = full
    tree = {"sub": [JL.KVCache(**fields[i]) for i in sorted(fields)]}
    for r in range(int(np.prod(MESH))):
        policy = decode_step_bundle(
            cfg, ShapeSpec("t", S + GEN, B, "decode"), _RankMesh(r)).policy
        got = ranks.cache_leaves(
            interop.lm_caches(tree, "cpu", policy=policy))
        assert [p for p, _ in got] == [p for p, _, _ in
                                       jout[name]["caches"]]
        for (path, blk), (_, full, slices) in zip(got,
                                                  jout[name]["caches"]):
            want = full[tuple(slice(a, b) for a, b in slices[r])]
            np.testing.assert_array_equal(blk, want, err_msg=path)


def test_lm_caches_refuses_ssm_caches_on_a_mesh():
    """Mamba caches on a mesh are placed now, not refused: rank (0, 1)'s
    block of a Mamba2 cache is its batch block over "data" with its half
    of the conv channels and of the heads over "model"
    (``ssm_cache_spec``); a cache the port does not know is still
    refused."""
    cfg = _cfg("qwen3-1.7b", {})
    policy = decode_step_bundle(cfg, ShapeSpec("t", S + GEN, 4, "decode"),
                                _RankMesh(1)).policy
    conv = np.arange(1 * 4 * 3 * 8, dtype=np.float32).reshape(1, 4, 3, 8)
    h = np.arange(1 * 4 * 2 * 4 * 16, dtype=np.float32).reshape(1, 4, 2, 4,
                                                                16)
    caches = {"sub": [JSSM.Mamba2Cache(conv, h)]}
    got = interop.lm_caches(caches, "cpu", policy=policy)["sub"][0]
    np.testing.assert_array_equal(got.conv.numpy(), conv[:, :2, :, 4:])
    np.testing.assert_array_equal(got.h.numpy(), h[:, :2, 1:])
    with pytest.raises(ValueError, match="the port knows"):
        interop.lm_caches({"sub": [(conv,)]}, "cpu", policy=policy)


def _one_rank(case):
    """The port's one-rank serving of a case: (logits by step, ids)."""
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


@pytest.mark.parametrize("name", ONE_RANK)
def test_mesh_matches_one_rank(served, name):
    cases, port, _ = served
    i = _index(name)
    want, ids = _one_rank(cases[i])
    for g, w in zip(_logits(port, i), want):
        _close(g, w)
    np.testing.assert_array_equal(port[0][i]["ids"], ids)
    if "no_drop" in name:
        assert all(sum(r[i]["dropped"]) == 0 for r in port)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_generate_the_same_ids(served, name):
    _, port, _ = served
    i = _index(name)
    for r in port[1:]:
        np.testing.assert_array_equal(r[i]["ids"], port[0][i]["ids"])
    assert port[0][i]["ids"].shape == (CASES[name][2], GEN)


def test_modes_and_collectives(served):
    """Each case takes its branch, seen in its collectives: the B = 4
    prefill's batch over (data, model) and its vocab-parallel lookup's
    reduce_scatter; B = 1's sequence sharding; llama4's all_to_all
    dispatch in prefill and ``ep`` all_gather in decode; every decode
    step's TP all_reduce and FSDP gathers."""
    _, port, _ = served
    r0 = port[0]

    def calls(counts, kind, axes):
        return counts.get((kind, axes), (0, 0))[0]

    L = {"qwen3_b4": 2, "llama4": 4, "qwen2_moe": 2}
    b4 = r0[_index("qwen3_b4")]
    assert b4["batch_axes"] == ("data", "model") and b4["seq_shard"] is None
    assert calls(b4["counts"][0], "reduce_scatter", ("model",)) == 1
    b1 = r0[_index("qwen3_b1_seq")]
    assert b1["batch_axes"] == () and b1["seq_shard"] == "model"
    ll = r0[_index("llama4")]
    assert calls(ll["counts"][0], "all_to_all", ("model",)) == \
        2 * L["llama4"]
    # ep: an all_gather over the model axis a layer, beside the router's
    # (split over (data, model)); the step's counts end before greedy's
    assert calls(ll["counts"][1], "all_gather", ("model",)) == \
        2 * L["llama4"]
    qm = r0[_index("qwen2_moe")]
    assert not any(k[0] == "all_to_all" for k in qm["counts"][0])
    for res in r0:
        for step in res["counts"][1:]:
            assert calls(step, "all_reduce", ("model",)) > 0
            assert step[("all_gather", ("data",))][1] > 0
    print({n: r0[_index(n)]["counts"][1] for n in CASES})


def _cli(*args, torchrun=0):
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    pre = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(torchrun)] if torchrun else [sys.executable]
    return subprocess.run(pre + ["-m", "repro_torch.launch.serve",
                                 "--device", "cpu", "--gen", "8", *args],
                          env=env, cwd=HERE.parent, capture_output=True,
                          text=True, timeout=180)


def _ids(p):
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 3, p.stdout
    return lines, ast.literal_eval(lines[2].split(":", 1)[1].strip())


def test_serve_cli_under_torchrun():
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.serve
    --model-parallel 2 --device cpu``: rank 0 alone prints, on the (2, 2)
    mesh, the ids of the one-rank CLI."""
    lines, ids = _ids(_cli("--model-parallel", "2", torchrun=4))
    assert "mesh={'data': 2, 'model': 2}" in lines[0]
    _, want = _ids(_cli("--model-parallel", "1"))
    assert ids == want and len(ids) == 8
