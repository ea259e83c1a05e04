"""The port's selector API, CLI and import boundary, on the CPU.

``DistributedSelector(..., device="cpu")`` is held against the JAX sim
driver it wraps (two_round_sim on the same shards, with the sample draws
injected from the JAX keys).  The port must import neither ``jax`` nor the
JAX package ``repro``; so must ``chip_smoke.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import two_round_sim as j_two_round_sim
from repro_torch.core import selector as tsel
from repro_torch.core.functions import FacilityLocation, FeatureCoverage

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
N, D, M, K = 512, 10, 4, 6


def _jax_uniforms(key, m, n_local):
    """two_round_sim's sample draws: split the key, split the first half
    over the m machines, one uniform vector each."""
    kd, _ = jax.random.split(key)
    draw = jax.vmap(lambda kk: jax.random.uniform(kk, (n_local,)))
    return np.array(draw(jax.random.split(kd, m)))[None]


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_selector_on_cpu_matches_jax_two_round(engine):
    rng = np.random.default_rng(0)
    X = (rng.random((N, D), dtype=np.float32)) ** 2
    key = jax.random.PRNGKey(3)
    jres, _ = j_two_round_sim(
        JFeatureCoverage(feat_dim=D), jnp.asarray(X.reshape(M, N // M, D)),
        jnp.arange(N, dtype=jnp.int32).reshape(M, -1),
        jnp.ones((M, N // M), bool),
        JMRConfig(k=K, n_total=N, n_machines=M, engine=engine), key)
    spec = tsel.SelectorSpec(k=K, engine=engine, use_kernel=True)
    sel = tsel.DistributedSelector(spec, n_total=N, feat_dim=D, n_machines=M,
                                   device="cpu")
    res = sel.select(X, uniforms=_jax_uniforms(key, M, N // M))
    np.testing.assert_array_equal(res.sol_ids.numpy(), np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-5)
    assert int(res.n_dropped) == int(jres.n_dropped)
    assert sel.round_log.n_rounds == 2
    assert "tau_fallback=0" in sel.round_log.summary()
    # k * max singleton bounds the selection's value from above
    assert float(sel.opt_upper_bound(X)) >= float(res.value)


def test_selector_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tsel.SelectorSpec(k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsel.DistributedSelector(spec, n_total=64, feat_dim=4, n_machines=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsel.DistributedSelector(spec, n_total=64, feat_dim=4, n_machines=2,
                                 device="cuda")
    sel = tsel.DistributedSelector(spec, n_total=64, feat_dim=4, n_machines=2,
                                   device="cpu")
    assert sel.device.type == "cpu"


def test_oracles_need_cuda_or_an_explicit_cpu(monkeypatch):
    """The public oracles follow the selector's device rule: the card by
    default, an error without one, the CPU only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = torch.rand(5, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureCoverage(feat_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FacilityLocation(feat_dim=4, reference=ref)
    assert FeatureCoverage(feat_dim=4, device="cpu").device.type == "cpu"
    fl = FacilityLocation(feat_dim=4, reference=ref, device="cpu")
    assert fl.device.type == "cpu" and fl.init_state(3).shape == (3, 5)
    assert tsel.resolve_device("cpu").type == "cpu"


def test_spec_and_oracle_names_are_checked():
    with pytest.raises(ValueError, match="feature sum"):
        tsel.make_oracle(tsel.SelectorSpec(k=4, oracle="graph_cut"), 4, "cpu")
    with pytest.raises(ValueError, match="reference set"):
        tsel.make_oracle(tsel.SelectorSpec(k=4, oracle="facility_location"),
                         4, "cpu")
    with pytest.raises(ValueError, match="feature sum"):
        tsel.make_oracle(tsel.SelectorSpec(k=4, oracle="saturated_coverage"),
                         4, "cpu")
    with pytest.raises(ValueError, match="reference set"):
        tsel.make_oracle(tsel.SelectorSpec(k=4, oracle="exemplar"), 4, "cpu")
    assert tsel.make_oracle(tsel.SelectorSpec(k=4, oracle="log_det"), 4,
                            "cpu").k_max == 4
    with pytest.raises(ValueError, match="unknown oracle"):
        tsel.make_oracle(tsel.SelectorSpec(k=4, oracle="nope"), 4, "cpu")
    with pytest.raises(ValueError, match="algorithm"):
        tsel.SelectorSpec(k=4, algorithm="nope")
    with pytest.raises(ValueError, match="fused"):
        tsel.SelectorSpec(k=4, engine="fused", accept="best")
    with pytest.raises(ValueError, match="divisible"):
        tsel.DistributedSelector(tsel.SelectorSpec(k=4), n_total=63,
                                 feat_dim=4, n_machines=2, device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("extra", [["--engine", "fused"],
                                   ["--algorithm", "multi_epoch", "--epochs",
                                    "2", "--engine", "lazy", "--precision",
                                    "bf16"],
                                   ["--algorithm", "multi_threshold", "--t",
                                    "2"],
                                   ["--algorithm", "two_round_known_opt",
                                    "--engine", "fused"]])
def test_cli_runs_on_cpu(extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--use-kernel", "--n", "2048", "--k", "16", "--d", "16",
         "--machines", "4", *extra],
        capture_output=True, text=True, env=_env(), timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "|S|=16" in out.stdout and "device=cpu" in out.stdout


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"
    probe = ("import sys, pkgutil, importlib, repro_torch\n"
             "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
             "    importlib.import_module(m.name)\n"
             "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'repro'))\n"
             "print(len(sys.modules), bad)\n"
             "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=_env(), timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
