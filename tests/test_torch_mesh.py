"""The port's mesh substrate against the JAX package's, on the CPU.

One rank, in the test process (a gloo job of one process): the five mesh
drivers (two_round, multi_epoch, two_round_known_opt, multi_threshold,
two_round_batch) on FeatureCoverage and every engine, against the JAX mesh
drivers on the 1-device CPU mesh (FacilityLocation's drivers and the
other oracles' selectors are in test_torch_mesh_oracles.py).

Four ranks, spawned (``_torch_mesh_ranks``): data = 4, and data = 2 x
model = 2 with the tensor-parallel oracle, against the real JAX mesh of
four host devices, run once in a subprocess
(``_jax_mesh_reference.py``); and against the port's own sim (m = 4, or
m = 2 with the full-width oracle), with the same draws.  Every rank's
result equals rank 0's.

The JAX mesh draws each machine's sample from its epoch key folded in
with the machine index; the harness computes those draws
(``jax_mesh_uniforms``) and injects them.  Against JAX: ids, sizes,
overflow and fallback counts equal, values within rtol 1e-5, RoundLogs
equal record for record.  Against the sim the values are the same bits,
but under the tensor-parallel FeatureCoverage, whose gains are sums of
square roots split in two.  The data are dyadic (FeatureCoverage
(a/8)^2, GraphCut a/8 with lam a power of two, WeightedCoverage binary,
FacilityLocation (a/8)^2 against b/8).
"""

import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapreduce import jax_mesh_uniforms

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import MRConfig as JMRConfig
from repro.core import mapreduce as jmr
from repro.core import rounds as jrounds
from repro.launch.mesh import make_mesh_for as j_make_mesh_for
from repro_torch import interop
from repro_torch.core import mapreduce as tmr
from repro_torch.core import selector as tsel
from repro_torch.core.sequential import greedy
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")

HERE = Path(__file__).resolve().parent
N, D, K = 512, 8, 6
T, E = 2, 2
ENGINES = ("dense", "lazy", "fused")
DRIVERS = ("two_round", "multi_epoch", "two_round_known_opt",
           "multi_threshold", "two_round_batch")
KS = [6, 4, 1]


@pytest.fixture(scope="module")
def mesh1():
    with ranks.one_rank():
        yield tmesh.make_mesh_for(1, model_parallel=1)


def _dyadic(seed, n=N, d=D, square=True):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 9, (n, d)) / 8.0
    return (X ** 2 if square else X).astype(np.float32)


def epoch_keys(driver, key, t=T, epochs=E):
    """The sample rounds' keys of a JAX mesh driver."""
    if driver == "multi_threshold":
        return jrounds.chain_keys(key, t)
    if driver == "multi_epoch" and epochs > 1:
        return list(jax.random.split(key, epochs))
    return [key]


def _records(log):
    return [(r.name, r.bytes_per_machine, r.bytes_total, r.detail)
            for r in log.records]


FIELDS = ("ids", "size", "value", "n_dropped", "tau_fallback")


def fields(res):
    """A result's fields as numpy arrays, from a SelectionResult (either
    package) or a rank's dict."""
    if isinstance(res, dict):
        return {f: np.asarray(res[f]) for f in FIELDS}
    return {f: np.asarray(v) for f, v in zip(FIELDS, (
        res.sol_ids, res.sol_size, res.value, res.n_dropped,
        res.tau_fallback))}


def assert_same(expected, got, rtol=1e-5, bits=False):
    """Equal ids, sizes and counts (under any leading query axis), and
    values within rtol, or the same bits."""
    e, g = fields(expected), fields(got)
    for f in ("ids", "size", "n_dropped", "tau_fallback"):
        np.testing.assert_array_equal(g[f], e[f], err_msg=f)
    if bits:
        np.testing.assert_array_equal(g["value"], e["value"])
    else:
        np.testing.assert_allclose(g["value"], e["value"], rtol=rtol)


def _drivers(driver, jo, to, cfg_knobs, mesh1, X, key, opt):
    """The JAX mesh driver (jitted, as its selector runs it) and the
    port's on the same data and draws; returns (JAX result, JAX records,
    port result, port records)."""
    jmesh = j_make_mesh_for(1, model_parallel=1)
    jcfg, tcfg = JMRConfig(**cfg_knobs), tmr.MRConfig(**cfg_knobs)
    Xj, idsj = jnp.asarray(X), jnp.arange(N, dtype=jnp.int32)
    Xt, idst = torch.from_numpy(X), torch.arange(N, dtype=torch.int32)
    u = jax_mesh_uniforms(epoch_keys(driver, key), 1, N)
    if driver in ("two_round", "multi_epoch"):
        epochs = 1 if driver == "two_round" else E
        jrun, jlog = jmr.multi_epoch_mesh(jo, jcfg, jmesh, epochs=epochs)
        trun, tlog = tmr.multi_epoch_mesh(to, tcfg, mesh1, epochs=epochs)
        jres = jax.jit(jrun)(Xj, idsj, key)
        tres = trun(Xt, idst, uniforms=u)
    elif driver == "two_round_batch":
        jrun, jlogs = jmr.two_round_batch_mesh(jo, jcfg, jmesh)
        trun, tlogs = tmr.two_round_batch_mesh(to, tcfg, mesh1)
        jres = jax.jit(jrun)(Xj, idsj, jmr.make_query_batch(KS), key)
        tres = trun(Xt, idst, tmr.make_query_batch(KS, device="cpu"),
                    uniforms=u)
        jlog, tlog = jlogs(len(KS)), tlogs(len(KS))
    else:
        if driver == "multi_threshold":
            jrun, jlog = jmr.multi_threshold_mesh(jo, jcfg, T, jmesh)
            trun, tlog = tmr.multi_threshold_mesh(to, tcfg, T, mesh1)
        else:
            jrun, jlog = jmr.two_round_known_opt_mesh(jo, jcfg, jmesh)
            trun, tlog = tmr.two_round_known_opt_mesh(to, tcfg, mesh1)
        jres = jax.jit(jrun)(Xj, idsj, jnp.float32(opt), key)
        tres = trun(Xt, idst, opt, uniforms=u)
    return jres, _records(jlog), tres, _records(tlog)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("driver", DRIVERS)
def test_one_rank_drivers_match_the_jax_mesh(mesh1, driver, engine):
    X = _dyadic(1)
    to = interop.feature_coverage(D, use_kernel=True)
    opt = 0.9 * float(greedy(to, torch.from_numpy(X),
                             torch.ones(N, dtype=torch.bool), K)[2])
    knobs = dict(k=K, n_total=N, n_machines=1, engine=engine, chunk=16)
    jres, jrec, tres, trec = _drivers(driver, JFeatureCoverage(feat_dim=D),
                                      to, knobs, mesh1, X,
                                      jax.random.PRNGKey(7), opt)
    assert_same(jres, tres)
    assert trec == jrec
    assert int(tres.sol_size.max()) > 0


def test_sim_and_mesh_round_logs_agree(mesh1):
    """Per-epoch RoundLog parity across substrates at E = 3: six rounds,
    every record equal (names, per-machine and total bytes), and equal to
    the JAX mesh driver's."""
    knobs = dict(k=4, n_total=128, n_machines=1, epochs=3)
    to = interop.feature_coverage(5)
    _, sim_log = tmr.multi_epoch_sim(
        to, *interop.shard(np.zeros((1, 128, 5), np.float32),
                           np.arange(128).reshape(1, -1),
                           np.ones((1, 128), bool)),
        tmr.MRConfig(**knobs))
    _, mesh_log = tmr.multi_epoch_mesh(to, tmr.MRConfig(**knobs), mesh1)
    _, jlog = jmr.multi_epoch_mesh(JFeatureCoverage(feat_dim=5),
                                   JMRConfig(**knobs),
                                   j_make_mesh_for(1, model_parallel=1))
    assert sim_log.n_rounds == mesh_log.n_rounds == 6
    assert _records(sim_log) == _records(mesh_log) == _records(jlog)


def test_mesh_select_takes_this_ranks_shard(mesh1):
    X = _dyadic(2)
    sel = tsel.DistributedSelector(tsel.SelectorSpec(k=K), n_total=N,
                                   feat_dim=D, device="cpu", mesh=mesh1)
    assert sel.cfg.n_machines == 1 and not sel.tp
    np.testing.assert_array_equal(sel.data_sharding(X).numpy(), X)
    with pytest.raises(ValueError, match="shard"):
        sel.select(X[:N // 2])


def test_mesh_axes_and_groups(mesh1):
    assert mesh1.shape == {"data": 1, "model": 1}
    assert mesh1.coords == {"data": 0, "model": 0}
    assert mesh1.machine_axes == ("data",) and mesh1.tp == 1
    assert mesh1.size(mesh1.machine_axes) == 1
    with pytest.raises(ValueError, match="ranks"):
        tmesh.Mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="pods"):
        tmesh.make_mesh_for(1, model_parallel=2)


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

N4 = 1024
CASES4 = ("fc_two_round", "fc_multi_epoch", "fc_known_opt",
          "fc_multi_threshold", "fc_batch", "gc_batch", "fl_two_round",
          "fc_tp", "wc_tp")


def _cases4():
    X = _dyadic(21, n=N4)
    Xg = _dyadic(22, n=N4, square=False)
    Xw = (np.random.default_rng(23).random((N4, D)) < 0.3).astype(np.float32)
    Xf = _dyadic(24, n=N4)
    R = _dyadic(25, n=24, square=False)
    opt = 0.9 * float(greedy(interop.feature_coverage(D), torch.from_numpy(X),
                             torch.ones(N4, dtype=torch.bool), K)[2])
    base = dict(k=K, engine="fused", chunk=16, use_kernel=True)
    cases = [
        dict(mesh=(4, 1), spec=base, X=X),
        dict(mesh=(4, 1), spec=dict(base, algorithm="multi_epoch", epochs=E,
                                    engine="lazy"), X=X),
        dict(mesh=(4, 1), spec=dict(base, algorithm="two_round_known_opt",
                                    engine="dense"), X=X, opt=opt),
        dict(mesh=(4, 1), spec=dict(base, algorithm="multi_threshold", t=T),
             X=X, opt=opt),
        dict(mesh=(4, 1), spec=base, X=X, batch=(KS, None, None)),
        dict(mesh=(4, 1), spec=dict(base, oracle="graph_cut"), X=Xg,
             total=Xg.sum(0), batch=([6, 3], [0.5, 0.25], None)),
        dict(mesh=(4, 1), spec=dict(base, oracle="facility_location"), X=Xf,
             reference=R),
        dict(mesh=(2, 2), spec=dict(base, oracle_tp=True), X=X),
        dict(mesh=(2, 2), spec=dict(base, oracle="weighted_coverage",
                                    oracle_tp=True), X=Xw),
    ]
    for i, c in enumerate(cases):
        c["key"] = 30 + i
        algorithm = ("two_round_batch" if c.get("batch") is not None
                     else c["spec"].get("algorithm", "two_round"))
        m = c["mesh"][0]
        c["uniforms"] = jax_mesh_uniforms(
            epoch_keys(algorithm, jax.random.PRNGKey(c["key"])), m,
            N4 // m).numpy()
    return cases


@pytest.fixture(scope="module")
def four_ranks():
    """Every four-rank case, run once: (cases, [rank][case] port results,
    [case] JAX results)."""
    cases = _cases4()
    with tempfile.TemporaryDirectory() as tmp:
        cin, cout = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(cin, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=str(HERE.parent / "src"))
        with open(os.path.join(tmp, "jax.log"), "w+b") as jlog:
            jproc = subprocess.Popen(
                [sys.executable, str(HERE / "_jax_mesh_reference.py"), cin,
                 cout], env=env, stdout=jlog, stderr=subprocess.STDOUT)
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
            jout = pickle.load(f)
    return cases, port, jout


def _index(name):
    return CASES4.index(name)


@pytest.mark.parametrize("name", CASES4)
def test_four_ranks_match_the_jax_mesh(four_ranks, name):
    cases, port, jout = four_ranks
    i = _index(name)
    assert_same(jout[i], port[0][i])
    assert port[0][i]["records"] == jout[i]["records"]
    assert port[0][i]["tp"] == (cases[i]["mesh"][1] > 1)
    assert int(np.max(port[0][i]["size"])) > 0


@pytest.mark.parametrize("name", CASES4)
def test_four_ranks_agree(four_ranks, name):
    _, port, _ = four_ranks
    i = _index(name)
    for r in range(1, 4):
        assert_same(port[0][i], port[r][i], bits=True)
        assert port[r][i]["records"] == port[0][i]["records"]
        assert port[r][i]["events"] == port[0][i]["events"]


@pytest.mark.parametrize("name", CASES4)
def test_four_ranks_match_the_sim(four_ranks, name):
    """The port's sim with the mesh's draws: m = 4, or m = 2 with the
    full-width oracle for the tensor-parallel cases."""
    cases, port, _ = four_ranks
    i = _index(name)
    c = cases[i]
    m = c["mesh"][0]
    sel = tsel.DistributedSelector(
        tsel.SelectorSpec(**c["spec"]), n_total=N4, feat_dim=D,
        n_machines=m, device="cpu", reference=c.get("reference"),
        total=c.get("total"))
    u = torch.from_numpy(c["uniforms"])
    if c.get("batch") is not None:
        res = sel.select_batch(c["X"], tmr.make_query_batch(
            *c["batch"], device="cpu"), uniforms=u)
        log = sel.round_log_batch
    else:
        res = sel.select(c["X"], opt_estimate=c.get("opt"), uniforms=u)
        log = sel.round_log
    assert_same(res, port[0][i], bits=name != "fc_tp")
    if c["mesh"][1] == 1:
        assert [tuple(r) for r in port[0][i]["records"]] == _records(log)
