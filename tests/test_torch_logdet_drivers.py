"""LogDetDiversity and MutualInformationGaussian MapReduce drivers of the
port against the JAX package, on the CPU: two_round and multi_epoch, every
engine, f32 and bf16, with the JAX keys' sample draws injected.

Gaussian rows, so sums are not exact: ids must be equal and values agree to
rtol 1e-5.  ``DecisionLog`` records the port's run and replays its decisions
in float64: every accepted gain of the winning lane clears tau, every row
it passes over falls short of it, every filter decision of that lane and
the top-singleton cut of every machine clear their thresholds, and the
winning value beats every lane with other ids, each by more than MARGIN.  A
near tie therefore fails the margin assertion, not the id comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph_cut_logdet import MARGIN, logdet_gains64, replay_first
from test_torch_graph_cut_logdet_select import D, K, _corpus, run_both

from repro_torch.core import mapreduce as tmr
from repro_torch.core import rounds

torch.set_num_threads(2)
jax.config.update("jax_platform_name", "cpu")


class DecisionLog:
    """Records one run of the port's epoch driver: every central accept
    (``rounds.greedy_step``), survivor filter (``rounds.local_filter``),
    top-singleton cut (``rounds.local_top``) and the lanes' final values."""

    def __init__(self, monkeypatch):
        self.steps, self.filters, self.tops = [], [], []
        self.path = "grid"
        step0, sparse0 = rounds.greedy_step, rounds.sparse_sweep
        filt0, top0, run0 = rounds.local_filter, rounds.local_top, \
            tmr.run_epochs

        def step(oracle, carry, cands, tau, k, cfg):
            out = step0(oracle, carry, cands, tau, k, cfg)
            self.steps.append((self.path, carry[1].clone(), carry[2].clone(),
                               cands, tau.clone(), out[1].clone(),
                               out[2].clone()))
            return out

        def sparse(oracle, pool, schedule, cfg):
            self.path = "sparse"
            try:
                self.sparse_out = sparse0(oracle, pool, schedule, cfg)
            finally:
                self.path = "grid"
            return self.sparse_out

        def run(oracle, *args, **kw):
            out = run0(oracle, *args, **kw)
            (st, sol, size), _ = out
            self.grid_out = (sol, size, oracle.value(st))
            return out

        def filt(oracle, st, sol, size, feats, ids, valid, tau, cap, k,
                 chunk=None):
            self.filters.append((sol.clone(), size.clone(), feats, ids,
                                 valid, tau.clone()))
            return filt0(oracle, st, sol, size, feats, ids, valid, tau, cap,
                         k, chunk)

        def top(oracle, feats, ids, valid, cap):
            self.tops.append((feats, valid, cap))
            return top0(oracle, feats, ids, valid, cap)

        monkeypatch.setattr(rounds, "greedy_step", step)
        monkeypatch.setattr(rounds, "sparse_sweep", sparse)
        monkeypatch.setattr(rounds, "local_filter", filt)
        monkeypatch.setattr(rounds, "local_top", top)
        monkeypatch.setattr(tmr, "run_epochs", run)

    def check_margins(self, rows_by_id, gains_fn, k):
        """Replay the winning lane's decisions in float64 and assert every
        margin (see the module docstring)."""
        def f64(t):
            return t.float().numpy().astype(np.float64)

        sols = torch.cat([self.grid_out[0], self.sparse_out[0]])
        vals = torch.cat([self.grid_out[2], self.sparse_out[2]]).numpy()
        best = int(np.argmax(vals))
        tol = MARGIN * max(1.0, abs(float(vals[best])))
        for lane in np.flatnonzero(vals[best] - vals <= tol):
            assert torch.equal(sols[lane], sols[best]), \
                f"lanes {lane} and {best} tie in value with other ids"
        J = self.grid_out[1].shape[0]
        path, j = ("grid", best) if best < J else ("sparse", best - J)
        n_steps = 0
        for p, sol, size, (feats, ids, valid), tau, out_sol, out_size in \
                self.steps:
            if p != path:
                continue
            n_steps += 1
            s_in = sol[j, :int(size[j])].tolist()
            il = (ids[j] if ids.dim() == 2 else ids).numpy()
            vl = (valid[j] if valid.dim() == 2 else valid).numpy()
            elig = vl & (il >= 0) & ~np.isin(il, s_in)
            picks = replay_first(rows_by_id[s_in],
                                 f64(feats[j] if feats.dim() == 3 else feats),
                                 il, elig, float(tau[j]), k, gains_fn)
            assert picks == out_sol[j, len(s_in):int(out_size[j])].tolist()
        assert n_steps >= 1
        if path == "grid":
            for sol, size, feats, ids, valid, tau in self.filters:
                if int(size[j]) >= k:
                    continue
                s_in = sol[j, :int(size[j])].tolist()
                elig = (valid.reshape(-1).numpy()
                        & ~np.isin(ids.reshape(-1).numpy(), s_in))
                g = gains_fn(rows_by_id[s_in], f64(feats.reshape(-1, D)))
                tol = MARGIN * max(1.0, abs(float(tau[j])))
                assert (np.abs(g - float(tau[j]))[elig] > tol).all(), \
                    "a survivor filter decision is a near tie"
        for feats, valid, cap in self.tops:
            for mf, mv in zip(feats, valid):
                g = np.sort(gains_fn([], f64(mf))[mv.numpy()])[::-1]
                if len(g) > cap:
                    assert g[cap - 1] - g[cap] > MARGIN * max(1.0, g[cap]), \
                        "the top-singleton cut is a near tie"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("engine", ["dense", "lazy", "fused"])
@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("name", ["log_det", "mutual_information"])
def test_logdet_drivers_match_jax(name, epochs, engine, precision,
                                  monkeypatch):
    """Equal ids, sizes and RoundLogs, values within rtol 1e-5, and every
    decision's margin asserted (MI at noise 0.7)."""
    X = _corpus(name, 30 + epochs)
    log = DecisionLog(monkeypatch)
    jres, tres, to = run_both(name, X, epochs, engine, precision,
                              jax.random.PRNGKey(epochs))
    # the decisions are no accident of rounding; then the ids
    stored = (np.asarray(jnp.asarray(X, jnp.bfloat16)) if precision == "bf16"
              else X).astype(np.float64)
    log.check_margins(stored, lambda S, c: logdet_gains64(
        S, c, to.alpha, to.scale), K)
    np.testing.assert_array_equal(tres.sol_ids.numpy(),
                                  np.asarray(jres.sol_ids))
    np.testing.assert_allclose(float(tres.value), float(jres.value),
                               rtol=1e-5)
