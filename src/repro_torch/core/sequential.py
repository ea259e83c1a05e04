"""Single-machine baselines: classic greedy (Nemhauser–Wolsey–Fisher 1-1/e),
sequential threshold greedy, and exact brute force for tiny instances.
They anchor the guarantee checks: a MapReduce selection's value is held
against the greedy value, which is at most OPT, or against brute-force OPT
when n is tiny.
"""

from __future__ import annotations

import itertools

import torch

from repro_torch.core.threshold import threshold_greedy
from repro_torch.states import where_state


def greedy(oracle, feats, valid, k: int, ids=None):
    """Classic greedy: k argmax steps over the whole block.  Returns (ids
    (k,) int32 -1 padded, size () int, value ()); the buffer holds row
    indices, or global ids when ``ids`` is given."""
    n = feats.shape[0]
    dev = valid.device
    st = oracle.init_state()
    aux = oracle.prep(st, feats)
    sol = torch.full((k,), -1, dtype=torch.int32, device=dev)
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(k):
        gains = torch.where(valid & ~taken, oracle.marginals(st, aux),
                            float("-inf"))
        best = gains.argmax()
        ok = gains[best] > 0.0
        st = where_state(ok, oracle.add(st, aux[best]), st)
        out_id = best.to(torch.int32) if ids is None else ids[best]
        sol[i] = torch.where(ok, out_id, sol[i])
        taken[best] |= ok
    return sol, (sol >= 0).sum(), oracle.value(st)


def threshold_sequential(oracle, feats, valid, k: int, tau):
    """Single-machine ThresholdGreedy over the whole block (Algorithm 1 run
    centrally), as one lane.  Returns (ids (k,), size (), value ())."""
    n = feats.shape[0]
    dev = valid.device
    st = oracle.init_state(1)
    sol = torch.full((1, k), -1, dtype=torch.int32, device=dev)
    size = torch.zeros(1, dtype=torch.int32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    st, sol, size = threshold_greedy(oracle, st, sol, size, feats, ids, valid,
                                     tau, k)
    return sol[0], size[0], oracle.value(st)[0]


def brute_force(oracle, feats, k: int):
    """Exact OPT by enumeration, only for tiny (n choose k).  Each subset's
    value comes from the state chain (prep, then one add per element).
    Returns (best subset as a tuple of row indices, its value as a float);
    the first subset in enumeration order wins a tie."""
    n = feats.shape[0]

    def value_of(subset):
        st = oracle.init_state()
        aux = oracle.prep(st, feats[list(subset)])
        for i in range(len(subset)):
            st = oracle.add(st, aux[i])
        return float(oracle.value(st))

    best, best_v = (), -1.0
    for subset in itertools.combinations(range(n), min(k, n)):
        v = value_of(subset)
        if v > best_v:
            best, best_v = subset, v
    return best, best_v
