"""Distributed sieve-and-merge: every machine sieves its local stream, the
packed survivors are gathered once, and a central completion finishes
with the ThresholdGreedy engines.

This is the GreeDi / randomized-core-set shape (Mirzasoleiman et al.;
Barbosa et al.) on the port's substrates: each shard compresses its
stream, a central machine finishes.  Against ``two_round`` it trades the
Bernoulli-sample round for a *single* gather (one round, one pass over
every shard) at the cost of the weaker one-pass constant; the central
completion over the pooled survivors recovers most of the gap.

The same per-machine function runs on two substrates:

* ``sieve_and_merge_sim``: the m machines on one device.  The JAX package
  vmaps the local sieve over them; here each machine's stream is sieved
  in turn, a loop over machines (m x T ``sieve_update`` calls, each one
  engine call of L lanes).  A lane's bits do not depend on how many lanes
  share its launch, so one engine call of m L lanes would give the same
  bits, at m times the per-lane candidate memory;
* ``sieve_and_merge_mesh``: this process is one machine of a process
  group (``launch.mesh.Mesh``); the survivor gather is one
  ``rounds.gather_packed`` a tensor, and the completion runs replicated on
  every rank, with the RoundLog of the sim.

Both apply a fault plan through ``faults.FaultyRounds(None, ...)`` on the
one gather, and mask the dead machines' best lanes and v_max through its
``last_dead``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import faults as faults_mod
from repro_torch.core.mapreduce import SelectionResult, _mesh_setup
from repro_torch.core.rounds import RoundLog, gather_packed, log_gather
from repro_torch.core.threshold import pack_by_mask
from repro_torch.streaming.sieve import (SieveSpec, merge_pool, sieve_best,
                                         sieve_stream)


def _pool_cap(spec: SieveSpec, cap: Optional[int]) -> int:
    # every lane can contribute k survivors; the default cap is lossless
    return cap or spec.lanes * spec.k


def _local_sieve(oracle, spec: SieveSpec, feats, ids, valid,
                 chunk_elems: int, cap: int):
    """One machine's half: sieve the local stream chunk by chunk, then pack
    the union of lane solutions (features + ids) to the message cap,
    by lane value so a tight cap keeps the best lanes whole; the
    top-singleton reservoir rides along uncapped."""
    state = sieve_stream(oracle, spec, feats, ids, valid, chunk_elems)
    L, k = spec.lanes, spec.k
    d = feats.shape[-1]
    lane_vals = oracle.value(state.oracle_states)                # (L,)
    prio = lane_vals[:, None].expand(L, k).reshape(L * k)
    pool_ids = state.sol_ids.reshape(L * k)
    pf, pi, pv, dropped = pack_by_mask(state.sol_feats.reshape(L * k, d),
                                       pool_ids, pool_ids >= 0, cap,
                                       priority=prio)
    pf = torch.cat([pf, state.top_feats])
    pi = torch.cat([pi, state.top_ids])
    pv = torch.cat([pv, state.top_ids >= 0])
    b_sol, b_size, b_val = sieve_best(oracle, state)
    return pf, pi, pv, dropped, state.v_max, b_sol, b_size, b_val


def _log(spec: SieveSpec, cap: int, m: int, feat_dim: int) -> RoundLog:
    log = RoundLog()
    log_gather(log, "gather-sieve-survivors", cap + spec.tops, m, feat_dim,
               f"L={spec.lanes} lanes, pool cap={cap}+top "
               f"{spec.tops}/machine",
               itemsize=spec.precision_policy.storage_itemsize)
    return log


def _merge(oracle, spec, pool, v_all, b_sols, b_sizes, b_vals, dropped,
           faults, log, m: int, n_total: int) -> SelectionResult:
    """The central half on the gathered pool and statistics: the fault
    plan's one gather, the dead machines' best lanes and v_max masked,
    then ``merge_pool`` with the best surviving machine's lane riding
    along, so the merge never returns less than the best machine."""
    if faults is not None:
        w = faults_mod.FaultyRounds(None, faults, log, m, n_total)
        pool, _ = w.degrade(pool, torch.zeros((), dtype=torch.int32))
        if w.last_dead is not None:
            dm = torch.from_numpy(w.last_dead).to(b_vals.device)
            b_vals = torch.where(dm, float("-inf"), b_vals)
            v_all = torch.where(dm, float("-inf"), v_all)
    best = b_vals.argmax()
    res = merge_pool(oracle, spec, *pool, v_all.max(), b_sols[best],
                     b_sizes[best], b_vals[best].clamp(min=0.0))
    res = res._replace(n_dropped=dropped.to(torch.int32))
    return faults_mod.apply_fault_flags(res, log)


def sieve_and_merge_sim(oracle, feats_mk, ids_mk, valid_mk, spec: SieveSpec,
                        chunk_elems: int = 512,
                        pool_cap: Optional[int] = None,
                        faults: Optional[faults_mod.FaultPlan] = None
                        ) -> Tuple[SelectionResult, RoundLog]:
    """Sieve-and-merge with the m machines on one device.  feats_mk (m,
    n/m, d), ids_mk and valid_mk (m, n/m): the layout of the MapReduce
    sims.  ``faults`` applies the plan's epoch-0 / gather-0 faults to the
    one survivor gather (a lost machine's best lane and v_max are masked
    too).  Returns (SelectionResult, RoundLog)."""
    m, n_loc, d = feats_mk.shape
    cap = _pool_cap(spec, pool_cap)
    log = _log(spec, cap, m, d)
    outs = [_local_sieve(oracle, spec, feats_mk[c], ids_mk[c], valid_mk[c],
                         chunk_elems, cap) for c in range(m)]
    pf, pi, pv, dropped, v_loc, b_sol, b_size, b_val = (
        torch.stack(x) for x in zip(*outs))
    # the gather: machine c's message is rows [c msg, (c + 1) msg)
    pool = (pf.reshape(-1, d), pi.reshape(-1), pv.reshape(-1))
    b_vals = torch.where(b_size > 0, b_val, float("-inf"))
    return _merge(oracle, spec, pool, v_loc, b_sol, b_size, b_vals,
                  dropped.sum(), faults, log, m, m * n_loc), log


def sieve_and_merge_mesh(oracle, spec: SieveSpec, mesh, axes=("data",),
                         chunk_elems: int = 512,
                         pool_cap: Optional[int] = None,
                         faults: Optional[faults_mod.FaultPlan] = None):
    """Sieve-and-merge on a mesh: every rank is one machine of ``mesh``'s
    ``axes`` (those it has).  Returns ``run(feats, ids) -> SelectionResult``
    over this rank's stream (feats (n/m, d), ids (n/m,) global, -1 for
    padding) and the RoundLog.  No RNG: the driver is deterministic, and a
    fault plan realizes the sim's dead machines (the same records)."""
    m, group = _mesh_setup(mesh, axes)
    cap = _pool_cap(spec, pool_cap)
    log = _log(spec, cap, m, oracle.feat_dim)

    def run(feats, ids):
        valid = ids >= 0
        pf, pi, pv, dropped, v_loc, b_sol, b_size, b_val = _local_sieve(
            oracle, spec, feats, ids, valid, chunk_elems, cap)
        pool = tuple(gather_packed(x, group) for x in (pf, pi, pv))
        b_vals = torch.where(b_size > 0, b_val, float("-inf"))
        # every machine's statistics and best lane, machine-major
        stats = gather_packed(torch.stack([v_loc, b_vals])[None], group)
        v_all, b_vals = stats[:, 0], stats[:, 1]
        b_sols = gather_packed(b_sol[None], group)
        b_sizes = gather_packed(b_size.reshape(1), group)
        dropped = dropped.clone()
        dist.all_reduce(dropped, group=group)
        return _merge(oracle, spec, pool, v_all, b_sols, b_sizes, b_vals,
                      dropped, faults, log, m, m * feats.shape[0])

    return run, log
