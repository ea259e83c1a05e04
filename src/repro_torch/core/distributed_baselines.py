"""The paper's comparison points, as executable baselines on the sim
substrate.

* ``rand_greedi`` (Barbosa, Ene, Nguyen and Ward): a random partition,
  classic greedy to k on each machine, the m k union to the central
  machine, which greedily selects k; the better of the central solution and
  the best machine's.  Two rounds; 1/2 in expectation.
* ``mz_coresets`` (Mirrokni and Zadimoghaddam): the same communication
  with ``duplication`` copies of the data set, each element sent to that
  many machines (the data set blow-up the paper removes, counted in the
  RoundLog).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.mapreduce import SelectionResult
from repro_torch.core.rounds import RoundLog, RoundRecord, buffer_bytes
from repro_torch.core.sequential import greedy


def _greedy_ids(oracle, feats, ids, valid, k: int):
    """Greedy over one block, its picks as global ids (-1 padded)."""
    sol_local, size, value = greedy(oracle, feats, valid, k)
    pick = sol_local.clamp(min=0).long()
    return torch.where(sol_local >= 0, ids[pick], -1), pick, size, value


def rand_greedi(oracle, feats_mk, ids_mk, valid_mk, k: int
                ) -> Tuple[SelectionResult, RoundLog]:
    """RandGreeDi over the (m, n/m, d) partition: each machine's greedy
    core-set, one gather, the central greedy, and the better of the central
    and the best machine's solution (ids, size and value from the same
    one)."""
    m, _, d = feats_mk.shape
    log = RoundLog()
    cores = [_greedy_ids(oracle, f, i, v, k)
             for f, i, v in zip(feats_mk, ids_mk, valid_mk)]
    ci = torch.stack([c[0] for c in cores])
    cf = torch.stack([f[c[1]] for f, c in zip(feats_mk, cores)])
    local_vals = torch.stack([c[3] for c in cores])
    log.add("gather-coresets", buffer_bytes(k, d), buffer_bytes(m * k, d),
            "greedy core-set per machine")

    union = (cf.reshape(m * k, d), ci.reshape(-1), ci.reshape(-1) >= 0)
    sol_ids, _, size, central_val = _greedy_ids(oracle, *union, k)
    log.add("broadcast-result", buffer_bytes(k, 0), buffer_bytes(k, 0))

    best_local = local_vals.argmax()
    local_ids = ci[best_local]
    use_central = central_val >= local_vals[best_local]
    res = SelectionResult(
        torch.where(use_central, sol_ids, local_ids),
        torch.where(use_central, size, (local_ids >= 0).sum()),
        torch.where(use_central, central_val, local_vals[best_local]),
        torch.zeros((), dtype=torch.int32, device=ci.device),
        torch.zeros((), dtype=torch.int32, device=ci.device))
    return res, log


def mz_coresets(oracle, feats, ids, valid, k: int, m: int, perms=None,
                generator: Optional[torch.Generator] = None,
                duplication: int = 1) -> Tuple[SelectionResult, RoundLog]:
    """A random (re)partition of the unpartitioned (n, d) ``feats`` with
    ``duplication`` copies, then rand_greedi's communication.  ``perms``:
    the copies' permutations of range(n), one a copy; else drawn from
    ``generator`` (a fresh generator seeded 0 when None)."""
    n, d = feats.shape
    n_loc = n // m
    if perms is None:
        if generator is None:
            generator = torch.Generator(device=feats.device).manual_seed(0)
        perms = [torch.randperm(n, generator=generator,
                                device=generator.device)
                 for _ in range(duplication)]
    if len(perms) != duplication:
        raise ValueError(f"mz_coresets: {len(perms)} permutations for "
                         f"duplication {duplication}")
    copies = []
    for perm in perms:
        take = torch.as_tensor(perm, device=feats.device).long()[:n_loc * m]
        copies.append((feats[take].reshape(m, n_loc, d),
                       ids[take].reshape(m, n_loc),
                       valid[take].reshape(m, n_loc)))
    res, log = rand_greedi(oracle, *(torch.cat(c, 1) for c in zip(*copies)),
                           k)
    # duplication multiplies the first round's input volume
    r0 = log.records[0]
    log.records[0] = RoundRecord(r0.name, r0.bytes_per_machine,
                                 r0.bytes_total,
                                 f"dataset duplication x{duplication}")
    return res, log
