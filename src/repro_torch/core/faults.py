"""Deterministic fault injection for the round-primitives layer.

* ``FaultPlan``: a seeded, stateless chaos schedule of per-epoch shard
  loss and per-gather dropped, corrupted and straggling messages.  Every
  mask is drawn on the host with numpy from (seed, fault kind, epoch or
  gather index), the JAX package's draws bit for bit, so a plan realizes
  the same faults on both substrates, in every process and across
  restarts.
* ``FaultyRounds``: a wrapper with the substrates' surface that applies
  the plan at every gather, records each event as a ``FaultRecord`` in the
  driver's RoundLog, and boosts the sample probability for shards known
  lost at the start of an epoch.

A fault never corrupts a selection silently: the affected rows are
invalidated before the central accept (corrupted rows are also overwritten
with a finite canary, so a consumed one shows), every event is recorded,
and the result carries ``degraded`` and a guarantee ``haircut``, the worst
per-round survivor fraction.  With ``plan=None``, or a plan that realizes
no fault, the wrapper passes everything through unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.rounds import FaultRecord, RoundLog

#: fault kinds a FaultPlan can realize, in record order
FAULT_KINDS = ("shard_loss", "msg_drop", "msg_corrupt", "straggler")

#: corrupted rows get every feature column set to this (at the storage
#: dtype) before they are invalidated: large and finite, so a consumed
#: corrupted row shows as an absurd value
CORRUPT_CANARY = 1.0e30


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic chaos schedule.

    Rates are per-machine Bernoulli probabilities.  ``loss_rate`` is drawn
    once an epoch: the machine is gone for both of the epoch's rounds, and
    the sample probability is boosted to make up for it.  The other three
    are drawn once a gather and are transient.  A straggler misses the
    round's deadline, which under a synchronous barrier is a drop;
    ``straggler_deadline_ms`` is reporting detail."""
    loss_rate: float = 0.0
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_deadline_ms: float = 50.0
    seed: int = 0

    def __post_init__(self):
        for name in ("loss_rate", "drop_rate", "corrupt_rate",
                     "straggler_rate"):
            r = getattr(self, name)
            if not 0.0 <= float(r) <= 1.0:
                raise ValueError(f"FaultPlan: {name}={r} not in [0, 1]")

    @property
    def active(self) -> bool:
        return (self.loss_rate > 0 or self.drop_rate > 0
                or self.corrupt_rate > 0 or self.straggler_rate > 0)

    def _draw(self, tag: int, idx: int, rate: float, m: int) -> np.ndarray:
        """Bernoulli mask over m machines keyed by (seed, kind tag, epoch
        or gather index), whatever the call order."""
        if rate <= 0.0:
            return np.zeros(m, bool)
        rng = np.random.default_rng([int(self.seed) & 0x7FFFFFFF, tag, idx])
        return rng.random(m) < rate

    def loss_mask(self, epoch: int, m: int) -> np.ndarray:
        """Machines lost for the whole of ``epoch``.  Losing every shard is
        an outage, not a degraded run, so the plan spares one machine
        (rotating with the epoch) instead."""
        lost = self._draw(0, epoch, self.loss_rate, m)
        if lost.all():
            lost[epoch % m] = False
        return lost

    def round_masks(self, round_index: int, m: int) -> Dict[str, np.ndarray]:
        """The transient masks of gather number ``round_index``."""
        return {
            "msg_drop": self._draw(1, round_index, self.drop_rate, m),
            "msg_corrupt": self._draw(2, round_index, self.corrupt_rate, m),
            "straggler": self._draw(3, round_index, self.straggler_rate, m),
        }

    def grid_pad(self, eps: float) -> int:
        """Extra unknown-OPT grid points: lost shards can lower the sampled
        max singleton by about the loss fraction, so covering OPT costs
        about log_{1+eps} 1/(1 - loss) more points."""
        r = min(float(self.loss_rate), 0.75)
        if r <= 0.0:
            return 0
        return int(math.ceil(math.log(1.0 / (1.0 - r)) / math.log1p(eps)))


def chaos_plan(rate: float, seed: int = 0) -> Optional[FaultPlan]:
    """The one-knob chaos profile: shard loss at ``rate``, message drops at
    half of it, corruption and stragglers at a quarter each; None (no
    wrapper) at rate 0."""
    rate = float(rate)
    if rate <= 0.0:
        return None
    return FaultPlan(loss_rate=rate, drop_rate=rate / 2,
                     corrupt_rate=rate / 4, straggler_rate=rate / 4,
                     seed=seed)


class FaultyRounds:
    """Fault-injecting wrapper over a ``SimRounds`` or ``MeshRounds``.

    It has the substrates' surface (``sample``, ``tops``, ``filter_grid``,
    ``finalize_drops`` and the ``begin_epoch`` hook), so every driver runs
    over it unchanged; other attributes are the wrapped substrate's.  Both
    substrates make the same gathers in the same order and the masks come
    from the host, so the realized faults and their records are the same
    on sim and mesh.  It clears the log's fault records when it is built,
    once a driver call.
    """

    def __init__(self, inner, plan: Optional[FaultPlan], log: RoundLog,
                 m: int, n_total: int):
        self.inner = inner
        self.plan = plan if (plan is not None and plan.active) else None
        self.log = log
        self.m = int(m)
        self.n_total = int(n_total)
        self._round = 0
        self._epoch: Optional[int] = None
        self._lost = np.zeros(self.m, bool)
        #: the last ``degrade``'s realized dead-machine mask (numpy bool
        #: (m,)), or None when that gather was clean: a driver with one
        #: gather (the distributed sieve) masks its ride-along statistics
        #: with it
        self.last_dead: Optional[np.ndarray] = None
        log.faults.clear()

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def survivors(self) -> int:
        return self.m - int(self._lost.sum())

    def _eff_n(self, eff_machines: int) -> int:
        return int(round(self.n_total * eff_machines / self.m))

    def begin_epoch(self, e: int) -> None:
        # ``inner=None`` is the mode of a one-gather driver that is no
        # substrate (the distributed sieve): only ``degrade`` is used, and
        # nothing delegates
        if self.inner is not None:
            self.inner.begin_epoch(e)
        if self.plan is None or self._epoch == e:
            return
        self._epoch = e
        self._lost = self.plan.loss_mask(e, self.m)
        down = np.flatnonzero(self._lost)
        if down.size:
            eff = self.m - int(down.size)
            self.log.fault(FaultRecord(
                "shard_loss", e, self._round,
                tuple(int(x) for x in down), self.m, eff, self._eff_n(eff),
                f"epoch {e}: {down.size}/{self.m} shards lost; sample_p "
                f"boosted x{self.m / max(eff, 1):.3f}"))

    def _ensure_epoch(self) -> None:
        # the unknown-OPT drivers draw epoch 1's sample before run_epochs
        # announces the epoch
        if self._epoch is None:
            self.begin_epoch(0)

    def degrade(self, gathered, drops):
        """Apply this gather's transient faults and the epoch's loss mask
        to a gathered machine-major triple (rows [c cap, (c + 1) cap) are
        machine c's, under any leading lane or query axes)."""
        self._ensure_epoch()
        f, i, v = gathered
        r = self._round
        self._round += 1
        self.last_dead = None
        if self.plan is None:
            return gathered, drops
        masks = self.plan.round_masks(r, self.m)
        dead = self._lost.copy()
        detail = {
            "msg_drop": "gather message dropped",
            "msg_corrupt": "gather message corrupted (detected, discarded)",
            "straggler": (f"reply past the "
                          f"{self.plan.straggler_deadline_ms:g}ms round "
                          "deadline (counted out)"),
        }
        for kind in ("msg_drop", "msg_corrupt", "straggler"):
            mk = masks[kind] & ~dead
            if not mk.any():
                continue
            dead |= mk
            eff = self.m - int(dead.sum())
            self.log.fault(FaultRecord(
                kind, self._epoch or 0, r,
                tuple(int(x) for x in np.flatnonzero(mk)), self.m, eff,
                self._eff_n(eff), detail[kind]))
        if not dead.any():
            return gathered, drops
        self.last_dead = dead
        cap = i.shape[-1] // self.m
        corrupt = masks["msg_corrupt"] & ~self._lost
        if corrupt.any():
            crow = torch.from_numpy(np.repeat(corrupt, cap)).to(f.device)
            f = torch.where(crow[:, None],
                            torch.tensor(CORRUPT_CANARY, dtype=f.dtype,
                                         device=f.device), f)
        keep = torch.from_numpy(np.repeat(~dead, cap)).to(v.device)
        return (f, i, v & keep), drops

    def sample(self, uniforms, p, cap):
        self._ensure_epoch()
        s = self.survivors
        if self.plan is not None and s < self.m:
            # shards lost at the epoch's start are known lost: boost the
            # rate so the survivors' union keeps the expected p n rows
            p = min(1.0, p * self.m / max(s, 1))
        return self.degrade(*self.inner.sample(uniforms, p, cap))

    def tops(self, oracles, cap):
        return self.degrade(*self.inner.tops(oracles, cap))

    def filter_grid(self, groups, cap, chunk):
        return self.degrade(*self.inner.filter_grid(groups, cap, chunk))

    def finalize_drops(self, drops):
        return self.inner.finalize_drops(drops)


def with_faults(rr, plan: Optional[FaultPlan], log: RoundLog, m: int,
                n_total: int):
    """``rr`` wrapped when a fault plan is configured; ``rr`` itself when
    ``plan`` is None."""
    if plan is None:
        return rr
    return FaultyRounds(rr, plan, log, m, n_total)


def degrade_gathered(rr, gathered, drops):
    """``rr``'s fault injection on a gathered triple that a driver gathered
    outside the substrate's own ops; the triple unchanged on a bare
    substrate."""
    if isinstance(rr, FaultyRounds):
        return rr.degrade(gathered, drops)
    return gathered, drops


def fault_summary(log: RoundLog) -> Tuple[bool, float]:
    """(degraded, haircut) from a driver's recorded faults.  The haircut is
    the worst per-round survivor fraction (M - m) / M: under a random
    partition the optimum's elements land uniformly over the machines, so
    losing m of M shards keeps E[f(OPT and survivors)] >= ((M - m) / M)
    f(OPT) for monotone submodular f."""
    if not log.faults:
        return False, 1.0
    frac = min(rec.eff_machines / rec.n_machines for rec in log.faults)
    return True, float(frac)


def apply_fault_flags(res, log: RoundLog):
    """``res`` with ``degraded`` and ``haircut`` set from the RoundLog's
    fault records; ``res`` itself when there are none."""
    degraded, haircut = fault_summary(log)
    if not degraded:
        return res
    dev = res.value.device
    return res._replace(
        degraded=torch.ones((), dtype=torch.int32, device=dev),
        haircut=torch.tensor(haircut, dtype=torch.float32, device=dev))
