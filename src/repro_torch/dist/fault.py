"""Failure recovery: the scheduler work Spark does for HAlign-II.

``BackupShardPlan`` — static replication plan mapping every sequence shard
to ``replication`` hosts (primary first, ring successors after), plus the
reassignment table used when a host dies: each affected shard moves to its
first surviving owner, so recovery is a table lookup, not a reshuffle.

``ResilientLoop`` checkpoints every ``ckpt_every`` steps, and on
``StepFailure`` (preemption, injected fault, a timeout surfaced by the
caller) restores the newest checkpoint and replays forward. Steps are
pure functions of ``(state, batch(step))``, so replay reproduces the
exact trajectory — failures cost wall-clock, never correctness.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from ..obs import metrics as _obs
from .checkpoint import CheckpointManager

_C_STEPS = _obs.counter("repro_resilient_steps_total",
                        "steps completed by ResilientLoop")
_C_FAILURES = _obs.counter("repro_resilient_failures_total",
                           "StepFailures caught by ResilientLoop")
_C_REPLAYS = _obs.counter("repro_resilient_replays_total",
                          "restore-and-replay recoveries")


class StepFailure(RuntimeError):
    """A step failed in a way that warrants checkpoint replay."""


@dataclasses.dataclass(frozen=True)
class BackupShardPlan:
    """shard s lives on hosts (s, s+1, ..., s+replication-1) mod n_hosts.

    ``n_shards`` defaults to one shard per host; pass it explicitly when
    the data is split finer than the host count.
    """
    n_hosts: int
    replication: int
    n_shards: Optional[int] = None

    def __post_init__(self):
        if not 1 <= self.replication <= self.n_hosts:
            raise ValueError(
                f"replication {self.replication} not in [1, {self.n_hosts}]")
        if self.n_shards is None:
            object.__setattr__(self, "n_shards", self.n_hosts)

    def owners(self, shard: int) -> List[int]:
        """Hosts holding ``shard``; owners[0] is the primary."""
        return [(shard + j) % self.n_hosts for j in range(self.replication)]

    @staticmethod
    def _dead_set(dead) -> frozenset:
        """Accept a single host id or any iterable of them (cascades)."""
        if isinstance(dead, int):
            return frozenset((dead,))
        return frozenset(int(h) for h in dead)

    def takeover(self, dead, shard: int) -> Optional[int]:
        """First surviving owner of ``shard`` when ``dead`` fails.

        ``dead`` is one host id or an iterable of them (a cascading
        failure where the backup owners may be dead too); ``None`` means
        every replica of the shard is gone.
        """
        dead = self._dead_set(dead)
        for h in self.owners(shard):
            if h not in dead:
                return h
        return None

    def reassignment(self, dead) -> Dict[int, int]:
        """shard -> takeover host, for every shard the dead hosts held.

        Shards whose every replica died are absent from the table — the
        caller must re-ingest those, not look them up.
        """
        dead = self._dead_set(dead)
        out = {}
        for s in range(self.n_shards):
            if dead & set(self.owners(s)):
                t = self.takeover(dead, s)
                if t is not None:
                    out[s] = t
        return out


class ResilientLoop:
    """Checkpointed step loop with deterministic failure replay.

    ``step_fn(state, batch) -> state`` must be pure in its inputs;
    ``batches`` provides ``n_steps`` and ``batches(step) -> batch``.
    ``failure_hook(step)`` (tests, chaos injection) runs before each step
    and may raise ``StepFailure``; any other exception ends the run (a
    kill), after which ``run(..., resume=True)`` continues from the
    newest checkpoint. ``state_shardings`` (a ``sharding_plan.Shardings``
    of the state) is forwarded to every restore, so a replayed or resumed
    state lands back on the mesh.
    """

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager, *,
                 ckpt_every: int = 100,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 max_failures: Optional[int] = None,
                 state_shardings=None):
        self.step_fn = step_fn
        self.state_shardings = state_shardings
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.failure_hook = failure_hook
        self.max_failures = max_failures

    def run(self, state, batches, *, resume: bool = False):
        """Run to ``batches.n_steps``; returns ``(state, steps_completed)``."""
        n_steps = int(batches.n_steps)
        step = 0
        if resume and self.ckpt.all_steps():
            state, step = self.ckpt.restore(
                state, shardings=self.state_shardings)
        failures = 0
        while step < n_steps:
            if self.ckpt_every and step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                state = self.step_fn(state, batches(step))
                step += 1
                _C_STEPS.inc()
            except StepFailure:
                failures += 1
                _C_FAILURES.inc()
                if self.max_failures is not None and failures > self.max_failures:
                    raise
                if not self.ckpt.all_steps():
                    raise
                state, step = self.ckpt.restore(
                    state, shardings=self.state_shardings)
                _C_REPLAYS.inc()
        if self.ckpt_every and self.ckpt.latest_step() != step:
            self.ckpt.save(step, state)      # final state must be durable
        return state, step
