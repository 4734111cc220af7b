"""Failure recovery: the deterministic replay loop around a step function.

``ResilientLoop`` checkpoints every ``ckpt_every`` steps, and on
``StepFailure`` (preemption, injected fault, a timeout surfaced by the
caller) restores the newest checkpoint and replays forward. Steps are
pure functions of ``(state, batch(step))``, so replay reproduces the
exact trajectory — failures cost wall-clock, never correctness. The
reference's ``BackupShardPlan`` (shard replication across hosts) belongs
to the distributed runtime, ROADMAP.md §1 item 11, and is not ported.
"""
from __future__ import annotations

from typing import Callable, Optional

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


class ResilientLoop:
    """Checkpointed step loop with deterministic failure replay.

    ``step_fn(state, batch) -> state`` must be pure in its inputs;
    ``batches`` provides ``n_steps`` and ``batches(step) -> batch``.
    ``failure_hook(step)`` (tests, chaos injection) runs before each step
    and may raise ``StepFailure``; any other exception ends the run (a
    kill), after which ``run(..., resume=True)`` continues from the
    newest checkpoint.
    """

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager, *,
                 ckpt_every: int = 100,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 max_failures: Optional[int] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.failure_hook = failure_hook
        self.max_failures = max_failures

    def run(self, state, batches, *, resume: bool = False):
        """Run to ``batches.n_steps``; returns ``(state, steps_completed)``."""
        n_steps = int(batches.n_steps)
        step = 0
        if resume and self.ckpt.all_steps():
            state, step = self.ckpt.restore(state)
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
                state, step = self.ckpt.restore(state)
                _C_REPLAYS.inc()
        if self.ckpt_every and self.ckpt.latest_step() != step:
            self.ckpt.save(step, state)      # final state must be durable
        return state, step
