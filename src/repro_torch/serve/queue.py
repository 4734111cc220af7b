"""Deadline-aware request coalescing for the align service.

The expensive unit of work in a center-star request is map(1): a batch of
queries against that request's center. Concurrent requests each carry a
*different* center, so they cannot share the broadcast-center primitive —
but they can share ``AlignEngine.align_pairs``: every (query, center)
pair becomes one row of a per-pair-target batch, and the engine's pow2
(q_width, t_width) bucketing turns the merged batch into at most
log2(Lq)·log2(Lt) kernel calls no matter how many callers contributed.
On the card each call is the Gotoh forward kernel
(``csrc/sw_forward.cu``, through ``kernels.sw.ops.gotoh_forward``).

Scheduling is max-wait / max-batch: a submitted job waits at most
``max_wait_ms`` for company (the deadline), and a group is flushed early
the moment it reaches ``max_batch`` pairs. One worker thread executes
groups serially — device work is serialized anyway; the coalescing win is
batching, not concurrency. Jobs only merge within an ``engine_key``
(same alphabet/scoring/backend), and ``close()`` drains: everything
already submitted completes, new submissions are refused.

The merged batch is built on the engine's device (each job's queries and
center cross to it once) and the batch's rows come back to the host once;
the worker makes the engine's card its current device, since the kernels
launch on that device's current stream.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import on_device
from ..obs import metrics as _obs
from ..obs import trace as _trace

_H_WAIT = _obs.histogram(
    "repro_queue_wait_seconds", "submit-to-batch-start wait per job",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5))
_H_OCCUPANCY = _obs.histogram(
    "repro_batch_pairs", "pairs per coalesced batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_C_FAILED_BATCHES = _obs.counter("repro_failed_batches_total",
                                 "coalesced batches whose engine call failed")
_C_FAILED_PAIRS = _obs.counter("repro_failed_pairs_total",
                               "pairs failed with their batch")


@dataclasses.dataclass
class AlignJob:
    """One caller's map(1) work unit: queries against a frozen center."""
    Q: object              # (B, Lq) int8 encoded queries (gap-padded),
                           # numpy or a tensor
    qlens: object          # (B,) int32
    target: object         # (m,) int8 encoded center (unpadded)
    tlen: int
    engine: object         # repro_torch.align.AlignEngine
    engine_key: str        # jobs coalesce only within one key


class JobResult(NamedTuple):
    score: np.ndarray      # (B,) f32
    a_row: np.ndarray      # (B, P) int8
    b_row: np.ndarray      # (B, P) int8
    aln_len: np.ndarray    # (B,) i32
    meta: dict             # batch_jobs / batch_pairs / engine_calls


class CoalescingAligner:
    """Merge concurrent AlignJobs into bucketed ``align_pairs`` batches."""

    def __init__(self, *, max_batch: int = 256, max_wait_ms: float = 5.0):
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._pending: Dict[str, List[Tuple[float, AlignJob, Future]]] = {}
        self._cond = threading.Condition()
        self._closing = False
        self._stats = {"jobs": 0, "pairs": 0, "batches": 0,
                       "engine_calls": 0, "coalesced_jobs": 0,
                       "fallback_pairs": 0, "failed_batches": 0,
                       "failed_pairs": 0}
        self._in_flight = 0
        self._worker = threading.Thread(target=self._loop,
                                        name="coalescing-aligner",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ public

    def submit(self, job: AlignJob) -> "Future[JobResult]":
        """Enqueue a job; the returned future resolves to a JobResult."""
        fut: Future = Future()
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        with self._cond:
            if self._closing:
                raise RuntimeError("CoalescingAligner is draining; "
                                   "no new jobs accepted")
            self._pending.setdefault(job.engine_key, []).append(
                (deadline, job, fut))
            self._stats["jobs"] += 1
            self._stats["pairs"] += int(job.Q.shape[0])
            self._in_flight += 1
            self._cond.notify()
        return fut

    def close(self):
        """Drain: flush every pending group, finish in-flight work, stop.

        Idempotent; after it returns, all previously returned futures are
        resolved and ``submit`` raises.
        """
        with self._cond:
            self._closing = True
            self._cond.notify()
        self._worker.join()

    @property
    def lock(self) -> threading.Condition:
        """The queue's own lock, exposed for combined atomic snapshots
        (``MSAService.stats_snapshot`` holds it together with the cache
        lock so ``/healthz`` numbers come from one instant)."""
        return self._cond

    def stats_locked(self) -> dict:
        """Stats snapshot; caller must hold ``self.lock``."""
        return dict(self._stats, in_flight=self._in_flight)

    def stats(self) -> dict:
        with self._cond:
            return self.stats_locked()

    # ------------------------------------------------------------ worker

    def _ready_key(self, now: float) -> Optional[str]:
        for key, items in self._pending.items():
            pairs = sum(int(j.Q.shape[0]) for _, j, _ in items)
            if (self._closing or pairs >= self.max_batch
                    or min(d for d, _, _ in items) <= now):
                return key
        return None

    def _loop(self):
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    key = self._ready_key(now)
                    if key is not None:
                        items = self._pending.pop(key)
                        break
                    if self._closing and not self._pending:
                        return
                    if self._pending:
                        nxt = min(d for items in self._pending.values()
                                  for d, _, _ in items)
                        self._cond.wait(timeout=max(nxt - now, 0.0))
                    else:
                        self._cond.wait()
            self._run_batch(items)
            with self._cond:
                self._in_flight -= len(items)
                self._cond.notify()

    @staticmethod
    def _merge(jobs, counts, engine):
        """The jobs' pairs as one per-pair-target batch on the engine's
        device: (Q, qlens, T, tlens) tensors, gap-padded."""
        dev = engine.device
        gap = engine.gap_code
        B = sum(counts)
        Lq = max(int(j.Q.shape[1]) for j in jobs)
        Lt = max(int(j.tlen) for j in jobs)
        Q = torch.full((B, Lq), gap, dtype=torch.int8, device=dev)
        T = torch.full((B, Lt), gap, dtype=torch.int8, device=dev)
        qlens = torch.zeros((B,), dtype=torch.int32, device=dev)
        tlens = torch.zeros((B,), dtype=torch.int32, device=dev)
        off = 0
        for j, c in zip(jobs, counts):
            q = torch.as_tensor(j.Q).to(dev, torch.int8)
            Q[off:off + c, :q.shape[1]] = q
            T[off:off + c, :j.tlen] = torch.as_tensor(
                j.target).to(dev, torch.int8)[:j.tlen]
            qlens[off:off + c] = torch.as_tensor(j.qlens).to(dev,
                                                             torch.int32)
            tlens[off:off + c] = int(j.tlen)
            off += c
        return Q, qlens, T, tlens

    def _run_batch(self, items):
        jobs = [j for _, j, _ in items]
        futs = [f for _, _, f in items]
        now = time.monotonic()
        wait_budget = self.max_wait_ms / 1e3
        for deadline, _, _ in items:
            # submit time is deadline - max_wait, so no tuple change needed
            _H_WAIT.observe(max(now - (deadline - wait_budget), 0.0))
        n_pairs = sum(int(j.Q.shape[0]) for j in jobs)
        try:
            with _trace.span("serve.batch", jobs=len(jobs), pairs=n_pairs,
                             engine_key=jobs[0].engine_key):
                engine = jobs[0].engine
                counts = [int(j.Q.shape[0]) for j in jobs]
                B = sum(counts)
                with on_device(engine.device):
                    res = engine.align_pairs(*self._merge(jobs, counts,
                                                          engine))
                    # the batch's rows cross to the host once
                    a_rows = res.a_row.cpu().numpy()
                    b_rows = res.b_row.cpu().numpy()
                    score = res.score.cpu().numpy()
                    aln_len = res.aln_len.cpu().numpy()
            meta = {"batch_jobs": len(jobs), "batch_pairs": B,
                    "engine_calls": int(res.n_calls)}
            _H_OCCUPANCY.observe(B)
            with self._cond:
                self._stats["batches"] += 1
                self._stats["engine_calls"] += int(res.n_calls)
                self._stats["fallback_pairs"] += int(res.n_fallback)
                if len(jobs) > 1:
                    self._stats["coalesced_jobs"] += len(jobs)
            off = 0
            for fut, c in zip(futs, counts):
                fut.set_result(JobResult(score[off:off + c],
                                         a_rows[off:off + c],
                                         b_rows[off:off + c],
                                         aln_len[off:off + c], meta))
                off += c
        except BaseException as e:
            _C_FAILED_BATCHES.inc()
            _C_FAILED_PAIRS.inc(n_pairs)
            with self._cond:
                self._stats["failed_batches"] += 1
                self._stats["failed_pairs"] += n_pairs
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
