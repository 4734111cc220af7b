"""AlignEngine: the single entry point for HAlign-II's map(1) stage.

It owns length-bucketed batching (``bucketing.bucket_plan``: each bucket
runs at its own power-of-two width instead of the global Lmax) and the
per-pair full-DP fallback shared by the banded backends (band overflow)
and the k-mer chaining path (chain failure). Bucket merges and fallback
merges stay on the device; only the (B,) ok flags cross to the host.

Two host batch APIs:

  ``align_to_center``  one broadcast target — the MSA map(1) stage
  ``align_pairs``      per-pair targets, grouped into pow2
                       (q_width, t_width) buckets, one backend call per
                       bucket (``PairsResult.n_calls`` reports how many)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import backends, bucketing
from ..obs import metrics as _obs

_M_CALLS = _obs.counter(
    "repro_align_calls_total",
    "backend invocations (buckets + fallback batches)", ("api", "backend"))
_M_PAIRS = _obs.counter(
    "repro_align_pairs_total", "pairs aligned", ("api", "backend"))
_M_FALLBACK = _obs.counter(
    "repro_align_fallback_pairs_total",
    "pairs re-aligned with full DP after band overflow", ("backend",))
_M_CELLS = _obs.counter(
    "repro_align_cells_total", "useful DP cells dispatched", ("api",))
_M_PAD_CELLS = _obs.counter(
    "repro_align_pad_cells_total", "padding DP cells dispatched", ("api",))
_G_PAD_WASTE = _obs.gauge(
    "repro_align_pad_waste_ratio",
    "padding fraction of the last dispatch's DP area", ("api",))


def _record_dispatch(api: str, backend: str, n_calls: int, n_pairs: int,
                     real_cells: Optional[int],
                     padded_cells: Optional[int]) -> None:
    _M_CALLS.labels(api=api, backend=backend).inc(n_calls)
    _M_PAIRS.labels(api=api, backend=backend).inc(n_pairs)
    if real_cells is None or padded_cells is None or padded_cells <= 0:
        return
    _M_CELLS.labels(api=api).inc(real_cells)
    _M_PAD_CELLS.labels(api=api).inc(max(padded_cells - real_cells, 0))
    _G_PAD_WASTE.labels(api=api).set(1.0 - real_cells / padded_cells)


class EngineResult(NamedTuple):
    score: torch.Tensor      # (B,) f32
    a_row: torch.Tensor      # (B, P) int8 gap-padded aligned queries
    b_row: torch.Tensor      # (B, P) int8 aligned target rows
    aln_len: torch.Tensor    # (B,) i32
    n_fallback: int          # pairs re-aligned with full DP


class PairsResult(NamedTuple):
    score: torch.Tensor      # (B,) f32
    a_row: torch.Tensor      # (B, P) int8 gap-padded aligned queries
    b_row: torch.Tensor      # (B, P) int8 aligned per-pair targets
    aln_len: torch.Tensor    # (B,) i32
    n_fallback: int          # pairs re-aligned with full DP
    n_calls: int             # backend invocations (buckets + fallbacks)


def _pad_cols(x, width: int, fill):
    if x.shape[-1] >= width:
        return x
    return F.pad(x, (0, width - x.shape[-1]), value=fill)


@dataclasses.dataclass(frozen=True)
class AlignEngine:
    """One configured map(1) engine. ``sub`` lives on the engine's device;
    the backend route (``cuda`` kernel or ``torch`` plain) follows it."""
    sub: torch.Tensor
    gap_open: int
    gap_extend: int
    gap_code: int = 5
    backend: str = "auto"
    local: bool = False
    bucket: bool = True
    min_bucket: int = 32

    def __post_init__(self):
        backends.resolve_backend(self.backend, self.sub.device)

    @property
    def device(self) -> torch.device:
        return self.sub.device

    @property
    def route(self) -> str:
        """``cuda`` (the kernel) or ``torch`` (the plain version)."""
        return backends.resolve_backend(self.backend, self.sub.device)

    def batch_fn(self, *, local: Optional[bool] = None):
        """(Q, lens, b, lb) -> BatchAlignment against one target."""
        loc = self.local if local is None else local

        def fn(Q, lens, b, lb):
            return backends.sw_align_batch(
                Q, lens, b, lb, self.sub, gap_open=self.gap_open,
                gap_extend=self.gap_extend, local=loc,
                gap_code=self.gap_code)
        return fn

    def pairs_fn(self, *, local: Optional[bool] = None):
        """(Q, qlens, T, tlens) -> BatchAlignment with per-pair targets."""
        loc = self.local if local is None else local

        def fn(Q, qlens, T, tlens):
            return backends.sw_align_pairs(
                Q, qlens, T, tlens, self.sub, gap_open=self.gap_open,
                gap_extend=self.gap_extend, local=loc,
                gap_code=self.gap_code)
        return fn

    def _empty_rows(self, B: int, P: int):
        dev = self.device
        return (torch.zeros((B,), dtype=torch.float32, device=dev),
                torch.full((B, P), self.gap_code, dtype=torch.int8,
                           device=dev),
                torch.full((B, P), self.gap_code, dtype=torch.int8,
                           device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev),
                torch.ones((B,), dtype=torch.bool, device=dev))

    def _merge(self, dst, ix, out: backends.BatchAlignment, P: int):
        score, a_rows, b_rows, aln_len, ok = dst
        score[ix] = out.score
        a_rows[ix] = _pad_cols(out.a_row, P, self.gap_code)
        b_rows[ix] = _pad_cols(out.b_row, P, self.gap_code)
        aln_len[ix] = out.aln_len
        ok[ix] = out.ok

    # ------------------------------------------------------------- host API

    def align_to_center(self, Q, lens, b, lb) -> EngineResult:
        """Bucketed, fallback-handling map(1): every query against ``b``.

        Q: (B, Lmax) int8, lens: (B,), b: (m,), lb scalar. Output rows are
        (B, Lmax + m) — trailing (gap, gap) columns are dead padding the
        center-star assembly ignores.
        """
        dev = self.device
        Q = torch.as_tensor(Q, device=dev)
        lens = torch.as_tensor(lens, device=dev).to(torch.int32)
        b = torch.as_tensor(b, device=dev)
        B, Lmax = Q.shape
        m = b.shape[0]
        P = Lmax + m
        fn = self.batch_fn()

        if not self.bucket or B == 0:
            _record_dispatch("to_center", self.route, 1 if B else 0, B,
                             None, None)
            out = fn(Q, lens, b, lb)
            return self._apply_fallback(out, Q, lens, b, lb, P)

        lens_np = lens.cpu().numpy()
        real_cells = int(lens_np.sum()) * m
        plan = bucketing.bucket_plan(lens_np, Lmax,
                                     min_bucket=self.min_bucket)
        padded_cells = sum(width * len(idx) for width, idx in plan) * m
        _record_dispatch("to_center", self.route, len(plan), B,
                         real_cells, padded_cells)
        if len(plan) == 1:
            width, _ = plan[0]
            out = fn(Q[:, :width], lens, b, lb)
            return self._apply_fallback(out, Q, lens, b, lb, P)

        merged = self._empty_rows(B, P)
        for width, idx in plan:
            ix = torch.as_tensor(idx, device=dev)
            self._merge(merged, ix, fn(Q[ix, :width], lens[ix], b, lb), P)
        return self._apply_fallback(backends.BatchAlignment(*merged), Q,
                                    lens, b, lb, P)

    def _apply_fallback(self, out: backends.BatchAlignment, Q, lens, b, lb,
                        P: int) -> EngineResult:
        """Re-align pairs the backend flagged (band overflow) with full DP."""
        bad = torch.nonzero(~out.ok).flatten()
        rows = [out.score, _pad_cols(out.a_row, P, self.gap_code),
                _pad_cols(out.b_row, P, self.gap_code), out.aln_len, out.ok]
        if len(bad):
            _M_FALLBACK.labels(backend=self.route).inc(len(bad))
            _M_CALLS.labels(api="to_center", backend=self.route).inc()
            res = self.batch_fn(local=False)(Q[bad], lens[bad], b, lb)
            self._merge(rows, bad, res, P)
        return EngineResult(*rows[:4], len(bad))

    def align_pairs(self, Q, qlens, T, tlens) -> PairsResult:
        """Bucketed batch-entry map(1): row i of ``Q`` against row i of ``T``.

        Q: (B, Lq) int8, T: (B, Lt) int8, qlens/tlens: (B,). Pairs are
        grouped into pow2 (q_width, t_width) buckets
        (``bucketing.pair_bucket_plan``); output rows are (B, Lq + Lt) with
        trailing (gap, gap) dead padding. ``n_calls`` counts backend
        invocations.
        """
        dev = self.device
        Q = torch.as_tensor(Q, device=dev)
        T = torch.as_tensor(T, device=dev)
        qlens = torch.as_tensor(qlens, device=dev).to(torch.int32)
        tlens = torch.as_tensor(tlens, device=dev).to(torch.int32)
        B, Lq = Q.shape
        Lt = T.shape[1]
        P = Lq + Lt
        if B == 0:
            z = torch.zeros((0,), dtype=torch.float32, device=dev)
            r = torch.zeros((0, P), dtype=torch.int8, device=dev)
            return PairsResult(z, r, r, torch.zeros((0,), dtype=torch.int32,
                                                    device=dev), 0, 0)
        fn = self.pairs_fn()

        if not self.bucket:
            _record_dispatch("pairs", self.route, 1, B, None, None)
            out = fn(Q, qlens, T, tlens)
            return self._apply_pairs_fallback(out, Q, qlens, T, tlens, P,
                                              n_calls=1)

        qlens_np = qlens.cpu().numpy()
        tlens_np = tlens.cpu().numpy()
        real_cells = int((qlens_np.astype(np.int64)
                          * tlens_np.astype(np.int64)).sum())
        plan = bucketing.pair_bucket_plan(qlens_np, tlens_np, Lq, Lt,
                                          min_bucket=self.min_bucket)
        _record_dispatch("pairs", self.route, len(plan), B, real_cells,
                         sum(wq * wt * len(idx) for wq, wt, idx in plan))
        if len(plan) == 1:
            wq, wt, _ = plan[0]
            out = fn(Q[:, :wq], qlens, T[:, :wt], tlens)
            return self._apply_pairs_fallback(out, Q, qlens, T, tlens, P,
                                              n_calls=1)

        merged = self._empty_rows(B, P)
        for wq, wt, idx in plan:
            ix = torch.as_tensor(idx, device=dev)
            self._merge(merged, ix, fn(Q[ix, :wq], qlens[ix], T[ix, :wt],
                                       tlens[ix]), P)
        return self._apply_pairs_fallback(backends.BatchAlignment(*merged),
                                          Q, qlens, T, tlens, P,
                                          n_calls=len(plan))

    def _apply_pairs_fallback(self, out: backends.BatchAlignment, Q, qlens,
                              T, tlens, P: int, *, n_calls: int
                              ) -> PairsResult:
        """Full-DP re-alignment of pairs the backend flagged."""
        bad = torch.nonzero(~out.ok).flatten()
        rows = [out.score, _pad_cols(out.a_row, P, self.gap_code),
                _pad_cols(out.b_row, P, self.gap_code), out.aln_len, out.ok]
        if len(bad):
            _M_FALLBACK.labels(backend=self.route).inc(len(bad))
            _M_CALLS.labels(api="pairs", backend=self.route).inc()
            res = self.pairs_fn(local=False)(Q[bad], qlens[bad], T[bad],
                                             tlens[bad])
            self._merge(rows, bad, res, P)
            n_calls += 1
        return PairsResult(*rows[:4], len(bad), n_calls)

    def realign_failed(self, Q, lens, b, lb, a_rows, b_rows, ok):
        """Full-DP re-alignment of k-mer chain failures, merged on the
        device; only the (B,) ok flags cross to the host.

        Returns (a_rows, b_rows, n_fallback); widths grow to fit the DP
        rows if needed.
        """
        bad = torch.nonzero(~ok).flatten()
        if len(bad) == 0:
            return a_rows, b_rows, 0
        # the k-mer assembly is global, so its fallback must be too — even
        # under a local (Smith-Waterman) engine
        eng = (self if not self.local
               else dataclasses.replace(self, local=False))
        res = eng.align_to_center(Q[bad], lens[bad], b, lb)
        P = max(int(a_rows.shape[1]), int(res.a_row.shape[1]))
        a_rows = _pad_cols(a_rows, P, self.gap_code)
        b_rows = _pad_cols(b_rows, P, self.gap_code)
        a_rows[bad] = _pad_cols(res.a_row, P, self.gap_code)
        b_rows[bad] = _pad_cols(res.b_row, P, self.gap_code)
        return a_rows, b_rows, len(bad)
