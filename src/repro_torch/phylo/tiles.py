"""Tiled distance-matrix engine: (row-block x column-block) JC69 tiles.

The phylogeny stage's hot input is the (N, N) JC69 distance matrix. Dense
``core.distance.distance_matrix`` materializes all of it — the scaling
cliff this module removes. ``TileContext`` computes the same matrix as
independent tiles and exposes *streaming block-reductions*, so the HPTree
pipeline (``repro_torch.phylo.pipeline``) never holds more than one tile
row-block strip of distance storage:

  ``strips``          generator of (row_block, M) strips, one resident at a
                      time; split over the ``repro_torch.dist`` mesh when
                      one is given (``dist.mapreduce.
                      distance_strip_over_mesh``: each rank a column shard)
  ``row_sums``        streamed row-sum reduction (medoid seeding)
  ``greedy_k_center`` streamed farthest-point medoid selection — identical
                      picks to ``core.cluster.farthest_point_medoids`` with
                      no (m, m) sample matrix
  ``nearest_assign``  each row's nearest anchor and distance, strip by
                      strip, with no (N, k) matrix (the pipeline's
                      assignment; the reference's ``nearest`` returns the
                      (N, k) matrix itself); on a mesh each rank takes a
                      shard of the rows (``dist.mapreduce.
                      nearest_anchor_over_mesh``'s split)
  ``squares``         a stack of small per-cluster matrices in one launch
  ``full``            assemble the whole matrix tile by tile — the parity /
                      small-N-exact path, not the production one

Every tile's counts come from the match/valid kernel when the context's
device is the card, and from its plain version on the CPU. The counts are
exact integers, so every tile is *bitwise equal* to the corresponding
dense sub-block whatever the tiling. The rows stay on the device; each
tile comes back to the host, where the pipeline's discrete choices run.

``TileAccountant`` tracks resident distance bytes exactly as the reference
counts them; ``peak_resident_bytes <= row_block * N * 4`` is the bound the
tiled backend keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import distance as dist_mod
from ..device import resolve_device
from ..obs import metrics as _obs

_G_RESIDENT = _obs.gauge("repro_tile_resident_bytes",
                         "distance bytes currently resident (last accountant)")
_C_TILES = _obs.counter("repro_tiles_total", "distance tiles materialized")
_C_TILE_BYTES = _obs.counter("repro_tile_bytes_total",
                             "distance bytes materialized, cumulative")


class TileAccountant:
    """Byte accounting for resident distance storage.

    Every distance buffer the tiled pipeline materializes passes through
    ``alloc``/``free``; ``peak_resident_bytes`` is the memory bound the
    tiled backend advertises (one row-block strip), reported by
    ``launch/tree_run.py``.
    """

    def __init__(self):
        self.resident = 0
        self.peak = 0
        self.n_tiles = 0
        self.total_bytes = 0

    def alloc(self, nbytes: int) -> int:
        nbytes = int(nbytes)
        self.resident += nbytes
        self.peak = max(self.peak, self.resident)
        self.n_tiles += 1
        self.total_bytes += nbytes
        _C_TILES.inc()
        _C_TILE_BYTES.inc(nbytes)
        _G_RESIDENT.set(self.resident)
        return nbytes

    def free(self, nbytes: int) -> None:
        self.resident -= int(nbytes)
        _G_RESIDENT.set(self.resident)

    def stats(self) -> dict:
        return {"peak_resident_bytes": self.peak,
                "n_tiles": self.n_tiles,
                "total_tile_bytes": self.total_bytes}


@dataclasses.dataclass
class TileContext:
    """One configured tile engine (alphabet + tile geometry + device)."""

    gap_code: int
    n_chars: int
    correct: bool = True           # JC69 correction (off for protein)
    row_block: int = 128
    col_block: Optional[int] = None   # ``full`` only; defaults to row_block
    mesh: Optional[object] = None     # a dist.sharding.Mesh
    accountant: Optional[TileAccountant] = None
    device: str = "cuda"
    data_axis: str = "data"

    def __post_init__(self):
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(self.device))
        if self.accountant is None:
            self.accountant = TileAccountant()

    def rows(self, msa) -> torch.Tensor:
        """``msa`` (host array or tensor) as int8 rows on the device."""
        if not isinstance(msa, torch.Tensor):
            msa = torch.from_numpy(np.array(msa))
        return msa.to(self.device)

    # ------------------------------------------------------------ accounting

    def track(self, arr: np.ndarray) -> np.ndarray:
        self.accountant.alloc(arr.nbytes)
        return arr

    def release(self, arr: np.ndarray) -> None:
        self.accountant.free(arr.nbytes)

    # ------------------------------------------------------------ tile math

    def block(self, rows, cols) -> np.ndarray:
        """One (r, c) distance tile between two row sets."""
        d = dist_mod.cross_distance(self.rows(rows), self.rows(cols),
                                    gap_code=self.gap_code,
                                    n_chars=self.n_chars,
                                    correct=self.correct)
        return d.cpu().numpy()

    def square(self, rows) -> np.ndarray:
        """Small dense symmetric matrix (the skeleton over the medoids)."""
        d = dist_mod.distance_matrix(self.rows(rows), gap_code=self.gap_code,
                                     n_chars=self.n_chars,
                                     correct=self.correct)
        return d.cpu().numpy()

    def squares(self, msa, groups, width: int) -> torch.Tensor:
        """(G, width, width) distance matrices of the row groups ``groups``
        (index arrays into ``msa``), padded with zeros past each group's
        rows, on the device: one kernel launch
        (``core.distance.distance_groups``). Each real entry equals
        ``square(msa[group])``'s."""
        return dist_mod.distance_groups(
            self.rows(msa), dist_mod.group_index(groups, width, self.device),
            gap_code=self.gap_code, n_chars=self.n_chars,
            correct=self.correct)

    # ------------------------------------------------------------- streaming

    def strips(self, msa, cols=None) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield ``(start, stop, strip)`` row-block strips of the cross
        distance between ``msa`` and ``cols`` (default: ``msa`` itself, i.e.
        one row-block of the (N, N) matrix per step).

        Exactly one strip is resident at a time (alloc on yield, free on
        resume); each is counted at the full ``row_block`` height, as the
        reference counts the strip it pads to that height. With a mesh and
        ``cols is None`` each rank computes its column shard of every
        strip, gathered to the whole strip on every rank; the strips are
        bitwise those of one device (integer counts, elementwise JC69).
        """
        msa = self.rows(msa)
        cols_t = msa if cols is None else self.rows(cols)
        n, m = msa.shape[0], cols_t.shape[0]
        rb = self.row_block
        mesh_fn = None
        if self.mesh is not None and cols is None:
            mesh_fn, S = self._mesh_strip_fn(msa)
        for start in range(0, n, rb):
            stop = min(start + rb, n)
            if mesh_fn is not None:
                strip = mesh_fn(msa[start:stop], S)[:, :m].cpu().numpy()
            else:
                strip = self.block(msa[start:stop], cols_t)
            nbytes = self.accountant.alloc(rb * m * 4)
            try:
                yield start, stop, strip
            finally:
                self.accountant.free(nbytes)

    def _mesh_strip_fn(self, msa: torch.Tensor):
        from ..dist import mapreduce
        S = mapreduce.shard_padded(msa, self.mesh, self.data_axis,
                                   fill=self.gap_code)
        fn = mapreduce.distance_strip_over_mesh(
            self.mesh, gap_code=self.gap_code, n_chars=self.n_chars,
            correct=self.correct, data_axis=self.data_axis)
        return fn, S

    def row_sums(self, msa) -> np.ndarray:
        """Streamed row-sum reduction over the implicit (N, N) matrix."""
        msa = self.rows(msa)
        out = np.zeros((msa.shape[0],), np.float32)
        for start, stop, strip in self.strips(msa):
            out[start:stop] = strip.sum(axis=1)
        return out

    def greedy_k_center(self, msa, k: int) -> np.ndarray:
        """Streamed farthest-point medoid selection.

        Same picks as ``core.cluster.farthest_point_medoids`` on the dense
        sample matrix: the seed is the max-row-sum point (streamed), then
        each round adds the point farthest from the chosen set, maintaining
        the (m,) min-distance vector with one single-column tile per round.
        """
        msa = self.rows(msa)
        m = msa.shape[0]
        first = int(np.argmax(self.row_sums(msa)))
        chosen = [first]
        mind = self.block(msa, msa[first: first + 1])[:, 0]
        for _ in range(1, min(k, m)):
            nxt = int(np.argmax(mind))
            chosen.append(nxt)
            mind = np.minimum(mind, self.block(msa, msa[nxt: nxt + 1])[:, 0])
        return np.asarray(chosen)

    def nearest_assign(self, msa, anchors) -> Tuple[np.ndarray, np.ndarray]:
        """Every row's nearest anchor and its distance to it, strip by
        strip: ``(assign (N,), own (N,) float32)``, as ``np.argmin`` over
        the rows of the (N, k) distance matrix picks them, with no such
        matrix resident. With a mesh each rank streams its shard of the
        rows against every anchor (the reference's
        ``nearest_anchor_over_mesh`` split) and the (N,) results are
        gathered to every rank."""
        msa = self.rows(msa)
        anchors = self.rows(anchors)
        n = msa.shape[0]
        if self.mesh is not None:
            from ..dist import mapreduce
            from ..dist import sharding as sh
            rows = mapreduce.shard_padded(msa, self.mesh, self.data_axis,
                                          fill=self.gap_code)
            assign, own = self._assign(rows, anchors)
            assign, own = (sh.gather_rows(torch.from_numpy(x).to(
                self.device), self.mesh, self.data_axis).cpu().numpy()[:n]
                for x in (assign, own))
            return assign, own
        return self._assign(msa, anchors)

    def _assign(self, msa, anchors):
        n = msa.shape[0]
        assign = np.empty((n,), np.int64)
        own = np.empty((n,), np.float32)
        for start, stop, strip in self.strips(msa, cols=anchors):
            a = np.argmin(strip, axis=1)
            assign[start:stop] = a
            own[start:stop] = strip[np.arange(stop - start), a]
        return assign, own

    def sorted_rows(self, msa, anchors, idx) -> np.ndarray:
        """``np.argsort`` of the distance rows of the rows ``idx`` (at most
        ``row_block``) to ``anchors``: one strip, resident while sorted."""
        rows = self.rows(msa)[torch.as_tensor(np.asarray(idx),
                                              device=self.device)]
        nbytes = self.accountant.alloc(self.row_block * anchors.shape[0] * 4)
        try:
            return np.argsort(self.block(rows, anchors), axis=1)
        finally:
            self.accountant.free(nbytes)

    # ------------------------------------------------------------- assembly

    def full(self, msa) -> np.ndarray:
        """Assemble the complete (N, N) matrix from tiles.

        Parity path plus the tiled backend's small-N exact route
        (N <= row_block, where the whole matrix is one strip). Bitwise
        equal to ``core.distance.distance_matrix``.
        """
        msa = self.rows(msa)
        n = msa.shape[0]
        cb = self.col_block or self.row_block
        out = self.track(np.zeros((n, n), np.float32))
        for rs in range(0, n, self.row_block):
            re_ = min(rs + self.row_block, n)
            for cs in range(0, n, cb):
                ce = min(cs + cb, n)
                nbytes = self.accountant.alloc((re_ - rs) * (ce - cs) * 4)
                out[rs:re_, cs:ce] = self.block(msa[rs:re_], msa[cs:ce])
                self.accountant.free(nbytes)
        np.fill_diagonal(out, 0.0)
        return out
