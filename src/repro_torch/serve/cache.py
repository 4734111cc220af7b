"""Content-hash result cache for the MSA service.

Host code only, the reference's (``repro.serve.cache``) line for line:
``canonical_key`` must give the reference's hex digest, because the
service hands that digest to clients as ``msa_id``.

Requests are keyed by *what they align*, not how they arrived: the
sequence set is canonicalized (sorted, names dropped — names never
influence an alignment) and hashed together with the engine fingerprint,
so the same family submitted in any order, under any names, hits the
same entry. The stored value is the alignment of the canonical order;
``MSAService`` maps rows back to each request's order on the way out,
which is also why a hit can be byte-identical to the miss that filled it.

Eviction is LRU under two budgets (entry count and total payload bytes);
``stats()`` feeds the hit/miss counters every response carries.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from ..obs import metrics as _obs

_C_LOOKUPS = _obs.counter("repro_cache_requests_total",
                          "cache lookups by outcome", ("outcome",))
_C_EVICTIONS = _obs.counter("repro_cache_evictions_total", "LRU evictions")
_G_BYTES = _obs.gauge("repro_cache_bytes",
                      "payload bytes resident (last cache instance)")
_G_ITEMS = _obs.gauge("repro_cache_items",
                      "entries resident (last cache instance)")


def canonicalize(seqs: Sequence[str]) -> Tuple[List[str], List[int]]:
    """Sort sequences; returns (sorted_seqs, perm) with seqs[perm[i]] ==
    sorted_seqs[i]. Duplicates keep a stable order so the permutation is
    deterministic."""
    perm = sorted(range(len(seqs)), key=lambda i: (seqs[i], i))
    return [seqs[i] for i in perm], perm


def canonical_key(seqs: Sequence[str], fingerprint: str = "",
                  center: Optional[str] = None) -> str:
    """sha256 over the canonicalized set + engine fingerprint.

    ``center`` pins the key to a specific frozen center sequence —
    incremental add-to-MSA results are centered on the *parent's* center,
    which a fresh align of the same set would not necessarily pick, so
    the two must not collide.
    """
    h = hashlib.sha256()
    h.update(fingerprint.encode())
    if center is not None:
        h.update(b"\x00center\x00")
        h.update(center.encode())
    canon, _ = canonicalize(seqs)
    for s in canon:
        h.update(b"\x00")
        h.update(s.encode())
    return h.hexdigest()


class ResultCache:
    """Thread-safe LRU keyed by content hash, bounded by items and bytes."""

    def __init__(self, max_bytes: int = 256 << 20, max_items: int = 4096):
        self.max_bytes = int(max_bytes)
        self.max_items = int(max_items)
        self._d: OrderedDict[str, Tuple[object, int]] = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._lock = threading.Lock()

    @property
    def lock(self) -> threading.Lock:
        """The cache's own lock — exposed so a caller can combine this
        cache's stats with another component's under one acquisition
        (``MSAService.stats_snapshot``)."""
        return self._lock

    def get(self, key: str):
        with self._lock:
            ent = self._d.get(key)
            if ent is None:
                self._misses += 1
                _C_LOOKUPS.labels(outcome="miss").inc()
                return None
            self._d.move_to_end(key)
            self._hits += 1
            _C_LOOKUPS.labels(outcome="hit").inc()
            return ent[0]

    def peek(self, key: str):
        """Lookup without touching LRU order or hit/miss counters (used to
        resolve msa_id references, which are not align-request hits)."""
        with self._lock:
            ent = self._d.get(key)
            return None if ent is None else ent[0]

    def put(self, key: str, value, nbytes: int):
        with self._lock:
            if key in self._d:
                self._bytes -= self._d.pop(key)[1]
            self._d[key] = (value, int(nbytes))
            self._bytes += int(nbytes)
            while self._d and (len(self._d) > self.max_items
                               or self._bytes > self.max_bytes):
                _, (_, nb) = self._d.popitem(last=False)
                self._bytes -= nb
                self._evictions += 1
                _C_EVICTIONS.inc()
            _G_BYTES.set(self._bytes)
            _G_ITEMS.set(len(self._d))

    def stats_locked(self) -> dict:
        """Stats snapshot; caller must hold ``self.lock``."""
        return {"hits": self._hits, "misses": self._misses,
                "items": len(self._d), "bytes": self._bytes,
                "evictions": self._evictions}

    def stats(self) -> dict:
        with self._lock:
            return self.stats_locked()
