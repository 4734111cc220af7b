"""Persistent, generation-versioned store of named alignments.

The service's in-process cache (``serve/cache.py``) is content-addressed
and volatile: a restart loses every alignment, and ``/align/add`` can
only extend what happens to still be resident. This module is the
surveillance-scale answer (UPP's accrete-onto-a-backbone shape): each
*named* alignment lives on disk as a sequence of immutable generation
files, new sequences accrete through ``incremental.add_to_msa``, and
when cumulative width drift crosses a threshold a *background* realign
rebuilds the family while readers keep being served the stale-but-valid
current generation — the realigned result then swaps in atomically as
the next generation.

Durability model (one directory per name under the store root):

  <root>/<name>/gen_0000000000.npz     generation 0 (creation)
  <root>/<name>/gen_0000000001.npz     generation 1 (one /align/add)
  ...

* Every commit goes through ``dist/checkpoint.atomic_save_npz`` (temp
  file + one ``os.replace``), so a crash mid-commit leaves the previous
  generation intact — never a torn file.
* Retention keeps the newest ``keep`` generation files per name
  (``CheckpointManager``'s policy, applied per named alignment).
* Restore walks generations newest→oldest and skips unreadable files
  *and* files whose stored content fingerprint does not match the
  recomputed one — a corrupt latest generation costs one commit, not
  the alignment (mirrors ``CheckpointManager.restore``).
* The in-memory registry is strictly a cache of disk: a failed commit
  invalidates the name so the next access reloads the committed truth.

Generations are monotone per name; the *content fingerprint* (sha256
over rows + center + member names) identifies what a generation holds,
which is what ``/tree`` cache keys incorporate so trees never mix
generations. Concurrency: one lock per name serializes mutation
(add / realign-swap); readers never take it — ``get`` returns the
current immutable entry. ``fault_hook`` is the crash-injection seam the
store's crash-atomicity tests drive (labels documented on
``COMMIT_FAULT_LABELS``).

The on-disk schema is the reference's (``repro.serve.store``, schema
version 1, the same npz keys): a directory either package wrote restores
in the other. The store's alignments run on ``device`` — an add on the
engine it is given, the background realign on the store's own worker
thread, which makes that card its current device first.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import re
import threading
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.msa import MSAConfig, center_star_msa
from ..device import on_device, resolve_device
from ..dist.checkpoint import atomic_save_npz
from ..obs import metrics as _obs
from ..obs import trace as _trace
from . import incremental

_GEN_PREFIX = "gen_"
_GEN_SUFFIX = ".npz"
_SCHEMA_VERSION = 1
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

# the fault-injection points a commit passes through, in order; a hook
# raising at any label before save.post-replace must leave the previous
# generation committed, at or after it the new one (pinned by the
# crash-atomicity property test)
COMMIT_FAULT_LABELS = (
    "commit.begin", "save.serialize", "save.pre-replace",
    "save.post-replace", "commit.gc", "commit.end",
)

_C_COMMITS = _obs.counter("repro_store_commits_total",
                          "generation commits by kind", ("kind",))
_C_REALIGNS = _obs.counter("repro_store_realigns_total",
                           "background realigns by outcome", ("outcome",))
_C_RESTORES = _obs.counter("repro_store_restores_total",
                           "named alignments restored from disk")
_G_GENERATION = _obs.gauge("repro_store_generation",
                           "current generation per named alignment",
                           ("name",))
_G_BYTES = _obs.gauge("repro_store_bytes",
                      "resident MSA bytes across named alignments")
_G_NAMES = _obs.gauge("repro_store_names", "named alignments resident")
_G_PENDING = _obs.gauge("repro_store_pending_realigns",
                        "background realigns queued or running")
_H_COMMIT = _obs.histogram("repro_store_commit_seconds",
                           "serialize + atomic replace per commit")
_H_REALIGN = _obs.histogram("repro_store_realign_seconds",
                            "background realign wall-clock (incl. swap)")
_H_RESTORE = _obs.histogram("repro_store_restore_seconds",
                            "disk restore per named alignment")


class StoreError(RuntimeError):
    """A store operation failed (commit fault, closed store, bad name)."""


@dataclasses.dataclass(frozen=True)
class StoreEntry:
    """One immutable committed generation of a named alignment."""
    name: str
    msa: np.ndarray          # (N, width) int8, gap == alphabet gap code
    center_idx: int
    width: int
    seqs: Tuple[str, ...]    # ungapped members, row order
    names: Tuple[str, ...]   # member names, row order
    generation: int
    base_width: int          # width at the last full (re)align — the
                             # drift baseline cumulative growth is
                             # measured against
    fingerprint: str         # content fingerprint (rows+center+names)

    @property
    def nbytes(self) -> int:
        return self.msa.nbytes + sum(len(s) for s in self.seqs)

    def growth(self) -> float:
        """Cumulative relative width growth since the last full realign."""
        return (self.width - self.base_width) / max(self.base_width, 1)


def content_fingerprint(msa: np.ndarray, center_idx: int,
                        names: Sequence[str]) -> str:
    """sha256 over what a generation *is*: the aligned rows, the frozen
    center, and the member names. Content-derived (not generation-
    numbered) so identical content yields identical tree cache keys."""
    msa = np.ascontiguousarray(np.asarray(msa, np.int8))
    h = hashlib.sha256()
    h.update(str(msa.shape).encode())
    h.update(msa.tobytes())
    h.update(f"\x00{int(center_idx)}\x00".encode())
    for n in names:
        h.update(b"\x00")
        h.update(n.encode())
    return h.hexdigest()


class _Named:
    """Registry slot: the current entry plus the per-name mutation lock."""

    __slots__ = ("entry", "lock", "realign_future")

    def __init__(self, entry: StoreEntry):
        self.entry = entry
        self.lock = threading.Lock()
        self.realign_future: Optional[Future] = None


class MSAStore:
    """Persistent named-alignment store; thread-safe."""

    def __init__(self, root, *, keep: int = 4,
                 drift_threshold: float = 0.25,
                 realign: str = "background",
                 fault_hook: Optional[Callable[[str], None]] = None,
                 device="cuda"):
        if realign not in ("background", "never"):
            raise ValueError(f"realign must be background|never, "
                             f"got {realign!r}")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self.drift_threshold = float(drift_threshold)
        self.realign = realign
        self.fault_hook = fault_hook
        self.device = resolve_device(device)
        self._registry: Dict[str, _Named] = {}
        self._reg_lock = threading.Lock()
        self._pending_realigns = 0
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="store-realign")

    # ------------------------------------------------------------ inventory

    def _dir(self, name: str) -> Path:
        return self.root / name

    def _gen_path(self, name: str, gen: int) -> Path:
        return self._dir(name) / f"{_GEN_PREFIX}{gen:010d}{_GEN_SUFFIX}"

    def generations(self, name: str) -> List[int]:
        """Generation numbers present on disk, oldest first."""
        gens = []
        for p in self._dir(name).glob(f"{_GEN_PREFIX}*{_GEN_SUFFIX}"):
            try:
                gens.append(int(p.name[len(_GEN_PREFIX):-len(_GEN_SUFFIX)]))
            except ValueError:
                continue
        return sorted(gens)

    def names(self) -> List[str]:
        """Every named alignment: resident or restorable from disk."""
        on_disk = {p.parent.name
                   for p in self.root.glob(f"*/{_GEN_PREFIX}*{_GEN_SUFFIX}")}
        with self._reg_lock:
            return sorted(on_disk | set(self._registry))

    def stats(self) -> dict:
        """One-instant snapshot for /healthz and /statusz."""
        with self._reg_lock:
            entries = {n: s.entry for n, s in self._registry.items()
                       if s.entry is not None}
            pending = self._pending_realigns
        return {"names": len(self.names()),
                "resident": len(entries),
                "bytes": sum(e.nbytes for e in entries.values()),
                "pending_realigns": pending,
                "generations": {n: e.generation
                                for n, e in sorted(entries.items())}}

    # -------------------------------------------------------------- loading

    def get(self, name: str) -> StoreEntry:
        """Current generation (memory first, disk restore on miss).

        Never blocks on the per-name mutation lock: while an add or a
        realign swap is in flight, callers keep getting the previous
        committed generation.
        """
        with self._reg_lock:
            slot = self._registry.get(name)
            if slot is not None and slot.entry is not None:
                return slot.entry
        entry = self._restore(name)
        with self._reg_lock:
            slot = self._registry.get(name)
            if slot is None:                     # lost race: first in wins
                slot = self._registry[name] = _Named(entry)
                self._publish_gauges_locked()
            if slot.entry is None:               # creation still committing
                raise KeyError(f"unknown named alignment {name!r}")
            return slot.entry

    def _restore(self, name: str) -> StoreEntry:
        """Newest readable + fingerprint-consistent generation from disk."""
        import time
        t0 = time.perf_counter()
        with _trace.span("store.restore", alignment=name):
            for gen in self.generations(name)[::-1]:
                entry = self._read_gen(name, gen)
                if entry is not None:
                    _C_RESTORES.inc()
                    _H_RESTORE.observe(time.perf_counter() - t0)
                    return entry
        raise KeyError(f"unknown named alignment {name!r}")

    def _read_gen(self, name: str, gen: int) -> Optional[StoreEntry]:
        path = self._gen_path(name, gen)
        try:
            with np.load(path, allow_pickle=False) as z:
                if int(z["schema_version"]) != _SCHEMA_VERSION:
                    raise ValueError(
                        f"schema v{int(z['schema_version'])} != "
                        f"v{_SCHEMA_VERSION}")
                entry = StoreEntry(
                    name=str(z["name"]),
                    msa=np.asarray(z["msa"], np.int8),
                    center_idx=int(z["center_idx"]),
                    width=int(z["msa"].shape[1]),
                    seqs=tuple(str(s) for s in z["seqs"]),
                    names=tuple(str(s) for s in z["names"]),
                    generation=int(z["generation"]),
                    base_width=int(z["base_width"]),
                    fingerprint=str(z["fingerprint"]))
        except Exception as e:
            warnings.warn(f"store: skipping unreadable generation "
                          f"{path}: {e!r}")
            return None
        actual = content_fingerprint(entry.msa, entry.center_idx,
                                     entry.names)
        if actual != entry.fingerprint or entry.name != name \
                or entry.generation != gen:
            warnings.warn(f"store: skipping torn/mislabeled generation "
                          f"{path} (fingerprint mismatch)")
            return None
        return entry

    # ------------------------------------------------------------ mutation

    def _hook(self, label: str):
        if self.fault_hook is not None:
            self.fault_hook(label)

    def create(self, name: str, *, msa, center_idx: int,
               seqs: Sequence[str], names: Sequence[str]) -> StoreEntry:
        """Commit generation 0 of a new named alignment."""
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid alignment name {name!r} (want "
                f"[A-Za-z0-9][A-Za-z0-9._-]*, at most 64 chars)")
        msa = np.asarray(msa, np.int8)
        if len(seqs) != msa.shape[0] or len(names) != msa.shape[0]:
            raise ValueError(f"{len(seqs)} seqs / {len(names)} names for "
                             f"{msa.shape[0]} rows")
        slot = _Named(None)  # type: ignore[arg-type]
        with self._reg_lock:
            if self._closed:
                raise StoreError("store is closed")
            if name in self._registry:
                raise StoreError(f"alignment {name!r} already exists")
            if self.generations(name):
                raise StoreError(f"alignment {name!r} already on disk "
                                 f"(restore it with get() first)")
            self._registry[name] = slot
        try:
            with slot.lock:
                entry = StoreEntry(
                    name=name, msa=msa, center_idx=int(center_idx),
                    width=int(msa.shape[1]), seqs=tuple(seqs),
                    names=tuple(names), generation=0,
                    base_width=int(msa.shape[1]),
                    fingerprint=content_fingerprint(msa, center_idx, names))
                self._commit(slot, entry, kind="create")
                return entry
        except BaseException:
            with self._reg_lock:
                if self._registry.get(name) is slot and slot.entry is None:
                    del self._registry[name]
            raise

    def add(self, name: str, new_names: Sequence[str],
            new_seqs: Sequence[str], cfg: MSAConfig, *,
            engine=None) -> Tuple[StoreEntry, dict]:
        """Accrete ``new_seqs`` onto ``name``'s current generation.

        The incremental merge (frozen center, ``incremental.add_to_msa``)
        always commits as the next generation — bit-identical rows for
        existing members. When the *cumulative* width growth since the
        last full realign crosses ``drift_threshold``, a background
        realign of the full member set is scheduled; readers keep this
        (valid) generation until the realigned one swaps in. The add runs
        on ``engine``'s device, or on the store's without one.
        """
        slot = self._slot(name)
        with slot.lock:
            cur = slot.entry
            res = incremental.add_to_msa(
                cur.msa, cur.center_idx, list(new_seqs), cfg,
                drift_threshold=math.inf, engine=engine,
                device=self.device)
            assert not res.realigned
            entry = StoreEntry(
                name=name, msa=np.asarray(res.msa, np.int8),
                center_idx=res.center_idx, width=res.width,
                seqs=cur.seqs + tuple(new_seqs),
                names=cur.names + tuple(new_names),
                generation=cur.generation + 1,
                base_width=cur.base_width,
                fingerprint=content_fingerprint(
                    res.msa, res.center_idx, cur.names + tuple(new_names)))
            self._commit(slot, entry, kind="add")
            drifted = entry.growth() > self.drift_threshold
            pending = drifted and self._schedule_realign(name, slot, entry,
                                                         cfg)
        info = {"n_new": len(new_seqs), "n_fallback": res.n_fallback,
                "growth": round(entry.growth(), 4),
                "drifted": drifted, "realign_pending": pending}
        return entry, info

    def _slot(self, name: str) -> _Named:
        with self._reg_lock:
            if self._closed:
                raise StoreError("store is closed")
            slot = self._registry.get(name)
        if slot is None:
            self.get(name)                       # restore from disk
            with self._reg_lock:
                slot = self._registry[name]
        if slot.entry is None:
            raise StoreError(f"alignment {name!r} is still being created")
        return slot

    def _commit(self, slot: _Named, entry: StoreEntry, *, kind: str):
        """Atomically persist ``entry`` as its generation file, publish it
        to readers, and apply retention. Caller holds ``slot.lock``.

        Exception safety: disk is the truth. Any failure before the
        ``os.replace`` leaves the previous generation current; a failure
        after it means the commit *happened* — either way the in-memory
        slot is invalidated so the next access reloads committed state.
        """
        import time
        t0 = time.perf_counter()
        try:
            with _trace.span("store.commit", alignment=entry.name,
                             generation=entry.generation, kind=kind):
                self._hook("commit.begin")
                atomic_save_npz(
                    self._gen_path(entry.name, entry.generation),
                    {"schema_version": np.int64(_SCHEMA_VERSION),
                     "name": np.str_(entry.name),
                     "msa": entry.msa,
                     "center_idx": np.int64(entry.center_idx),
                     "generation": np.int64(entry.generation),
                     "base_width": np.int64(entry.base_width),
                     "seqs": np.array(entry.seqs),
                     "names": np.array(entry.names),
                     "fingerprint": np.str_(entry.fingerprint)},
                    _hook=self._hook if self.fault_hook is not None
                    else None)
                slot.entry = entry
                self._hook("commit.gc")
                self._gc(entry.name)
                self._hook("commit.end")
        except BaseException:
            # memory may now disagree with disk (e.g. a fault after the
            # replace): drop the slot so the next access re-restores
            with self._reg_lock:
                if self._registry.get(entry.name) is slot:
                    del self._registry[entry.name]
                self._publish_gauges_locked()
            raise
        _H_COMMIT.observe(time.perf_counter() - t0)
        _C_COMMITS.labels(kind=kind).inc()
        _G_GENERATION.labels(name=entry.name).set(entry.generation)
        with self._reg_lock:
            self._publish_gauges_locked()

    def _gc(self, name: str):
        gens = self.generations(name)
        for g in gens[:max(len(gens) - self.keep, 0)]:
            try:
                self._gen_path(name, g).unlink()
            except FileNotFoundError:
                pass

    def _publish_gauges_locked(self):
        _G_BYTES.set(sum(s.entry.nbytes for s in self._registry.values()
                         if s.entry is not None))
        _G_NAMES.set(len(self._registry))
        _G_PENDING.set(self._pending_realigns)

    # ------------------------------------------------------------- realign

    def _schedule_realign(self, name: str, slot: _Named, entry: StoreEntry,
                          cfg: MSAConfig) -> bool:
        """Queue a background realign of ``entry``'s member set (one in
        flight per name). Caller holds ``slot.lock``."""
        if self.realign != "background":
            return False
        if slot.realign_future is not None and \
                not slot.realign_future.done():
            return True                          # one already pending
        with self._reg_lock:
            if self._closed:
                return False
            self._pending_realigns += 1
            self._publish_gauges_locked()
        slot.realign_future = self._pool.submit(
            self._realign, name, slot, entry.generation, cfg)
        return True

    def _realign(self, name: str, slot: _Named, from_gen: int,
                 cfg: MSAConfig):
        """Worker-thread body: cold full realign, then atomic swap."""
        import time
        t0 = time.perf_counter()
        outcome = "error"
        try:
            with _trace.span("store.realign", alignment=name,
                             from_generation=from_gen):
                # member set frozen at schedule time — if more adds land
                # while we realign, the swap is discarded (the next
                # drifted add reschedules over the larger set)
                base = slot.entry
                if base.generation != from_gen:
                    outcome = "stale"
                    return
                with on_device(self.device):
                    res = center_star_msa(list(base.seqs), cfg,
                                          device=self.device)
                new = StoreEntry(
                    name=name, msa=np.asarray(res.msa, np.int8),
                    center_idx=res.center_idx, width=res.width,
                    seqs=base.seqs, names=base.names,
                    generation=from_gen + 1, base_width=res.width,
                    fingerprint=content_fingerprint(
                        res.msa, res.center_idx, base.names))
                with slot.lock:
                    if slot.entry.generation != from_gen:
                        outcome = "stale"
                        return
                    self._commit(slot, new, kind="realign")
                    outcome = "swapped"
        except BaseException:
            warnings.warn(f"store: background realign of {name!r} failed",
                          stacklevel=2)
            raise
        finally:
            _C_REALIGNS.labels(outcome=outcome).inc()
            _H_REALIGN.observe(time.perf_counter() - t0)
            with self._reg_lock:
                self._pending_realigns -= 1
                self._publish_gauges_locked()

    def wait_realigns(self, timeout: Optional[float] = None):
        """Block until every scheduled realign resolved (raises theirs)."""
        with self._reg_lock:
            futures = [s.realign_future for s in self._registry.values()
                       if s.realign_future is not None]
        for f in futures:
            f.result(timeout=timeout)

    # --------------------------------------------------------------- close

    def close(self, wait: bool = True):
        """Refuse new work; optionally let queued realigns finish (their
        commits are atomic, so ``wait=False`` just forfeits wall-clock,
        never durability)."""
        with self._reg_lock:
            self._closed = True
        self._pool.shutdown(wait=wait, cancel_futures=not wait)
