"""SearchIndex: the encode-once, query-many database artifact.

The port of ``repro.search.index``. The database is encoded once to the
usual ``(D, Lmax) int8`` frame and every row gets its own dense k-mer
table (``core.kmer_index.build_tables``: ``build_center_index`` for all
rows at once, on the device). The artifact is a flat dict of numpy
arrays persisted through ``dist.checkpoint.atomic_save_npz`` under the
reference's keys and format version, so an index saved by either
package loads in the other with the same ``fingerprint()``.

Size note: a table is ``4^k * r`` int32 per database sequence — 64 KiB
at the seeding default ``k=6``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import alphabet as ab
from ..core import kmer_index
from ..device import resolve_device

_FORMAT_VERSION = 1


def _alpha(alphabet: str) -> ab.Alphabet:
    if alphabet not in ("dna", "rna"):
        raise ValueError(
            f"search indexes need a nucleotide alphabet (base-4 k-mer "
            f"codes), got {alphabet!r}")
    return {"dna": ab.DNA, "rna": ab.RNA}[alphabet]


@dataclasses.dataclass(frozen=True)
class SearchIndex:
    """Immutable database artifact: encoded rows + per-row k-mer tables."""

    names: Tuple[str, ...]
    S: np.ndarray          # (D, Lmax) int8 encoded rows, gap-padded
    lens: np.ndarray       # (D,) int32 true lengths
    tables: np.ndarray     # (D, 4^k, r) int32 code -> first r positions
    k: int                 # seeding k-mer width
    r: int                 # occurrences kept per code
    alphabet: str          # dna | rna

    @property
    def n_seqs(self) -> int:
        return int(self.S.shape[0])

    @property
    def db_residues(self) -> int:
        """Total true residue count — the N of the e-value search space."""
        return int(self.lens.sum())

    def alpha(self) -> ab.Alphabet:
        return _alpha(self.alphabet)

    def fingerprint(self) -> str:
        """Content hash over everything that changes search results."""
        h = hashlib.sha256()
        h.update(f"search-index/v{_FORMAT_VERSION}/{self.alphabet}/"
                 f"{self.k}/{self.r}".encode())
        h.update(np.ascontiguousarray(self.lens).tobytes())
        h.update(np.ascontiguousarray(self.S).tobytes())
        return h.hexdigest()

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, names: Sequence[str], seqs: Sequence[str], *,
              k: int = 6, alphabet: str = "dna", r: int = 4,
              device="cuda") -> "SearchIndex":
        """Encode ``seqs`` and build their tables on ``device`` (raises
        when CUDA is asked for and absent)."""
        alpha = _alpha(alphabet)
        if not seqs:
            raise ValueError("cannot index an empty database")
        if len(names) != len(seqs):
            raise ValueError(f"{len(names)} names for {len(seqs)} sequences")
        dev = resolve_device(device)
        norm = [s.replace("U", "T").replace("u", "t")
                if alphabet == "rna" else s for s in seqs]
        S, lens = ab.encode_batch(norm, alpha)
        if S.shape[1] < k:          # keep at least one window's worth of
            S, lens = ab.encode_batch(norm, alpha, pad_to=k)  # table width
        tables = kmer_index.build_tables(torch.as_tensor(S, device=dev),
                                         torch.as_tensor(lens, device=dev),
                                         k=k, r=r)
        return cls(names=tuple(names), S=S, lens=lens,
                   tables=tables.cpu().numpy(), k=k, r=r, alphabet=alphabet)

    # ---------------------------------------------------------- persist

    def save(self, path) -> None:
        """Atomic single-file persist (``dist.checkpoint.atomic_save_npz``)."""
        from ..dist.checkpoint import atomic_save_npz
        atomic_save_npz(path, {
            "version": np.int32(_FORMAT_VERSION),
            "names": np.array(self.names, dtype=np.str_),
            "S": self.S, "lens": self.lens, "tables": self.tables,
            "k": np.int32(self.k), "r": np.int32(self.r),
            "alphabet": np.str_(self.alphabet)})

    @classmethod
    def load(cls, path) -> "SearchIndex":
        with np.load(path) as z:
            version = int(z["version"])
            if version != _FORMAT_VERSION:
                raise ValueError(
                    f"search index {path} has format v{version}, this "
                    f"build reads v{_FORMAT_VERSION} — rebuild the index")
            return cls(names=tuple(str(n) for n in z["names"]),
                       S=z["S"].astype(np.int8),
                       lens=z["lens"].astype(np.int32),
                       tables=z["tables"].astype(np.int32),
                       k=int(z["k"]), r=int(z["r"]),
                       alphabet=str(z["alphabet"]))
