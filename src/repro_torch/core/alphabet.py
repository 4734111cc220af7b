"""Sequence alphabets and scoring matrices.

Encodings are dense int8 codes so sequences live in ``(N, L) int8`` tensors
(the analogue of HAlign-II's RDD partitions of strings). The gap
code doubles as the pad code: a padded tail is indistinguishable from
trailing gaps, which is exactly the semantics center-star MSA wants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

_DNA_CHARS = "ACGTN"
_PROTEIN_CHARS = "ARNDCQEGHILKMFPSTWYVX"

# BLOSUM62, rows/cols in _PROTEIN_CHARS order (20 AAs + X), standard values.
_BLOSUM62 = np.array([
    #  A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V   X
    [  4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0,  0],  # A
    [ -1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3, -1],  # R
    [ -2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3, -1],  # N
    [ -2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3, -1],  # D
    [  0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -2],  # C
    [ -1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2, -1],  # Q
    [ -1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2, -1],  # E
    [  0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3, -1],  # G
    [ -2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3, -1],  # H
    [ -1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3, -1],  # I
    [ -1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1, -1],  # L
    [ -1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2, -1],  # K
    [ -1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1, -1],  # M
    [ -2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1, -1],  # F
    [ -1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2, -2],  # P
    [  1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2,  0],  # S
    [  0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0,  0],  # T
    [ -3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3, -2],  # W
    [ -2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -1, -1],  # Y
    [  0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4, -1],  # V
    [  0, -1, -1, -1, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -2,  0,  0, -2, -1, -1, -1],  # X
], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A biological alphabet with dense int8 codes.

    Codes ``0..n_chars-1`` are real symbols, ``gap_code`` (== ``n_chars``)
    is the gap/pad code. ``size`` includes the gap row so scoring matrices
    can be indexed by any code without bounds games (gap rows score 0 — the
    DP never legitimately scores a gap through the substitution matrix).
    """
    name: str
    chars: str

    @property
    def n_chars(self) -> int:
        return len(self.chars)

    @property
    def gap_code(self) -> int:
        return len(self.chars)

    @property
    def size(self) -> int:
        return len(self.chars) + 1

    @property
    def char_to_code(self) -> Dict[str, int]:
        return {c: i for i, c in enumerate(self.chars)}

    def encode(self, seq: str) -> np.ndarray:
        lut = self.char_to_code
        unknown = self.unknown_code
        return np.array([lut.get(c, unknown) for c in seq.upper().replace("-", "")],
                        dtype=np.int8)

    def encode_aligned(self, seq: str) -> np.ndarray:
        """Encode keeping '-' as gap_code (for pre-aligned input)."""
        lut = dict(self.char_to_code)
        lut["-"] = self.gap_code
        unknown = self.unknown_code
        return np.array([lut.get(c, unknown) for c in seq.upper()], dtype=np.int8)

    def encode_aligned_rows(self, seqs) -> np.ndarray:
        """(N, L) int8 rows of equal-width ASCII aligned strings, coded as
        ``encode_aligned`` codes each one, through one byte lookup table."""
        lut = np.full(256, self.unknown_code, np.int8)
        for c, code in self.char_to_code.items():
            lut[ord(c)] = lut[ord(c.lower())] = code
        lut[ord("-")] = self.gap_code
        width = len(seqs[0]) if len(seqs) else 0
        if any(len(s) != width for s in seqs):
            raise ValueError("rows of different widths")
        buf = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
        return lut[buf].reshape(len(seqs), width)

    def decode(self, codes) -> str:
        """The characters of a row of codes (the gap code as '-'), through
        one byte lookup table that codes index as a string's characters
        are indexed (negative ones from its end)."""
        table = np.frombuffer((self.chars + "-").encode("ascii"), np.uint8)
        return table[np.asarray(codes)].tobytes().decode("ascii")

    @property
    def unknown_code(self) -> int:
        # 'N' for DNA, 'X' for protein: the last real symbol by convention.
        return len(self.chars) - 1


DNA = Alphabet("dna", _DNA_CHARS)
RNA = Alphabet("rna", _DNA_CHARS)  # U encoded via T by upstream replace
PROTEIN = Alphabet("protein", _PROTEIN_CHARS)


def dna_matrix(match: int = 2, mismatch: int = -1) -> np.ndarray:
    """Simple match/mismatch matrix for DNA/RNA; N scores 0 vs anything."""
    n = DNA.size
    m = np.full((n, n), mismatch, dtype=np.int32)
    np.fill_diagonal(m, match)
    m[DNA.unknown_code, :] = 0
    m[:, DNA.unknown_code] = 0
    m[DNA.gap_code, :] = 0
    m[:, DNA.gap_code] = 0
    return m


def blosum62() -> np.ndarray:
    n = PROTEIN.size
    m = np.zeros((n, n), dtype=np.int32)
    m[: PROTEIN.n_chars, : PROTEIN.n_chars] = _BLOSUM62
    return m


def encode_batch(seqs, alphabet: Alphabet, pad_to: int | None = None):
    """Encode a list of strings into a padded ``(N, L) int8`` array + lengths.

    Padding uses the gap code (trailing-gap semantics). Returns numpy
    arrays; callers move them to their device.
    """
    enc = [alphabet.encode(s) for s in seqs]
    lens = np.array([len(e) for e in enc], dtype=np.int32)
    L = int(pad_to if pad_to is not None else (max(lens) if len(lens) else 0))
    out = np.full((len(enc), L), alphabet.gap_code, dtype=np.int8)
    for i, e in enumerate(enc):
        out[i, : len(e)] = e[:L]
    return out, lens
