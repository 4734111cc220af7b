"""Minimal, robust FASTA reader/writer (the system's HDFS stand-in).

``iter_fasta`` is the streaming core: one ``(name, sequence)`` record at a
time from a path or any line-iterable (an open file, ``io.StringIO`` over
an HTTP upload body, so an upload is never materialized twice). ``read_fasta`` is the
list-building wrapper every launcher uses.

Records are normalized on the way in:

  * CRLF / stray ``\\r`` line endings are stripped (files written on
    Windows or pasted through HTTP bodies arrive as ``\\r\\n`` even when
    the stream wasn't opened in universal-newline mode),
  * sequence characters are uppercased (lowercase soft-masked residues
    otherwise leak into encoding, where only uppercase codes exist),
  * ``.`` gap characters become ``-``,
  * anything outside letters / ``-`` / ``*`` raises ``ValueError`` with
    the offending record named. IUPAC ambiguity codes (R, Y, S, W, ...)
    are letters and pass through — the alphabet encoder maps codes
    outside its table to the unknown symbol (N / X).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, Iterator, List, Tuple

_BAD_CHARS = re.compile(r"[^A-Z\-*]")


def _normalize_seq(chunks: List[str], name: str) -> str:
    seq = "".join(chunks).upper().replace(".", "-")
    bad = _BAD_CHARS.search(seq)
    if bad:
        raise ValueError(
            f"invalid character {bad.group()!r} in sequence {name!r}")
    return seq


def iter_fasta(source) -> Iterator[Tuple[str, str]]:
    """Stream ``(name, normalized_sequence)`` records from ``source``.

    ``source`` is a path (opened and closed here) or any iterable of
    lines (already-open file, ``io.StringIO``, a list of strings).
    """
    if isinstance(source, (str, Path)):
        with open(source) as f:
            yield from _iter_lines(f, str(source))
    else:
        yield from _iter_lines(source, "<stream>")


def _iter_lines(lines, label: str) -> Iterator[Tuple[str, str]]:
    name = None
    cur: List[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, _normalize_seq(cur, name)
            cur = []
            name = line[1:].split()[0] if len(line) > 1 else ""
        else:
            if name is None:
                raise ValueError(
                    f"malformed FASTA {label}: sequence data before the "
                    f"first '>' header")
            cur.append(line.replace(" ", "").replace("\t", ""))
    if name is not None:
        yield name, _normalize_seq(cur, name)


def read_fasta(path) -> Tuple[List[str], List[str]]:
    names, seqs = [], []
    for name, seq in iter_fasta(path):
        names.append(name)
        seqs.append(seq)
    return names, seqs


def write_fasta(path, names: Iterable[str], seqs: Iterable[str], width: int = 80):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n")
            for i in range(0, len(s), width):
                f.write(s[i: i + width] + "\n")
