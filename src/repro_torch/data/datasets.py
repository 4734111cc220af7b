"""Synthetic sequence families with known phylogeny.

The paper's datasets (human mitochondrial genomes, 16S rRNA, BAliBASE R10)
are not shippable here, so we simulate statistically similar families: a
random ancestor evolved along a random binary tree with JC69 substitutions
and occasional indels. Crucially this gives a *ground-truth tree*, letting us
score reconstructed phylogenies by Robinson-Foulds distance — a stronger
check than the paper's likelihood-only comparison. Scale knobs mirror the
paper's Φ_DNA / Φ_RNA / Φ_Protein: length ~16.5k similar genomes, ~1.4k
moderately diverged RNA, 19-4895 diverged proteins.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np

_DNA = np.array(list("ACGT"))
_AA = np.array(list("ARNDCQEGHILKMFPSTWYV"))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_leaves: int = 16
    root_len: int = 1024
    alphabet: str = "dna"          # dna | protein
    branch_sub: float = 0.01       # expected substitutions/site/branch
    branch_indel: float = 0.0005   # expected indels/site/branch
    indel_len_mean: float = 2.0
    seed: int = 0
    len_jitter: float = 0.0        # fractional leaf-length variation


class SimFamily(NamedTuple):
    names: List[str]
    seqs: List[str]
    children: np.ndarray    # ground-truth tree (leaves 0..n-1)
    blen: np.ndarray
    root: int


def _random_topology(n: int, rng) -> tuple[np.ndarray, np.ndarray, int]:
    """Random binary tree via sequential random joins; NJ-style arrays."""
    children = np.full((2 * n - 1, 2), -1, np.int32)
    blen = np.zeros((2 * n - 1, 2), np.float32)
    active = list(range(n))
    nxt = n
    while len(active) > 1:
        i, j = rng.choice(len(active), size=2, replace=False)
        a, b = active[i], active[j]
        children[nxt] = (a, b)
        blen[nxt] = rng.exponential(1.0, size=2)
        for x in sorted([i, j], reverse=True):
            active.pop(x)
        active.append(nxt)
        nxt += 1
    return children[:nxt], blen[:nxt], nxt - 1


def _evolve(seq: np.ndarray, t_sub: float, t_indel: float, cfg: SimConfig, rng):
    chars = _DNA if cfg.alphabet == "dna" else _AA
    n = len(seq)
    # JC69-like substitutions
    p_sub = 1.0 - np.exp(-t_sub)
    mask = rng.random(n) < p_sub
    seq = seq.copy()
    if mask.any():
        seq[mask] = chars[rng.integers(0, len(chars), mask.sum())]
    # indels
    n_indel = rng.poisson(t_indel * n)
    for _ in range(n_indel):
        pos = rng.integers(0, max(len(seq), 1))
        ln = max(1, rng.poisson(cfg.indel_len_mean))
        if rng.random() < 0.5 and len(seq) > ln + 2:
            seq = np.concatenate([seq[:pos], seq[pos + ln:]])
        else:
            ins = chars[rng.integers(0, len(chars), ln)]
            seq = np.concatenate([seq[:pos], ins, seq[pos:]])
    return seq


def simulate_family(cfg: SimConfig) -> SimFamily:
    rng = np.random.default_rng(cfg.seed)
    chars = _DNA if cfg.alphabet == "dna" else _AA
    children, blen, root = _random_topology(cfg.n_leaves, rng)
    root_seq = chars[rng.integers(0, len(chars), cfg.root_len)]
    seqs: dict[int, np.ndarray] = {}

    def rec(node: int, seq: np.ndarray):
        c = children[node]
        if c[0] < 0:
            seqs[node] = seq
            return
        for ci, t in ((int(c[0]), blen[node, 0]), (int(c[1]), blen[node, 1])):
            rec(ci, _evolve(seq, t * cfg.branch_sub, t * cfg.branch_indel, cfg, rng))

    rec(root, root_seq)
    names = [f"seq{i}" for i in range(cfg.n_leaves)]
    out = ["".join(seqs[i]) for i in range(cfg.n_leaves)]
    return SimFamily(names, out, children, blen, root)


def phi_dna(scale: int = 1, seed: int = 0) -> SimFamily:
    """Φ_DNA analogue: highly similar 'mitochondrial' genomes (scaled)."""
    return simulate_family(SimConfig(n_leaves=16 * scale, root_len=2048,
                                     branch_sub=0.002, branch_indel=0.0002,
                                     seed=seed))


def phi_rna(scale: int = 1, seed: int = 1) -> SimFamily:
    """Φ_RNA analogue: ~1.4k-length moderately diverged sequences."""
    return simulate_family(SimConfig(n_leaves=24 * scale, root_len=1440,
                                     branch_sub=0.01, branch_indel=0.001,
                                     seed=seed))


def phi_protein(scale: int = 1, seed: int = 2) -> SimFamily:
    """Φ_Protein analogue: diverged proteins, variable length."""
    return simulate_family(SimConfig(n_leaves=16 * scale, root_len=459,
                                     alphabet="protein", branch_sub=0.05,
                                     branch_indel=0.002, seed=seed))
