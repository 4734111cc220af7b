"""High-level MSA driver: HAlign-II's pipeline as host-orchestrated stages.

Pipeline (paper Fig. 3):
  1. pick the center sequence (first, or most-shared-kmers sample heuristic)
  2. map(1): align every sequence to the broadcast center
       - 'sw' / 'plain': Gotoh DP through ``repro_torch.align.AlignEngine``
         (length-bucketed batching)
       - 'kmer': chain k-mer anchors, DP only on inter-anchor segments
         (the trie-accelerated path; pairs whose chain fails are realigned
         whole through the engine)
  3. reduce(1): merge insert-space profiles (columnwise max)
  4. map(2): rebuild every row in the merged frame

Every DP — the inter-anchor segments and the full-DP realignments — runs
through ``kernels.sw.ops.gotoh_forward``: the hand-written kernel on the
card, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import alphabet as ab
from . import centerstar, kmer_index
from ..device import resolve_device, sync
from ..obs import trace as _trace


@dataclasses.dataclass(frozen=True)
class MSAConfig:
    alphabet: str = "dna"            # dna | rna | protein
    method: str = "kmer"             # kmer | plain | sw
    match: int = 2
    mismatch: int = -1
    gap_open: int = 3
    gap_extend: int = 1
    k: int = 11                      # k-mer width (trie depth equivalent)
    stride: int = 1                  # query probe stride
    max_anchors: int = 256
    max_seg: int = 64                # inter-anchor DP budget
    center: str = "first"            # first | sampled
    local: bool = False              # Smith-Waterman local stage-1 alignment
    backend: str = "auto"            # map(1) DP route (see align.backends)
    band: int = 64                   # band width for the banded backends
    bucket: bool = True              # length-bucketed batching in map(1)

    def alpha(self) -> ab.Alphabet:
        return {"dna": ab.DNA, "rna": ab.RNA, "protein": ab.PROTEIN}[self.alphabet]

    def matrix(self, device="cuda") -> torch.Tensor:
        if self.alphabet == "protein":
            m = ab.blosum62()
        else:
            m = ab.dna_matrix(self.match, self.mismatch)
        return torch.as_tensor(m, dtype=torch.float32,
                               device=resolve_device(device))

    def engine(self, device="cuda", *, bucket: Optional[bool] = None):
        """The configured ``repro_torch.align.AlignEngine`` on ``device``
        (raises when CUDA is asked for and absent)."""
        from ..align.engine import AlignEngine
        return AlignEngine(self.matrix(device), gap_open=self.gap_open,
                           gap_extend=self.gap_extend,
                           gap_code=self.alpha().gap_code,
                           backend=self.backend, local=self.local,
                           bucket=self.bucket if bucket is None else bucket)


class MSAResult(NamedTuple):
    msa: np.ndarray          # (N, L) int8 aligned rows, original order
    center_idx: int
    n_fallback: int          # pairs that fell back to full DP
    width: int
    center_mode: str = "first"   # effective center selection ('first'|'sampled')


# ---------------------------------------------------------------- k-mer path

def _get_segs(seq, rows, start, length, width: int, gap_code: int):
    """(L, width) windows ``seq[rows, start:start+length]``, gap-padded
    past ``length`` and past the end of the sequence (``seq`` is (B, n))."""
    B, n = seq.shape
    seqp = torch.cat([seq, torch.full((B, width), gap_code, dtype=seq.dtype,
                                      device=seq.device)], dim=1)
    col = torch.arange(width, device=seq.device)
    idx = start.long().clamp(0, n)[:, None] + col
    s = seqp[rows[:, None], idx]
    return torch.where(col < length[:, None], s,
                       torch.tensor(gap_code, dtype=seq.dtype,
                                    device=seq.device))


def kmer_align_batch(Q, lens, center, lc, table, sub, *, k, stride,
                     max_anchors, max_seg, gap_open, gap_extend, gap_code):
    """Anchor-chained alignment of a batch of queries against the center.

    Returns (a_rows, b_rows) in a fixed assembly buffer of width
    ``(A+1)·2·max_seg + A·k + 2·max_seg`` plus per-pair ok flags. Dead
    (gap, gap) columns are interior padding, ignored downstream.

    The segment DPs of all queries go through the pairs backend as one
    batch; segments that are empty in both sequences (dead segments past
    the chain's tail, adjacent anchors) are left out, since their rows
    are all gap and their aligned length is 0. Blocks are written only
    over their aligned length, which gives the reference's buffer: the
    tail of each full-width block it writes is gap.
    """
    from ..align.backends import sw_align_pairs
    dev = Q.device
    B, n = Q.shape
    A = max_anchors
    blk = 2 * max_seg
    kbuf = (A + 1) * blk + A * k + blk
    lens = lens.to(torch.int32)
    anch = kmer_index.chain_anchors(Q, lens, table, lc, k=k, stride=stride,
                                    max_anchors=A, max_seg=max_seg)
    qs, qlen, cs, clen = kmer_index.segment_bounds(anch, lens, lc, k=k)

    # block u of query b starts at the running sum of the block lengths:
    # seg0, anch0, seg1, anch1, ..., seg_A
    qb, s = torch.nonzero(((qlen + clen) > 0) & anch.ok[:, None],
                          as_tuple=True)
    center2 = center[None, :]
    zeros = torch.zeros_like(qb)
    seg_q = _get_segs(Q, qb, qs[qb, s], qlen[qb, s], max_seg, gap_code)
    seg_c = _get_segs(center2, zeros, cs[qb, s], clen[qb, s], max_seg,
                      gap_code)
    aln = sw_align_pairs(seg_q, qlen[qb, s], seg_c, clen[qb, s], sub,
                         gap_open=gap_open, gap_extend=gap_extend,
                         local=False, gap_code=gap_code)
    lens_u = torch.zeros((B, 2 * A + 1), dtype=torch.int32, device=dev)
    lens_u[qb, 2 * s] = aln.aln_len
    anch_live = torch.arange(A, device=dev)[None, :] < anch.count[:, None]
    lens_u[:, 1::2] = torch.where(anch_live, k, 0).to(torch.int32)
    off = torch.cumsum(lens_u, dim=1) - lens_u                # exclusive

    buf_a = torch.full((B * kbuf,), gap_code, dtype=torch.int8, device=dev)
    buf_b = torch.full((B * kbuf,), gap_code, dtype=torch.int8, device=dev)
    col = torch.arange(blk, device=dev)
    pos = qb[:, None] * kbuf + off[qb, 2 * s][:, None] + col
    keep = col[None, :] < aln.aln_len[:, None]
    buf_a[pos[keep]] = aln.a_row[:, :blk][keep]
    buf_b[pos[keep]] = aln.b_row[:, :blk][keep]

    # anchor blocks: exact k-length matches
    ab_, as_ = torch.nonzero(anch_live & anch.ok[:, None], as_tuple=True)
    colk = torch.arange(k, device=dev)
    pos = (ab_[:, None] * kbuf + off[ab_, 2 * as_ + 1][:, None] + colk
           ).flatten()
    qpos = anch.q_pos[ab_, as_].long()[:, None] + colk
    cpos = anch.c_pos[ab_, as_].long()[:, None] + colk
    buf_a[pos] = Q[ab_[:, None], qpos].flatten()
    buf_b[pos] = center[cpos].flatten()
    return buf_a.view(B, kbuf), buf_b.view(B, kbuf), anch.ok


# ------------------------------------------------------------------- driver

def encode_for_msa(seqs: Sequence[str], cfg: MSAConfig):
    """Normalize (RNA U->T) and encode a string batch for ``cfg``'s
    alphabet; returns numpy ``(S (N, L) int8, lens (N,) int32)``."""
    return ab.encode_batch(
        [s.replace("U", "T").replace("u", "t")
         if cfg.alphabet == "rna" else s for s in seqs], cfg.alpha())


def map1_align_to_center(Q, qlens, center, lc, cfg: MSAConfig, engine=None):
    """The map(1) stage on its own: a query batch against a frozen center.

    Returns ``(a_rows, b_rows, n_fallback)`` — the per-pair aligned rows
    that ``assemble_center_star`` feeds to the reduce(1)/map(2) assembly.
    Runs on ``Q``'s device.
    """
    gap = cfg.alpha().gap_code
    engine = cfg.engine(Q.device) if engine is None else engine
    if cfg.method == "kmer":
        table = kmer_index.build_center_index(center, lc, k=cfg.k)
        a_rows, b_rows, ok = kmer_align_batch(
            Q, qlens, center, lc, table, engine.sub, k=cfg.k,
            stride=cfg.stride, max_anchors=cfg.max_anchors,
            max_seg=cfg.max_seg, gap_open=cfg.gap_open,
            gap_extend=cfg.gap_extend, gap_code=gap)
        # chain failures re-align through the engine; rows stay on device
        return engine.realign_failed(Q, qlens, center, lc, a_rows, b_rows,
                                     ok)
    res = engine.align_to_center(Q, qlens, center, lc)
    return res.a_row, res.b_row, res.n_fallback


def assemble_center_star(a_rows, b_rows, center, lc, *, others, cidx: int,
                         n_total: int, gap: int):
    """reduce(1) + map(2): merge insert profiles, rebuild rows, place center.

    ``a_rows``/``b_rows`` are the map(1) pair alignments for the ``others``
    rows (any width — dead (gap, gap) columns are ignored). Returns
    ``(msa, width)`` with msa a numpy (n_total, width) int8 array in
    original row order.
    """
    num_slots = int(center.shape[0]) + 1
    g = centerstar.gap_profiles(a_rows, b_rows, gap_code=gap,
                                num_slots=num_slots)
    G = centerstar.merge_profiles(g)
    width = centerstar.msa_width(G, int(lc))
    rows = centerstar.build_rows(a_rows, b_rows, G, gap_code=gap,
                                 out_len=width)
    crow = centerstar.center_msa_row(center, lc, G, gap_code=gap,
                                     out_len=width)
    msa = torch.full((n_total, width), gap, dtype=torch.int8,
                     device=rows.device)
    msa[torch.as_tensor(others, device=rows.device)] = rows
    msa[cidx] = crow
    return msa.cpu().numpy(), width


def center_star_msa(seqs: Sequence[str] | np.ndarray, cfg: MSAConfig,
                    lens: Optional[np.ndarray] = None, *,
                    device="cuda") -> MSAResult:
    """Center-star MSA of ``seqs`` (strings, or encoded (N, L) int8 rows
    with ``lens``) on ``device``."""
    dev = resolve_device(device)
    alpha = cfg.alpha()
    gap = alpha.gap_code
    if isinstance(seqs, (list, tuple)):
        with _trace.span("encode", n=len(seqs)):
            S, lens = encode_for_msa(seqs, cfg)
    else:
        S = seqs
    S = torch.as_tensor(np.asarray(S), device=dev)
    lens = torch.as_tensor(np.asarray(lens), device=dev).to(torch.int32)
    N, Lmax = S.shape
    if N < 2:
        return MSAResult(S.cpu().numpy(), 0, 0, Lmax, "first")

    with _trace.span("center", n=int(N), mode=cfg.center):
        cidx, center_mode = _select_center(S, lens, cfg)
        center = S[cidx]
        lc = int(lens[cidx])
        others = np.array([i for i in range(N) if i != cidx])
        oix = torch.as_tensor(others, device=dev)
        Q, qlens = S[oix], lens[oix]

    with _trace.span("map1", n=int(N) - 1, method=cfg.method,
                     backend=cfg.backend) as sp:
        a_rows, b_rows, n_fallback = map1_align_to_center(
            Q, qlens, center, lc, cfg)
        if sp is not None:
            sync(dev)   # bill the DP to map1, not to the next stage
    with _trace.span("assemble", n=int(N)):
        msa, width = assemble_center_star(a_rows, b_rows, center, lc,
                                          others=others, cidx=int(cidx),
                                          n_total=N, gap=gap)
    return MSAResult(msa, int(cidx), n_fallback, width, center_mode)


def _select_center(S, lens, cfg: MSAConfig) -> tuple[int, str]:
    """Pick the center row; returns (index, effective mode).

    ``center='sampled'`` needs the k-mer index, which only exists for
    nucleotide alphabets — for proteins it warns and reports
    ``center_mode='first'``.
    """
    if cfg.center == "first" or S.shape[0] <= 2:
        return 0, "first"
    if cfg.alphabet == "protein":
        warnings.warn(
            "center='sampled' is unsupported for protein alphabets (no "
            "k-mer index); falling back to center='first'", stacklevel=2)
        return 0, "first"
    # 'sampled': index sequence 0, pick the sequence sharing the most k-mers —
    # the paper's "contains the most segments among all sequences" heuristic.
    table = kmer_index.build_center_index(S[0], lens[0], k=cfg.k)
    codes = kmer_index.kmer_codes(S, lens, cfg.k)
    cand = table[codes.clamp(min=0).long(), 0]     # first occurrence column
    hits = ((codes >= 0) & (cand != kmer_index.EMPTY)).sum(dim=1)
    return int(torch.argmax(hits)), "sampled"


def decode_msa(msa: np.ndarray, cfg: MSAConfig) -> list[str]:
    alpha = cfg.alpha()
    return [alpha.decode(r) for r in np.asarray(msa)]
