#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. print the card's name and power limit (nvidia-smi);
  2. build the five CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     each, started together) and print the build seconds;
  3. hold the Gotoh forward kernel bit-exact against its plain PyTorch
     version, global and local, at the segment shape (B=16384, 64x64),
     the fallback shape (B=64, 2048x1460, broadcast target), ragged
     batches with lengths 0 and 1 and lengths past n and m, m + 1 at a
     strip's edge (384 columns) -1, at it and +1 (one and two strips), m of
     16,384 and 20,000 (past the first design's cap), n >> m and m >> n,
     m = 0 and n = 0, B not a multiple of the pairs a CTA, BLOSUM62 at gap
     11 with codes past the table, and planted local ties (a repeated
     unit: equal maxima in two rows and across strips and lanes);
  4. hold the match/valid kernel exact against its plain version on every
     route (``MV_CASES``, ``MV_GROUP_CASES``): tensor cores at the
     main-path shape (symmetric, 4,096^2 x 6,344), split L (4,096 x 64),
     N not a multiple of the tile, every load width, codes below 0 and
     above n_chars, protein (n_chars 21) and the gap inside the alphabet,
     L past 16,352; skinny at M = 1, N = 1 and short sides up to 8; SIMD
     at n_chars 40; ``match_valid_groups`` with ragged groups (an empty
     one, one of one row) on tensor cores and SIMD;
  5. hold the banded forward kernel and the fused banded kernel bit-exact
     against their plain versions at ragged small shapes (lengths 0 and
     1, W = 1, 8, 17, 33, 42, 64, 128, 256, 500 and 1,024 on the warp
     route, 1,025, 1,536, 2,048, 4,096, 8,192 and 16,384 on the wide
     route, a band covering
     every column, broadcast targets, band slides above one column a row
     (lb >= 3 la, la = 1 with lb = m, lb = 1 with la = n), la = n in every
     pair, B not a multiple of the pairs a CTA, n * W past the first
     design's 200 KB of shared memory, n + m = 241,000 codes); the fused
     kernel's outputs must also equal the banded forward kernel + the
     banded traceback;
  6. run the main path, ``repro_torch.launch.msa_run`` with default flags
     (``--method kmer --tree nj``), on a 4,096-sequence family simulated
     with the paper's Phi_RNA (16S rRNA) parameters, check its outputs and
     that kernels 1 and 2 were launched during the run;
  7. run the banded main path, ``msa_run --backend banded-pallas``, on the
     same family: check its outputs, that kernels 1-3 were launched, and
     print its band-overflow fallbacks and how many aligned rows differ
     from phase 6's (a finding: banding is a heuristic);
  8. run the search path, ``repro_torch.launch.search_run``, with the last
     4 of 4,100 simulated leaves as queries against the first 4,096:
     ``--score global`` under ``--backend banded-pallas`` (kernel 4) and
     ``banded`` (kernel 3 + traceback), whose hits must be equal, then
     ``--score local`` (kernel 1 local);
  9. on the inputs of the largest call each of phases 6-8 gave each
     kernel (kernel 1: for each mode and target form, so the full-DP
     fallbacks of the banded paths and the local search chunks too), hold
     the kernel bit-exact against its plain version again and time it
     beside that plain version, one PyTorch library call where there is
     one, and its bound (kernels 1 and 4 with their plans' pairs a CTA,
     grid, workspace, registers and spill bytes; kernel 1 with each call's
     own device peak);
 10. run the tree backends at 4,096 on phase 6's ``aligned.fasta``:
     ``repro_torch.launch.tree_run --tree-ll`` with ``--backend dense``,
     ``cluster`` and ``tiled --row-block 128``, then ``msa_run --tree
     tiled --tree-ll`` once; check each tree (4,096 leaves, finite logL,
     kernel 2 launched), that the cluster and tiled trees are bitwise
     equal and the tiled run stayed within one (128, N) strip, and print
     each run's seconds by stage, device peak, logL and normalized RF
     against the simulated tree;
 11. run ``tree_run --backend auto`` (which must resolve to ``tiled``)
     and ``--backend cluster`` on 65,536 aligned Phi_RNA-shaped rows
     (no indels, so no MSA run): the two trees bitwise equal, the tiled
     run within one strip; print seconds by stage, device peaks, kernel-2
     launches and normalized RF;
 12. for each tree run, hold kernel 2's largest call in each role (the
     span it ran in, single columns, the per-cluster batch of
     ``match_valid_groups``) exact against the plain version and time it
     beside two float32 one-hot products (batched for the groups) and
     ``torch._int_mm`` of the int8 one-hots where it takes the shapes;
     each run prints its kernel-2 launches by route;
 13. run ``msa_run --tree ml`` (auto backend, here cluster, plus ML
     refinement at its defaults: model auto, 150 Adam steps, 8 NNI
     rounds) on 384 sequences (cut from 1,024 to make room for phases 21
     and 23)
     simulated with Phi_DNA's parameters
     (mitochondrial-like: root_len 2,048, branch_sub 0.002, branch_indel
     0.0002): kernels 1 and 2 launched, a registry model, final logL >=
     initial; print seconds by stage (``ml.fit``, ``ml.score``), the
     device peak, logL before and after, normalized RF of the dense NJ
     tree, the backend's tree and the ML tree against the simulated tree; hold the pruning logL and
     its gradient at the refined tree on the card against the CPU
     (rtol 1e-5; 1e-3 of the largest gradient component), and a 2-step
     fit from it (the card's CUDA-graph replay against the CPU's eager
     steps, rtol 1e-5);
 14. ``tree_run --refine ml --bootstrap 100`` on phase 13's alignment:
     every internal non-trivial edge with a finite support in [0, 1], the
     Newick with its labels; print bootstrap seconds and replicates/s;
 15. the tree-search fleet (4 starts, radius 3, 4 rounds) on 128 of
     phase 13's rows, as shipped (the searcher turns on deterministic
     algorithms itself): uninterrupted, killed at round 2 by a non-StepFailure error, resumed;
     the resumed tree and Newick bitwise equal to the uninterrupted run's;
     then ``tree_run --refine search --restartable --search-rounds 4``
     once;
 16. ``search_run --pipeline --bootstrap 25`` on phase 8's database and
     queries: every family tree ML-refined with support labels;
 then hold kernels 1 and 2 on phase 13's largest calls;
 17. LM serving: hold the flash-attention kernel (kernel 5) against its
     plain version (f32 within 2e-5; bf16 within half a bf16 ulp of the
     plain version's f32 result, plus 2e-5) at the four dense configs'
     head layouts (H/KH/D 32/8/64, 16/16/64, 8/1/256, 32/8/120), S = 2,048
     causal, not causal and window 64, window 4,096 at S = 8,192, ragged
     S = 1, 37 and 1,000, D = 8 and 32 (padded to 64), D = 60, 100 and
     250 and K/V expanded over the KV heads (head stride 0) at D = 64,
     120 and 256 (the bf16 kernel's element route at each padded head
     dim), 1,000 queries at q_offset 2,000 over 3,000 keys, and the (B, H,
     S, D) entry ``ops.flash_attention`` (transposed strides), and the
     other families' layouts at S = 2,048 (16/16/128, 64/8/112, 12/2/128
     and 64/8/128 causal, 16/16/80 not causal), f32 and bf16;
     run ``repro_torch.launch.serve
     --arch h2o-danube-3-4b --batch 4 --prompt-len 8192 --gen 32`` at full
     width (random weights, seed 0): kernel 5 launched once per layer (24),
     finite logits, tokens in the vocabulary, and print prefill ms, decode
     ms per token and the device peak above the memory in use at its
     start; check prefill/decode continuity at
     full width (B = 1, f32, 8,192 tokens against 8,191 + one decode step,
     atol 2e-3); time kernel 5 at the serve shape beside its bound, its
     plain version and ``scaled_dot_product_attention``;
 18. the distributed runtime (``repro_torch.dist``, one process a rank):
     in a world of one in this process (``nccl``), ``msa_run --dist`` on
     phase 6's family (refused, as the reference's mesh path refuses a
     merged width past 2·Lmax + 64 columns; equal to phase 6 where it
     fits), then on 4,096 Φ_RNA-shaped sequences with indel rate 0.00005
     (which fit) ``msa_run --tree tiled --tree-ll`` with and without
     ``--dist``: equal files, ``kmer_fallbacks`` null, kernels 1 and 2
     launched and their largest calls held against their plain versions;
     then spawned ``gloo`` worlds sharing the card (kernels built here
     first): 2 ranks run ``msa_run --dist --tree tiled --tree-ll`` (files
     equal to the world of one's), ``search_run --dist --score global
     --backend banded-pallas`` on phase 8's database (``hits.json`` equal
     to phase 8's but for its ``seed`` stat), ``tree_run --mesh 2x1
     --backend tiled --row-block 32`` with ``--refine ml --bootstrap 20``
     and with ``--refine search --starts 4`` on phase 15's 128 rows; 1
     rank runs those ``tree_run``s with ``--mesh 1x1``: equal Newick
     files; each rank prints its stage seconds, device peak and kernel
     launches;
 19. the MSA service (``repro_torch.serve``, ``launch/serve_msa``), at
     ``--method plain`` (the coalesced route) over HTTP: (a)
     ``MSAService`` with ``serve_http`` on a thread (``--max-batch 8192
     --max-wait-ms 50``, phase 8's index, a store directory): ``/align``
     of phase 6's 4,096 sequences (4,095 pairs, one kernel-1 batch; rows
     decode to their inputs, one width, no all-gap column, the rows equal
     ``center_star_msa`` plain; kernel 1's largest call held against its
     plain version), the same again (a byte-identical cache hit), eight
     concurrent ``/align`` of 256 from a 2,048-sequence family (one
     coalesced batch at least; each response equal to the request alone
     on a fresh service), ``/align/add`` of 64 members (old rows =
     ``expand_rows`` of the stored ones; equal to the full realign with
     the same center), ``/tree`` (kernel 2 launched and held; RF 0
     against ``tree_run`` at the same backend on the same rows),
     ``/search`` of phase 8's queries (phase 8's local hits), then drain:
     started == finished + rejected; (b) a spawned ``serve_msa
     --store-dir``: a named alignment of 1,024 and three adds of 16,
     SIGKILL, a restart that reads the store back bit-identical, one more
     add at the next generation, SIGTERM drains with exit code 0; (c)
     ``serve_msa --dist --dist-threshold 1024`` on 1 and on 2 spawned
     ``gloo`` ranks sharing the card: ``/align`` of 2,048 sequences at
     phase 18's indel rate (``path: "dist"``) and ``/tree --backend
     tiled`` equal on both worlds; each request's wall ms, the device
     peaks, kernel launches (counted by the service's worker threads, read
     after each request) and the queue's batches are printed;
 20. the adaptive band policy and the progressive baseline: (a) 4,096
     pairs of partial 16S reads (substrings of 400-1,440 nt of phase 6's
     leaves) against other full-length leaves through ``AlignEngine(
     band_policy="adaptive").align_pairs`` at band 64 on both banded
     routes (kernel 4; kernel 3 + the banded traceback): rows, fallbacks
     and calls equal, kernel 4 launched once a bucket; beside the fixed W
     = 64 policy on the same pairs (fewer fallbacks; its fallbacks go
     through kernel 1); every bucket's call held exact against the plain
     versions on 3 of its pairs; the widest call and a W = 16,384 call
     timed beside their bounds and plain versions, with registers and
     spill bytes; each run's wall seconds, device peak, buckets, calls,
     fallbacks and launches; (b) ``progressive_msa`` on the card on the
     Table 4 protein family (16 x 459) and on 64 of phase 6's sequences:
     rows decode to their inputs; seconds and avg SP beside
     ``center_star_msa`` on the same family;
 21. the LM's other families (random f32 weights, seed 0; bf16 compute
     unless named): ``launch.serve --arch mamba2-130m --batch 4
     --prompt-len 8192 --gen 32`` at full width and depth (kernel 5
     launched 0 times: attention-free); through ``make_prefill_step`` /
     ``make_decode_step``: moonshot-v1-16b-a3b at full width, 12 of 48
     layers, 4 x 2,048 and 31 steps (12 launches; the MoE's dropped
     picks printed), qwen2-vl-2b at full width and depth on 4 x 4,096
     random embeddings with the M-RoPE positions of a text run, a 32 x 32
     image grid and text again, 15 steps on embeddings (28 launches),
     jamba-1.5-large-398b as one group of 8 layers with d_ff (experts and
     the mamba layers' MLP) cut from 24,576 to 4,096, 2 x 4,096 and 15
     steps (1 launch), kimi-k2-1t-a32b as its dense prefix (d_ff 18,432)
     and one MoE layer with 32 of its 384 experts, top-8, 2 x 2,048 and 7
     steps (2 launches); ``apply_model`` on hubert-xlarge at full width
     and depth, 4 x 4,096 frame embeddings, not causal (48 launches);
     each run's prefill ms, decode ms per token, device peak above the
     memory in use at its start and launches; f32 prefill/decode
     continuity at B = 1 (atol 2e-3) for mamba2 (8,192), moonshot at
     capacity 11.0 (2,048) and jamba at capacity 8.0 (4,096), where C =
     T and nothing drops; the largest tensor one ``moe_block`` call
     (moonshot, 4 x 2,048) and one ``ssd_chunked`` call (mamba2 4 x
     8,192, jamba 2 x 4,096) make, beside the reference's (T, E, C)
     one-hot and the (B, nc, nh, Q, Q) decay; kernel 5 timed at
     qwen2-vl's and hubert's prefill shapes beside its bound, its plain
     version and SDPA;
 22. LM training (``repro_torch.train``, ``launch/train``): (a) ``launch.
     train --arch llama3.2-1b --batch 8 --seq 4096 --micro 4 --steps 4``
     at the published config (random f32 weights, seed 0; bf16 compute;
     every layer rematerialized): every loss and grad norm finite, the
     first loss within [ln V - 0.1, ln V + 1.0], kernel 5 launched 128
     times a step (16 layers x 4 microbatches, forward and remat's
     recompute); each step's ms, loss and grad norm, tokens/s, model
     FLOPs a step against 989 TFLOP/s, the device peak above the 16
     bytes a parameter of state, and one ``torch.profiler`` step's share
     of device time in the attention backward; then the same command at 2
     of the 16 layers with ``--ckpt-dir <work> --ckpt-every 2``,
     ``--resume`` to 6 steps from the step-4 checkpoint and an
     uninterrupted 6-step run, under deterministic algorithms: the
     resumed step-5 loss the uninterrupted run's within 1e-5 (at 16
     layers a checkpoint is 14.8 GB, and its 5 writes, 74 GB, would be
     the script's largest disk load by far); (b) f32
     gradients on the card against the port's CPU path: llama3.2-1b at
     full width cut to 2 layers, 1 x 1,024 tokens, and one
     ``make_train_step`` step (2 microbatches) of each family's smoke
     config (danube, gemma, kimi, mamba2, jamba, qwen2-vl on embeddings
     with M-RoPE positions, hubert): each leaf within 1e-4 of its norm,
     losses within 1e-5; (c) one bf16 step (2 x 2,048 tokens, 2
     microbatches) of each non-dense family at phase 21's published
     width, cut as ``TRAIN_FAMILY_RUNS`` says to keep 16 bytes a
     parameter under 40 GB: step ms, peak, kernel-5 launches, the MoE's
     dropped picks, finite losses; then kernel 5 timed at llama3.2-1b's
     training shape (2 x 32 x 4,096 x 64, KH 8, causal, bf16) beside its
     bound, its plain version and SDPA, and the chunked attention
     backward beside SDPA's backward;
 23. the production mesh (``models/sharding_plan``, ``launch/steps``,
     ``launch/dryrun``): (a) ``launch.train --mesh 2x2`` on four spawned
     ``gloo`` ranks sharing the card (collectives through gloo's own,
     ``sharding_plan.collectives``), llama3.2-1b at its published width
     cut to 2 of 16 layers, ``--batch 8 --seq 1024 --micro 2 --steps 3``,
     beside a 1x1 run of the same flags here: losses within rtol 1e-4,
     leaf by leaf Adam's first moment within ``MESH_M_RTOL`` of 1x1's and
     the parameters within ``MESH_P_RATIO`` of 1x1's update (in norm),
     each rank's local bytes of parameters and Adam moments the plan's
     arithmetic, kernel 5 launched on every rank; each rank's parameter
     elements, device peak and step ms (four ranks share one card: no
     speed figure); (b) ``launch.dryrun`` of llama3.2-1b train_4k on the
     pod mesh and kimi-k2-1t-a32b decode_32k on the multipod mesh, each
     at ``--device cuda`` and ``--device cpu`` in subprocesses started
     after phase 22's timed and profiled steps (they use the CPU only,
     beside the rest of phase 22 and phase 23 (a)): the two records equal in
     every byte, FLOP and collective count, 4,894,720 and 2,002,147,840 parameters a rank
     (the latter reconciled with the reference's 2,013,760,000);
 each phase prints its seconds on a line of its own; then print each
 kernel on its own path as one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_SEQS = 4096
N_BIG = 65536          # the tree backends' large run
# H100 SXM peak rates: HBM, f32 outside the tensor
# cores, int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# f32 operations per DP cell of the Gotoh forward: 3 max + 2 compare for
# h and its argmax, add + compare + 2 select (local) for M, 2 sub + max +
# compare for Ix, add + max (scan) + 2 sub for Iy, 2 sub + compare for dirIy
SW_OPS_PER_CELL = 20
# per band cell the banded forward adds the band masks (4 compares,
# 3 selects) and the edge-pressure compare to the Gotoh cell's work,
# less the local select
BANDED_OPS_PER_CELL = 25
N_QUERIES = 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


_PEAK_CARRY = [0]


def reset_peak() -> None:
    import torch
    _PEAK_CARRY[0] = 0
    torch.cuda.reset_peak_memory_stats()


def device_peak() -> int:
    """Peak device bytes allocated since the last ``reset_peak``, through
    the resets ``BudgetWatch`` makes in between."""
    import torch
    return max(torch.cuda.max_memory_allocated(), _PEAK_CARRY[0])


def cuda_ms(fn, reps: int = 3):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, from CUDA events, and the last run's result. The card is kept
    busy (``torch.cuda._sleep``) while the runs are queued, so the events
    time the device's work and not the host's dispatch of small calls."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)         # ~25 ms at the H100's clocks
    t0.record()
    for _ in range(reps):
        out = None
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


def phase_clock():
    """A function printing the seconds since its last call (or since this
    one) as ``phase <label>: <s> s`` on a line of its own."""
    last = [time.time()]

    def mark(label) -> None:
        now = time.time()
        print(f"phase {label}: {now - last[0]:.1f} s", flush=True)
        last[0] = now
    return mark


def host_ms(fn, reps: int = 20) -> float:
    """Mean wall milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, ending in a device sync: dispatch and device together, what a
    caller waits for a small call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# ------------------------------------------------------------------ kernel 1

def sw_inputs(B, n, m, *, seed, broadcast=False, ragged=False,
              n_chars=5, over=False):
    """Random codes below ``n_chars``; lengths from half to full, with
    ``ragged`` lengths of 0 and 1 and with ``over`` some past n and m."""
    import torch
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_chars, (B, n)).astype(np.int8)
    b = rng.integers(0, n_chars, (1 if broadcast else B, m)).astype(np.int8)
    la = rng.integers(max(n // 2, 0), n + 1, B)
    lb = rng.integers(max(m // 2, 0), m + 1, B)
    if ragged:
        la[: B // 2] = rng.integers(0, 2, B // 2)
        lb[B // 4: B // 4 + B // 2] = rng.integers(0, 2, B // 2)
    if over:
        la[::3] = n + 1 + rng.integers(0, 3, len(la[::3]))
        lb[1::3] = m + 1 + rng.integers(0, 3, len(lb[1::3]))
    lens = np.stack([la, lb], 1).astype(np.int32)
    dev = torch.device("cuda")
    bt = torch.from_numpy(b).to(dev)
    if broadcast:
        bt = bt.expand(B, m)
    return (torch.from_numpy(a).to(dev), bt, torch.from_numpy(lens).to(dev))


def sw_tie_inputs(B, unit, reps, seed):
    """Local ties in two rows and across strips: a query of a random
    ``unit`` of C, G, T twice, 2 * unit + 8 A's apart (bridging them costs
    more than a unit scores), against a target of the unit ``reps`` times;
    so the local maximum 2 * unit ends in rows unit and the query's end, at
    every repeat of the unit. Lengths cut at random in half the pairs."""
    import torch
    rng = np.random.default_rng(seed)
    u = rng.integers(1, 4, unit).astype(np.int8)
    q = np.concatenate([u, np.zeros(2 * unit + 8, np.int8), u])
    a = np.tile(q, (B, 1))
    b = np.tile(u, (B, reps))
    n, m = a.shape[1], b.shape[1]
    la = np.full(B, n)
    lb = np.full(B, m)
    la[1::2] = rng.integers(unit, n + 1, B // 2)
    lb[1::4] = rng.integers(unit, m + 1, len(lb[1::4]))
    lens = np.stack([la, lb], 1).astype(np.int32)
    dev = torch.device("cuda")
    return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.from_numpy(lens).to(dev))


def same_sw(k, plain, where: str) -> float:
    """Hold the kernel's ``ForwardResult`` against the plain version's
    ``(dir rows 1..n, rec)``: raises on any differing byte or record field,
    returns the largest score difference."""
    import torch
    from repro_torch.core.pairwise import boundary_row
    rows, rec = plain
    m = rows.shape[2] - 1
    pairs = (("dirs row 0", k.dirs[:, 0],
              boundary_row(m, rows.device).expand(rows.shape[0], m + 1)),
             ("dirs", k.dirs[:, 1:], rows), ("score", k.score, rec[:, 0]),
             ("start_i", k.start_i, rec[:, 1].to(torch.int32)),
             ("start_j", k.start_j, rec[:, 2].to(torch.int32)),
             ("start_state", k.start_state, rec[:, 3].to(torch.int32)))
    for name, x, y in pairs:
        if not torch.equal(x, y):
            fail(f"gotoh_forward {name} differs at {where}: "
                 f"{int((x != y).sum())} elements")
    return float((k.score - rec[:, 0]).abs().max()) if rec.shape[0] else 0.0


def hold_sw(a, b, lens, sub, go, where: str) -> float:
    """Kernel vs plain version, global and local; raises on any differing
    byte or record field, returns the largest score difference."""
    from repro_torch.kernels.sw import ops, ref
    err = 0.0
    for local in (False, True):
        k = ops.gotoh_forward(a, b, lens, sub, gap_open=go, gap_extend=1,
                              local=local)
        p = ref.gotoh_forward_ref(a, b, lens, sub, gap_open=go, gap_extend=1,
                                  local=local)
        err = max(err, same_sw(k, p, f"{where} local={local}"))
        del k, p
    print(f"gotoh_forward exact vs plain: {where} (global, local)")
    return err


def check_sw(B, n, m, *, seed, broadcast=False, ragged=False,
             protein=False, over=False):
    """Kernel vs plain version at a random case: DNA at gap 3, or
    ``protein`` (BLOSUM62, 21 codes and 2 past them, gap 11)."""
    import torch
    from repro_torch.core import alphabet as ab
    a, b, lens = sw_inputs(B, n, m, seed=seed, broadcast=broadcast,
                           ragged=ragged, n_chars=23 if protein else 5,
                           over=over)
    sub = torch.as_tensor(ab.blosum62() if protein else ab.dna_matrix(),
                          dtype=torch.float32, device="cuda")
    return hold_sw(a, b, lens, sub, 11 if protein else 3,
                   f"B={B} n={n} m={m} broadcast={broadcast} "
                   f"ragged={ragged} protein={protein} over={over}")


def sw_checks() -> float:
    """Kernel 1 at the first design's cases and the strip layout's edges
    (``ops.strip_layout``: strips of at most W = 32 ``ops.MAX_COLS``
    columns)."""
    import torch
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels.sw import ops
    W = 32 * ops.MAX_COLS
    err = max(check_sw(16384, 64, 64, seed=1),
              check_sw(64, 2048, 1460, seed=2, broadcast=True),
              check_sw(12, 37, 53, seed=3, ragged=True),
              # m + 1 at a strip edge -1, at it, +1 (one and two strips)
              check_sw(13, 70, W - 2, seed=30, ragged=True),
              check_sw(13, 70, W - 1, seed=31, over=True),
              check_sw(13, 70, W, seed=32, broadcast=True),
              check_sw(9, 40, 2 * W - 2, seed=33),
              check_sw(9, 40, 2 * W - 1, seed=34, ragged=True),
              check_sw(9, 40, 2 * W, seed=35, over=True),
              # past the first design's 16,383 columns
              check_sw(5, 30, 20000, seed=36, ragged=True),
              check_sw(3, 60, 16384, seed=37, broadcast=True),
              # n >> m and m >> n; B not a multiple of the pairs a CTA
              check_sw(7, 3000, 20, seed=38, ragged=True),
              check_sw(7, 20, 3000, seed=39, ragged=True),
              check_sw(1, 5, 0, seed=40), check_sw(2, 0, 5, seed=41),
              check_sw(4101, 33, 300, seed=42),
              # protein: BLOSUM62, gap 11, codes past the table
              check_sw(50, 300, 280, seed=43, protein=True, ragged=True),
              check_sw(21, 150, 700, seed=44, protein=True, broadcast=True))
    dna = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32, device="cuda")
    for unit, reps in ((48, 12), (40, 20), (5, 80)):
        a, b, lens = sw_tie_inputs(6, unit, reps, seed=unit)
        err = max(err, hold_sw(a, b, lens, dna, 3,
                               f"local ties: unit {unit} twice, {reps} "
                               f"repeats in the target"))
    return err


def call_peak(fn) -> int:
    """Device bytes one call of ``fn`` allocates above what was in use."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def time_sw(inputs):
    """Time the kernel and its plain version on the inputs a path gave it
    and hold the two outputs bit-exact; returns (timings with the launch
    plan, registers, spills and the call's own device peak, largest score
    error)."""
    from repro_torch.kernels.sw import ops, ref
    a, b, lens, sub, kw = inputs
    B, n = a.shape
    m = b.shape[1]
    broadcast = B > 1 and b.stride(0) == 0
    where = (f"path inputs B={B} n={n} m={m} broadcast={broadcast} "
             f"local={kw['local']}")
    ms, k = cuda_ms(lambda: ops.gotoh_forward(a, b, lens, sub, **kw))
    plain_ms, p = cuda_ms(
        lambda: ref.gotoh_forward_ref(a, b, lens, sub, **kw), reps=1)
    err = same_sw(k, p, where)
    del k, p
    print(f"gotoh_forward exact vs plain at the {where}")
    cells = B * n * (m + 1)
    nbytes = cells + B * n + (m if broadcast else B * m) + B * 8 + B * 32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * SW_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    S = sub.shape[0]
    plan = ops.sw_plan(B, n, m, ops.resident_ctas(a.device, m, kw["local"],
                                                  S))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, pairs_per_cta=ops.PAIRS_PER_CTA,
                **plan._asdict(),
                **ops.sw_kernel_attrs(m, kw["local"], S),
                call_peak_bytes=call_peak(
                    lambda: ops.gotoh_forward(a, b, lens, sub, **kw))), err


# ------------------------------------------------------------------ kernel 2

# (N, M, L, symmetric, n_chars, gap, codes from lo to hi - 1): every route
# and load width of kernel 2. Tensor cores: the main-path shape, symmetric;
# split L (4,096 x 64); N not a multiple of the tile with L % 16 == 1
# (byte loads); codes below 0 and above n_chars with L % 4 == 0; protein;
# the gap inside the alphabet (a plane skipped); L past 16,352 (split by the
# accumulator's field). Skinny: M = 1, N = 1, a short side of 5 and 8, a
# symmetric call of 7 rows. SIMD: n_chars above the tensor-core maximum.
MV_CASES = (
    (4096, 4096, 6344, True, 5, 5, 0, 6),
    (4096, 64, 6344, False, 5, 5, 0, 6),
    (1000, 1000, 1441, True, 5, 5, 0, 6),
    (300, 200, 1444, False, 5, 5, -3, 9),
    (257, 130, 33, False, 5, 5, 0, 6),
    (1024, 1024, 2000, True, 21, 21, 0, 23),
    (257, 130, 35, False, 21, 21, -2, 24),
    (200, 150, 96, False, 6, 2, 0, 8),
    (256, 256, 20000, True, 5, 5, 0, 6),
    (409, 1, 6344, False, 5, 5, 0, 6),
    (1, 409, 6344, False, 5, 5, -1, 7),
    (5, 300, 33, False, 21, 21, -2, 24),
    (700, 8, 1442, False, 5, 5, 0, 6),
    (7, 7, 100, True, 5, 5, 0, 6),
    (300, 200, 500, False, 40, 40, -3, 45),
    (130, 130, 97, True, 40, 40, 0, 42),
)
# (rows, L, groups, width, n_chars, gap, lo, hi): match_valid_groups with
# ragged groups (an empty one, one of a single row), tensor cores and SIMD
MV_GROUP_CASES = (
    (4096, 6344, 55, 96, 5, 5, 0, 6),
    (1000, 2000, 7, 150, 21, 21, -2, 24),
    (500, 333, 5, 40, 40, 40, 0, 42),
)


def mv_inputs(N, M, L, seed, lo=0, hi=6):
    import torch
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(lo, hi, (N, L)).astype(np.int8))
    b = torch.from_numpy(rng.integers(lo, hi, (M, L)).astype(np.int8))
    return a.cuda(), b.cuda()


def group_index(rows, n_groups, width, seed):
    """(G, width) int64 ragged groups of distinct rows, -1 past each
    group's size: group 0 empty, group 1 one row, the others 2..width."""
    rng = np.random.default_rng(seed)
    index = np.full((n_groups, width), -1, np.int64)
    for g in range(1, n_groups):
        size = 1 if g == 1 else int(rng.integers(2, width + 1))
        index[g, :size] = rng.choice(rows, size=size, replace=False)
    return index


def same_mv(k, plain, where: str) -> float:
    """Hold the kernel's (match, valid) exact against the plain version's;
    returns the largest count difference."""
    import torch
    (km, kv), (pm, pv) = k, plain
    if not (torch.equal(km, pm) and torch.equal(kv, pv)):
        fail(f"match_valid differs at {where}: "
             f"{int((km != pm).sum())} match, {int((kv != pv).sum())} valid")
    return float(max((km - pm).abs().max(), (kv - pv).abs().max()))


def check_mv(N, M, L, sym, n_chars, gap, lo, hi, *, seed):
    from repro_torch.kernels.distance import ops, ref
    a, b = mv_inputs(N, M, L, seed, lo, hi)
    kw = dict(n_chars=n_chars, gap_code=gap)
    rt = ops.route(N, M, n_chars)
    err = same_mv(ops.match_valid(a, None if sym else b, **kw),
                  ref.match_valid_ref(a, a if sym else b, **kw),
                  f"N={N} M={M} L={L} n_chars={n_chars} gap={gap} "
                  f"({rt}{', symmetric' if sym else ''})")
    print(f"match_valid exact vs plain: N={N} M={M} L={L} "
          f"n_chars={n_chars} gap={gap} codes {lo}..{hi - 1}, route {rt}"
          f"{', symmetric' if sym else ''}")
    return err


def check_mv_groups(rows, L, G, S, n_chars, gap, lo, hi, *, seed):
    import torch
    from repro_torch.kernels.distance import ops, ref
    msa, _ = mv_inputs(rows, 1, L, seed, lo, hi)
    index = torch.from_numpy(group_index(rows, G, S, seed)).cuda()
    kw = dict(n_chars=n_chars, gap_code=gap)
    rt = ops.route(S, S, n_chars, groups=True)
    where = (f"groups G={G} S={S} of {rows} rows, L={L}, n_chars={n_chars} "
             f"({rt})")
    err = same_mv(ops.match_valid_groups(msa, index, **kw),
                  ref.match_valid_groups_ref(msa, index, **kw), where)
    print(f"match_valid_groups exact vs plain: {where}")
    return err


def mv_checks() -> float:
    """Every case of MV_CASES and MV_GROUP_CASES held exact against the
    plain version; returns the largest count error."""
    err = 0.0
    for i, case in enumerate(MV_CASES):
        err = max(err, check_mv(*case, seed=40 + i))
    for i, case in enumerate(MV_GROUP_CASES):
        err = max(err, check_mv_groups(*case, seed=60 + i))
    return err


def onehots(x, n_chars, gap_code, dtype):
    """The reference's one-hot planes of int8 rows (..., L), prebuilt:
    (validity (..., L), symbols (..., L * n_chars)) in ``dtype``."""
    import torch
    xl = x.long()
    sym = torch.arange(n_chars, device=x.device)
    valid = ((xl != gap_code) & (xl < n_chars)).to(dtype)
    oh = ((xl[..., None] == sym) & (xl[..., None] != gap_code)).to(dtype)
    return valid, oh.flatten(-2)


def int_mm_ms(a, b, n_chars, gap_code):
    """Device ms of ``torch._int_mm`` on the int8 one-hots (match and
    valid), or None where its shape rules refuse the call."""
    import torch
    if a.shape[0] <= 16 or b.shape[0] % 8 or a.shape[1] % 8:
        return None
    va, oa = onehots(a, n_chars, gap_code, torch.int8)
    vb, ob = onehots(b, n_chars, gap_code, torch.int8)
    try:
        ms, _ = cuda_ms(lambda: (torch._int_mm(oa, ob.T),
                                 torch._int_mm(va, vb.T)))
    except RuntimeError:
        return None
    return ms


def mv_bound(n_pairs, L, in_bytes, out_pairs):
    """Least card time of kernel 2 on the call: 2 int8 operations per pair
    and column at the int8 tensor-core rate, or its bytes (each input read
    once, two int32 outputs written once)."""
    t_bytes = (in_bytes + 2 * 4 * out_pairs) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_pairs * L / INT8_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_mv_inputs(a, b, where: str, *, n_chars=5, gap_code=5):
    """Time the kernel, its plain version and the library yardsticks on the
    inputs (``b`` None: the symmetric call) and hold the kernel exact
    against the plain version; returns (timings, largest count error).
    ``wall_ms``: a call of the wrapper on the host clock, dispatch
    included."""
    import torch
    from repro_torch.kernels.distance import ops, ref
    kw = dict(n_chars=n_chars, gap_code=gap_code)
    bb = a if b is None else b
    N, L = a.shape
    M = bb.shape[0]
    ms, k = cuda_ms(lambda: ops.match_valid(a, b, **kw))
    plain_ms, p = cuda_ms(lambda: ref.match_valid_ref(a, bb, **kw), reps=1)
    err = same_mv(k, p, where)
    del k, p
    rt = ops.route(N, M, n_chars)
    print(f"match_valid exact vs plain at {where} (route {rt})")
    # yardsticks, never called by the port: the match and valid counts as
    # two float32 products of the prebuilt one-hots; torch._int_mm of the
    # int8 one-hots where it takes the shapes
    va, oa = onehots(a, n_chars, gap_code, torch.float32)
    vb, ob = (va, oa) if b is None else onehots(bb, n_chars, gap_code,
                                                torch.float32)
    library_ms, _ = cuda_ms(lambda: (torch.matmul(oa, ob.T),
                                     torch.matmul(va, vb.T)))
    del va, oa, vb, ob
    in_bytes = N * L if b is None else (N + M) * L
    return dict(ms=ms, plain_ms=plain_ms, **mv_bound(N * M, L, in_bytes,
                                                     N * M),
                library_ms=library_ms,
                int_mm_ms=int_mm_ms(a, bb, n_chars, gap_code),
                kernel_route=rt,
                wall_ms=host_ms(lambda: ops.match_valid(a, b, **kw))), err


def time_mv_groups(msa, index, where: str, *, n_chars=5, gap_code=5):
    """``time_mv_inputs`` for a group call; the yardstick is two batched
    float32 products of the groups' prebuilt one-hots."""
    import torch
    from repro_torch.kernels.distance import ops, ref
    kw = dict(n_chars=n_chars, gap_code=gap_code)
    ms, k = cuda_ms(lambda: ops.match_valid_groups(msa, index, **kw))
    plain_ms, p = cuda_ms(lambda: ref.match_valid_groups_ref(msa, index,
                                                             **kw), reps=1)
    err = same_mv(k, p, where)
    del k, p
    G, S = index.shape
    L = msa.shape[1]
    rt = ops.route(S, S, n_chars, groups=True)
    print(f"match_valid_groups exact vs plain at {where} (route {rt})")
    live = (index >= 0)[:, :, None]
    rows = msa[index.clamp(min=0)]
    v, oh = onehots(rows, n_chars, gap_code, torch.float32)
    v, oh = v * live, oh * live
    del rows
    library_ms, _ = cuda_ms(lambda: (torch.bmm(oh, oh.transpose(1, 2)),
                                     torch.bmm(v, v.transpose(1, 2))))
    del v, oh
    real = int((index >= 0).sum())
    return dict(ms=ms, plain_ms=plain_ms, **mv_bound(G * S * S, L, real * L,
                                                     G * S * S),
                library_ms=library_ms, int_mm_ms=None, kernel_route=rt,
                wall_ms=host_ms(lambda: ops.match_valid_groups(msa, index,
                                                               **kw))), err


def time_mv(N, L):
    """Kernel 2 at the main-path shape: the symmetric N x N call at width
    L, as ``core.distance`` makes it."""
    a, _ = mv_inputs(N, 1, L, seed=11)
    return time_mv_inputs(a, None, f"main-path shape N=M={N} L={L}, "
                          "symmetric")


# ------------------------------------------------------------- kernels 3, 4

def banded_inputs(B, n, m, *, seed, broadcast=False, ragged=False,
                  lens=None):
    """Pairs for the banded kernels: targets are mutated, shifted copies
    of the queries (band-sized offsets, so some pairs stay in the band
    and some press its edge). ``lens``: ``"slides"`` for lb >= 3 la (the
    band slides by more than one column a row) with the pairs (1, m), (n,
    1) and (2, m) first; ``"full"`` for la = n in every pair."""
    import torch
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, n)).astype(np.int8)
    b = np.full((1 if broadcast else B, m), 5, np.int8)
    width = min(n, m)
    b[:, :width] = a[: b.shape[0], :width]
    noise = rng.random(b.shape) < 0.1
    b[noise] = rng.integers(0, 4, int(noise.sum()))
    b[:, width:] = rng.integers(0, 4, (b.shape[0], m - width))
    shift = rng.integers(0, 9, b.shape[0])
    b = np.stack([np.roll(r, s) for r, s in zip(b, shift)])
    la = rng.integers(max(n // 2, 0), n + 1, B)
    lb = rng.integers(max(m // 2, 0), m + 1, B)
    if ragged:
        la[: B // 2] = rng.integers(0, 2, B // 2)
        lb[B // 4: B // 4 + B // 2] = rng.integers(0, 2, B // 2)
    if lens == "slides":
        la = rng.integers(1, max(2, n // 3 + 1), B)
        lb = np.minimum(m, 3 * la + rng.integers(0, m, B))
        la[:3], lb[:3] = (1, n, 2), (m, 1, m)
    elif lens == "full":
        la = np.full(B, n)
    dev = torch.device("cuda")
    bt = torch.from_numpy(b).to(dev)
    if broadcast:
        bt = bt.expand(B, m)
    return (torch.from_numpy(a).to(dev), bt,
            torch.from_numpy(np.stack([la, lb], 1).astype(np.int32)).to(dev))


def same_banded(k, plain, where: str) -> float:
    """Hold the kernel's ``BandedForward`` against the plain version's;
    raises on any differing byte or field, returns the largest score
    difference."""
    import torch
    for name in k._fields:
        x, y = getattr(k, name), getattr(plain, name)
        if not torch.equal(x, y):
            fail(f"banded_forward {name} differs at {where}: "
                 f"{int((x != y).sum())} elements")
    return float((k.score - plain.score).abs().max()) if len(k.score) else 0.0


def same_fused(k, plain, where: str, what="banded_fused") -> float:
    """Hold (score, a_row, b_row, aln_len, ok) tuples equal; returns the
    largest score difference."""
    import torch
    for name, x, y in zip(("score", "a_row", "b_row", "aln_len", "ok"),
                          k, plain):
        if not torch.equal(x, y):
            fail(f"{what} {name} differs at {where}: "
                 f"{int((x != y).sum())} elements")
    return float((k[0] - plain[0]).abs().max()) if len(k[0]) else 0.0


def fused_plain(a, b, lens, sub, *, gap_open, gap_extend, band, gap_code=5):
    """The fused kernel's plain version on the card: the plain forward and
    the plain traceback."""
    from repro_torch.kernels.banded import ref
    fwd = ref.banded_forward(a, lens[:, 0], b, lens[:, 1], sub,
                                  gap_open, gap_extend, band=band)
    a_row, b_row, k, ok = ref.banded_traceback(a, b, fwd, gap_code,
                                                    band=band)
    return fwd.score, a_row, b_row, k, ok


def check_banded_inputs(a, b, lens, sub, W, where: str):
    """Kernels 3 and 4 against their plain versions, and kernel 4 against
    kernel 3 + the banded traceback, on one input; returns the largest
    score difference. Kernel 3 must equal the plain forward bit for bit,
    so one plain traceback of that forward is both kernel 4's plain
    version and the traceback of kernel 3's output."""
    from repro_torch.kernels.banded import ops, ref
    kw = dict(gap_open=3, gap_extend=1, band=W)
    k3 = ops.banded_forward(a, b, lens, sub, **kw)
    fwd = ref.banded_forward(a, lens[:, 0], b, lens[:, 1], sub, 3, 1,
                             band=W)
    err = same_banded(k3, fwd, where)
    plain = (fwd.score, *ref.banded_traceback(a, b, fwd, 5, band=W))
    k4 = ops.banded_pairs_fused(a, b, lens, sub, **kw)
    return max(err, same_fused(k4, plain, where))


def check_banded(B, n, m, W, *, seed, broadcast=False, ragged=False,
                 lens=None):
    import torch
    from repro_torch.core import alphabet as ab
    a, b, ln = banded_inputs(B, n, m, seed=seed, broadcast=broadcast,
                             ragged=ragged, lens=lens)
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32,
                          device="cuda")
    where = (f"B={B} n={n} m={m} W={W} broadcast={broadcast} "
             f"ragged={ragged} lens={lens or 'typical'}")
    err = check_banded_inputs(a, b, ln, sub, W, where)
    print(f"banded_forward and banded_fused exact vs plain, fused == "
          f"forward + traceback: {where}")
    return err


def wide_banded_checks():
    """Kernels 3 and 4 past W = 1,024 (the wide route, a pair a CTA): W
    not a power of two, up to the limit 16,384; ragged lengths, a broadcast
    target, slides above one column a row with la = 1 against lb = m, and
    bands covering every column. The plain version runs a host loop of
    rows and steps, so B and n stay small at the widest W."""
    return (check_banded(5, 60, 900, 1025, seed=30, lens="slides"),
            check_banded(6, 300, 400, 1536, seed=31, ragged=True),
            check_banded(7, 200, 1500, 2048, seed=32, broadcast=True,
                         lens="slides"),
            check_banded(9, 1500, 1500, 2048, seed=33),
            check_banded(6, 400, 3000, 4096, seed=34, ragged=True),
            check_banded(4, 120, 6000, 8192, seed=35, lens="slides"),
            check_banded(5, 300, 2000, 8192, seed=36, broadcast=True,
                         ragged=True),
            check_banded(3, 150, 8000, 16384, seed=37, lens="slides"),
            check_banded(3, 500, 600, 16384, seed=38, ragged=True))


def band_cells(lens, W: int) -> int:
    """Band cells inside the matrix that pairs of lengths ``lens`` (B, 2)
    need: for each live row i in 1..la, the columns of the row's band
    [lo_i, lo_i + W) that lie in 0..lb (``ref.band_lo``). Cells of the
    band outside the matrix change no score and no row."""
    lens = np.asarray(lens.cpu() if hasattr(lens, "cpu") else lens,
                      dtype=np.int64)
    la, lb = lens[:, 0], lens[:, 1]
    live = la > 0
    la, lb = la[live], lb[live]
    total = 0
    for c in range(0, len(la), 256):        # rows of 256 pairs at a time
        a, b = la[c:c + 256], lb[c:c + 256]
        pair = np.repeat(np.arange(len(a)), a)
        i = np.arange(len(pair)) - np.repeat(np.cumsum(a) - a, a) + 1
        lo = i * b[pair] // a[pair] - W // 2
        hi = np.minimum(lo + W - 1, b[pair])
        total += int(np.maximum(hi - np.maximum(lo, 0) + 1, 0).sum())
    return total


def banded_bound(lens, n, m, W, broadcast, fused):
    """Least time for the banded kernels' work on the H100: the inputs
    read once and the outputs written once (kernel 3: its (B, n, W)
    direction band; kernel 4: two aligned rows) against
    BANDED_OPS_PER_CELL f32 operations per band cell inside the matrix
    (``band_cells``)."""
    B = len(lens)
    inputs = B * n + (m if broadcast else B * m) + B * 8
    outputs = B * 32 + (2 * B * (n + m) if fused else B * n * W)
    t_bytes = (inputs + outputs) / HBM_BYTES_PER_S * 1e3
    t_ops = band_cells(lens, W) * BANDED_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_banded(inputs, *, fused):
    """Time kernel 3 or 4 and its plain version on the inputs a path gave
    it and hold the two outputs bit-exact; returns (timings, error)."""
    from repro_torch.kernels.banded import ops, ref
    a, b, lens, sub, kw = inputs
    B, n = a.shape
    m = b.shape[1]
    broadcast = B > 1 and b.stride(0) == 0
    where = (f"path inputs B={B} n={n} m={m} W={kw['band']} "
             f"broadcast={broadcast}")
    extra = {}
    if fused:
        ms, k = cuda_ms(lambda: ops.banded_pairs_fused(a, b, lens, sub, **kw))
        plain_ms, p = cuda_ms(lambda: fused_plain(a, b, lens, sub, **kw),
                              reps=1)
        err = same_fused(k, p, where)
        plan = ops.fused_plan(B, n, m, kw["band"], ops.resident_ctas(
            a.device, kw["band"], sub.shape[0]))
        extra = dict(placement="workspace",
                     pairs_per_cta=ops.pairs_per_cta(kw["band"]),
                     grid=plan.grid, workspace_bytes=plan.workspace_bytes,
                     **ops.fused_kernel_attrs(kw["band"], sub.shape[0]))
    else:
        ms, k = cuda_ms(lambda: ops.banded_forward(a, b, lens, sub, **kw))
        plain_ms, p = cuda_ms(lambda: ref.banded_forward(
            a, lens[:, 0], b, lens[:, 1], sub, kw["gap_open"],
            kw["gap_extend"], band=kw["band"]), reps=1)
        err = same_banded(k, p, where)
    del k, p
    name = "banded_fused" if fused else "banded_forward"
    print(f"{name} exact vs plain at the {where}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                **banded_bound(lens, n, m, kw["band"], broadcast, fused),
                **extra), err


# ----------------------------------------------------------------- main path

def stage_seconds(names):
    from repro_torch.obs import trace
    stages = {}
    for rec in trace.TRACER.spans():
        stages[rec.name] = stages.get(rec.name, 0.0) + rec.duration
    return {k: round(stages.get(k, 0.0), 3) for k in names}


def fallback_pairs() -> float:
    """Pairs the align engine re-aligned after a band overflow, so far."""
    from repro_torch.obs import metrics
    fam = metrics.REGISTRY.snapshot().get("repro_align_fallback_pairs_total")
    return sum(s["value"] for s in fam["samples"]) if fam else 0.0


class Observe:
    """Reset the kernel launch counts, then watch a path's calls (not
    altering them): kernel 1's shapes, the inputs of each kernel's largest
    call (kernel 1's for each mode and target form), the band-overflow
    fallbacks, and the peak device memory of the path's stages
    (each stage's own peak; the run's peak is the largest of them and of
    the memory peaks between stages). With ``tree=True`` also kernel 2's
    largest call in each role and the tree engine's result."""

    def __init__(self, tree: bool = False):
        from repro_torch.align.engine import AlignEngine
        from repro_torch.core import msa
        from repro_torch.kernels.banded import ops as bd_ops
        from repro_torch.kernels.distance import ops as mv_ops
        from repro_torch.kernels.sw import ops as sw_ops
        from repro_torch.phylo.engine import TreeEngine
        from repro_torch.search.engine import SearchEngine
        self.mods = (sw_ops, mv_ops, bd_ops)
        self.sw_shapes = []
        self.largest = {}
        self.mv_largest = {}
        self.tree_result = None
        self.stage_peaks = {}
        self.running = 0
        self.targets = [
            (sw_ops, "gotoh_forward", self._keep("gotoh_forward")),
            (bd_ops, "banded_forward", self._keep("banded_forward")),
            (bd_ops, "banded_pairs_fused", self._keep("banded_fused")),
            (msa, "map1_align_to_center", self._stage("map1")),
            (msa, "assemble_center_star", self._stage("assemble")),
            (SearchEngine, "seed_counts", self._stage("search.seed")),
            (AlignEngine, "align_pairs", self._stage("align_pairs"))]
        if tree:
            self.targets += [(mv_ops, "match_valid", self._keep_mv),
                             (mv_ops, "match_valid_groups",
                              self._keep_mv_groups),
                             (TreeEngine, "build", self._keep_tree)]

    def _keep(self, name):
        """Wrap a kernel wrapper: keep a copy of the inputs of its largest
        call for each role (mode and target form)."""
        def wrap(fn):
            def wrapped(a, b, lens, sub, **kw):
                broadcast = b.shape[0] > 1 and b.stride(0) == 0
                role = "broadcast target" if broadcast else "per-pair targets"
                if name == "gotoh_forward":
                    self.sw_shapes.append((a.shape[0], a.shape[1], b.shape[1],
                                           broadcast, kw["local"]))
                    role = ("local, " if kw["local"] else "global, ") + role
                size = a.shape[0] * a.shape[1] * max(b.shape[1], 1)
                if size > self.largest.get((name, role), (0,))[0]:
                    own = (b[:1].clone().expand(b.shape) if broadcast
                           else b.clone())
                    self.largest[(name, role)] = (
                        size, (a.clone(), own, lens.clone(), sub.clone(),
                               dict(kw)))
                return fn(a, b, lens, sub, **kw)
            return wrapped
        return wrap

    def _keep_mv(self, fn):
        """Wrap kernel 2's wrapper: keep a host copy of the inputs of its
        largest call in each role (single-column calls, else the span it
        ran in), off the card so that later runs' peaks do not see it."""
        from repro_torch.obs import trace

        def wrapped(a, b=None, **kw):
            role = ("M=1" if b is not None and b.shape[0] == 1
                    else trace.current_span_name() or "-")
            size = a.shape[0] * (a if b is None else b).shape[0] * a.shape[1]
            if size > self.mv_largest.get(role, (0,))[0]:
                self.mv_largest[role] = (size, ("pairs", a.cpu(), None if b
                                                is None else b.cpu(),
                                                dict(kw)))
            return fn(a, b, **kw)
        return wrapped

    def _keep_mv_groups(self, fn):
        """Wrap kernel 2's group wrapper: keep a host copy of the inputs
        of its largest call (role "groups")."""
        def wrapped(msa, index, **kw):
            size = index.numel() * index.shape[1] * msa.shape[1]
            if size > self.mv_largest.get("groups", (0,))[0]:
                self.mv_largest["groups"] = (size, ("groups", msa.cpu(),
                                                    index.cpu(), dict(kw)))
            return fn(msa, index, **kw)
        return wrapped

    def _keep_tree(self, fn):
        """Wrap the tree engine's ``build``: keep its result and its own
        peak device memory (stage ``tree``)."""
        build = self._stage("tree")(fn)

        def wrapped(engine, *args, **kw):
            self.tree_result = build(engine, *args, **kw)
            return self.tree_result
        return wrapped

    def _stage(self, name):
        import torch

        def wrap(fn):
            def wrapped(*args, **kw):
                torch.cuda.synchronize()
                self.running = max(self.running, device_peak())
                reset_peak()
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.synchronize()
                    peak = device_peak()
                    self.stage_peaks[name] = max(
                        self.stage_peaks.get(name, 0), peak)
                    self.running = max(self.running, peak)
            return wrapped
        return wrap

    def __enter__(self):
        import torch
        sw_ops, mv_ops, bd_ops = self.mods
        self.saved = [(obj, attr, getattr(obj, attr))
                      for obj, attr, _ in self.targets]
        for (obj, attr, wrap), (_, _, fn) in zip(self.targets, self.saved):
            setattr(obj, attr, wrap(fn))
        sw_ops.launches = mv_ops.launches = 0
        for rt in mv_ops.route_launches:
            mv_ops.route_launches[rt] = 0
        bd_ops.forward_launches = bd_ops.fused_launches = 0
        self.fallbacks0 = fallback_pairs()
        torch.cuda.synchronize()
        reset_peak()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        sw_ops, mv_ops, bd_ops = self.mods
        self.launches = {"gotoh_forward": sw_ops.launches,
                         "match_valid": mv_ops.launches,
                         "banded_forward": bd_ops.forward_launches,
                         "banded_fused": bd_ops.fused_launches}
        self.mv_routes = dict(mv_ops.route_launches)
        for obj, attr, fn in self.saved:
            setattr(obj, attr, fn)
        self.fallbacks = int(fallback_pairs() - self.fallbacks0)
        self.peak_gib = max(self.running, device_peak()) / 2**30
        return False

    def peaks(self) -> str:
        """The run's and its stages' peak device memory, in GiB."""
        stages = ", ".join(f"{k} {v / 2**30:.3f}"
                           for k, v in sorted(self.stage_peaks.items()))
        return f"{self.peak_gib:.3f} GiB (stage peaks: {stages})"

    def calls(self):
        """((kernel, role), size, inputs) of each kept largest call."""
        return [(key, size, inputs) for key, (size, inputs)
                in sorted(self.largest.items())]


def check_msa(out: Path, fam, backend: str, need_fallbacks: bool = True):
    """The run's aligned FASTA, tree and report are right; returns (rows,
    report). ``need_fallbacks``: the family is diverged enough that some
    k-mer chains fail, so kernel 1 also runs its full-DP role."""
    from repro_torch.data import read_fasta
    names, rows = read_fasta(out / "aligned.fasta")
    if names != fam.names:
        fail("aligned.fasta names differ from the input")
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        fail("aligned.fasta rows have different widths")
    if any(r.replace("-", "") != s for r, s in zip(rows, fam.seqs)):
        fail("an ungapped aligned row differs from its input sequence")
    if width < max(map(len, fam.seqs)):
        fail(f"MSA width {width} below the longest input")
    nwk = (out / "tree.nwk").read_text().strip()
    leaves = re.findall(r"[(,]([^(),:;]+):", nwk)
    if (not nwk.endswith(";") or nwk.count("(") != nwk.count(")")
            or sorted(leaves) != sorted(fam.names)):
        fail(f"tree.nwk does not parse with {len(fam.names)} leaves "
             f"({len(leaves)} found)")
    report = json.loads((out / "report.json").read_text())
    if not math.isfinite(report["avg_sp_penalty"]):
        fail(f"avg_sp_penalty {report['avg_sp_penalty']} is not finite")
    if need_fallbacks and not report["kmer_fallbacks"] > 0:
        fail("no k-mer fallback: the full-DP role of kernel 1 was not run")
    if report["backend"] != backend or report["width"] != width:
        fail(f"report disagrees with the run: {report}")
    return rows, report


MSA_STAGES = ("load", "encode", "center", "map1", "assemble", "write",
              "score", "tree.distance", "tree.nj", "msa_run")


def run_msa(fam, fasta: Path, out: Path, label: str, flags, backend: str,
            kernels, stages=MSA_STAGES, need_fallbacks=True, tree=False):
    """One ``msa_run`` with the launch counts reset just before it; checks
    its outputs and that each of ``kernels`` was launched."""
    from repro_torch.launch import msa_run
    from repro_torch.obs import trace
    trace.TRACER.clear()
    t0 = time.time()
    with Observe(tree=tree) as obs:
        msa_run.main(["--fasta", str(fasta), "--out", str(out), *flags])
    wall = time.time() - t0
    print(f"{label} stage seconds: {json.dumps(stage_seconds(stages))} "
          f"(wall {wall:.2f} s)")
    print(f"{label} peak device memory: {obs.peaks()}")
    print(f"{label} kernel launches: {json.dumps(obs.launches)} "
          f"(match_valid by route {json.dumps(obs.mv_routes)}); "
          f"gotoh_forward shapes (B, n, m, broadcast, local): "
          f"{sorted(set(obs.sw_shapes))}")
    rows, report = check_msa(out, fam, backend, need_fallbacks)
    for name in kernels:
        if obs.launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {label}")
    print(f"{label} outputs ok: width {report['width']}, "
          f"{report['kmer_fallbacks']} k-mer fallbacks, "
          f"{obs.fallbacks} band-overflow fallbacks, avg SP "
          f"{report['avg_sp_penalty']}")
    return obs, rows, report


def simulate(n_leaves: int, indel: float = 0.001):
    from repro_torch.data import SimConfig, simulate_family
    t0 = time.time()
    fam = simulate_family(SimConfig(n_leaves=n_leaves, root_len=1440,
                                    branch_sub=0.01, branch_indel=indel,
                                    seed=1))
    print(f"simulated {n_leaves} Phi_RNA-shaped sequences, lengths "
          f"{min(map(len, fam.seqs))}..{max(map(len, fam.seqs))}, in "
          f"{time.time() - t0:.1f} s")
    return fam


# -------------------------------------------------------------- search path

SEARCH_STAGES = ("index", "search.seed", "search.rescore", "search",
                 "search_run")


def run_search(work: Path, db, queries, label: str, flags, kernels):
    """One ``search_run`` with the launch counts reset just before it;
    checks its outputs and that each of ``kernels`` was launched."""
    from repro_torch.launch import search_run
    from repro_torch.obs import trace
    out = work / label.replace(" ", "_")
    trace.TRACER.clear()
    t0 = time.time()
    with Observe() as obs:
        search_run.main(["--db", str(db), "--query", str(queries),
                         "--index", str(work / "db.idx.npz"),
                         "--out", str(out), *flags])
    wall = time.time() - t0
    hits = json.loads((out / "hits.json").read_text())
    st = hits["stats"]
    print(f"search {label}: stage seconds "
          f"{json.dumps(stage_seconds(SEARCH_STAGES))} (wall {wall:.2f} s), "
          f"peak device memory {obs.peaks()}, survival "
          f"{st['survival']}, candidates {st['candidates']}, band "
          f"fallbacks {obs.fallbacks}, align calls "
          f"{st['align_calls']}, kernel launches {json.dumps(obs.launches)}")
    for q in hits["queries"]:
        if not q["hits"]:
            fail(f"search {label}: query {q['name']} found no hit")
        scores = [h["score"] for h in q["hits"]]
        if scores != sorted(scores, reverse=True) or not all(
                math.isfinite(h["evalue"]) for h in q["hits"]):
            fail(f"search {label}: hits of {q['name']} are not ranked")
    for name in kernels:
        if obs.launches[name] <= 0:
            fail(f"kernel {name} was not launched on search {label}")
    print(f"search {label}: top hits "
          f"{[(q['name'], q['hits'][0]['target'], q['hits'][0]['score']) for q in hits['queries']]}")
    return obs, hits["queries"]


def hold_path_calls(runs):
    """Each kernel on the inputs of the largest call each run gave it (for
    kernel 1, each mode and target form): held bit-exact against its plain
    version again, and timed. Returns (largest error per kernel, timings
    per (run, kernel) as (call size, timings) pairs)."""
    err = dict.fromkeys(("gotoh_forward", "banded_forward", "banded_fused"),
                        0.0)
    timed = {}
    for label, obs in runs:
        for (name, role), size, inputs in obs.calls():
            t, e = (time_sw(inputs) if name == "gotoh_forward" else
                    time_banded(inputs, fused=name == "banded_fused"))
            err[name] = max(err[name], e)
            timed.setdefault((label, name), []).append((size, t))
            print(f"{name} ({role}) on the {label}'s largest call "
                  f"{tuple(inputs[0].shape)} x {inputs[1].shape[1]}: "
                  f"{json.dumps(t)}")
        del obs.largest
    return err, timed


# --------------------------------------------------------------- tree paths

TREE_STAGES = ("load", "tree.distance", "tree.nj", "tree.medoids",
               "tree.assign", "tree.cluster_nj", "tree.stitch", "tree",
               "loglik", "write", "tree_run")


def split_hashes(children, root, n, keys):
    """The non-trivial splits of a tree as 64-bit hashes: a clade hashes
    to the XOR of its leaves' random keys, a split to the smaller of its
    two sides' hashes. Node ids must be topological (children below their
    parent), as NJ, the stitch and the simulator number them."""
    children = np.asarray(children)
    h = np.zeros(children.shape[0], np.uint64)
    size = np.zeros(children.shape[0], np.int64)
    h[:n], size[:n] = keys, 1
    total = np.bitwise_xor.reduce(keys)
    for node in range(n, children.shape[0]):
        c0, c1 = children[node]
        if c0 >= 0:
            h[node] = h[c0] ^ h[c1]
            size[node] = size[c0] + size[c1]
    inner = [v for v in range(n, children.shape[0])
             if v != root and 1 < size[v] < n - 1]
    return {min(int(h[v]), int(total ^ h[v])) for v in inner}


def normalized_rf(tree, true_tree, n) -> float:
    """Robinson-Foulds distance between two trees over leaves 0..n-1,
    over its most, 2 (n - 3)."""
    keys = np.random.default_rng(0).integers(1, 2**63, n, dtype=np.uint64)
    a = split_hashes(tree[0], tree[1], n, keys)
    b = split_hashes(true_tree[0], true_tree[1], n, keys)
    return len(a ^ b) / (2 * max(n - 3, 1))


def run_tree(fasta: Path, out: Path, label: str, flags, n: int, true_tree,
             stages=TREE_STAGES):
    """One ``tree_run`` with the launch counts reset just before it; checks
    its tree and report and that kernel 2 was launched; returns (observer,
    report)."""
    from repro_torch.launch import tree_run
    from repro_torch.obs import trace
    trace.TRACER.clear()
    t0 = time.time()
    with Observe(tree=True) as obs:
        tree_run.main(["--fasta", str(fasta), "--out", str(out), *flags])
    wall = time.time() - t0
    report = json.loads((out / "report.json").read_text())
    res = obs.tree_result
    nwk = (out / "tree.nwk").read_text().strip()
    if (report["n_sequences"] != n or res.n_leaves != n
            or nwk.count(",") != n - 1 or not nwk.endswith(";")):
        fail(f"tree {label}: the tree does not have {n} leaves")
    ll = report.get("log_likelihood")
    if "--tree-ll" in flags and not (ll is not None and math.isfinite(ll)):
        fail(f"tree {label}: log-likelihood {ll} is not finite")
    if obs.launches["match_valid"] <= 0:
        fail(f"kernel match_valid was not launched on the tree {label}")
    nrf = (normalized_rf((res.children, res.root), true_tree, n)
           if true_tree is not None else float("nan"))
    print(f"tree {label}: backend {report['backend']}, stage seconds "
          f"{json.dumps(stage_seconds(stages))} (wall {wall:.2f} s), "
          f"peak device memory {obs.peaks()}, match_valid "
          f"launches {obs.launches['match_valid']} (by route "
          f"{json.dumps(obs.mv_routes)}), logL {ll}, normalized "
          f"RF vs the simulated tree {nrf:.4f}, tile_stats "
          f"{json.dumps(report['tile_stats'])}")
    return obs, report


def same_tree(a, b, what: str) -> None:
    """Two tree runs gave bitwise-equal trees and equal Newick files."""
    (obs_a, out_a), (obs_b, out_b) = a, b
    ra, rb = obs_a.tree_result, obs_b.tree_result
    if not (np.array_equal(ra.children, rb.children)
            and np.array_equal(ra.blen, rb.blen) and ra.root == rb.root):
        fail(f"{what}: the trees differ")
    if (out_a / "tree.nwk").read_bytes() != (out_b / "tree.nwk").read_bytes():
        fail(f"{what}: the Newick files differ")
    print(f"{what}: children, branch lengths and Newick bitwise equal")


def within_strip(report, n: int, label: str) -> None:
    peak = report["tile_stats"]["peak_resident_bytes"]
    if report["backend"] != "tiled" or not 0 < peak <= 128 * n * 4:
        fail(f"tree {label}: backend {report['backend']}, resident peak "
             f"{peak} bytes against one strip of {128 * n * 4}")


def hold_tree_calls(runs) -> float:
    """Kernel 2 on each tree run's largest call in each role (the span it
    ran in; single columns; the per-cluster batch): held exact against its
    plain version and timed beside its yardsticks. Returns the largest
    count error."""
    err = 0.0
    for label, obs in runs:
        calls = obs.mv_largest
        top = max(calls, key=lambda r: calls[r][0])
        for role in sorted(calls):
            what = f"{role}{' (largest)' if role == top else ''}"
            form, x, y, kw = calls[role][1]
            if form == "groups":
                shape = f"{tuple(y.shape)} groups of {tuple(x.shape)} rows"
                t, e = time_mv_groups(x.cuda(), y.cuda(),
                                      f"the tree {label}'s {what} {shape}",
                                      **kw)
            else:
                shape = (f"{tuple(x.shape)} x "
                         f"{'itself' if y is None else tuple(y.shape)}")
                t, e = time_mv_inputs(x.cuda(), None if y is None
                                      else y.cuda(),
                                      f"the tree {label}'s {what} {shape}",
                                      **kw)
            err = max(err, e)
            print(f"match_valid {what} on the tree {label}: {shape}: "
                  f"{json.dumps(t)}")
        obs.mv_largest = {}
    return err


def tree_phases(fam, fasta: Path, work: Path, n_big: int = N_BIG,
                route: str = "cuda", mark=lambda label: None) -> float:
    """Phases 10-12: the tree backends on ``fam``'s alignment from phase 6
    and on ``n_big`` simulated aligned rows, then kernel 2's tree calls
    held against its plain version. Returns the largest count error."""
    from repro_torch.data import write_fasta
    n = len(fam.names)
    # the tree backends at 4,096, on phase 6's alignment
    aligned = work / "out" / "aligned.fasta"
    truth = (fam.children, fam.root)
    tree_runs = {}
    for label, flags in (("dense", ["--backend", "dense"]),
                         ("cluster", ["--backend", "cluster"]),
                         ("tiled", ["--backend", "tiled",
                                    "--row-block", "128"])):
        out = work / f"tree_{label}"
        tree_runs[f"{label} {n}"] = (run_tree(
            aligned, out, f"{label} {n}", [*flags, "--tree-ll"],
            n, truth)[0], out)
    within_strip(json.loads((work / "tree_tiled" / "report.json")
                            .read_text()), n, f"tiled {n}")
    same_tree(tree_runs[f"cluster {n}"], tree_runs[f"tiled {n}"],
              f"cluster and tiled at {n}")
    _, _, treport = run_msa(
        fam, fasta, work / "out_tree", "main path --tree tiled --tree-ll",
        ["--tree", "tiled", "--tree-ll"], route,
        ("gotoh_forward", "match_valid"),
        stages=MSA_STAGES + TREE_STAGES[3:7] + ("loglik",))
    if treport["tree_backend"] != "tiled" or not math.isfinite(
            treport["log_likelihood"]):
        fail(f"msa_run --tree tiled --tree-ll: {treport}")
    print(f"msa_run --tree tiled --tree-ll: logL "
          f"{treport['log_likelihood']}, tile_stats "
          f"{json.dumps(treport['tile_stats'])}")
    mark(10)

    # the tree backends at n_big aligned rows (no indels: no MSA run)
    big = simulate(n_big, indel=0.0)
    big_fa = work / f"phi_rna_{n_big}_aligned.fa"
    write_fasta(big_fa, big.names, big.seqs)
    big_truth = (big.children, big.root)
    del big
    for label, flags in (("auto", ["--backend", "auto"]),
                         ("cluster", ["--backend", "cluster"])):
        out = work / f"tree_{label}_{n_big}"
        obs, report = run_tree(big_fa, out, f"{label} {n_big}", flags,
                               n_big, big_truth)
        tree_runs[f"{label} {n_big}"] = (obs, out)
        if label == "auto":
            within_strip(report, n_big, f"auto {n_big}")
    same_tree(tree_runs[f"auto {n_big}"], tree_runs[f"cluster {n_big}"],
              f"auto (tiled) and cluster at {n_big}")
    mark(11)
    err = hold_tree_calls((label, obs) for label, (obs, _) in
                          tree_runs.items())
    mark(12)
    return err


# ----------------------------------------------------------------- ML paths

N_ML = 384             # msa_run --tree ml: Phi_DNA's shape (cut from 1,024)
N_FLEET = 128          # the tree-search fleet (cut from 256: PERF.md)
FLEET_ROUNDS = 4       # its move rounds (cut from the searcher's 12: PERF.md)
N_BOOT = 100           # tree_run --bootstrap
ML_STAGES = ("map1", "assemble", "write", "score", "tree.distance",
             "tree.medoids", "tree.assign", "tree.cluster_nj", "tree.stitch",
             "ml.fit", "ml.score", "tree.refine", "tree.bootstrap", "tree",
             "msa_run", "tree_run")
FLEET_STAGES = ("tree.distance", "ml.fit", "search.score", "search.round",
                "tree.search", "tree.refine", "tree", "tree_run")


class MLWatch:
    """Keep each ML refinement's input tree and result while a path runs
    (the calls are not altered)."""

    def __enter__(self):
        from repro_torch.phylo import ml
        self.cls, self.saved = ml.MLRefiner, ml.MLRefiner.refine
        self.inputs, self.results = [], []
        saved, watch = self.saved, self

        def refine(refiner, msa, children, blen, root, **kw):
            watch.inputs.append((np.array(children), int(root)))
            watch.results.append(saved(refiner, msa, children, blen, root,
                                       **kw))
            return watch.results[-1]
        self.cls.refine = refine
        return self

    def __exit__(self, *exc):
        self.cls.refine = self.saved
        return False


class BudgetWatch:
    """Every scoring (``ml.score_trees``: NNI candidates and the search
    fleet) and bootstrap (``ml.replicate_trees``) call while a phase runs:
    the device memory it takes above what was allocated when it began,
    which must stay within its ``budget`` (``ml.MEMORY_BUDGET``)."""

    def __enter__(self):
        from repro_torch.phylo import ml, treesearch
        self.used = {"score": 0, "bootstrap": 0}
        self.calls = {"score": 0, "bootstrap": 0}
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (ml, "score_trees"), (treesearch, "score_trees"),
            (ml, "replicate_trees"))]
        for mod, name, fn in self.saved:
            kind = "score" if name == "score_trees" else "bootstrap"
            setattr(mod, name, self._wrap(kind, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def _wrap(self, kind: str, fn):
        import torch
        from repro_torch.phylo import ml

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            _PEAK_CARRY[0] = device_peak()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            used = torch.cuda.max_memory_allocated() - base
            _PEAK_CARRY[0] = device_peak()
            budget = kw.get("budget", ml.MEMORY_BUDGET)
            if used > budget:
                fail(f"a {kind} call took {used / 2**30:.3f} GiB of device "
                     f"memory, over its budget of {budget / 2**30:.3f} GiB")
            self.used[kind] = max(self.used[kind], used)
            self.calls[kind] += 1
            return out
        return wrapped

    def report(self) -> str:
        from repro_torch.phylo import ml
        return ", ".join(
            f"{k}: {self.calls[k]} calls, largest {self.used[k] / 2**30:.3f} "
            f"GiB" for k in self.used) + \
            f" (budget {ml.MEMORY_BUDGET / 2**30:.3f} GiB each)"


def hold_loglik(msa, res, card: str = "cuda") -> None:
    """The pruning logL and its branch-length gradient at the refined
    tree, on the card against the port's CPU result: logL at rtol 1e-5,
    the gradient within 1e-3 of its largest component."""
    import torch
    from repro_torch.core import likelihood as lik
    from repro_torch.phylo import models
    pat, w = lik.compress_patterns(msa)
    n = msa.shape[0]
    order = np.arange(n, 2 * n - 1)
    got = {}
    for dev in (card, "cpu"):
        dec = models.decompose(res.model, torch.from_numpy(res.params).to(dev))
        bl = torch.from_numpy(res.blen).to(dev).requires_grad_(True)
        t0 = time.time()
        ll = lik.pruning_log_likelihood(
            torch.from_numpy(pat).to(dev), torch.from_numpy(w).to(dev),
            res.children, bl, order, res.root, *dec, site_chunk=2048)
        ll.backward()
        got[dev] = (float(ll.detach()), bl.grad.cpu().numpy(),
                    time.time() - t0)
    (lc, gc, tc), (lp, gp, tp) = got[card], got["cpu"]
    rel = abs(lc - lp) / abs(lp)
    gerr = float(np.abs(gc - gp).max() / np.abs(gp).max())
    if not (rel <= 1e-5 and gerr <= 1e-3):
        fail(f"pruning logL on the card {lc} vs CPU {lp} (rel {rel:.2e}), "
             f"gradient error {gerr:.2e} of its largest component")
    print(f"pruning logL + gradient at the refined tree ({res.model}, "
          f"{pat.shape[1]} patterns): card {lc} vs CPU {lp}, rel {rel:.2e}, "
          f"gradient error {gerr:.2e} of the largest component (card "
          f"{tc:.3f} s, CPU {tp:.3f} s, first call)")


def hold_fit(msa, res, card: str = "cuda", steps: int = 2) -> None:
    """``ml._fit`` from the refined tree: on the card (one step captured
    as a CUDA graph, replayed) against the CPU's eager steps. Adam's
    bias correction rounds differently on the two (device tensors vs
    host floats), so the fitted logL is held at rtol 1e-5."""
    import torch
    from repro_torch.core import likelihood as lik
    from repro_torch.phylo import ml
    pat, w = lik.compress_patterns(msa)
    n = msa.shape[0]
    order = np.arange(n, 2 * n - 1)
    got = {}
    for dev in (card, "cpu"):
        t0 = time.time()
        _, _, ll = ml._fit(torch.from_numpy(pat).to(dev),
                           torch.from_numpy(w).to(dev), res.children, order,
                           res.root, res.blen, res.params, model=res.model,
                           steps=steps, lr=0.05, site_chunk=2048)
        got[dev] = (float(ll), time.time() - t0)
    (lc, tc), (lp, tp) = got[card], got["cpu"]
    rel = abs(lc - lp) / abs(lp)
    if not rel <= 1e-5:
        fail(f"{steps}-step fit on the card {lc} vs CPU {lp} (rel {rel:.2e})")
    print(f"{steps}-step fit from the refined tree: card (graph) {lc} vs CPU "
          f"(eager) {lp}, rel {rel:.2e} (card {tc:.3f} s with its capture, "
          f"CPU {tp:.3f} s)")


def check_supports(res, nwk: str, n: int) -> int:
    """Every internal non-trivial edge of the tree carries a finite support
    in [0, 1], and the Newick carries one label per supported node;
    returns the number of labelled nodes."""
    children, root, sup = res.children, res.root, res.support
    size = np.zeros(children.shape[0], np.int64)
    size[:n] = 1
    for v in range(n, children.shape[0]):
        size[v] = size[children[v, 0]] + size[children[v, 1]]
    for v in range(n, children.shape[0]):
        if v != root and 1 < size[v] < n - 1:
            if not (np.isfinite(sup[v]) and 0.0 <= sup[v] <= 1.0):
                fail(f"node {v} (clade of {size[v]}) has support {sup[v]}")
    labels = re.findall(r"\)([0-9.]+)[:;]", nwk)
    if len(labels) != int(np.isfinite(sup).sum()) or not labels:
        fail(f"tree.nwk carries {len(labels)} support labels, the tree "
             f"{int(np.isfinite(sup).sum())} finite supports")
    return len(labels)


def fleet_run(msa, label: str, card: str, **kw):
    """One ``TreeSearcher`` run on the card; returns (result, peak GiB,
    wall seconds)."""
    import torch
    from repro_torch.obs import trace
    from repro_torch.phylo.treesearch import TreeSearcher
    trace.TRACER.clear()
    torch.cuda.synchronize()
    reset_peak()
    t0 = time.time()
    res = TreeSearcher(gap_code=5, device=card, **kw).search(msa)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = device_peak() / 2**30
    print(f"fleet {label}: stage seconds "
          f"{json.dumps(stage_seconds(FLEET_STAGES))} (wall {wall:.2f} s), "
          f"peak device memory {peak:.3f} GiB")
    return res, peak, wall


def fleet_phase(msa, names, work: Path, card: str = "cuda") -> None:
    """Phase 15: the fleet uninterrupted, killed at round 2, resumed —
    as a user runs it: the searcher turns on deterministic algorithms
    and the cuBLAS workspace configuration itself, after cuBLAS has
    started in the earlier phases — the resumed tree bitwise equal to the
    uninterrupted one; then ``tree_run --refine search --restartable
    --search-rounds 4`` once."""
    import shutil

    import torch
    from repro_torch.core import treeio
    from repro_torch.data import write_fasta
    for d in ("fleet_clean", "fleet_killed"):
        shutil.rmtree(work / d, ignore_errors=True)

    def kill(step):
        if step == 2:
            raise RuntimeError("killed at round 2")

    if torch.are_deterministic_algorithms_enabled():
        fail("deterministic algorithms are on before the fleet runs")
    clean, _, _ = fleet_run(msa, "uninterrupted", card,
                            ckpt_dir=str(work / "fleet_clean"),
                            rounds=FLEET_ROUNDS)
    try:
        fleet_run(msa, "killed", card, ckpt_dir=str(work / "fleet_killed"),
                  failure_hook=kill, rounds=FLEET_ROUNDS)
        fail("the fleet's failure hook did not stop the run")
    except RuntimeError as e:
        if "killed at round 2" not in str(e):
            raise
        print("fleet killed at round 2 (a non-StepFailure error)")
    resumed, _, _ = fleet_run(msa, "resumed", card,
                              ckpt_dir=str(work / "fleet_killed"),
                              resume=True, rounds=FLEET_ROUNDS)
    if torch.are_deterministic_algorithms_enabled():
        fail("the searcher left deterministic algorithms on")
    nwk = [treeio.to_newick(r.children, r.blen, r.root, names)
           for r in (clean, resumed)]
    if not (np.array_equal(clean.children, resumed.children)
            and np.array_equal(clean.blen, resumed.blen)
            and clean.root == resumed.root
            and clean.logl_final == resumed.logl_final
            and np.array_equal(clean.trajectories, resumed.trajectories,
                               equal_nan=True)
            and np.array_equal(clean.n_moves, resumed.n_moves)
            and nwk[0] == nwk[1]):
        fail("the resumed fleet differs from the uninterrupted one")
    print(f"fleet: the resumed tree, lengths, logL, trajectories and Newick "
          f"are bitwise equal to the uninterrupted run's "
          f"(model {clean.model}, best start {clean.best_start} "
          f"{clean.start_labels[clean.best_start]}, logL "
          f"{clean.logl_init} -> {clean.logl_final}, moves (nni, spr) per "
          f"start {clean.n_moves.tolist()})")
    print(f"fleet per-start trajectories: "
          f"{json.dumps(np.round(clean.trajectories, 3).tolist())}; round "
          f"seconds {json.dumps(np.round(clean.round_seconds, 3).tolist())}")

    fasta = work / f"phi_dna_{len(names)}_aligned.fa"
    from repro_torch.core import alphabet as ab
    write_fasta(fasta, names, [ab.DNA.decode(r) for r in msa])
    _, rep = run_tree(fasta, work / "tree_search", f"search {len(names)}",
                      ["--refine", "search", "--restartable",
                       "--search-rounds", "4"], len(names),
                      None, stages=FLEET_STAGES)
    if not rep["backend"].endswith("+search") or not Path(
            rep["search"]["ckpt_dir"]).is_dir():
        fail(f"tree_run --refine search --restartable: {rep['backend']}, "
             f"{rep['search']['ckpt_dir']}")
    print(f"tree_run --refine search --restartable: best start "
          f"{rep['search']['best_start']}, logL {rep['logl']}, moves "
          f"{rep['search']['n_moves']}")


def ml_phases(work: Path, route: str = "cuda", mark=lambda label: None):
    """Phases 13-16, every scoring and bootstrap call held within its
    memory budget; returns the observer of phase 13's ``msa_run``."""
    with BudgetWatch() as budget:
        obs = _ml_phases(work, route, mark)
    if not all(budget.calls.values()):
        fail(f"phases 13-16 made no scoring or no bootstrap call: "
             f"{budget.calls}")
    print(f"scoring and bootstrap device memory above each call's start: "
          f"{budget.report()}")
    return obs


def _ml_phases(work: Path, route: str, mark):
    from repro_torch.core import alphabet as ab
    from repro_torch.data import phi_dna, write_fasta
    from repro_torch.phylo import TreeEngine, models
    t0 = time.time()
    fam = phi_dna(N_ML // 16)
    print(f"simulated {N_ML} Phi_DNA-shaped sequences, lengths "
          f"{min(map(len, fam.seqs))}..{max(map(len, fam.seqs))}, in "
          f"{time.time() - t0:.1f} s")
    fasta = work / f"phi_dna_{N_ML}.fa"
    write_fasta(fasta, fam.names, fam.seqs)
    truth = (fam.children, fam.root)

    # 13: msa_run --tree ml
    with MLWatch() as watch:
        obs, rows, report = run_msa(
            fam, fasta, work / "out_ml", "ml path --tree ml",
            ["--tree", "ml"], route, ("gotoh_forward", "match_valid"),
            stages=ML_STAGES, need_fallbacks=False, tree=True)
    res, logl = watch.results[0], report["tree_logl"]
    if report["tree_backend"] != "cluster+ml" or \
            report["tree_model"] not in models.MODELS or \
            not logl["final"] >= logl["initial"]:
        fail(f"msa_run --tree ml: {report['tree_backend']}, "
             f"{report['tree_model']}, logL {logl}")
    tree = obs.tree_result
    msa = ab.DNA.encode_aligned_rows(rows)
    card = "cuda" if route == "cuda" else "cpu"
    nj = TreeEngine(gap_code=5, n_chars=5, backend="dense",
                    device=card).build(msa)
    print(f"ml path: model {res.model} (BIC {json.dumps(res.bic)}), "
          f"{res.n_nni} NNI, logL {logl['initial']} -> {logl['final']}; "
          f"normalized RF vs the simulated tree: dense NJ tree "
          f"{normalized_rf((nj.children, nj.root), truth, N_ML):.4f}, "
          f"backend (cluster) tree "
          f"{normalized_rf(watch.inputs[0], truth, N_ML):.4f}, ML tree "
          f"{normalized_rf((tree.children, tree.root), truth, N_ML):.4f}")
    hold_loglik(msa, res, card)
    hold_fit(msa, res, card)
    mark(13)

    # 14: tree_run --refine ml --bootstrap
    out = work / "tree_ml_boot"
    obs14, rep = run_tree(out.parent / "out_ml" / "aligned.fasta", out,
                          f"ml bootstrap {N_ML}",
                          ["--refine", "ml", "--bootstrap", str(N_BOOT)],
                          N_ML, truth, stages=ML_STAGES)
    n_labels = check_supports(obs14.tree_result,
                              (out / "tree.nwk").read_text(), N_ML)
    secs = rep["bootstrap"]["bootstrap_seconds"]
    print(f"bootstrap {N_BOOT} replicates at {N_ML} leaves: {secs:.2f} s, "
          f"{N_BOOT / secs:.2f} replicates/s, {n_labels} supported edges, "
          f"mean support {rep['bootstrap']['mean_support']}")
    obs14.mv_largest = {}
    mark(14)

    # 15: the search fleet, kill and resume
    fleet_phase(msa[:N_FLEET], fam.names[:N_FLEET], work, card)
    mark(15)

    # 16: search_run --pipeline --bootstrap on phase 8's database
    _, queries = run_search(work, work / "db.fa", work / "q.fa",
                            "pipeline bootstrap",
                            ["--score", "global", "--max-hits", "10",
                             "--pipeline", "--bootstrap", "25"],
                            ("gotoh_forward", "match_valid"))
    fams = json.loads((work / "pipeline_bootstrap" / "report.json")
                      .read_text())["families"]
    for f in fams:
        if f.get("skipped"):
            continue
        nwk = (work / "pipeline_bootstrap" / f["dir"] / "tree.nwk"
               ).read_text()
        if f["refine"] != "ml" or f["mean_support"] is None or \
                not re.search(r"\)[0-9.]+:", nwk):
            fail(f"search_run --pipeline --bootstrap 25: family {f}")
    print(f"search pipeline bootstrap: families "
          f"{[(f['query'], f['n_members'], f.get('mean_support')) for f in fams]}")
    return obs


# ------------------------------------------------------- distributed runtime

DIST_RANKS = 2
DIST_INDEL = 0.00005    # phase 18's family: its merged width fits 2·Lmax + 64
DIST_TREE_RUNS = {      # tree_run on N_FLEET rows of phase 13's alignment;
    # the tiled backend named, so that every world size resolves the same
    # (auto takes tiled on more than one rank only), its strips split
    "tree_ml": ["--backend", "tiled", "--row-block", "32", "--refine", "ml",
                "--bootstrap", "20", "--ml-steps", "20", "--nni-rounds",
                "2"],
    "tree_search": ["--backend", "tiled", "--row-block", "32", "--refine",
                    "search", "--starts", "4", "--search-rounds", "3",
                    "--ml-steps", "20"]}
DIST_TIMEOUT = 420      # seconds a spawned world may run
DIST_STAGES = {"msa": MSA_STAGES + TREE_STAGES[3:7] + ("loglik",),
               "search": SEARCH_STAGES,
               "tree_ml": ML_STAGES, "tree_search": FLEET_STAGES}


def dist_argv(work: Path, job: str, tag: str, n: int, device: str):
    """The launcher and argv of one phase-18 run at world size ``n``
    (outputs under ``work / f"{tag}_{job}"``)."""
    main, argv = _dist_argv(work, job, tag, n)
    return main, argv + ["--device", device]


def _dist_argv(work: Path, job: str, tag: str, n: int):
    from repro_torch.launch import msa_run, search_run, tree_run
    out = str(work / f"{tag}_{job}")
    if job == "msa":
        return msa_run.main, ["--fasta", str(work / "phi_rna_dist.fa"),
                              "--out", out, "--dist", "--tree", "tiled",
                              "--tree-ll"]
    if job == "search":
        return search_run.main, ["--db", str(work / "db.fa"), "--query",
                                 str(work / "q.fa"), "--index",
                                 str(work / "db.idx.npz"), "--out", out,
                                 "--dist", "--score", "global",
                                 "--max-hits", "10", "--backend",
                                 "banded-pallas"]
    return tree_run.main, ["--fasta",
                           str(work / f"phi_dna_{N_FLEET}_aligned.fa"),
                           "--out", out, "--mesh", f"{n}x1",
                           *DIST_TREE_RUNS[job]]


def dist_run(work: Path, job: str, tag: str, n: int, rank: int,
             device: str) -> dict:
    """One phase-18 run on this rank, the launch counts reset just before
    it: its stage seconds, wall seconds, device peak and launches."""
    from repro_torch.obs import trace
    main, argv = dist_argv(work, job, tag, n, device)
    trace.TRACER.clear()
    t0 = time.time()
    with Observe() as obs:
        main(argv)
    return {"rank": rank, "stages": stage_seconds(DIST_STAGES[job]),
            "wall": round(time.time() - t0, 3),
            "peak_gib": round(obs.peak_gib, 3), "launches": obs.launches}


def dist_rank(rank: int, n: int, work: str, tag: str, jobs,
              device: str) -> None:
    """A spawned rank of phase 18(b): ``gloo`` (NCCL refuses two ranks on
    one card) from a ``FileStore``, the card shared, the kernels already
    built by the parent; writes its runs' numbers to
    ``work / f"{tag}_rank{rank}.json"``. ``device="cpu"`` rehearses the
    phase without a card (peaks then read 0)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    work = Path(work)
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        for f in ("synchronize", "reset_peak_memory_stats"):
            setattr(torch.cuda, f, lambda *a, **k: None)
        for f in ("max_memory_allocated", "memory_allocated"):
            setattr(torch.cuda, f, lambda *a, **k: 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / f"{tag}_store"), n),
        rank=rank, world_size=n, timeout=timedelta(seconds=DIST_TIMEOUT))
    try:
        runs = {job: dist_run(work, job, tag, n, rank, device)
                for job in jobs}
    finally:
        dist.destroy_process_group()
    (work / f"{tag}_rank{rank}.json").write_text(json.dumps(runs))


def spawn_world(work: Path, tag: str, n: int, jobs, device: str) -> list:
    """Phase 18(b)'s worlds: ``n`` spawned ranks (never forked: CUDA is
    up in this process) running ``jobs``; each rank's numbers, printed.
    A rank that fails, or a world past ``DIST_TIMEOUT``, fails."""
    import torch.multiprocessing as mp
    (work / f"{tag}_store").unlink(missing_ok=True)
    t0 = time.time()
    ctx = mp.start_processes(dist_rank, args=(n, str(work), tag, tuple(jobs),
                                              device),
                             nprocs=n, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.time() - t0 > DIST_TIMEOUT:
                fail(f"the {n}-rank world ran past {DIST_TIMEOUT} s")
    except mp.ProcessRaisedException as e:
        fail(f"a rank of the {n}-rank world failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"a rank of the {n}-rank world exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [json.loads((work / f"{tag}_rank{r}.json").read_text())
             for r in range(n)]
    print(f"world of {n} ({tag}): {time.time() - t0:.1f} s wall, spawn "
          "included")
    for r, runs in enumerate(ranks):
        for job, v in runs.items():
            print(f"  rank {r} {job}: stage seconds {json.dumps(v['stages'])}"
                  f" (wall {v['wall']} s), peak device memory "
                  f"{v['peak_gib']} GiB, kernel launches "
                  f"{json.dumps(v['launches'])}")
    return ranks


def same_files(a: Path, b: Path, files, what: str) -> None:
    for f in files:
        x, y = (a / f).read_bytes(), (b / f).read_bytes()
        if f == "hits.json":
            # the seed stat names the route: "mesh" under --dist
            x, y = json.loads(x), json.loads(y)
            seeds = (x["stats"].pop("seed"), y["stats"].pop("seed"))
            if seeds != ("mesh", "host"):
                fail(f"{what}: seed stats {seeds}")
        if x != y:
            fail(f"{what}: {f} differs ({a} against {b})")
    print(f"{what}: {', '.join(files)} equal")


def dist_phase(fam, work: Path, route: str = "cuda") -> None:
    """Phase 18: the distributed runtime.

    (a) A world of one in this process (``nccl``, a ``HashStore``). On
    phase 6's family ``msa_run --dist`` takes the reference's mesh
    semantics: its rows are built in a frame of 2·Lmax + 64 columns, and
    a merged width past that is refused (phase 6's is); where the width
    fits, its ``aligned.fasta`` must equal phase 6's. Then on a family of
    ``N_SEQS`` Φ_RNA-shaped sequences with ``DIST_INDEL`` indels, which
    fits: ``msa_run --tree tiled --tree-ll`` without and with ``--dist``,
    equal files, ``kmer_fallbacks`` null under ``--dist``, the dist run's
    largest kernel-1 and kernel-2 calls held against their plain versions.
    (b) Spawned worlds sharing the card (``gloo``): two ranks run
    ``msa_run --dist`` (files equal to (a)'s), ``search_run --dist`` on
    phase 8's database (``hits.json`` equal to phase 8's) and ``tree_run
    --mesh 2x1`` ML + bootstrap and the search fleet on phase 15's rows;
    one rank runs the same ``tree_run``s with ``--mesh 1x1``: their Newick
    files equal."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import write_fasta
    from repro_torch.launch import msa_run
    device = "cuda" if route == "cuda" else "cpu"
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        width = json.loads((work / "out" / "report.json").read_text())[
            "width"]
        frame = 2 * max(map(len, fam.seqs)) + 64
        try:
            msa_run.main(["--fasta", str(work / "phi_rna_4096.fa"), "--out",
                          str(work / "dist_phase6"), "--dist", "--tree",
                          "none"])
            if width > frame:
                fail(f"msa_run --dist took phase 6's family (width {width} "
                     f"past its frame of {frame} columns)")
            same_files(work / "dist_phase6", work / "out",
                       ("aligned.fasta",), "msa_run --dist on phase 6's "
                       "family against phase 6")
        except ValueError as e:
            if width <= frame or "exceeds out_len" not in str(e):
                raise
            print(f"msa_run --dist on phase 6's family refuses, as the "
                  f"reference's mesh path does: {e}")
        fam18 = simulate(N_SEQS, indel=DIST_INDEL)
        fasta = work / "phi_rna_dist.fa"
        write_fasta(fasta, fam18.names, fam18.seqs)
        flags = ["--tree", "tiled", "--tree-ll"]
        _, _, host = run_msa(
            fam18, fasta, work / "dist_host", "dist family, one process",
            flags, route, ("gotoh_forward", "match_valid"),
            stages=DIST_STAGES["msa"], need_fallbacks=False)
        frame = 2 * max(map(len, fam18.seqs)) + 64
        if host["width"] > frame:
            fail(f"phase 18's family does not fit the mesh frame: width "
                 f"{host['width']} > {frame}; lower DIST_INDEL")
        obs, _, report = run_msa(
            fam18, fasta, work / "dist1a_msa", "dist family, world of one",
            ["--dist", *flags], route, ("gotoh_forward", "match_valid"),
            stages=DIST_STAGES["msa"], need_fallbacks=False, tree=True)
    finally:
        dist.destroy_process_group()
    print(f"dist family: width {host['width']} in a frame of {frame}, "
          f"{host['kmer_fallbacks']} k-mer fallbacks in one process")
    if report["kmer_fallbacks"] is not None:
        fail(f"msa_run --dist: kmer_fallbacks {report['kmer_fallbacks']}")
    same_files(work / "dist1a_msa", work / "dist_host",
               ("aligned.fasta", "tree.nwk"),
               "msa_run --dist --tree tiled (world of one) against one "
               "process")
    err, _ = hold_path_calls((("dist world of one", obs),))
    e2 = hold_tree_calls((("dist world of one", obs),))
    print(f"dist world of one: kernels held, largest errors "
          f"{json.dumps(dict(err, match_valid=e2))}")
    if max(max(err.values()), e2) != 0:
        fail("a kernel disagrees with its plain version on phase 18")

    torch.cuda.empty_cache()
    spawn_world(work, "dist1b", 1, list(DIST_TREE_RUNS), device)
    spawn_world(work, "dist2", DIST_RANKS,
                ["msa", *DIST_TREE_RUNS, "search"], device)
    same_files(work / "dist2_msa", work / "dist1a_msa",
               ("aligned.fasta", "tree.nwk"),
               "msa_run --dist --tree tiled on 2 ranks against (a)")
    same_files(work / "dist2_search", work / "global_banded-pallas",
               ("hits.json",), "search_run --dist on 2 ranks against phase 8")
    for job in DIST_TREE_RUNS:
        same_files(work / f"dist2_{job}", work / f"dist1b_{job}",
                   ("tree.nwk",), f"tree_run {job} --mesh 2x1 against 1x1")


# ---------------------------------------------------------- the MSA service

SERVE_CFG = dict(max_batch=8192, max_wait_ms=50.0)   # --max-batch/--max-wait-ms
N_FAMILY2 = 2048        # the concurrent requests' and the store's family
N_CONCURRENT = 8        # concurrent /align requests of N_EACH sequences
N_EACH = 256
N_ADD = 64              # /align/add onto the 4,096 alignment
N_NAMED = 1024          # the named alignment of phase 19(b)
SERVE_TIMEOUT = 300     # seconds an HTTP wait or a spawned server may take
SERVE_DIST_THRESHOLD = 1024   # serve_msa --dist --dist-threshold


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(port: int, path: str, obj=None, timeout=SERVE_TIMEOUT):
    """POST ``obj`` as JSON (GET when None) to the local server; returns
    (status, body bytes, wall ms)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if obj is None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, (time.perf_counter() - t0) * 1e3


def post_ok(port: int, path: str, obj, what: str) -> dict:
    """A request that must answer 200; prints its wall ms."""
    code, body, ms = http(port, path, obj)
    if code != 200:
        fail(f"service {what}: HTTP {code}: {body[:400]!r}")
    print(f"service {what}: {ms:.1f} ms wall")
    return json.loads(body)


def wait_healthy(port: int, alive, what: str) -> None:
    """Poll ``/healthz`` until it answers; fail if ``alive()`` turns
    false or ``SERVE_TIMEOUT`` passes."""
    import urllib.error
    deadline = time.time() + SERVE_TIMEOUT
    while True:
        try:
            if http(port, "/healthz", timeout=5)[0] == 200:
                return
        except (urllib.error.URLError, OSError):
            pass
        if not alive():
            fail(f"{what} died before it served")
        if time.time() > deadline:
            fail(f"{what} did not serve within {SERVE_TIMEOUT} s")
        time.sleep(0.5)


def strip_volatile(resp: dict) -> dict:
    return {k: v for k, v in resp.items()
            if k not in ("elapsed_ms", "trace_id", "cache")}


def newick_splits(nwk: str) -> set:
    """The non-trivial splits of a Newick tree, each as the frozenset of
    leaf names on the side without the first name in sort order."""
    stack, clades, prev = [set()], [], "("
    for tok in re.findall(r"[(),]|[^(),;]+", nwk):
        if tok == "(":
            stack.append(set())
        elif tok == ")":
            clade = stack.pop()
            clades.append(frozenset(clade))
            stack[-1] |= clade
        elif tok != "," and prev in "(,":
            stack[-1].add(tok.split(":")[0])
        prev = tok
    leaves = frozenset(stack[0])
    first = min(leaves)
    return {c if first not in c else leaves - c for c in clades
            if 1 < len(c) < len(leaves) - 1}


def check_alignment(aln: dict, names, seqs, what: str):
    """One width, every row its input ungapped, no all-gap column (every
    column holds a center char or some row's insertion); returns the rows
    as an (N, W) uint8 array."""
    rows = aln["rows"]
    if aln["names"] != list(names):
        fail(f"service {what}: names differ from the request")
    if any(len(r) != aln["width"] for r in rows):
        fail(f"service {what}: rows of more than one width")
    if any(r.replace("-", "") != s for r, s in zip(rows, seqs)):
        fail(f"service {what}: a row is not its input sequence")
    arr = np.frombuffer("".join(rows).encode(), np.uint8).reshape(
        len(rows), aln["width"])
    if not (arr != ord("-")).any(axis=0).all():
        fail(f"service {what}: an all-gap column")
    c = aln["center_idx"]
    if int((arr[c] != ord("-")).sum()) != len(seqs[c]):
        fail(f"service {what}: the center row is not its sequence")
    return arr


def mutants(seqs, n: int, seed: int):
    """``n`` new members: copies of ``seqs`` members with 3 substitutions
    and a 2-base insertion each."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.choice(len(seqs), n, replace=False):
        s = list(seqs[i])
        for _ in range(3):
            s[rng.integers(len(s))] = "ACGT"[rng.integers(4)]
        p = int(rng.integers(len(s)))
        out.append("".join(s[:p]) + "GA" + "".join(s[p:]))
    return out


def serve_inprocess(fam, fam2, work: Path, route: str) -> None:
    """Phase 19(a): ``MSAService`` with ``serve_http`` on a thread."""
    import threading

    import torch
    from repro_torch.align.bucketing import pair_bucket_plan
    from repro_torch.align.engine import AlignEngine
    from repro_torch.core import alphabet as ab
    from repro_torch.core.msa import MSAConfig, center_star_msa
    from repro_torch.data import read_fasta, write_fasta
    from repro_torch.launch import tree_run
    from repro_torch.obs import metrics
    from repro_torch.search import SearchIndex
    from repro_torch.serve import MSAService, ServiceConfig, serve_http
    from repro_torch.serve.cache import canonicalize
    from repro_torch.serve.incremental import center_profile, expand_rows
    device = "cuda" if route == "cuda" else "cpu"
    plain = MSAConfig(method="plain")
    gap = ab.DNA.gap_code
    store = work / "serve_store_a"
    if store.exists():
        import shutil
        shutil.rmtree(store)
    svc = MSAService(ServiceConfig(
        **SERVE_CFG, store_dir=str(store), device=device,
        search_index=SearchIndex.load(work / "db.idx.npz")))
    httpd = serve_http(svc, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        # /align: 4,095 pairs through kernel 1 in one coalesced batch
        with Observe() as obs:
            r1 = post_ok(port, "/align", {"names": fam.names,
                                          "sequences": fam.seqs},
                         f"/align {len(fam.seqs)}")
        aln = r1["alignment"]
        arr = check_alignment(aln, fam.names, fam.seqs,
                              f"/align {len(fam.seqs)}")
        print(f"service /align {len(fam.seqs)}: path {r1['path']}, "
              f"width {aln['width']}, coalesce {json.dumps(r1['coalesce'])}"
              f", peak device memory {obs.peaks()}, kernel launches "
              f"{json.dumps(obs.launches)} (counted by the coalescer's "
              "worker thread, read after the request)")
        if r1["path"] != "coalesced" or obs.launches["gotoh_forward"] <= 0:
            fail(f"service /align: path {r1['path']}, launches "
                 f"{obs.launches}")
        canon, perm = canonicalize(fam.seqs)
        want = center_star_msa(canon, plain, device=device)
        if not np.array_equal(ab.DNA.encode_aligned_rows(
                [aln["rows"][p] for p in perm]), want.msa):
            fail("service /align: rows differ from center_star_msa "
                 "--method plain on the same family")
        print("service /align: rows equal center_star_msa --method plain")
        err, _ = hold_path_calls((("service /align", obs),))
        if err["gotoh_forward"] != 0:
            fail("kernel 1 disagrees with its plain version on the "
                 "service's batch")
        code, body, ms = http(port, "/align", {"names": fam.names,
                                               "sequences": fam.seqs})
        r2 = json.loads(body)
        if code != 200 or not r2["cached"] or json.dumps(
                r2["alignment"]) != json.dumps(aln):
            fail("service /align again: not a byte-identical cache hit")
        print(f"service /align {len(fam.seqs)} again: cached, "
              f"byte-identical, {ms:.1f} ms wall")

        # eight concurrent /align requests of 256 sequences
        chunks = [(fam2.names[i * N_EACH:(i + 1) * N_EACH],
                   fam2.seqs[i * N_EACH:(i + 1) * N_EACH])
                  for i in range(N_CONCURRENT)]
        q0 = svc.coalescer.stats()
        out = [None] * N_CONCURRENT
        # each merged batch: (pairs, the bucket count of its own query
        # and target lengths, the engine calls it made)
        batches = []
        t0 = time.perf_counter()
        with Observe() as cobs:
            staged = AlignEngine.align_pairs

            def planned(engine, Q, qlens, T, tlens):
                res = staged(engine, Q, qlens, T, tlens)
                plan = pair_bucket_plan(
                    torch.as_tensor(qlens).cpu().numpy(),
                    torch.as_tensor(tlens).cpu().numpy(), Q.shape[1],
                    T.shape[1], min_bucket=engine.min_bucket)
                batches.append((int(Q.shape[0]), len(plan),
                                int(res.n_calls)))
                return res
            AlignEngine.align_pairs = planned
            try:
                threads = [threading.Thread(
                    target=lambda i=i: out.__setitem__(i, http(
                        port, "/align", {"names": chunks[i][0],
                                         "sequences": chunks[i][1]})))
                    for i in range(N_CONCURRENT)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(SERVE_TIMEOUT)
            finally:
                AlignEngine.align_pairs = staged
        wall = (time.perf_counter() - t0) * 1e3
        q1 = svc.coalescer.stats()
        metas = []
        for i, res in enumerate(out):
            if res is None or res[0] != 200:
                fail(f"service concurrent /align {i}: {res and res[:2]}")
            metas.append(json.loads(res[1])["coalesce"])
        print(f"service {N_CONCURRENT} concurrent /align of {N_EACH}: "
              f"{wall:.1f} ms wall, each "
              f"{[round(r[2], 1) for r in out]} ms; coalesce {metas}; "
              f"queue batches {q1['batches'] - q0['batches']}, "
              f"coalesced_jobs {q1['coalesced_jobs'] - q0['coalesced_jobs']}"
              f", engine_calls {q1['engine_calls'] - q0['engine_calls']}; "
              f"batches (pairs, buckets, engine calls) {batches}; peak "
              f"device memory {cobs.peaks()}, kernel launches "
              f"{json.dumps(cobs.launches)}")
        if max(m["batch_jobs"] for m in metas) <= 1:
            fail("service: no concurrent /align was coalesced")
        if any(calls > buckets for _, buckets, calls in batches):
            fail("service: a batch made more engine calls than buckets")
        if not {(m["batch_pairs"], m["engine_calls"]) for m in metas} <= {
                (b, calls) for b, _, calls in batches}:
            fail(f"service: responses' batches {metas} are not the "
                 f"batches that ran {batches}")
        fresh = MSAService(ServiceConfig(**SERVE_CFG, device=device))
        try:
            for i, (names, seqs) in enumerate(chunks):
                alone = fresh.align(names, seqs)["alignment"]
                if json.dumps(alone) != json.dumps(
                        json.loads(out[i][1])["alignment"]):
                    fail(f"service concurrent /align {i} differs from the "
                         "same request alone on a fresh service")
        finally:
            fresh.drain()
        print("service concurrent /align: each equal to the request alone")

        # /align/add of 64 members onto the 4,096 alignment
        new = mutants(fam.seqs, N_ADD, seed=19)
        ra = post_ok(port, "/align/add", {
            "msa_id": aln["msa_id"], "names": [f"new{i}" for i in
                                               range(N_ADD)],
            "sequences": new}, f"/align/add {N_ADD}")
        if ra["add"]["realigned"]:
            fail(f"service /align/add realigned: {ra['add']}")
        old = ab.DNA.encode_aligned_rows([aln["rows"][p] for p in perm])
        got = ab.DNA.encode_aligned_rows(ra["alignment"]["rows"])
        cidx = ra["alignment"]["center_idx"]
        g_old = center_profile(old, cidx, gap)[2]
        g_new = center_profile(got, cidx, gap)[2]
        if not np.array_equal(got[:len(canon)],
                              expand_rows(old, cidx, g_old, g_new, gap)):
            fail("service /align/add: old rows are not expand_rows of the "
                 "stored rows")
        full = center_star_msa(canon + new, plain, device=device)
        if full.center_idx != cidx or not np.array_equal(got, full.msa):
            fail("service /align/add differs from a full realign with the "
                 "same center")
        print(f"service /align/add {N_ADD}: width {aln['width']} -> "
              f"{ra['alignment']['width']} (growth {ra['add']['growth']}); "
              "old rows = expand_rows of the stored ones; equal to the "
              "full realign")

        # /tree on the 4,096 alignment (kernel 2), against tree_run
        with Observe(tree=True) as tobs:
            rt = post_ok(port, "/tree", {"msa_id": aln["msa_id"]},
                         f"/tree {len(fam.seqs)}")
        print(f"service /tree: backend {rt['backend']}, peak device memory "
              f"{tobs.peaks()}, kernel launches {json.dumps(tobs.launches)}"
              f" (match_valid by route {json.dumps(tobs.mv_routes)})")
        if tobs.launches["match_valid"] <= 0:
            fail("kernel 2 was not launched on the service's /tree")
        if hold_tree_calls((("service /tree", tobs),)) != 0:
            fail("kernel 2 disagrees with its plain version on /tree")
        fa = work / "serve_tree_rows.fa"
        names_c = [fam.names[p] for p in perm]
        write_fasta(fa, names_c, [aln["rows"][p] for p in perm])
        tree_run.main(["--fasta", str(fa), "--out",
                       str(work / "serve_tree_run"), "--backend",
                       rt["backend"].split("-")[0], "--device", device])
        nwk = (work / "serve_tree_run" / "tree.nwk").read_text().strip()
        if nwk != rt["newick"] and newick_splits(nwk) != newick_splits(
                rt["newick"]):
            fail("service /tree is not RF 0 against tree_run")
        print(f"service /tree: RF 0 against tree_run --backend "
              f"{rt['backend']} ({'equal' if nwk == rt['newick'] else 'rooted apart'})")

        # /search of phase 8's queries: phase 8's local hits
        q_names, q_seqs = read_fasta(work / "q.fa")
        rs = post_ok(port, "/search", {"names": q_names,
                                       "sequences": q_seqs}, "/search")
        hits = json.loads((work / "local" / "hits.json").read_text())
        if rs["queries"] != hits["queries"] or {
                k: v for k, v in rs["stats"].items() if k != "seed"} != {
                k: v for k, v in hits["stats"].items() if k != "seed"}:
            fail("service /search differs from search_run --score local")
        print("service /search: hits equal phase 8's search_run --score "
              "local")

        health = json.loads(http(port, "/healthz")[1])
        text = http(port, "/metrics")[1].decode()
        if "repro_requests_started_total" not in text:
            fail("/metrics lacks the request counters")
        print(f"service /healthz: backend {health['backend']}, queue "
              f"{json.dumps(health['queue'])}, cache "
              f"{json.dumps(health['cache'])}, store "
              f"{json.dumps(health['store'])}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.drain()
    snap = metrics.REGISTRY.snapshot()
    tot = {f: sum(x["value"] for x in snap.get(f, {"samples": []})[
        "samples"]) for f in ("repro_requests_started_total",
                              "repro_requests_finished_total",
                              "repro_requests_rejected_total")}
    if tot["repro_requests_started_total"] != (
            tot["repro_requests_finished_total"]
            + tot["repro_requests_rejected_total"]):
        fail(f"service counters do not reconcile after drain: {tot}")
    print(f"service drained: requests {json.dumps(tot)}")
    del svc
    torch.cuda.empty_cache()


def spawn_server(argv, log: Path):
    """``python -m repro_torch.launch.serve_msa`` on a free port, its
    output in ``log``; returns (process, port) once it serves."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(log, "ab") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_msa", "--port",
             str(port), *argv], env=env, cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT)
    try:
        wait_healthy(port, lambda: proc.poll() is None, f"serve_msa {argv}")
    except SystemExit:
        proc.kill()
        proc.wait()
        print(log.read_text()[-4000:])
        raise
    return proc, port


def stop_server(proc, sig) -> int:
    import signal
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=SERVE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"serve_msa did not stop within {SERVE_TIMEOUT} s of "
             f"{signal.Signals(sig).name}")


def serve_store_phase(fam2, work: Path, device: str) -> None:
    """Phase 19(b): a spawned ``serve_msa --store-dir``: a named alignment,
    three adds, SIGKILL, restart, the store read back bit-identical, one
    more add, SIGTERM drains with exit code 0."""
    import shutil
    import signal
    store = work / "serve_store_b"
    if store.exists():
        shutil.rmtree(store)
    log = work / "serve_msa_b.log"
    log.unlink(missing_ok=True)
    argv = ["--store-dir", str(store), "--max-wait-ms", "5", "--device",
            device]
    names, seqs = fam2.names[:N_NAMED], fam2.seqs[:N_NAMED]
    t0 = time.time()
    proc, port = spawn_server(argv, log)
    print(f"serve_msa --store-dir up in {time.time() - t0:.1f} s")
    try:
        r = post_ok(port, "/align", {"name": "phi_rna", "names": names,
                                     "sequences": seqs},
                    f"named /align {N_NAMED}")
        if not r["created"]:
            fail("named /align did not create")
        for i in range(3):
            new = mutants(seqs, 16, seed=30 + i)
            r = post_ok(port, "/align/add", {
                "name": "phi_rna", "names": [f"a{i}_{j}" for j in range(16)],
                "sequences": new}, f"named /align/add 16 ({i + 1} of 3)")
        last = r["alignment"]
        if last["generation"] != 3:
            fail(f"named adds: generation {last['generation']}, not 3")
    finally:
        stop_server(proc, signal.SIGKILL)
    t0 = time.time()
    proc, port = spawn_server(argv, log)
    print(f"serve_msa restarted from the store in {time.time() - t0:.1f} s")
    try:
        back = post_ok(port, "/align", {"name": "phi_rna"},
                       "named /align after SIGKILL")["alignment"]
        for k in ("generation", "fingerprint", "rows", "names", "width",
                  "center_idx"):
            if back[k] != last[k]:
                fail(f"the restarted store differs in {k}")
        nxt = post_ok(port, "/align/add", {
            "name": "phi_rna", "names": ["after"], "sequences":
                mutants(seqs, 1, seed=40)}, "named /align/add after restart")
        if nxt["alignment"]["generation"] != last["generation"] + 1:
            fail("the add after the restart is not the next generation")
        health = json.loads(http(port, "/healthz")[1])
        print(f"serve_msa --store-dir: generation "
              f"{nxt['alignment']['generation']}, store "
              f"{json.dumps(health['store'])}, queue "
              f"{json.dumps(health['queue'])}")
    finally:
        rc = stop_server(proc, signal.SIGTERM)
    if rc != 0 or "drained; bye" not in log.read_text():
        fail(f"serve_msa did not drain on SIGTERM (exit code {rc})")
    print("serve_msa --store-dir: restored bit-identical after SIGKILL; "
          "SIGTERM drained with exit code 0 (device peak of the server's "
          "own process: not measured)")


def serve_rank(rank: int, n: int, work: str, port: int, threshold: int,
               device: str) -> None:
    """A spawned rank of phase 19(c): ``gloo`` from a ``FileStore``, the
    card shared, running ``serve_msa --dist``; writes its device peak to
    ``work / f"serve{n}_rank{rank}.json"``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    work = Path(work)
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / f"serve{n}_store"), n),
        rank=rank, world_size=n, timeout=timedelta(seconds=SERVE_TIMEOUT))
    try:
        from repro_torch.launch import serve_msa
        serve_msa.main(["--port", str(port), "--dist", "--dist-threshold",
                        str(threshold), "--max-wait-ms", "5", "--device",
                        device])
    finally:
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    (work / f"serve{n}_rank{rank}.json").write_text(json.dumps(
        {"peak_gib": round(peak / 2**30, 3)}))


def serve_world(fam, work: Path, n: int, device: str) -> dict:
    """Phase 19(c): ``serve_msa --dist`` on ``n`` spawned ranks; /align of
    ``fam`` (path "dist") and /tree --backend tiled on it, then SIGTERM
    to rank 0, which stops the others. Returns the two responses."""
    import signal

    import torch.multiprocessing as mp
    (work / f"serve{n}_store").unlink(missing_ok=True)
    port = free_port()
    t0 = time.time()
    ctx = mp.start_processes(serve_rank, args=(n, str(work), port,
                                               SERVE_DIST_THRESHOLD, device),
                             nprocs=n, join=False, start_method="spawn")
    try:
        wait_healthy(port, lambda: all(p.is_alive() for p in ctx.processes),
                     f"serve_msa --dist on {n} rank(s)")
        print(f"serve_msa --dist on {n} rank(s) up in "
              f"{time.time() - t0:.1f} s")
        ra = post_ok(port, "/align", {"names": fam.names,
                                      "sequences": fam.seqs},
                     f"/align {len(fam.seqs)} over {n} rank(s)")
        if ra["path"] != "dist":
            fail(f"/align over the mesh took path {ra['path']}")
        rt = post_ok(port, "/tree", {"msa_id": ra["alignment"]["msa_id"],
                                     "backend": "tiled"},
                     f"/tree tiled over {n} rank(s)")
        health = json.loads(http(port, "/healthz")[1])
        os.kill(ctx.processes[0].pid, signal.SIGTERM)
        deadline = time.time() + SERVE_TIMEOUT
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                fail(f"the {n}-rank service did not drain within "
                     f"{SERVE_TIMEOUT} s of SIGTERM")
    except mp.ProcessRaisedException as e:
        fail(f"a rank of the {n}-rank service failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"a rank of the {n}-rank service exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    peaks = [json.loads((work / f"serve{n}_rank{r}.json").read_text())[
        "peak_gib"] for r in range(n)]
    print(f"serve_msa --dist on {n} rank(s): width "
          f"{ra['alignment']['width']}, tree backend {rt['backend']}, queue "
          f"{json.dumps(health['queue'])}, device peak per rank {peaks} GiB;"
          f" drained on SIGTERM, {time.time() - t0:.1f} s wall, spawn "
          "included")
    return {"align": strip_volatile(ra), "tree": strip_volatile(rt)}


def msa_service_phase(fam, work: Path, route: str = "cuda") -> None:
    """Phase 19: the MSA service and its store (``repro_torch.serve``,
    ``launch/serve_msa``) over HTTP, on the card."""
    import torch
    device = "cuda" if route == "cuda" else "cpu"
    fam2 = simulate(N_FAMILY2)
    serve_inprocess(fam, fam2, work, route)
    serve_store_phase(fam2, work, device)
    fam3 = simulate(N_FAMILY2, indel=DIST_INDEL)
    torch.cuda.empty_cache()
    one = serve_world(fam3, work, 1, device)
    two = serve_world(fam3, work, DIST_RANKS, device)
    if one != two:
        fail("serve_msa --dist on 2 ranks differs from a world of one")
    print("serve_msa --dist: /align and /tree on 2 ranks equal a world of "
          "one's")


# ------------------------------------------------------- adaptive band policy

N_ADAPT = 4096          # phase 20's pairs: partial reads against full targets
ADAPT_BAND = 64
ADAPT_READ = (400, 1440)   # query lengths (partial 16S reads)
ADAPT_SAMPLE = 3        # pairs of each bucket held against the plain versions
N_PROG = 64             # progressive_msa on Phi_RNA sequences (cut from
                        # 128: PERF.md)
# W = 16,384 timed where the planner gives it: short reads (90-110 nt)
# against 8,192-nt targets at band 128 (|la - lb| + 128 > 8,192)
WIDE_READS = dict(pairs=1024, read=(90, 110), target=8192, band=128)


def adaptive_pairs(fam, n: int, seed: int):
    """Phase 20's traffic: each query a substring of 400-1,440 nt of one
    leaf (a partial 16S read), its target another full-length leaf."""
    from repro_torch.core import alphabet as ab
    rng = np.random.default_rng(seed)
    N = len(fam.seqs)
    qi = rng.integers(0, N, n)
    ti = (qi + rng.integers(1, N, n)) % N
    queries = []
    for i in qi:
        s = fam.seqs[i]
        L = int(rng.integers(ADAPT_READ[0], min(ADAPT_READ[1], len(s)) + 1))
        start = int(rng.integers(0, len(s) - L + 1))
        queries.append(s[start:start + L])
    Q, ql = ab.encode_batch(queries, ab.DNA)
    T, tl = ab.encode_batch([fam.seqs[i] for i in ti], ab.DNA)
    return Q, ql, T, tl


def wide_reads(sub, seed: int):
    """The W = 16,384 call the planner makes for WIDE_READS: each read a
    mutated substring of its 8,192-nt target; returns the call's inputs
    (sliced to its bucket's widths) and its [B, wq, wt, W]."""
    import torch
    from repro_torch.align import bucketing
    rng = np.random.default_rng(seed)
    B, (lo, hi), m = (WIDE_READS["pairs"], WIDE_READS["read"],
                      WIDE_READS["target"])
    T = rng.integers(0, 4, (B, m)).astype(np.int8)
    ql = rng.integers(lo, hi + 1, B)
    Q = np.full((B, hi), 5, np.int8)
    for r, L in enumerate(ql):
        start = int(rng.integers(0, m - L + 1))
        read = T[r, start:start + L].copy()
        noise = rng.random(L) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        Q[r, :L] = read
    tl = np.full(B, m)
    plan = bucketing.band_bucket_plan(ql, tl, hi, m, band=WIDE_READS["band"])
    if [W for _, _, W, _ in plan] != [16384]:
        got = [(wq, wt, W, len(ix)) for wq, wt, W, ix in plan]
        fail(f"WIDE_READS planned as {got}, not one W = 16,384 bucket")
    wq, wt, W, _ = plan[0]
    dev = sub.device
    lens = torch.as_tensor(np.stack([ql, tl], 1), dtype=torch.int32,
                           device=dev)
    call = (torch.from_numpy(Q[:, :wq].copy()).to(dev),
            torch.from_numpy(T[:, :wt].copy()).to(dev), lens, sub,
            dict(gap_open=3, gap_extend=1, band=W))
    return call, [B, wq, wt, W]


def capped_grid_check(call) -> None:
    """Kernel 4 with ``ops.WORKSPACE_BUDGET`` cut to four pair slots: its
    grid shrinks to four CTAs (each serving B / 4 pairs) and the results
    must equal the uncapped grid's bit for bit."""
    import torch
    from repro_torch.kernels.banded import ops
    a, b, lens, sub, kw = call
    B, n = a.shape
    full = ops.banded_pairs_fused(a, b, lens, sub, **kw)
    budget = ops.WORKSPACE_BUDGET
    slot = ops.fused_plan(B, n, b.shape[1], kw["band"], 1).slot_bytes
    ops.WORKSPACE_BUDGET = 4 * slot
    try:
        capped = ops.banded_pairs_fused(a, b, lens, sub, **kw)
    finally:
        ops.WORKSPACE_BUDGET = budget
    for x, y in zip(full, capped):
        if not torch.equal(x, y):
            fail(f"kernel 4 on a grid capped by its workspace budget (4 "
                 f"slots of {slot} bytes) differs from the full grid at "
                 f"B={B} n={n} W={kw['band']}")
    print(f"banded_fused on a grid capped at 4 slots of {slot} bytes "
          f"equals the full grid (B={B} n={n} W={kw['band']})")


def adaptive_run(eng, args, label: str) -> dict:
    """One ``align_pairs`` call with every launch count set to 0 just
    before it and read just after; its wall seconds and device peak."""
    import torch
    from repro_torch.kernels.banded import ops as bd_ops
    from repro_torch.kernels.sw import ops as sw_ops
    torch.cuda.synchronize()
    reset_peak()
    bd_ops.forward_launches = bd_ops.fused_launches = sw_ops.launches = 0
    t0 = time.perf_counter()
    out = eng.align_pairs(*args)
    torch.cuda.synchronize()
    stats = dict(seconds=round(time.perf_counter() - t0, 3),
                 peak_gib=round(device_peak() / 2 ** 30, 3),
                 n_calls=out.n_calls, n_fallback=out.n_fallback,
                 launches={"banded_forward": bd_ops.forward_launches,
                           "banded_fused": bd_ops.fused_launches,
                           "gotoh_forward": sw_ops.launches})
    print(f"adaptive phase, {label}: {json.dumps(stats)}")
    return out, stats


def adaptive_phase(fam, device: str = "cuda") -> dict:
    """Phase 20(a): ``AlignEngine(band_policy="adaptive").align_pairs`` on
    the card on both banded routes, beside the fixed W = 64 policy; every
    bucket's call held on a sample of its pairs, the widest timed
    (``device="cpu"`` rehearses it on the plain versions: no launch
    counts, no timings)."""
    import torch
    from repro_torch.align import bucketing
    from repro_torch.align.engine import AlignEngine
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels.banded import ops
    Q, ql, T, tl = adaptive_pairs(fam, N_ADAPT, seed=20)
    plan = bucketing.band_bucket_plan(ql, tl, Q.shape[1], T.shape[1],
                                      band=ADAPT_BAND)
    print(f"adaptive phase: {N_ADAPT} pairs, queries {ql.min()}..{ql.max()} "
          f"nt against targets {tl.min()}..{tl.max()} nt, band "
          f"{ADAPT_BAND}: {len(plan)} buckets (wq, wt, W, pairs) "
          f"{[(wq, wt, W, len(ix)) for wq, wt, W, ix in plan]}")
    dev = torch.device(device)
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32, device=dev)
    args = tuple(torch.from_numpy(x).to(dev) for x in (Q, ql, T, tl))
    kw = dict(gap_open=3, gap_extend=1, gap_code=ab.DNA.gap_code,
              band=ADAPT_BAND)
    fused, fs = adaptive_run(AlignEngine(sub, backend="banded-pallas",
                                         band_policy="adaptive", **kw),
                             args, "adaptive banded-pallas")
    banded, bs = adaptive_run(AlignEngine(sub, backend="banded",
                                          band_policy="adaptive", **kw),
                              args, "adaptive banded")
    fixed, xs = adaptive_run(AlignEngine(sub, backend="banded-pallas", **kw),
                             args, f"fixed W = {ADAPT_BAND} banded-pallas")
    # kernel 4 once a bucket; kernel 3 once a bucket or more (its calls
    # split by the direction budget)
    if device == "cuda" and (fs["launches"]["banded_fused"] != len(plan) or
                             bs["launches"]["banded_forward"] < len(plan)):
        fail(f"adaptive launches {fs['launches']} / {bs['launches']} do not "
             f"cover the plan's {len(plan)} buckets")
    for name in ("score", "a_row", "b_row", "aln_len"):
        if not torch.equal(getattr(fused, name), getattr(banded, name)):
            fail(f"adaptive banded-pallas and banded differ in {name}")
    if (fused.n_fallback, fused.n_calls) != (banded.n_fallback,
                                             banded.n_calls):
        fail("adaptive routes differ in fallbacks or calls")
    if not fused.n_fallback < fixed.n_fallback:
        fail(f"adaptive fallbacks {fused.n_fallback} not below the fixed "
             f"policy's {fixed.n_fallback}")
    differ = int((fused.a_row != fixed.a_row).any(1).sum())
    print(f"adaptive phase: both routes' rows equal; fallbacks "
          f"{fused.n_fallback} adaptive against {fixed.n_fallback} fixed; "
          f"{differ} of {N_ADAPT} aligned query rows differ from the fixed "
          "policy's")
    # every bucket's call, on a sample of its pairs, against the plain
    # versions (kernel 4 also against kernel 3 + the banded traceback)
    Qd, qld, Td, tld = args
    err = 0.0
    for wq, wt, W, idx in plan:
        s = torch.as_tensor(np.unique(np.r_[idx[:ADAPT_SAMPLE - 1],
                                            idx[-1:]]), device=dev)
        lens = torch.stack([qld[s], tld[s]], 1).to(torch.int32)
        err = max(err, check_banded_inputs(
            Qd[s, :wq].contiguous(), Td[s, :wt].contiguous(), lens, sub, W,
            f"bucket wq={wq} wt={wt} W={W} ({len(s)} of {len(idx)} pairs)"))
    print(f"adaptive phase: every bucket's call exact vs plain on "
          f"{ADAPT_SAMPLE} of its pairs")
    if device == "cpu":
        return dict(adaptive_banded_pallas=fs, adaptive_banded=bs, fixed=xs,
                    buckets=len(plan), timed={}, max_abs_err=err)
    # the widest call (most pairs among the widest W), timed, and W = 16,384
    wq, wt, W, idx = max(plan, key=lambda b: (b[2], len(b[3])))
    ix = torch.as_tensor(idx, device=dev)
    lens = torch.stack([qld[ix], tld[ix]], 1).to(torch.int32)
    call = (Qd[ix, :wq].contiguous(), Td[ix, :wt].contiguous(), lens, sub,
            dict(gap_open=3, gap_extend=1, band=W))
    timed = {}
    for name, fz in (("banded_fused", True), ("banded_forward", False)):
        timing, e = time_banded(call, fused=fz)
        err = max(err, e)
        attrs = (ops.fused_kernel_attrs if fz else ops.forward_kernel_attrs)(
            W, sub.shape[0])
        timed[name] = {"shape": [len(idx), wq, wt, W], **timing, **attrs}
    wide, shape = wide_reads(sub, seed=39)
    for name, fz in (("banded_fused", True), ("banded_forward", False)):
        timing, e = time_banded(wide, fused=fz)
        err = max(err, e)
        attrs = (ops.fused_kernel_attrs if fz else ops.forward_kernel_attrs)(
            shape[3], sub.shape[0])
        timed[name + "_16384"] = {"shape": shape, **timing, **attrs}
    capped_grid_check(wide)
    for name, row in timed.items():
        print(f"adaptive phase, {name}: {json.dumps(row)}")
    return dict(adaptive_banded_pallas=fs, adaptive_banded=bs, fixed=xs,
                buckets=len(plan), timed=timed, max_abs_err=err)


def progressive_phase(fam, device: str = "cuda") -> None:
    """Phase 20(b): ``progressive_msa`` on the card on the Table 4 protein
    family and on N_PROG Phi_RNA sequences: rows decode to their inputs;
    seconds and avg SP beside ``center_star_msa`` on the same family."""
    import torch
    from repro_torch.core.msa import MSAConfig, center_star_msa
    from repro_torch.core.progressive import progressive_msa
    from repro_torch.core.sp_score import avg_sp
    from repro_torch.data import SimConfig, simulate_family
    prot = simulate_family(SimConfig(n_leaves=16, root_len=459,
                                     alphabet="protein", branch_sub=0.05,
                                     branch_indel=0.002, seed=3)).seqs
    cases = (
        ("protein 16 x 459 (Table 4)", prot,
         MSAConfig(method="plain", alphabet="protein", gap_open=8),
         MSAConfig(method="sw", alphabet="protein", gap_open=11,
                   gap_extend=1)),
        (f"Phi_RNA {N_PROG} x ~1,440", fam.seqs[:N_PROG],
         MSAConfig(method="plain"), MSAConfig(method="plain")))
    for label, seqs, cfg, cs_cfg in cases:
        alpha = cfg.alpha()
        out = {}
        for name, fn, c in (("progressive", progressive_msa, cfg),
                            ("center_star", center_star_msa, cs_cfg)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(seqs, c, device=device)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            for s, row in zip(seqs, res.msa):
                if alpha.decode(row).replace("-", "") != s:
                    fail(f"{name} on {label}: a row does not decode to its "
                         "input")
            sp = float(avg_sp(torch.as_tensor(res.msa, device=device),
                              gap_code=alpha.gap_code,
                              n_chars=alpha.n_chars))
            out[name] = dict(seconds=round(sec, 3), width=res.width,
                             avg_sp=round(sp, 3))
        print(f"progressive phase, {label}: {json.dumps(out)}")


# ---------------------------------------------------------------- LM serving

SERVE_ARCH = "h2o-danube-3-4b"   # full width: 24 layers, 32/8 heads of 120
SERVE_ARGS = ("--batch", "4", "--prompt-len", "8192", "--gen", "32")
BF16_OPS_PER_S = 989e12
# (H, KH, D) of the dense configs at full width: llama3.2-1b, qwen1.5-0.5b,
# gemma-2b, h2o-danube-3-4b
FLASH_LAYOUTS = ((32, 8, 64), (16, 16, 64), (8, 1, 256), (32, 8, 120))
# kernel 5 against its plain version's f32 result on the same inputs (bf16
# inputs upcast exactly): in f32 within the JAX package's own tolerance
# (tests/test_kernels_flash.py); in bf16 the kernel's f32 result, rounded
# once to bf16, is within half a bf16 ulp of it (<= 2^-8 |x|) plus that
# tolerance. The JAX tests' bf16 atol of 2e-2 is the size of a typical
# output at these shapes (~sqrt(e / keys)) and would pass a wrong kernel.
FLASH_ATOL = 2e-5
FLASH_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# prefill of S tokens vs prefill of S - 1 plus one decode step, f32
# throughout (weights, activations, cache): the two differ only in the
# order of f32 sums (the kernel's key tiles against one softmax over the
# ring cache, GEMMs of S rows against 1), ~1e-6 relative per operation; the
# bound is the JAX package's own continuity tolerance (tests/test_models.py)
CONTINUITY_ATOL = 2e-3


def flash_inputs(B, S, H, KH, D, dtype, seed, device="cuda", T=None):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    T = S if T is None else T
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((B, S, H, D), (B, T, KH, D), (B, T, KH, D)))


def unmasked_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs a causal / windowed mask keeps over S x S."""
    pos = np.arange(S)
    hi = pos if causal else np.full(S, S - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(S, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_plain32(q, k, v, **kw):
    """The plain version's f32 result on (exactly upcast) inputs."""
    from repro_torch.kernels.flash_attention import ref
    return ref.blocked_attention(q.float(), k.float(), v.float(), **kw)


def flash_error(out, plain32):
    """(largest |out - plain32|, largest excess over the limit); the
    output passes when the excess is <= 0."""
    d = (out.float() - plain32).abs()
    rtol = FLASH_RTOL[str(out.dtype).split(".")[1]]
    excess = (d - rtol * plain32.abs()).max() - FLASH_ATOL
    return float(d.max()), float(excess)


def check_flash(B, S, H, KH, D, causal, window, dtype, seed,
                device="cuda", T=None, q_offset=0, bhsd=False,
                shared_kv=False) -> float:
    """Kernel 5 against its plain version on the same inputs, through
    ``ops.attention`` on (B, S, H, D) tensors, or with ``bhsd`` through
    ``ops.flash_attention`` on (B, H, S, D) ones (transposed strides);
    ``shared_kv`` expands KV head 0 over all KH (head stride 0). Raises
    above the limit, returns the largest difference."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v = flash_inputs(B, S, H, KH, D, dtype, seed, device, T)
    if shared_kv:
        k, v = (x[:, :, :1].expand_as(x) for x in (k, v))
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    if bhsd:
        out = ops.flash_attention(*(x.transpose(1, 2).contiguous()
                                    for x in (q, k, v)), **kw).transpose(1, 2)
    else:
        out = ops.attention(q, k, v, q_offset=q_offset, **kw)
    err, excess = flash_error(out, flash_plain32(q, k, v, q_offset=q_offset,
                                                 **kw))
    if out.dtype != dtype or out.shape != q.shape or not excess <= 0:
        fail(f"flash_attention differs from its plain version at B={B} "
             f"S={S} T={T} H/KH/D={H}/{KH}/{D} causal={causal} "
             f"window={window} q_offset={q_offset} bhsd={bhsd} "
             f"shared_kv={shared_kv} "
             f"{dtype}: {err}, {excess} over the limit")
    return err


def flash_cases():
    """(B, S, H, KH, D, causal, window, dtype[, check_flash keywords]) of
    every shape kernel 5 is held at."""
    import torch
    cases = []
    for H, KH, D in FLASH_LAYOUTS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in ((True, 0), (False, 0), (True, 64)):
                cases.append((1, 2048, H, KH, D, causal, window, dtype))
            cases.append((2, 1000, H, KH, D, True, 64, dtype))     # ragged
            cases.append((2, 37, H, KH, D, False, 0, dtype))
            cases.append((3, 1, H, KH, D, True, 0, dtype))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((1, 8192, 32, 8, 120, True, 4096, dtype))
        cases.append((1, 2048, 32, 8, 120, False, 64, dtype))
        # D <= 32: padded to 64 columns, zeros past D
        cases.append((2, 300, 4, 2, 32, True, 128, dtype))
        cases.append((1, 200, 2, 1, 8, False, 0, dtype))
        # the bf16 kernel's element route at each padded head dim (64, 128,
        # 256): D % 8 != 0, and K/V expanded over the KV heads (a head
        # stride of 0, which TMA cannot take)
        for D in (60, 100, 250):
            cases.append((2, 300, 4, 2, D, True, 128, dtype))
        for D in (64, 120, 256):
            cases.append((2, 700, 8, 2, D, True, 256, dtype,
                          dict(shared_kv=True)))
        # a continued prefill: 1,000 queries at positions 2,000.. over
        # 3,000 keys
        cases.append((1, 1000, 8, 2, 64, True, 1024, dtype,
                      dict(T=3000, q_offset=2000)))
        # the (B, H, S, D) entry, transposed strides
        cases.append((2, 700, 8, 2, 120, True, 256, dtype, dict(bhsd=True)))
        # the other families' layouts (phase 21)
        for H, KH, D, causal in FAMILY_FLASH_LAYOUTS:
            cases.append((1, 2048, H, KH, D, causal, 0, dtype))
    return cases


def flash_checks(device="cuda") -> float:
    cases = flash_cases()
    t0 = time.time()
    err = max(check_flash(*c[:8], seed=i, device=device,
                          **(c[8] if len(c) > 8 else {}))
              for i, c in enumerate(cases))
    print(f"flash_attention within its limits of its plain version at "
          f"{len(cases)} shapes (largest difference {err}) in "
          f"{time.time() - t0:.1f} s")
    return err


def serve_phase(device="cuda", smoke=False) -> int:
    """``repro_torch.launch.serve`` at full width, with kernel 5's launch
    count reset just before it; returns the count. The peak is the run's
    own: above the memory in use at its start."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    spec = get_arch(SERVE_ARCH)
    cfg = spec.smoke if smoke else spec.config
    argv = ["--arch", SERVE_ARCH, *SERVE_ARGS] + (["--smoke"] if smoke
                                                  else [])
    if device != "cuda":
        argv += ["--device", device]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_peak()
    t0 = time.time()
    ops.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = ops.launches
    wall = time.time() - t0
    tokens, logits = res["tokens"], res["logits"]
    B, gen = int(SERVE_ARGS[1]), int(SERVE_ARGS[5])
    print(f"serve {cfg.name} {' '.join(SERVE_ARGS)}: prefill "
          f"{res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms_per_token']:.2f} ms/token, wall {wall:.2f} s "
          f"(weights included), peak device memory "
          f"{(device_peak() - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB in use at its start, flash_attention "
          f"launches {launches}")
    if launches != cfg.n_layers:
        fail(f"serve launched flash_attention {launches} times, not once "
             f"per layer ({cfg.n_layers})")
    if tuple(tokens.shape) != (B, gen) or \
            tuple(logits.shape) != (B, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"serve: tokens {tuple(tokens.shape)} in "
             f"[{int(tokens.min())}, {int(tokens.max())}], logits "
             f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    return launches


def continuity_check(device="cuda", smoke=False, S=8192) -> float:
    """Last-token logits of a prefill of S tokens against a prefill of
    S - 1 plus one decode step, B = 1, f32 throughout."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    spec = get_arch(SERVE_ARCH)
    cfg = spec.smoke if smoke else spec.config
    t0 = time.time()
    params = tt.init_params(cfg, 0, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                         device=device)
    f32 = dict(logits_mode="last", compute_dtype=torch.float32)
    full, _, _ = tt.apply_model(params, cfg, {"tokens": toks}, **f32)
    cache = tt.init_cache(cfg, 1, S, dtype=torch.float32, device=device)
    _, cache, _ = tt.apply_model(params, cfg, {"tokens": toks[:, :-1]},
                                 cache=cache, **f32)
    pos = torch.full((1, 1), S - 1, dtype=torch.int32, device=device)
    dec, _, _ = tt.apply_model(params, cfg, {"tokens": toks[:, -1:],
                                             "positions": pos},
                               cache=cache, **f32)
    err = float((dec - full).abs().max())
    print(f"continuity {cfg.name}, f32, prefill {S} vs {S - 1} + 1 decode: "
          f"max |logit difference| {err} (logits up to "
          f"{float(full.abs().max()):.3f}; bound {CONTINUITY_ATOL}), "
          f"{time.time() - t0:.1f} s")
    if not err <= CONTINUITY_ATOL:
        fail(f"continuity: {err} > {CONTINUITY_ATOL}")
    return err


def time_flash(B=4, S=8192, H=32, KH=8, D=120, causal=True, W=4096,
               label="the serve shape"):
    """Kernel 5 at one prefill shape (by default the serve shape) beside
    its bound, its plain version and ``scaled_dot_product_attention``
    (the port never calls it); returns (timings, largest difference from
    the plain version)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = flash_inputs(B, S, H, KH, D, torch.bfloat16, seed=99)
    kw = dict(scale=D ** -0.5, causal=causal, window=W)
    ms, out = cuda_ms(lambda: ops.attention(q, k, v, **kw))
    plain_ms, plain = cuda_ms(lambda: ref.blocked_attention(q, k, v, **kw),
                              reps=1)
    del plain
    err, excess = flash_error(out, flash_plain32(q, k, v, **kw))
    if not excess <= 0:
        fail(f"flash_attention at {label}: {err}, {excess} over the limit")
    # the yardstick: one SDPA call with the same mask and GQA, on
    # (B, H, S, D) copies made outside the timing
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask = None
    if W > 0:
        pos = torch.arange(S, device="cuda")
        mask = (pos[:, None] - pos[None, :] < W) & \
            ((pos[:, None] >= pos[None, :]) if causal else True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                is_causal=causal and mask is None, enable_gqa=True)
    lib_ms, lib = cuda_ms(sdpa)
    lib_err = float((lib.transpose(1, 2).float() - out.float()).abs().max())
    pairs = unmasked_pairs(S, causal, W) * B * H
    t_ops = pairs * 4 * D / BF16_OPS_PER_S * 1e3
    t_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 \
        / HBM_BYTES_PER_S * 1e3
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  library_ms=lib_ms)
    print(f"flash_attention at {label} {B}x{H}x{S}x{D} (KH {KH}, causal "
          f"{causal}, window {W}, bf16, {pairs} unmasked pairs): "
          f"{json.dumps(timing)}; sdpa differs from the kernel by {lib_err}")
    return timing, err


def lm_phase(device="cuda", smoke=False):
    """Phase 17: returns kernel 5's serve-run launches, its timings at the
    serve shape and its largest difference from the plain version."""
    import torch
    err = flash_checks(device)
    launches = serve_phase(device, smoke)
    continuity_check(device, smoke, S=48 if smoke else 8192)
    if device != "cuda":
        return launches, None, err
    torch.cuda.empty_cache()
    timing, e = time_flash()
    return launches, timing, max(err, e)


# ------------------------------------------------------------ LM families

# phase 21: the LM's other families. Each run is (arch, cuts of the
# published config, batch, prompt, decode steps, kernel-5 launches its
# prefill makes: one an attention layer)
FAMILY_SERVE_ARCH = "mamba2-130m"                 # full width and depth
FAMILY_SERVE_ARGS = ("--batch", "4", "--prompt-len", "8192", "--gen", "32")
FAMILY_RUNS = (
    ("moonshot-v1-16b-a3b", dict(n_layers=12), 4, 2048, 31, 12),
    ("qwen2-vl-2b", {}, 4, 4096, 15, 28),
    ("jamba-1.5-large-398b", dict(n_layers=8, d_ff=4096), 2, 4096, 15, 1),
    ("kimi-k2-1t-a32b", dict(n_layers=2, n_experts=32), 2, 2048, 7, 2),
)
HUBERT = ("hubert-xlarge", 4, 4096, 48)         # apply_model, not causal
VL_IMAGE_GRID = 32                              # qwen2-vl's 32 x 32 patches
# f32 continuity at B = 1: (arch, cuts, prompt length). A prefill of N
# tokens may drop a pick that one decode step keeps, so the MoE configs
# run at a capacity factor of at least E / K, where C = T and nothing
# drops (moonshot's 64 / 6 = 10.7: 8.0 dropped picks of its skewed
# random-weight routing on the card)
FAMILY_CONTINUITY = (
    ("mamba2-130m", {}, 8192),
    ("moonshot-v1-16b-a3b", dict(n_layers=12, capacity_factor=11.0), 2048),
    ("jamba-1.5-large-398b", dict(n_layers=8, d_ff=4096,
                                  capacity_factor=8.0), 4096),
)
# (H, KH, D, causal) of the families' attention at full width: moonshot,
# kimi, qwen2-vl, jamba (causal), hubert (not causal)
FAMILY_FLASH_LAYOUTS = ((16, 16, 128, True), (64, 8, 112, True),
                        (12, 2, 128, True), (64, 8, 128, True),
                        (16, 16, 80, False))


def family_cfg(arch: str, cuts: dict, smoke: bool = False):
    import dataclasses

    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    if smoke:
        keep = {k: v for k, v in cuts.items() if k == "capacity_factor"}
        return dataclasses.replace(spec.smoke, **keep)
    return dataclasses.replace(spec.config, **cuts)


def vl_positions(B: int, S: int, device, grid: int = VL_IMAGE_GRID):
    """qwen2-vl's three position streams (3, B, S) for a text run, an image
    of grid x grid patches (t constant, h and w over the grid) and text
    again, each text position one past the largest before it."""
    import torch
    while 2 * grid * grid > S:         # a short rehearsal prompt
        grid //= 2
    n_text = (S - grid * grid) // 4
    n_img = grid * grid
    pos = torch.empty((3, S), dtype=torch.int32, device=device)
    pos[:, :n_text] = torch.arange(n_text, device=device)
    r = torch.arange(n_img, device=device)
    pos[0, n_text:n_text + n_img] = n_text
    pos[1, n_text:n_text + n_img] = n_text + r // grid
    pos[2, n_text:n_text + n_img] = n_text + r % grid
    rest = S - n_text - n_img
    pos[:, n_text + n_img:] = n_text + grid + torch.arange(rest,
                                                          device=device)
    return pos[:, None].expand(3, B, S).contiguous()


def family_batch(cfg, B: int, S: int, device, seed: int = 1):
    """Random tokens, or random embeddings (and M-RoPE positions) for a
    model that takes them."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.embed_input:
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=g, device=device)}
    batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=g,
                                   device=device)}
    if cfg.m_rope:
        batch["pos3"] = vl_positions(B, S, device)
    return batch


class DropWatch:
    """Count the MoE's dropped picks (place >= capacity) of every
    ``moe_route`` call while it is on, on the device (no sync)."""

    def __enter__(self):
        from repro_torch.models import layers
        self.saved, self.dropped, self.picks = layers.moe_route, [], 0
        watch = self

        def route(logits, K, C):
            out = watch.saved(logits, K, C)
            watch.dropped.append((~out[4]).sum())
            watch.picks += out[4].numel()
            return out
        layers.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe_route = self.saved
        return False

    def count(self) -> int:
        return int(sum(int(d) for d in self.dropped))


def largest_tensor(fn, *args, **kw):
    """Run ``fn`` once, recording the largest tensor any operation inside
    it makes (a dispatch mode sees every output) and its device memory
    above what was allocated when it began; returns (bytes, op, peak
    bytes)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        size, op = 0, ""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    n = t.untyped_storage().nbytes()
                    if n > Largest.size:
                        Largest.size, Largest.op = n, str(func)
            return out

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_peak()
    with Largest():
        fn(*args, **kw)
    torch.cuda.synchronize()
    return Largest.size, Largest.op, device_peak() - base


def run_start():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_peak()
    return base


def check_logits(logits, shape, what: str, tokens=None, vocab=None):
    import torch
    if tuple(logits.shape) != tuple(shape) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{what}: logits {tuple(logits.shape)} (expected {shape}), "
             f"finite {bool(torch.isfinite(logits).all())}")
    if tokens is not None and not bool(((tokens >= 0) &
                                        (tokens < vocab)).all()):
        fail(f"{what}: tokens outside [0, {vocab})")


def family_serve_run(device="cuda", smoke=False) -> dict:
    """``launch.serve --arch mamba2-130m`` at full width and depth:
    attention-free, so kernel 5 is launched 0 times."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    cfg = family_cfg(FAMILY_SERVE_ARCH, {}, smoke)
    argv = ["--arch", FAMILY_SERVE_ARCH, *FAMILY_SERVE_ARGS] + \
        (["--smoke", "--device", device] if smoke else [])
    base = run_start()
    t0 = time.time()
    ops.launches = 0
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = ops.launches
    B, gen = int(FAMILY_SERVE_ARGS[1]), int(FAMILY_SERVE_ARGS[5])
    row = dict(prefill_ms=res["prefill_ms"],
               decode_ms_per_token=res["decode_ms_per_token"],
               wall_s=round(time.time() - t0, 2),
               peak_gib=round((device_peak() - base) / 2 ** 30, 3),
               base_gib=round(base / 2 ** 30, 3), flash_launches=launches)
    print(f"family serve {cfg.name} {' '.join(FAMILY_SERVE_ARGS)}: "
          f"{json.dumps(row)}")
    check_logits(res["logits"], (B, cfg.vocab_size), "family serve",
                 res["tokens"], cfg.vocab_size)
    if tuple(res["tokens"].shape) != (B, gen) or launches != 0:
        fail(f"family serve {cfg.name}: tokens {tuple(res['tokens'].shape)}"
             f", flash_attention launches {launches} (attention-free: 0)")
    return row


def family_steps_run(arch, cuts, B, S, n_decode, want_launches,
                     device="cuda", smoke=False):
    """``make_prefill_step`` / ``make_decode_step`` on one family at its
    phase-21 size, with kernel 5's count reset just before the prefill
    and read after it; decode feeds back greedy tokens, or fresh random
    embedding rows where the model takes embeddings. Returns (row,
    params)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as tt
    from repro_torch.train import serve_step
    cfg = family_cfg(arch, cuts, smoke)
    run_start()
    t0 = time.time()
    params = tt.init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    base = run_start()                # the weights are in use at its start
    batch = family_batch(cfg, B, S, device)
    rows = family_batch(cfg, B, n_decode, device, seed=2)
    prefill = serve_step.make_prefill_step(cfg, max_len=S + n_decode)
    decode = serve_step.make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.launches = 0
    with DropWatch() as drops:
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    launches = ops.launches
    check_logits(logits, (B, cfg.vocab_size), f"{arch} prefill")
    toks = [torch.argmax(logits, -1).to(torch.int32)]
    pos = torch.full((B,), S, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    for i in range(n_decode):
        x = toks[-1] if cfg.embed_input else rows["embeds"][:, i]
        logits, cache = decode(params, cache, x, pos)
        toks.append(torch.argmax(logits, -1).to(torch.int32))
        pos = pos + 1
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    check_logits(logits, (B, cfg.vocab_size), f"{arch} decode",
                 torch.stack(toks, 1), cfg.vocab_size)
    row = dict(layers=cfg.n_layers, batch=B, prompt=S, decode_steps=n_decode,
               init_s=round(t_init, 2),
               prefill_ms=round(t_prefill * 1e3, 3),
               decode_ms_per_token=round(t_decode / n_decode * 1e3, 3),
               peak_gib=round((device_peak() - base) / 2 ** 30, 3),
               base_gib=round(base / 2 ** 30, 3), flash_launches=launches)
    if cfg.n_experts:
        row.update(moe_dropped=drops.count(), moe_picks=drops.picks)
    print(f"family {cfg.name} ({json.dumps(cuts)}): {json.dumps(row)}")
    if launches != want_launches and not smoke:
        fail(f"{arch}: prefill launched flash_attention {launches} times, "
             f"not once per attention layer ({want_launches})")
    del cache, logits
    return row, params


def hubert_run(device="cuda", smoke=False) -> dict:
    """``apply_model`` on the audio encoder at full width and depth:
    frame embeddings in, not causal, no cache."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as tt
    arch, B, S, want = HUBERT
    cfg = family_cfg(arch, {}, smoke)
    run_start()
    params = tt.init_params(cfg, 0, device=device)
    base = run_start()                # the weights are in use at its start
    batch = family_batch(cfg, B, S, device)
    tt.apply_model(params, cfg, {"embeds": batch["embeds"][:, :64]})
    torch.cuda.synchronize()
    ops.launches = 0
    t0 = time.perf_counter()
    logits, _, aux = tt.apply_model(params, cfg, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launches
    check_logits(logits, (B, S, cfg.vocab_size), f"{arch} encoder pass")
    row = dict(layers=cfg.n_layers, batch=B, frames=S,
               encoder_ms=round(ms, 3),
               peak_gib=round((device_peak() - base) / 2 ** 30, 3),
               base_gib=round(base / 2 ** 30, 3), flash_launches=launches)
    print(f"family {cfg.name} apply_model (not causal): {json.dumps(row)}")
    if launches != (cfg.n_layers if smoke else want):
        fail(f"{arch}: flash_attention launched {launches} times, not once "
             f"per layer ({want})")
    return row


def family_continuity(arch, cuts, S, device="cuda", smoke=False,
                      params=None) -> float:
    """Last-token logits of a prefill of S tokens against a prefill of
    S - 1 plus one decode step, B = 1, f32 throughout."""
    import torch
    from repro_torch.models import transformer as tt
    cfg = family_cfg(arch, cuts, smoke)
    t0 = time.time()
    if params is None:
        params = tt.init_params(cfg, 0, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                         device=device)
    f32 = dict(logits_mode="last", compute_dtype=torch.float32)
    with DropWatch() as drops:
        full, _, _ = tt.apply_model(params, cfg, {"tokens": toks}, **f32)
        cache = tt.init_cache(cfg, 1, S, dtype=torch.float32, device=device)
        _, cache, _ = tt.apply_model(params, cfg, {"tokens": toks[:, :-1]},
                                     cache=cache, **f32)
        pos = torch.full((1, 1), S - 1, dtype=torch.int32, device=device)
        dec, _, _ = tt.apply_model(params, cfg, {"tokens": toks[:, -1:],
                                                 "positions": pos},
                                   cache=cache, **f32)
    err = float((dec - full).abs().max())
    print(f"continuity {cfg.name} ({json.dumps(cuts)}), f32, prefill {S} "
          f"vs {S - 1} + 1 decode: max |logit difference| {err} (logits up "
          f"to {float(full.abs().max()):.3f}; bound {CONTINUITY_ATOL}; MoE "
          f"picks dropped {drops.count()}), {time.time() - t0:.1f} s")
    if drops.count():
        fail(f"continuity {cfg.name}: the MoE dropped picks")
    if not err <= CONTINUITY_ATOL:
        fail(f"continuity {cfg.name}: {err} > {CONTINUITY_ATOL}")
    return err


def family_memory(device="cuda", smoke=False) -> None:
    """The largest tensor one ``moe_block`` call (moonshot's width, its
    4 x 2,048 prefill) and one ``ssd_chunked`` call (mamba2-130m's 4 x
    8,192 prefill; jamba's 2 x 4,096) make, beside the reference's (T, E,
    C) f32 one-hot and the SSD's (B, nc, nh, Q, Q) f32 decay."""
    import torch
    from repro_torch.models import layers, mamba2, transformer as tt
    cfg = family_cfg("moonshot-v1-16b-a3b", dict(n_layers=1), smoke)
    p = tt.init_params(cfg, 0, device=device)["layers"][0]["moe"]
    B, S = (4, 2048) if not smoke else (2, 40)
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=device
                    ).bfloat16()
    T = B * S
    C = layers._moe_capacity(T, cfg)
    with torch.inference_mode():
        big, op, peak = largest_tensor(layers.moe_block, p, x, cfg)
    onehot = T * cfg.n_experts * C * 4
    print(f"moe_block {cfg.name} T={T} E={cfg.n_experts} C={C} bf16: "
          f"largest tensor {big / 2**20:.1f} MiB ({op}), call peak "
          f"{peak / 2**20:.1f} MiB above its start; the reference's (T, E, "
          f"C) f32 dispatch {onehot / 2**20:.1f} MiB")
    if big >= onehot:
        fail("moe_block made a tensor as large as (T, E, C)")
    del p, x
    for arch, cuts, B, S in (("mamba2-130m", {}, 4, 8192),
                             ("jamba-1.5-large-398b", {}, 2, 4096)):
        cfg = family_cfg(arch, cuts, smoke)
        if smoke:
            B, S = 2, 300
        nh, hp, st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        g = torch.Generator(device=device).manual_seed(5)
        x = torch.randn((B, S, nh, hp), generator=g, device=device
                        ).bfloat16()
        dt = torch.rand((B, S, nh), generator=g, device=device) * 0.1
        A = -torch.rand((nh,), generator=g, device=device) - 0.5
        Bm, Cm = (torch.randn((B, S, st), generator=g, device=device)
                  for _ in range(2))
        with torch.inference_mode():
            big, op, peak = largest_tensor(mamba2.ssd_chunked, x, dt, A, Bm,
                                           Cm)
        nc = -(-S // 128)
        decay = B * nc * nh * 128 * 128 * 4
        print(f"ssd_chunked {cfg.name} B={B} S={S} nh={nh} hp={hp} st={st}:"
              f" largest tensor {big / 2**20:.1f} MiB ({op}), call peak "
              f"{peak / 2**20:.1f} MiB above its start; the (B, nc, nh, Q, "
              f"Q) f32 decay {decay / 2**20:.1f} MiB, a (B, nc, Q, Q, nh, "
              f"hp) one {decay * hp / 2**30:.1f} GiB")
        if big > decay:
            fail(f"ssd_chunked made a tensor larger than its decay ({big} > "
                 f"{decay} bytes)")


def families_phase(device="cuda", smoke=False):
    """Phase 21: the LM's other families on the card (see the module
    docstring); returns the rows printed."""
    import gc

    import torch
    rows = {"serve " + FAMILY_SERVE_ARCH: family_serve_run(device, smoke)}
    cont = {arch: (cuts, S) for arch, cuts, S in FAMILY_CONTINUITY}
    for arch, cuts, B, S, n_dec, want in FAMILY_RUNS:
        if smoke:
            B, S, n_dec = 2, 40, 3
        row, params = family_steps_run(arch, cuts, B, S, n_dec, want,
                                       device, smoke)
        rows[arch] = row
        if arch in cont:
            ccuts, cS = cont.pop(arch)
            family_continuity(arch, ccuts, 48 if smoke else cS, device,
                              smoke, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch, (ccuts, cS) in cont.items():
        family_continuity(arch, ccuts, 48 if smoke else cS, device, smoke)
        gc.collect()
        torch.cuda.empty_cache()
    rows["hubert"] = hubert_run(device, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    family_memory(device, smoke)
    if device == "cuda":
        for arch, (B, S, H, KH, D, causal) in (
                ("qwen2-vl-2b", (4, 4096, 12, 2, 128, True)),
                ("hubert-xlarge", (4, 4096, 16, 16, 80, False))):
            rows[f"flash {arch}"], _ = time_flash(
                B, S, H, KH, D, causal, 0, label=f"{arch}'s prefill shape")
    return rows


# ---------------------------------------------------------------- LM training

# phase 22 (a): launch.train on llama3.2-1b at its published config (16
# layers, d 2,048, GQA 32/8 of 64, d_ff 8,192, vocab 128,256, tied), the
# reference's train_4k shape (4,096 tokens) with its 4-way microbatching
TRAIN_ARCH = "llama3.2-1b"
TRAIN_ARGS = ("--batch", "8", "--seq", "4096", "--micro", "4")
TRAIN_SMOKE_ARGS = ("--batch", "4", "--seq", "64", "--micro", "2")
TRAIN_STEPS, TRAIN_RESUMED, TRAIN_CKPT_EVERY = 4, 6, 2
# the checkpoints of a full-depth run (14.8 GB of params, m and v each, 5
# writes for 4 steps every 2 and a resume to 6: 74 GB) would outgrow the
# disk writes a machine with one card can take within the script's run:
# the resume is held at the same shape on llama3.2-1b cut to 2 layers
# (4.6 GB a checkpoint, 23 GB in all)
TRAIN_RESUME_LAYERS = 2
TRAIN_RESUME_ARCH = "llama3.2-1b-2-layers"
# the first loss within [ln V - 0.1, ln V + 1.0]: at init the tied head's
# logits have variance ~ d * 0.02^2 (the final norm starts at zero), so
# ~ln V + 0.41
FIRST_LOSS_BAND = (-0.1, 1.0)
RESUME_ATOL = 1e-5
# (b) card against CPU at f32: the norm of each gradient (or updated
# state) leaf's difference within 1e-4 of the CPU leaf's norm; losses
# within 1e-5 of the CPU's, relative
TRAIN_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_CPU_CUT = ("llama3.2-1b", dict(n_layers=2), 1, 1024)
TRAIN_SMOKE_FAMILIES = ("h2o-danube-3-4b", "gemma-2b", "kimi-k2-1t-a32b",
                        "mamba2-130m", "jamba-1.5-large-398b",
                        "qwen2-vl-2b", "hubert-xlarge")
# (c) one bf16 step a non-dense family at the published width of phase
# 21's config, 2 x 2,048 tokens in 2 microbatches; each cut keeps weights,
# gradients and Adam state (16 bytes a parameter) under 40 GB:
# (arch, cuts, why)
TRAIN_FAMILY_RUNS = (
    ("moonshot-v1-16b-a3b", dict(n_layers=2),
     "2 of 48 layers: 1.81 B parameters, 29.0 GB (48: 7.5 B per 12)"),
    ("qwen2-vl-2b", {}, "full depth: 1.54 B, 24.7 GB"),
    ("jamba-1.5-large-398b",
     dict(n_layers=2, attn_period=2, d_ff=4096, n_experts=2),
     "one mamba layer and one attention-MoE layer (the 8-layer group cut "
     "to 2: one mamba layer of d_inner 16,384 is 0.40 B), d_ff 24,576 -> "
     "4,096 and 2 of 16 experts (top-2)"),
    ("kimi-k2-1t-a32b", dict(n_layers=2, n_experts=8, vocab_size=32768),
     "the dense prefix layer and one MoE layer of 8 of 384 experts (top-8)"
     "; vocabulary 163,840 -> 32,768 (the untied embedding and head alone "
     "are 2.35 B parameters, 37.6 GB)"),
    ("mamba2-130m", {}, "full depth: 0.13 B"),
    ("hubert-xlarge", {}, "full depth: 1.26 B, 20.1 GB"),
)
TRAIN_FAMILY_SHAPE = (2, 2048, 2)          # batch, sequence, microbatches


def train_flops(cfg, B: int, S: int, micro: int) -> dict:
    """Model FLOPs of one training step: 6·N·tokens for the products of
    the layers and the head (N excludes the embedding lookup), remat's
    extra forward of the layers (2·N_layers·tokens), and causal attention
    (4·D a query-key pair forward, twice that backward, once more for
    remat), for a dense model."""
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    n_layers = cfg.param_count() - V * D * (1 if cfg.tie_embeddings else 2)
    n_head = V * D
    tokens = B * S
    pairs = S * (S + 1) // 2 if cfg.causal else S * S
    attn_fwd = 4 * cfg.head_dim * pairs * cfg.n_heads * B * L
    out = dict(dense=6 * (n_layers + n_head) * tokens,
               remat=2 * n_layers * tokens, attention=4 * attn_fwd)
    out["total"] = sum(out.values())
    return out


def train_run(argv, device: str, smoke: bool):
    """``launch.train.main(argv)`` with kernel 5's count reset just before
    it; returns (result, launches, seconds, device peak)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train
    argv = list(argv) + (["--smoke", "--device", device] if smoke else [])
    run_start()
    ops.launches = 0
    t0 = time.time()
    res = train.main(argv)
    torch.cuda.synchronize()
    return res, ops.launches, time.time() - t0, device_peak()


def train_profile(cfg, args, device: str, step_ms: float) -> dict:
    """One training step at the full run's shape under ``torch.profiler``:
    the device time of the kernels inside the attention backward's range
    against the step's kernel time, and that against ``step_ms`` (an
    unprofiled step's wall time: the profiler slows the host)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.train import batch_for
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_state, make_train_step
    B, S, micro = (int(args[i]) for i in (1, 3, 5))
    run_start()
    state = init_state(cfg, 0, device=device)
    step = make_train_step(cfg, AdamWConfig(), microbatches=micro)
    batch = batch_for(0, B, S, cfg.vocab_size, device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        state, m = step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    cpu = torch.autograd.DeviceType.CPU
    # kernels only (the profiler table's "Self CUDA time total"); the
    # backward's range as the kernels launched inside it (its CPU-side
    # event; the GPU-side annotation spans gaps too)
    dev_total = sum(e.self_device_time_total for e in ev
                    if e.device_type != cpu and
                    not getattr(e, "is_user_annotation", False)) / 1e3
    bwd = sum(e.device_time_total for e in ev
              if e.key == ops.BWD_RANGE and e.device_type == cpu) / 1e3
    del state
    return dict(profiled_step_wall_ms=round(wall, 3),
                device_ms=round(dev_total, 3),
                attention_backward_device_ms=round(bwd, 3),
                attention_backward_share_of_device=(
                    round(bwd / dev_total, 4) if dev_total else None),
                device_busy_share_of_step=(round(dev_total / step_ms, 4)
                                           if dev_total else None))


def train_full_run(device="cuda", smoke=False) -> dict:
    """Phase 22 (a), the full-width run: ``launch.train`` at the published
    config, 4 steps, kernel 5's launches counted over the run; then one
    profiled step."""
    import gc

    from repro_torch.configs import get_arch
    spec = get_arch(TRAIN_ARCH)
    cfg = spec.smoke if smoke else spec.config
    args = TRAIN_SMOKE_ARGS if smoke else TRAIN_ARGS
    B, S, micro = (int(args[i]) for i in (1, 3, 5))
    res, launches, secs, peak = train_run(
        ["--arch", TRAIN_ARCH, *args, "--steps", str(TRAIN_STEPS)], device,
        smoke)
    del res["state"]
    gc.collect()
    hist = res["history"]
    for h in hist:
        print(f"train {cfg.name} step {h['step']}: {h['ms']:.1f} ms, loss "
              f"{h['loss']:.6f}, grad_norm {h['grad_norm']:.4f}, lr "
              f"{h['lr']:.3g}, {B * S / h['ms'] * 1e3:.0f} tokens/s")
    n = cfg.param_count()
    state_bytes = 16 * n
    fl = train_flops(cfg, B, S, micro)
    ms = float(np.median([h["ms"] for h in hist[1:]]))
    row = dict(layers=cfg.n_layers, batch=B, seq=S, micro=micro,
               params=n, step_ms=round(ms, 3),
               first_step_ms=round(hist[0]["ms"], 3),
               tokens_per_s=round(B * S / ms * 1e3, 1),
               model_tflop_per_step=round(fl["total"] / 1e12, 3),
               flops=fl, mfu=round(fl["total"] / (ms / 1e3)
                                   / BF16_OPS_PER_S, 4),
               peak_gib=round(peak / 2 ** 30, 3),
               peak_above_state_gib=round((peak - state_bytes) / 2 ** 30, 3),
               state_gib=round(state_bytes / 2 ** 30, 3),
               flash_launches_per_step=launches / TRAIN_STEPS,
               run_s=round(secs, 2), first_loss=hist[0]["loss"],
               ln_vocab=round(math.log(cfg.vocab_size), 6))
    print(f"train {cfg.name} {' '.join(args)}: {json.dumps(row)}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        fail(f"train: a non-finite loss or grad norm: {hist}")
    lo, hi = FIRST_LOSS_BAND
    ln_v = math.log(cfg.vocab_size)
    if not ln_v + lo <= hist[0]["loss"] <= ln_v + hi:
        fail(f"train: first loss {hist[0]['loss']} outside [ln V {lo:+}, "
             f"ln V {hi:+}] (ln V = {ln_v:.4f})")
    want = 2 * cfg.n_layers * micro          # forward + remat's recompute
    if not smoke and launches != want * TRAIN_STEPS:
        fail(f"train: flash_attention launched {launches} times in "
             f"{TRAIN_STEPS} steps, not {want} a step (every attention "
             "layer's forward and its recompute)")
    prof = train_profile(cfg, args, device, ms)
    row.update(prof)
    print(f"train {cfg.name} one profiled step: {json.dumps(prof)}")
    return row


def train_resume_check(work: Path, device="cuda", smoke=False) -> dict:
    """Phase 22 (a), checkpoints: ``launch.train`` at the full run's shape
    on llama3.2-1b cut to ``TRAIN_RESUME_LAYERS`` layers (registered as
    ``TRAIN_RESUME_ARCH``), 4 steps with a checkpoint every 2, a resume
    to 6 and an uninterrupted 6-step run, under deterministic algorithms
    (the card then repeats itself): the resumed step-5 loss must be the
    uninterrupted run's."""
    import dataclasses
    import gc
    import shutil

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchSpec, register
    spec = get_arch(TRAIN_ARCH)
    cfg = spec.smoke if smoke else dataclasses.replace(
        spec.config, n_layers=TRAIN_RESUME_LAYERS)
    register(TRAIN_RESUME_ARCH, ArchSpec(cfg, spec.smoke))
    args = TRAIN_SMOKE_ARGS if smoke else TRAIN_ARGS
    micro = int(args[5])
    ckpt = work / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--arch", TRAIN_RESUME_ARCH, *args]
    saves = ["--ckpt-dir", str(ckpt), "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        for label, argv in (
                ("first", ["--steps", str(TRAIN_STEPS)] + saves),
                ("resumed", ["--steps", str(TRAIN_RESUMED)] + saves
                 + ["--resume"]),
                ("plain", ["--steps", str(TRAIN_RESUMED)])):
            res, launches, secs, _ = train_run(base + argv, device, smoke)
            del res["state"]
            gc.collect()
            runs[label] = (res["history"], launches, secs)
    finally:
        torch.use_deterministic_algorithms(prev)
    files = sorted(p.name for p in ckpt.iterdir())
    size = sum(p.stat().st_size for p in ckpt.iterdir())
    shutil.rmtree(ckpt, ignore_errors=True)
    first, resumed, plain = (runs[k][0] for k in ("first", "resumed",
                                                  "plain"))
    r5, u5 = resumed[-1], plain[TRAIN_RESUMED - 1]
    row = dict(layers=cfg.n_layers, params=cfg.param_count(),
               first_s=round(runs["first"][2], 2),
               resumed_s=round(runs["resumed"][2], 2),
               plain_s=round(runs["plain"][2], 2),
               first_steps_ms=[round(h["ms"], 3) for h in first],
               resumed_steps_ms=[round(h["ms"], 3) for h in resumed],
               plain_steps_ms=[round(h["ms"], 3) for h in plain],
               checkpoints=files, checkpoint_gib=round(size / len(files)
                                                       / 2 ** 30, 3),
               resumed_step5_loss=r5["loss"], plain_step5_loss=u5["loss"],
               launches=[runs[k][1] for k in ("first", "resumed", "plain")])
    print(f"train {cfg.name} ({TRAIN_RESUME_LAYERS} layers) checkpoints "
          f"and resume: {json.dumps(row)}")
    every = first + resumed + plain
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in every):
        fail(f"train: a non-finite loss or grad norm: {every}")
    if [h["step"] for h in resumed] != [4, 5] or \
            abs(r5["loss"] - u5["loss"]) > RESUME_ATOL:
        fail(f"train: the resumed run's step-5 loss {r5['loss']} is not "
             f"the uninterrupted run's {u5['loss']} (steps "
             f"{[h['step'] for h in resumed]})")
    want = 2 * cfg.n_layers * micro
    if not smoke and [runs[k][1] for k in ("first", "resumed", "plain")] \
            != [want * TRAIN_STEPS, want * 2, want * TRAIN_RESUMED]:
        fail(f"train: flash_attention launches {row['launches']}, not "
             f"{want} a step")
    return row


def train_loss_grads(params, cfg, batch):
    """f32 loss and the gradient of every leaf (flatten order)."""
    import torch
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import loss_fn
    live = [p.detach().requires_grad_() for p in topt.tree_leaves(params)]
    with torch.enable_grad():
        total, _ = loss_fn(topt.tree_unflatten(params, live), cfg, batch,
                           compute_dtype=torch.float32)
        total.backward()
    return float(total.detach()), [p.grad for p in live]


def leaf_errors(card, cpu) -> float:
    """The largest ``||card - cpu|| / ||cpu||`` over the leaves (a
    leaf whose CPU norm is 0 must be 0 on the card too)."""
    worst = 0.0
    for a, b in zip(card, cpu):
        a = a.detach().float().cpu()
        b = b.detach().float()
        d, nb = float((a - b).norm()), float(b.norm())
        worst = max(worst, d / nb if nb else (0.0 if d == 0 else math.inf))
    return worst


def to_device(tree, device):
    from repro_torch.train import optimizer as topt
    return topt.tree_map(lambda t: t.to(device), tree)


def train_card_vs_cpu(device="cuda", smoke=False) -> dict:
    """Phase 22 (b): llama3.2-1b at full width cut to 2 layers, 1 x 1,024
    tokens, and one ``make_train_step`` step of each family's smoke
    config, f32, on the card against the port's CPU path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import init_state, make_train_step
    out = {}
    arch, cuts, B, S = TRAIN_CPU_CUT
    spec = get_arch(arch)
    cfg = spec.smoke if smoke else dataclasses.replace(spec.config, **cuts)
    if smoke:
        B, S = 2, 48
    t0 = time.time()
    params = tt.init_params(cfg, 0, device="cpu")
    batch = family_batch(cfg, B, S, "cpu")
    batch["labels"] = batch["tokens"]
    cpu_loss, cpu_grads = train_loss_grads(params, cfg, batch)
    t_cpu = time.time() - t0
    card_loss, card_grads = train_loss_grads(to_device(params, device), cfg,
                                             to_device(batch, device))
    err = leaf_errors(card_grads, cpu_grads)
    lerr = abs(card_loss - cpu_loss) / abs(cpu_loss)
    out[arch] = dict(layers=cfg.n_layers, tokens=B * S, loss_cpu=cpu_loss,
                     loss_card=card_loss, loss_rel_err=lerr,
                     worst_leaf_rel_err=err, cpu_s=round(t_cpu, 2))
    print(f"train grads card vs cpu {cfg.name} ({json.dumps(cuts)}, "
          f"{B} x {S}, f32): {json.dumps(out[arch])}")
    if not (err <= TRAIN_GRAD_RTOL and lerr <= TRAIN_LOSS_RTOL):
        fail(f"train: {cfg.name}'s card gradients or loss differ from the "
             f"CPU's: leaf {err} (bound {TRAIN_GRAD_RTOL}), loss {lerr} "
             f"(bound {TRAIN_LOSS_RTOL})")
    del params, cpu_grads, card_grads
    for arch in TRAIN_SMOKE_FAMILIES:
        cfg = get_arch(arch).smoke
        batch = family_batch(cfg, 4, 32, "cpu", seed=3)
        g = torch.Generator().manual_seed(4)
        batch["labels"] = torch.randint(0, cfg.vocab_size, (4, 32),
                                        generator=g)
        res = {}
        for dev in ("cpu", device):
            state = to_device(init_state(cfg, 0, device="cpu"), dev)
            step = make_train_step(cfg, topt.AdamWConfig(lr=1e-3),
                                   microbatches=2,
                                   compute_dtype=torch.float32)
            res[dev] = step(state, to_device(batch, dev))
        (s_cpu, m_cpu), (s_card, m_card) = res["cpu"], res[device]
        err = max(leaf_errors(topt.tree_leaves(a), topt.tree_leaves(b))
                  for a, b in ((s_card.params, s_cpu.params),
                               (s_card.opt.m, s_cpu.opt.m),
                               (s_card.opt.v, s_cpu.opt.v)))
        lerr = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / \
            abs(float(m_cpu["loss"]))
        out[arch] = dict(loss_cpu=float(m_cpu["loss"]),
                         loss_card=float(m_card["loss"]),
                         loss_rel_err=lerr, worst_leaf_rel_err=err,
                         grad_norm_cpu=float(m_cpu["grad_norm"]),
                         grad_norm_card=float(m_card["grad_norm"]))
        print(f"train step card vs cpu {cfg.name} (smoke, 4 x 32, 2 "
              f"microbatches, f32): {json.dumps(out[arch])}")
        if not (err <= TRAIN_GRAD_RTOL and lerr <= TRAIN_LOSS_RTOL):
            fail(f"train: {cfg.name}'s step on the card differs from the "
                 f"CPU's: leaf {err}, loss {lerr}")
    return out


def train_family_steps(device="cuda", smoke=False) -> dict:
    """Phase 22 (c): one bf16 ``make_train_step`` step of each non-dense
    family at phase 21's published width, cut as ``TRAIN_FAMILY_RUNS``
    says."""
    import gc

    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as tt
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import init_state, make_train_step
    rows = {}
    B, S, micro = TRAIN_FAMILY_SHAPE
    if smoke:
        S = 40
    for arch, cuts, why in TRAIN_FAMILY_RUNS:
        cfg = family_cfg(arch, cuts, smoke)
        run_start()
        state = init_state(cfg, 0, device=device)
        base = run_start()
        batch = family_batch(cfg, B, S, device)
        g = torch.Generator(device=device).manual_seed(6)
        batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=g, device=device)
        step = make_train_step(cfg, topt.AdamWConfig(), microbatches=micro)
        torch.cuda.synchronize()
        ops.launches = 0
        with DropWatch() as drops:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launches
        n_attn = sum(k.startswith("attn") for k in tt.layer_kinds(cfg))
        row = dict(cuts=cuts, params=cfg.param_count(), batch=B, seq=S,
                   micro=micro, step_ms=round(ms, 3),
                   loss=float(m["loss"]), aux=float(m["aux"]),
                   grad_norm=float(m["grad_norm"]),
                   peak_gib=round((device_peak() - base) / 2 ** 30, 3),
                   state_gib=round(base / 2 ** 30, 3),
                   flash_launches=launches)
        if cfg.n_experts:
            row.update(moe_dropped=drops.count(), moe_picks=drops.picks)
        print(f"train step {cfg.name} bf16 ({why}): {json.dumps(row)}")
        rows[arch] = row
        if not all(math.isfinite(row[k]) for k in ("loss", "aux",
                                                    "grad_norm")):
            fail(f"train: {arch}'s step gave a non-finite loss: {row}")
        want = 2 * n_attn * micro
        if not smoke and launches != want:
            fail(f"train: {arch}'s step launched flash_attention {launches}"
                 f" times, not {want} (forward and recompute of each "
                 "attention layer, each microbatch)")
        del state, m, batch
        gc.collect()
    return rows


def time_flash_backward(B=2, S=4096, H=32, KH=8, D=64) -> dict:
    """The attention backward at llama3.2-1b's training shape: the chunked
    recompute against SDPA's backward (its forward + backward less its
    forward), bf16 inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    q, k, v = flash_inputs(B, S, H, KH, D, torch.bfloat16, seed=98)
    g = torch.randn(q.shape, device="cuda").bfloat16()
    kw = dict(scale=D ** -0.5, causal=True, window=0)
    ms, _ = cuda_ms(lambda: ops.attention_backward(q, k, v, g, **kw))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=kw["scale"],
                                              enable_gqa=True)

    def sdpa_fb():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), gt)
    fwd_ms, _ = cuda_ms(sdpa)
    fb_ms, _ = cuda_ms(sdpa_fb)
    row = dict(backward_ms=ms, sdpa_fwd_ms=fwd_ms, sdpa_fwd_bwd_ms=fb_ms,
               sdpa_bwd_ms=fb_ms - fwd_ms)
    print(f"attention backward at llama3.2-1b's training shape {B}x{H}x{S}"
          f"x{D} (KH {KH}, causal, bf16): {json.dumps(row)}")
    return row


def train_phase(work: Path, device="cuda", smoke=False,
                after_timed=None) -> dict:
    """Phase 22: the LM's training path (see the module docstring);
    ``after_timed()`` runs once its timed and profiled steps are done."""
    import gc

    import torch
    rows = {"full": train_full_run(device, smoke)}
    if after_timed is not None:
        after_timed()
    gc.collect()
    torch.cuda.empty_cache()
    rows["resume"] = train_resume_check(work, device, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    rows["card_vs_cpu"] = train_card_vs_cpu(device, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    rows["families"] = train_family_steps(device, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    if device == "cuda":
        rows["flash"], _ = time_flash(2, 4096, 32, 8, 64, True, 0,
                                      label="llama3.2-1b's training shape")
        rows["backward"] = time_flash_backward()
    return rows


# ----------------------------------------------------- the production mesh

# phase 23 (a): launch.train --mesh 2x2 on four gloo ranks sharing the
# card, llama3.2-1b at its published width cut to 2 of its 16 layers,
# beside a 1x1 run of the same flags in this process
MESH_ARCH = "llama3.2-1b-2-layers-mesh"
MESH_LAYERS = 2
MESH_ARGS = ("--batch", "8", "--seq", "1024", "--micro", "2", "--steps", "3")
MESH_SMOKE_ARGS = ("--batch", "4", "--seq", "24", "--micro", "2",
                   "--steps", "3")
MESH = "2x2"
MESH_TIMEOUT = 300
# losses within rtol 1e-4 of 1x1 (the CPU test's bound, tests/
# test_torch_launch_train.py). The state is held leaf by leaf where a
# fault of the sharded backward (a gradient's sum over the data ranks
# left out, a partial sum taken as whole) shows: Adam's first moment
# after the 3 steps (a sum of the steps' clipped gradients) within
# MESH_M_RTOL of 1x1's in norm, and each parameter leaf's distance from
# 1x1's within MESH_P_RATIO of 1x1's own update (p_3 - p_0) in norm. The
# limits lie between the sound run's readings (0.020 and 0.050 on an
# H100) and three planted faults' (0.82 and 0.92 at the least, smoke
# width on the CPU; PERF.md §6, PR 25). The CPU test's per-element bound (one learning
# rate a step) is printed beside the largest element difference and not
# held: AdamW's first steps move an element by ~lr · the sign of its
# gradient, and at full width some gradients are smaller than the bf16
# rounding in which the model-axis ranks' partial sums differ from 1x1's
# one product, so those elements step the other way (up to 2·lr a step)
MESH_LOSS_RTOL = 1e-4
MESH_M_RTOL = 0.1
MESH_P_RATIO = 0.2
# (b) two dry-run cells, each at --device cuda and --device cpu: the
# parameters a rank of the port's plan. llama's is the reference's plan's
# too; the reference's plan gives kimi-k2 2,013,760,000 on 2 x 16 x 16:
# its rule reads the stacked (1, 7168, 18432) dense prefix MLP as an MoE
# weight and splits it over the 32 data ranks only, where the port's
# per-layer rule splits its F over the model axis as well
DRYRUN_CELLS = (("llama3.2-1b", "train_4k", "pod", 4_894_720),
                ("kimi-k2-1t-a32b", "decode_32k", "multipod",
                 2_002_147_840))
KIMI_REFERENCE_PARAMS = 2_013_760_000
KIMI_PREFIX_MLP = 3 * 7168 * 18432
DRYRUN_TIMEOUT = 300
DRYRUN_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "flops_per_device",
               "bytes_accessed_per_device", "collective_bytes_per_device",
               "collective_counts", "collective_bytes_by_computation",
               "params_per_device", "microbatches")


def mesh_cfg(smoke: bool):
    """Phase 23's model, registered as ``MESH_ARCH``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchSpec, register
    spec = get_arch(TRAIN_ARCH)
    cfg = spec.smoke if smoke else dataclasses.replace(
        spec.config, n_layers=MESH_LAYERS)
    register(MESH_ARCH, ArchSpec(cfg, spec.smoke))
    return cfg


def mesh_rank(rank: int, n: int, work: str, device: str,
              smoke: bool) -> None:
    """A spawned rank of phase 23 (a): ``gloo`` from a ``FileStore``, the
    card shared; runs ``launch.train --mesh 2x2`` and writes its numbers
    (and rank 0 the state's distances from the 1x1 run's,
    ``mesh_vs_one``) to ``work / f"mesh_rank{rank}.json"``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    work = Path(work)
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        for f in ("synchronize", "reset_peak_memory_stats"):
            setattr(torch.cuda, f, lambda *a, **k: None)
        for f in ("max_memory_allocated", "memory_allocated"):
            setattr(torch.cuda, f, lambda *a, **k: 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "mesh_store"), n),
        rank=rank, world_size=n, timeout=timedelta(seconds=MESH_TIMEOUT))
    try:
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.launch import train
        from repro_torch.models import sharding_plan as sp
        from repro_torch.train import optimizer as topt
        cfg = mesh_cfg(smoke)
        args = MESH_SMOKE_ARGS if smoke else MESH_ARGS
        torch.cuda.reset_peak_memory_stats()
        ops.launches = 0
        t0 = time.time()
        res = train.main(["--arch", MESH_ARCH, *args, "--mesh", MESH,
                          "--device", device])
        secs = time.time() - t0
        st, plan = res["state"], res["plan"]
        local = [sp.local_bytes(t) for t in (st.params, st.opt.m,
                                             st.opt.v)]
        planned = [sp.planned_bytes(t, plan.param_specs, plan.mesh)
                   for t in (st.params, st.opt.m, st.opt.v)]
        elems = sum(t.to_local().numel()
                    for t in topt.tree_leaves(st.params))
        held = mesh_vs_one(st, torch.load(work / "mesh_1x1.pt", mmap=True,
                                          weights_only=True))
        row = dict(rank=rank, param_elements=elems, local_bytes=local,
                   planned_bytes=planned,
                   peak_gib=round(torch.cuda.max_memory_allocated()
                                  / 2 ** 30, 3),
                   steps_ms=[round(h["ms"], 3) for h in res["history"]],
                   losses=[h["loss"] for h in res["history"]],
                   lr=[h["lr"] for h in res["history"]],
                   flash_launches=ops.launches, run_s=round(secs, 2),
                   collectives=sp.collective_route(plan.mesh),
                   params=cfg.param_count())
        if rank == 0:
            row.update(held)
    finally:
        dist.destroy_process_group()
    (work / f"mesh_rank{rank}.json").write_text(json.dumps(row))


def _ratio(num_sq: float, den: float) -> float:
    """sqrt(num_sq) / den (0 where both are 0)."""
    num = math.sqrt(num_sq)
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def mesh_vs_one(state, one) -> dict:
    """A rank's shard of the mesh's parameters and Adam first moments
    against the same block of 1x1's (``one``: ``params``, ``m`` and
    ``update``, each leaf's ||p_3 - p_0||, leaves in flatten order); the
    sums of squares are added over the ranks (each block once, by the
    replicas' first rank) and the largest element difference taken over
    them, so every rank joins. -> the worst leaf of each relative
    distance (``mesh_train``'s bounds) and that largest difference."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import sharding_plan as sp
    from repro_torch.train import optimizer as topt

    def sq(t):
        return torch.linalg.vector_norm(t, dtype=torch.float64).item() ** 2
    ps, ms = topt.tree_leaves(state.params), topt.tree_leaves(state.opt.m)
    sums = torch.zeros(len(ps), 3, dtype=torch.float64)
    top = torch.zeros(1, dtype=torch.float64)
    for i, (p, m, p1, m1) in enumerate(zip(ps, ms, one["params"],
                                           one["m"])):
        dmesh = p.device_mesh
        coord = dmesh.get_coordinate()
        if any(c and not pl.is_shard() for c, pl in zip(coord,
                                                       p.placements)):
            continue                        # a replica's first rank counts
        size, off = sp.local_box(p.shape, dmesh.shape, coord, p.placements)
        box = tuple(slice(o, o + n) for o, n in zip(off, size))
        m1 = m1[box].to(p.device)
        dp = p.to_local().float() - p1[box].to(p.device)
        sums[i] = torch.tensor([sq(dp), sq(m.to_local() - m1), sq(m1)])
        top[0] = max(float(top[0]), float(dp.abs().max()))
    dist.all_reduce(sums)
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    m_rel = [_ratio(a, math.sqrt(c)) for _, a, c in sums.tolist()]
    p_rel = [_ratio(a, u) for (a, _, _), u in zip(sums.tolist(),
                                                  one["update"])]
    worst_m, worst_p = int(np.argmax(m_rel)), int(np.argmax(p_rel))
    return dict(m_rel_max=m_rel[worst_m],
                m_rel_leaf=[worst_m, list(ps[worst_m].shape)],
                p_rel_max=p_rel[worst_p],
                p_rel_leaf=[worst_p, list(ps[worst_p].shape)],
                param_max_abs_diff=float(top[0]))


def dryrun_start(work: Path, smoke: bool) -> list:
    """Phase 23 (b): the dry-run cells, each at --device cuda and cpu, in
    subprocesses started together (``--device cpu`` twice when
    rehearsing without a card)."""
    procs = []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape, mesh, _ in DRYRUN_CELLS:
        for dev in ("cuda", "cpu"):
            out = work / f"dryrun_{arch}_{shape}_{mesh}_{dev}.json"
            out.unlink(missing_ok=True)
            cmd = [sys.executable, "-W", "ignore", "-m",
                   "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", mesh, "--device",
                   "cpu" if smoke else dev, "--out", str(out)]
            log = open(work / f"{out.stem}.log", "w")
            procs.append(((arch, shape, mesh, dev), out, log,
                          subprocess.Popen(cmd, env=env, stdout=log,
                                           stderr=subprocess.STDOUT)))
    return procs


def dryrun_finish(procs, t0: float) -> dict:
    """Wait for the dry-run cells (each within ``DRYRUN_TIMEOUT`` of the
    phase's start) and hold them: the cuda record equal to the cpu one in
    every byte count, FLOP count and collective, the parameters a rank
    the plan's."""
    recs = {}
    for key, out, log, proc in procs:
        try:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for *_, p in procs:
                p.kill()
            fail(f"dryrun {key} ran past {DRYRUN_TIMEOUT} s")
        log.close()
        if proc.returncode != 0:
            tail = Path(log.name).read_text()[-2000:]
            fail(f"dryrun {key} exited {proc.returncode}:\n{tail}")
        recs[key] = json.loads(out.read_text())[0]
    rows = {}
    for arch, shape, mesh, want in DRYRUN_CELLS:
        a, b = (recs[(arch, shape, mesh, d)] for d in ("cuda", "cpu"))
        diff = [k for k in DRYRUN_KEYS if a[k] != b[k]]
        row = {k: a[k] for k in DRYRUN_KEYS}
        row.update(lower_s_cuda=a["lower_s"], lower_s_cpu=b["lower_s"])
        print(f"dryrun {arch} {shape} --mesh {mesh} (fake world, rank 0): "
              f"{json.dumps(row)}")
        if diff:
            fail(f"dryrun {arch} {shape}: --device cuda and cpu differ in "
                 f"{diff}")
        if a["params_per_device"] != want:
            fail(f"dryrun {arch} {shape}: {a['params_per_device']} "
                 f"parameters a rank, the plan gives {want}")
        rows[f"{arch} {shape} {mesh}"] = row
    n = DRYRUN_CELLS[1][3]
    print(f"kimi-k2 parameters a rank on 2 x 16 x 16: {n:,} (the port's "
          f"plan) = {KIMI_REFERENCE_PARAMS:,} (the reference's) - "
          f"{KIMI_PREFIX_MLP // 32 - KIMI_PREFIX_MLP // 512:,} (its dense "
          "prefix MLP over 32 ranks there, over 512 here)")
    if n != KIMI_REFERENCE_PARAMS - (KIMI_PREFIX_MLP // 32 -
                                     KIMI_PREFIX_MLP // 512):
        fail("kimi-k2's parameters a rank do not reconcile with the "
             "reference's")
    return rows


def mesh_phase(work: Path, device="cuda", smoke=False, procs=None) -> dict:
    """Phase 23: the production mesh (module doc); ``procs`` are its
    dry-run subprocesses where the caller started them earlier
    (``dryrun_start``), and none outlives the phase."""
    t0 = time.time()
    if procs is None:
        procs = dryrun_start(work, smoke)
    try:
        return _mesh_phase(work, device, smoke, procs, t0)
    finally:
        stop(procs)


def stop(procs) -> None:
    """Kill the dry-run subprocesses still running."""
    for *_, proc in procs:
        if proc.poll() is None:
            proc.kill()


def _mesh_phase(work: Path, device, smoke, procs, t0) -> dict:
    rows = mesh_train(work, device, smoke, t0)
    rows["dryrun"] = dryrun_finish(procs, t0)
    print(f"phase 23 (production mesh): {time.time() - t0:.1f} s")
    return rows


def mesh_train(work: Path, device, smoke, t0) -> dict:
    """Phase 23 (a): the 1x1 run here, then the 2x2 world, held against
    it (``MESH_LOSS_RTOL``, ``MESH_M_RTOL``, ``MESH_P_RATIO``)."""
    import gc

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import init_state
    if dist.is_initialized():
        fail("phase 23 needs no process group in this process")
    cfg = mesh_cfg(smoke)
    args = MESH_SMOKE_ARGS if smoke else MESH_ARGS
    res, launches, secs, peak = train_run(
        ["--arch", MESH_ARCH, *args, "--device", device], device, False)
    one = res["history"]
    p0 = topt.tree_leaves(init_state(cfg, 0, device=device).params)
    p3 = topt.tree_leaves(res["state"].params)
    update = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(p3, p0)]
    torch.save({"params": [t.cpu() for t in p3],
                "m": [t.cpu() for t in topt.tree_leaves(res["state"].opt.m)],
                "update": update}, work / "mesh_1x1.pt")
    del res, p0, p3
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train {cfg.name} 1x1 {' '.join(args)}: steps ms "
          f"{[round(h['ms'], 3) for h in one]}, losses "
          f"{[h['loss'] for h in one]}, peak {peak / 2 ** 30:.3f} GiB, "
          f"flash launches {launches}, {secs:.1f} s")
    (work / "mesh_store").unlink(missing_ok=True)
    n = 4
    ctx = mp.start_processes(mesh_rank, args=(n, str(work), device, smoke),
                             nprocs=n, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.time() - t0 > MESH_TIMEOUT:
                fail(f"the {MESH} world ran past {MESH_TIMEOUT} s")
    except mp.ProcessRaisedException as e:
        fail(f"a rank of the {MESH} world failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"a rank of the {MESH} world exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [json.loads((work / f"mesh_rank{r}.json").read_text())
             for r in range(n)]
    (work / "mesh_1x1.pt").unlink(missing_ok=True)
    for r in ranks:
        print(f"train {cfg.name} --mesh {MESH} rank {r['rank']}: "
              f"{r['param_elements']:,} parameter elements of "
              f"{r['params']:,}, device peak {r['peak_gib']} GiB, steps ms "
              f"{r['steps_ms']} (four ranks share one card and gloo "
              "moves their collectives through the host: no speed "
              f"figure), kernel-5 launches {r['flash_launches']}, "
              f"collectives {r['collectives']}")
        if r["local_bytes"] != r["planned_bytes"]:
            fail(f"rank {r['rank']} holds {r['local_bytes']} bytes of "
                 f"params, m and v; the plan gives {r['planned_bytes']}")
        if not smoke and r["flash_launches"] == 0:
            fail(f"rank {r['rank']}: kernel 5 not launched")
    r0 = ranks[0]
    loss_err = max(abs(a - b["loss"]) / abs(b["loss"])
                   for a, b in zip(r0["losses"], one))
    print(f"train --mesh {MESH} against 1x1: losses {r0['losses']} vs "
          f"{[h['loss'] for h in one]} (worst rel {loss_err:.3g}, bound "
          f"{MESH_LOSS_RTOL}); Adam's m, worst leaf "
          f"{r0['m_rel_leaf']}: {r0['m_rel_max']:.4g} of its norm (bound "
          f"{MESH_M_RTOL}); parameters, worst leaf {r0['p_rel_leaf']}: "
          f"{r0['p_rel_max']:.4g} of 1x1's update (bound {MESH_P_RATIO}); "
          f"largest element difference {r0['param_max_abs_diff']:.3g} "
          f"(not held: the CPU test's one lr a step is "
          f"{sum(r0['lr']):.3g})")
    if loss_err > MESH_LOSS_RTOL or r0["m_rel_max"] > MESH_M_RTOL or \
            r0["p_rel_max"] > MESH_P_RATIO:
        fail(f"train --mesh {MESH} differs from 1x1 past the bounds")
    return {"ranks": ranks, "one": [h["ms"] for h in one]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.time()
    mark = phase_clock()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.data import write_fasta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    built = _build.build()
    print(f"built {sorted(built)} in {time.time() - t0:.1f} s")
    mark("1-2 (card, build)")

    sw_err = sw_checks()
    mark(3)
    mv_err = mv_checks()
    mark(4)
    bd_err = max(check_banded(12, 37, 53, 8, seed=6, ragged=True),
                 check_banded(12, 53, 37, 64, seed=7, ragged=True),
                 check_banded(16, 90, 120, 128, seed=8),
                 check_banded(8, 40, 31, 64, seed=9),       # W >= 2*lb + 2
                 check_banded(16, 200, 180, 64, seed=10, broadcast=True),
                 check_banded(16, 1700, 1800, 128, seed=11),
                 # slides above one column a row; B not a multiple of the
                 # pairs a CTA
                 check_banded(13, 60, 200, 64, seed=12, lens="slides"),
                 check_banded(9, 30, 150, 8, seed=13, lens="slides"),
                 check_banded(7, 120, 130, 1024, seed=14, lens="slides"),
                 check_banded(11, 100, 100, 256, seed=15, ragged=True),
                 check_banded(6, 300, 400, 1024, seed=16),
                 check_banded(10, 70, 60, 500, seed=17, ragged=True),
                 check_banded(10, 45, 45, 33, seed=18, lens="slides"),
                 check_banded(10, 45, 45, 1, seed=19, ragged=True),
                 check_banded(33, 150, 160, 64, seed=20, lens="full"),
                 # n * W past the first design's 200 KB of shared memory
                 check_banded(5, 4096, 4000, 64, seed=21),
                 check_banded(10, 70, 60, 17, seed=22, broadcast=True,
                              ragged=True),
                 check_banded(21, 80, 300, 42, seed=23, broadcast=True,
                              lens="slides"),
                 # n + m = 241,000 codes (the staged windows take the same
                 # shared memory at any length), band slides of 148-213
                 check_banded(4, 1000, 240000, 64, seed=24, lens="full"),
                 *wide_banded_checks())
    mark(5)

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    fam = simulate(N_SEQS)
    fasta = work / "phi_rna_4096.fa"
    write_fasta(fasta, fam.names, fam.seqs)

    main_obs, rows, report = run_msa(
        fam, fasta, work / "out", "main path", [], "cuda",
        ("gotoh_forward", "match_valid"))
    width = report["width"]
    mark(6)
    bd_obs, brows, _ = run_msa(
        fam, fasta, work / "out_banded", "banded main path",
        ["--backend", "banded-pallas"], "cuda-banded",
        ("gotoh_forward", "match_valid", "banded_forward"))
    print(f"banded main path: {sum(x != y for x, y in zip(rows, brows))} of "
          f"{len(rows)} aligned rows differ from the main path's (widths "
          f"{len(brows[0])} and {len(rows[0])})")
    mark(7)

    # search: the last N_QUERIES of N_SEQS + N_QUERIES leaves against the
    # first N_SEQS
    sfam = simulate(N_SEQS + N_QUERIES)
    write_fasta(work / "db.fa", sfam.names[:N_SEQS], sfam.seqs[:N_SEQS])
    write_fasta(work / "q.fa", sfam.names[N_SEQS:], sfam.seqs[N_SEQS:])
    (work / "db.idx.npz").unlink(missing_ok=True)
    glob = ["--score", "global", "--max-hits", "10"]
    fused_obs, fused_hits = run_search(
        work, work / "db.fa", work / "q.fa", "global banded-pallas",
        glob + ["--backend", "banded-pallas"], ("banded_fused",))
    banded_obs, banded_hits = run_search(
        work, work / "db.fa", work / "q.fa", "global banded",
        glob + ["--backend", "banded"], ("banded_forward",))
    if fused_hits != banded_hits:
        fail("search hits differ between --backend banded-pallas (kernel 4) "
             "and banded (kernel 3 + traceback)")
    print("search hits equal under banded-pallas and banded")
    local_obs, _ = run_search(work, work / "db.fa", work / "q.fa", "local",
                              ["--score", "local", "--max-hits", "10"],
                              ("gotoh_forward",))
    mark(8)

    err, timed = hold_path_calls(
        (("main path", main_obs), ("banded main path", bd_obs),
         ("search global banded-pallas", fused_obs),
         ("search global banded", banded_obs), ("search local", local_obs)))
    err["gotoh_forward"] = max(err["gotoh_forward"], sw_err)
    for name in ("banded_forward", "banded_fused"):
        err[name] = max(err[name], bd_err)
    # the kernels line: each kernel on its own path's largest call
    sw = max(timed[("main path", "gotoh_forward")], key=lambda x: x[0])[1]
    bf = max(timed[("banded main path", "banded_forward")],
             key=lambda x: x[0])[1]
    fu = max(timed[("search global banded-pallas", "banded_fused")],
             key=lambda x: x[0])[1]
    mv, e = time_mv(N_SEQS, width)
    mv_err = max(mv_err, e)
    print(f"match_valid at main-path shape N={N_SEQS} L={width}: "
          f"{json.dumps(mv)}")
    mark(9)

    mv_err = max(mv_err, tree_phases(fam, fasta, work, mark=mark))

    ml_obs = ml_phases(work, mark=mark)
    ml_run = (("ml path --tree ml", ml_obs),)
    e, _ = hold_path_calls(ml_run)
    err["gotoh_forward"] = max(err["gotoh_forward"], e["gotoh_forward"])
    mv_err = max(mv_err, hold_tree_calls(ml_run))
    mark("16 (and the holds of 13's calls)")

    fa_launches, fa, fa_err = lm_phase()
    mark(17)

    dist_phase(fam, work)
    mark(18)

    msa_service_phase(fam, work)
    mark(19)

    t20 = time.time()
    adapt = adaptive_phase(fam)
    progressive_phase(fam)
    for name in ("banded_forward", "banded_fused"):
        err[name] = max(err[name], adapt["max_abs_err"])
    print(f"adaptive band policy and progressive baseline (phase 20): "
          f"{time.time() - t20:.1f} s")
    mark(20)

    families_phase()
    mark(21)

    # phase 23's dry runs use the CPU only: they start once phase 22's
    # timed and profiled steps are done, beside the rest of its work
    dry = []
    try:
        train_phase(work, after_timed=lambda: dry.extend(
            dryrun_start(work, smoke=False)))
        mark(22)
        mesh_phase(work, procs=dry)
        mark(23)
    finally:
        stop(dry)

    kernels = [
        dict(name="gotoh_forward", route="cuda",
             source="src/repro_torch/csrc/sw_forward.cu",
             replaces="src/repro/kernels/sw/sw_kernel.py:140",
             launches=main_obs.launches["gotoh_forward"],
             max_abs_err=err["gotoh_forward"],
             **sw),
        dict(name="match_valid", route="cuda",
             source="src/repro_torch/csrc/match_valid.cu",
             replaces="src/repro/kernels/distance/distance_kernel.py:63",
             launches=main_obs.launches["match_valid"], max_abs_err=mv_err,
             **mv),
        dict(name="banded_forward", route="cuda",
             source="src/repro_torch/csrc/banded_forward.cu",
             replaces="src/repro/kernels/banded/banded_kernel.py:117",
             launches=bd_obs.launches["banded_forward"],
             max_abs_err=err["banded_forward"],
             **bf),
        dict(name="banded_fused", route="cuda",
             source="src/repro_torch/csrc/banded_fused.cu",
             replaces="src/repro/kernels/banded/banded_kernel.py:245",
             launches=fused_obs.launches["banded_fused"],
             max_abs_err=err["banded_fused"],
             **fu),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_kernel.py:87",
             launches=fa_launches, max_abs_err=fa_err, **fa),
    ]
    print(f"chip_smoke: every phase in {time.time() - t_start:.1f} s, "
          "the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
