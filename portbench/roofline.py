"""The yardstick for kernel roofline shares: one NVIDIA H100 SXM's
published peaks (dense, at its full 700 W power limit) and each
kernel's operations and bytes computed from a call's shapes.

A call's least time is the larger of operations over the peak rate and
bytes over the HBM bandwidth; each input byte is counted read once and
each output byte written once, and the work is what the call's inputs
need (true lengths, distinct pairs), not what a padded layout holds.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12       # int8 tensor cores

# kernel 1 (Gotoh forward, csrc/sw_forward.cu): f32 operations per DP
# cell: 3 max + 2 compare for h and its argmax, add + compare + 2 select
# for M, 2 sub + max + compare for Ix, add + max (scan) + 2 sub for Iy,
# 2 sub + compare for the Iy direction bit
SW_OPS_PER_CELL = 20


def sw_bound_s(la, lb, target_bytes):
    """Least seconds of one kernel-1 call: ``la``/``lb`` the pairs' true
    lengths (tensors or arrays of one dtype), ``target_bytes`` the bytes
    of the targets as stored (one row when broadcast). Operations: 20 a
    cell of the la x lb matrix; bytes: the queries, the targets, the
    (la, lb + 1) direction bytes a pair writes, 8 bytes of lengths and
    a 32-byte record a pair."""
    cells = (la * lb).sum()
    ops = SW_OPS_PER_CELL * cells
    nbytes = la.sum() + target_bytes + (la * (lb + 1)).sum() \
        + 40 * la.shape[0]
    return _larger(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def match_valid_bound_s(N: int, M: int, L: int, symmetric: bool) -> float:
    """Least seconds of one kernel-2 call: 2 int8 operations (match and
    valid) a pair and column at the int8 tensor-core rate, over the
    distinct pairs (N (N + 1) / 2 for a symmetric call, whose inputs are
    one set of rows); bytes: each input row read once, the two int32
    (N, M) count matrices written once."""
    pairs = N * (N + 1) // 2 if symmetric else N * M
    ops = 2 * pairs * L
    nbytes = (N if symmetric else N + M) * L + 2 * 4 * N * M
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def _larger(a, b):
    """The larger of two times, either a float or a 0-d tensor (a tensor
    on the card is read only when the metric is)."""
    import torch
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return max(a, b)
