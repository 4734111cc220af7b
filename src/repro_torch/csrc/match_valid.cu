// Pairwise match/valid column counts over two int8 row sets, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/distance/distance_kernel.py::
// match_valid_kernel (body _kernel). For rows i of A (N, L) and j of B (M, L):
//   match[i, j] = #columns with A == B, A != gap, 0 <= A < n_chars
//   valid[i, j] = #columns with both A and B != gap and < n_chars
// exactly as the reference's one-hot products count them; counts are exact
// int32.
//
// What bounds it on the H100: operations. Each output pair compares all L
// columns, N*M*L byte compares against only (N+M)*L input bytes, so the
// inputs are re-read from shared memory ~64 times per load. The reference
// turns the compares into one-hot matrix products for the TPU's MXU; this
// first Hopper version keeps them as SIMD-in-a-word integer work instead:
// four columns per 32-bit word, __vcmpeq4 for the match compare and a
// bitwise AND of per-byte validity bits for the valid count, each reduced
// with __popc. The int8 tensor-core formulation (one-hot MMA) is left for a
// later version.
//
// Design: a 2-D grid of 64x64 output tiles, 256 threads per CTA, each thread
// a 4x4 register tile of int32 counters. L streams through shared memory in
// 64-byte chunks; on the way in each byte is recoded (invalid bytes get a
// sentinel that differs between A and B, so they never match) and its
// validity bit is stored beside it. On a TPU the L reduction ran over a
// sequential grid dimension; here it is a loop inside the block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // output rows/cols per CTA
constexpr int KB = 64;            // L bytes per chunk
constexpr int KW = KB / 4;        // 32-bit words per row chunk
constexpr int PAD = KW + 1;       // row pitch in words (bank-conflict free)
constexpr int THREADS = 256;

__device__ __forceinline__ void load_tile(const int8_t* __restrict__ X, int rows, int L,
                                          int row0, int k0, int n_chars, int gap,
                                          uint32_t sentinel, uint32_t (*code)[PAD],
                                          uint32_t (*ok)[PAD]) {
  for (int w = threadIdx.x; w < TILE * KW; w += THREADS) {
    const int r = w / KW, kw = w % KW;
    const bool row_in = row0 + r < rows;
    const int8_t* src = X + (long long)(row0 + r) * L;
    uint32_t c = 0, v = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = k0 + kw * 4 + q;
      bool valid = false, countable = false;
      int x = 0;
      if (row_in && col < L) {
        x = src[col];
        valid = x != gap && x < n_chars;
        countable = valid && x >= 0;
      }
      c |= (countable ? (uint32_t)x : sentinel) << (8 * q);
      v |= (valid ? 1u : 0u) << (8 * q);
    }
    code[r][kw] = c;
    ok[r][kw] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
match_valid_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int N,
                   int M, int L, int n_chars, int gap, int* __restrict__ match,
                   int* __restrict__ valid) {
  __shared__ uint32_t a_code[TILE][PAD], a_ok[TILE][PAD];
  __shared__ uint32_t b_code[TILE][PAD], b_ok[TILE][PAD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  uint32_t acc_m[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_m[i][j] = acc_v[i][j] = 0;

  for (int k0 = 0; k0 < L; k0 += KB) {
    load_tile(A, N, L, row0, k0, n_chars, gap, 0xFEu, a_code, a_ok);
    load_tile(B, M, L, col0, k0, n_chars, gap, 0xFFu, b_code, b_ok);
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < KW; ++kw) {
      uint32_t ac[4], av[4], bc[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ac[i] = a_code[ty + 16 * i][kw];
        av[i] = a_ok[ty + 16 * i][kw];
        bc[i] = b_code[tx + 16 * i][kw];
        bv[i] = b_ok[tx + 16 * i][kw];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_m[i][j] += __popc(__vcmpeq4(ac[i], bc[j]));   // 8 bits per equal byte
          acc_v[i][j] += __popc(av[i] & bv[j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= M) continue;
      match[(long long)r * M + c] = (int)(acc_m[i][j] >> 3);
      valid[(long long)r * M + c] = (int)acc_v[i][j];
    }
  }
}

}  // namespace

// a: (N, L) int8, b: (M, L) int8, both contiguous; match, valid: (N, M)
// int32 outputs. Returns a cudaError_t.
extern "C" int match_valid(const void* a, const void* b, int N, int M, int L,
                           int n_chars, int gap, void* match, void* valid, void* stream) {
  if (N < 1 || M < 1 || L < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + TILE - 1) / TILE, (N + TILE - 1) / TILE);
  match_valid_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, N, M, L, n_chars, gap, (int*)match, (int*)valid);
  return (int)cudaGetLastError();
}
