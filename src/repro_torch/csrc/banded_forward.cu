// Batched banded Gotoh forward (global) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/banded/banded_kernel.py::
// banded_forward_kernel (body _fwd_kernel). Same contract: for each pair the
// packed direction bytes of DP rows 1..n over a width-W band, (B, n, W) int8,
// and a record [score, la, lb, start_state, edge, 0, 0, 0]. Bit-exact with
// the plain version (repro_torch/kernels/banded/ref.py::banded_forward),
// including the rows past la, through which the band state advances as in
// the reference.
//
// What bounds it on the H100: the output. Each band cell emits one direction
// byte (B * n * W bytes, ~0.36 GB on the banded 16S main path) against about
// 25 f32 operations, so the byte bound (~0.1 ms at 3.35 TB/s) is above the
// operation bound. The band state never leaves the chip: M/Ix/Iy in
// registers, one row in shared memory. The simple design (banded_row.cuh:
// one CTA per pair, one thread per band cell, four barriers per row) is
// latency-bound instead, with W/32 warps per CTA doing a few operations
// between barriers.
#include "banded_row.cuh"

namespace {

__global__ void banded_forward_kernel(const int8_t* __restrict__ a, long long a_stride,
                                      const int8_t* __restrict__ b, long long b_stride,
                                      const int* __restrict__ lens,
                                      const float* __restrict__ sub, int S,
                                      int8_t* __restrict__ dirs, float* __restrict__ rec,
                                      int n, int m, int W, float go, float ge) {
  extern __shared__ __align__(16) int8_t smem[];
  const long long pair = blockIdx.x;
  const banded::Shared sh = banded::carve(smem, S, blockDim.x);
  const int la = lens[2 * pair];
  const int lb = lens[2 * pair + 1];
  const banded::Result res =
      banded::band_forward(a + pair * a_stride, b + pair * b_stride, n, m, la, lb, sub, S,
                           go, ge, W, sh, dirs + pair * (long long)n * W);
  if (threadIdx.x == 0) {
    float* o = rec + pair * 8;
    o[0] = res.score;
    o[1] = (float)la;
    o[2] = (float)lb;
    o[3] = (float)res.state;
    o[4] = res.edge ? 1.0f : 0.0f;
    o[5] = o[6] = o[7] = 0.0f;
  }
}

}  // namespace

// a: (B, n) int8 with row stride a_stride; b: (B, m) int8 with row stride
// b_stride (0 = one target broadcast to every pair), m >= 1; lens: (B, 2)
// int32 [la, lb], 0 <= la <= n, 0 <= lb <= m; sub: (S, S) f32 row-major,
// S <= 32; dirs: (B, n, W) int8; rec: (B, 8) f32; 1 <= W <= 1024.
// Returns a cudaError_t.
extern "C" int banded_forward(const void* a, long long a_stride, const void* b,
                              long long b_stride, const void* lens, const void* sub, int S,
                              void* dirs, void* rec, int B, int n, int m, int W, float go,
                              float ge, void* stream) {
  if (S < 1 || S > banded::MAX_S || B < 1 || n < 0 || m < 1 || W < 1 || W > banded::MAX_W)
    return (int)cudaErrorInvalidValue;
  const int threads = (W + 31) / 32 * 32;
  const size_t shmem = banded::shared_bytes(S, threads);
  banded_forward_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
      (const float*)sub, S, (int8_t*)dirs, (float*)rec, n, m, W, go, ge);
  return (int)cudaGetLastError();
}
