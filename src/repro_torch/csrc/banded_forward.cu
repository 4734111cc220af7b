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
// What bounds it on the H100: against its bytes (each band cell emits one
// direction byte, B * n * W bytes) and its ~25 f32 operations a cell, the
// operation bound is the larger at W = 64 (search shape 0.566 ms against
// 0.46 ms of bytes). Each pair runs on a warp through banded_row.cuh's
// barrier-free core, which is issue-bound, and each lane writes its K
// direction bytes of a row in one store when the band fills the warp; a
// CTA holds PAIRS pairs, one pass over B.
#include "banded_row.cuh"

namespace {

using namespace banded;

// The lane's K direction bytes of each row in turn into the pair's (n, W)
// bytes: one store when every lane's cells are in the band, else byte by
// byte.
template <int K>
struct ByteStore {
  int8_t* row;        // this lane's first byte of the next row
  int W;
  __device__ __forceinline__ void operator()(const int (&d)[K]) {
    if (W == 32 * K) {
      uint32_t w[(K + 3) / 4] = {};
#pragma unroll
      for (int q = 0; q < K; ++q) w[q / 4] |= (uint32_t)(d[q] & 255) << (8 * (q % 4));
      store_bytes<K>(row, w);
    } else {
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (lane_id() * K + q < W) row[q] = (int8_t)d[q];
    }
    row += W;
  }
};

template <int K>
__global__ void __launch_bounds__(32 * PAIRS, K <= 2 ? 4 : (K == 4 ? 3 : 1))
    banded_forward_kernel(const int8_t* __restrict__ a, long long a_stride,
                          const int8_t* __restrict__ b, long long b_stride,
                          const int* __restrict__ lens, const float* __restrict__ sub_g,
                          int S, int8_t* __restrict__ dirs, float* __restrict__ rec, int B,
                          int n, int m, int W, float go, float ge) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sub = reinterpret_cast<float*>(smem);
  const float margin = load_sub(sub_g, sub, S);
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * PAIRS + warp;
  if (pair >= B) return;
  const int la = lens[2 * pair], lb = lens[2 * pair + 1];
  int8_t* buf = reinterpret_cast<int8_t*>(smem + sub_bytes(S)) + warp * (A_CHUNK + b_window(W));
  Staged seq(a + pair * a_stride, n, b + pair * b_stride, m, S, W, buf);
  ByteStore<K> store{dirs + pair * (long long)n * W + lane_id() * K, W};
  const Result res = band_forward<K>(seq, la, lb, sub, go, ge, W, margin, store);
  if (lane_id() == 0) {
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
// S <= 32; dirs: (B, n, W) int8; rec: (B, 8) f32; 1 <= W <= 1024. Returns a
// cudaError_t.
extern "C" int banded_forward(const void* a, long long a_stride, const void* b,
                              long long b_stride, const void* lens, const void* sub, int S,
                              void* dirs, void* rec, int B, int n, int m, int W, float go,
                              float ge, void* stream) {
  if (S < 1 || S > MAX_S || B < 1 || n < 0 || m < 1 || W < 1 || W > MAX_W)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + PAIRS - 1) / PAIRS;
  const size_t shmem = cta_smem_bytes(S, W);
  cudaStream_t st = (cudaStream_t)stream;
  return with_cells(W, [&](auto k) {
    banded_forward_kernel<decltype(k)::value><<<grid, 32 * PAIRS, shmem, st>>>(
        (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
        (const float*)sub, S, (int8_t*)dirs, (float*)rec, B, n, m, W, go, ge);
    return (int)cudaGetLastError();
  });
}
