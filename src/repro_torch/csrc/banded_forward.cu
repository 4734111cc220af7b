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
// CTA holds PAIRS pairs, one pass over B. Bands wider than MAX_W take the
// wide route (banded_row.cuh: band_forward_wide), a pair a CTA of
// WIDE_THREADS threads, one CTA a pair, each thread writing its K bytes of
// a row.
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

// The wide route's bytes: the thread's K nibbles of each row in turn,
// widened to bytes, one aligned store when the band fills the CTA.
template <int K>
struct WideByteStore {
  int8_t* dst;        // this thread's first byte of the next row
  int W;
  __device__ __forceinline__ void operator()(const uint32_t (&dw)[(K + 7) / 8]) {
    if (W == WIDE_THREADS * K) {
      uint32_t b[K / 4];
#pragma unroll
      for (int x = 0; x < K / 4; ++x) {
        const uint32_t v = dw[x / 2] >> (16 * (x % 2));   // cells 4x .. 4x+3
        b[x] = (v & 15) | ((v >> 4) & 15) << 8 | ((v >> 8) & 15) << 16 | ((v >> 12) & 15) << 24;
      }
      store_bytes<K>(dst, b);
    } else {
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (threadIdx.x * K + q < W) dst[q] = (int8_t)((dw[q / 8] >> (4 * (q % 8))) & 15);
    }
    dst += W;
  }
};

template <int K>
__global__ void __launch_bounds__(WIDE_THREADS, K <= 8 ? 2 : 1)
    banded_forward_wide_kernel(const int8_t* __restrict__ a, long long a_stride,
                               const int8_t* __restrict__ b, long long b_stride,
                               const int* __restrict__ lens, const float* __restrict__ sub_g,
                               int S, int8_t* __restrict__ dirs, float* __restrict__ rec,
                               int n, int m, int W, float go, float ge) {
  extern __shared__ __align__(16) uint8_t smem[];
  const WideSmem sh(smem, S, W);
  const float margin = load_sub(sub_g, sh.sub, S);
  const long long pair = blockIdx.x;
  const int la = lens[2 * pair], lb = lens[2 * pair + 1];
  StagedWide seq(a + pair * a_stride, n, b + pair * b_stride, m, S, W, sh.buf);
  WideByteStore<K> store{dirs + pair * (long long)n * W + threadIdx.x * K, W};
  const Result res = band_forward_wide<K>(seq, la, lb, sh, go, ge, W, margin, store);
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

// The registers and local-memory (spill) bytes a thread of the
// instantiation for band W uses, and how many of its CTAs an SM holds at
// once with an S x S table. Returns a cudaError_t.
extern "C" int banded_forward_attrs(int W, int S, int* regs, int* local_bytes,
                                    int* ctas_per_sm) {
  if (W < 1 || W > MAX_WIDE_W || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  if (W > MAX_W)
    return with_wide_cells(W, [&](auto k) {
      return kernel_attrs(banded_forward_wide_kernel<decltype(k)::value>, WIDE_THREADS,
                          wide_smem_bytes(S, W), regs, local_bytes, ctas_per_sm);
    });
  return with_cells(W, [&](auto k) {
    return kernel_attrs(banded_forward_kernel<decltype(k)::value>, 32 * PAIRS,
                        cta_smem_bytes(S, W), regs, local_bytes, ctas_per_sm);
  });
}

// a: (B, n) int8 with row stride a_stride; b: (B, m) int8 with row stride
// b_stride (0 = one target broadcast to every pair), m >= 1; lens: (B, 2)
// int32 [la, lb], 0 <= la <= n, 0 <= lb <= m; sub: (S, S) f32 row-major,
// S <= 32; dirs: (B, n, W) int8; rec: (B, 8) f32; 1 <= W <= 16,384 (the
// warp route up to 1,024, the wide route above). Returns a cudaError_t.
extern "C" int banded_forward(const void* a, long long a_stride, const void* b,
                              long long b_stride, const void* lens, const void* sub, int S,
                              void* dirs, void* rec, int B, int n, int m, int W, float go,
                              float ge, void* stream) {
  if (S < 1 || S > MAX_S || B < 1 || n < 0 || m < 1 || W < 1 || W > MAX_WIDE_W)
    return (int)cudaErrorInvalidValue;
  if (W > MAX_W) {
    const size_t smem = wide_smem_bytes(S, W);
    return with_wide_cells(W, [&](auto k) {
      const auto kernel = banded_forward_wide_kernel<decltype(k)::value>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<B, WIDE_THREADS, smem, (cudaStream_t)stream>>>(
          (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
          (const float*)sub, S, (int8_t*)dirs, (float*)rec, n, m, W, go, ge);
      return (int)cudaGetLastError();
    });
  }
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
