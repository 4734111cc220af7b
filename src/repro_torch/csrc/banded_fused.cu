// Fused banded Gotoh score + traceback (global) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/banded/banded_kernel.py::
// banded_fused_kernel (body _fused_kernel). Same contract: for each pair a
// record [score, la, lb, start_state, aln_len, ok, edge, 0] and the two
// gap-padded aligned rows a_row, b_row of width n + m. Bit-exact with the
// plain version (repro_torch/kernels/banded/ref.py: banded_forward
// followed by banded_traceback).
//
// What bounds it on the H100: the sequences in and the aligned rows out
// (2 * B * (n + m) bytes) — the direction band never reaches device memory
// when it fits on chip — against about 25 f32 operations per band cell, so
// the operation bound is the larger one at the search shapes. The simple
// design is latency-bound instead: the forward is banded_row.cuh (one CTA per
// pair, one thread per band cell, four barriers per row) and the traceback is
// one thread walking up to n + m steps.
//
// Where the (n, W) direction band lives is a template switch chosen by the
// wrapper from the shape: in dynamic shared memory when n * W fits (the
// SMEM variant, ~96 KB at n = 1,493, W = 64), otherwise in a per-pair
// workspace in device memory that the wrapper allocates (the global
// variant). The walk emits columns in reverse at the end of the output rows;
// the block then shifts them to the front, as the reference's
// roll(flip(x), k - out_len) does.
#include "banded_row.cuh"

namespace {

template <bool SMEM>
__global__ void banded_fused_kernel(const int8_t* __restrict__ a, long long a_stride,
                                    const int8_t* __restrict__ b, long long b_stride,
                                    const int* __restrict__ lens,
                                    const float* __restrict__ sub, int S,
                                    int8_t* __restrict__ a_row, int8_t* __restrict__ b_row,
                                    float* __restrict__ rec, int8_t* __restrict__ work,
                                    int n, int m, int W, float go, float ge, int gap_code) {
  extern __shared__ __align__(16) int8_t smem[];
  const long long pair = blockIdx.x;
  const int T = blockDim.x;
  const banded::Shared sh = banded::carve(smem, S, T);
  const int la = lens[2 * pair];
  const int lb = lens[2 * pair + 1];
  const int8_t* arow = a + pair * a_stride;
  const int8_t* brow = b + pair * b_stride;
  int8_t* dirs = SMEM ? sh.tail : work + pair * (long long)n * W;
  const banded::Result res =
      banded::band_forward(arow, brow, n, m, la, lb, sub, S, go, ge, W, sh, dirs);

  // ---- traceback: one thread walks the band (band_forward ends in a barrier)
  const int out_len = n + m;
  int8_t* ar = a_row + pair * (long long)out_len;
  int8_t* br = b_row + pair * (long long)out_len;
  __shared__ int k_s;
  if (threadIdx.x == 0) {
    using namespace banded;
    int i = la, j = lb, st = res.state, k = 0;
    bool done = la == 0 && lb == 0, edge = false, oob = false;
    for (int t = 0; t < out_len && !done; ++t) {
      const int o = j - band_lo(i, la, lb, W);
      const bool in_band = o >= 0 && o < W && i >= 1;
      const long long at = clamp_i((i - 1) * W + o, 0, n * W - 1);
      const int byte_band = n > 0 ? (int)dirs[at] : 0;
      // boundary cells are pure gap runs with closed-form directions
      const int byte = i == 0 ? (FRESH | ((j == 1 ? 0 : 1) << 3))
                              : (j == 0 ? (M_ST | ((i == 1 ? 0 : 1) << 2)) : byte_band);
      const bool interior = i > 0 && j > 0;
      const bool lost = interior && !in_band;
      // an edge cell whose clipped neighbour is a real DP cell
      edge = edge || (interior && in_band && (o == 0 || (o == W - 1 && j < lb)));
      oob = oob || lost;
      if (lost) break;                      // done: nothing more is written
      const bool is_m = st == M_ST, is_ix = st == IX_ST, is_iy = st == IY_ST;
      const int8_t a_im1 = n > 0 ? arow[clamp_i(i - 1, 0, n - 1)] : (int8_t)gap_code;
      const int8_t b_jm1 = brow[clamp_i(j - 1, 0, m - 1)];
      ar[out_len - 1 - k] = (is_m || is_ix) ? a_im1 : (int8_t)gap_code;
      br[out_len - 1 - k] = (is_m || is_iy) ? b_jm1 : (int8_t)gap_code;
      ++k;
      const int ni = (is_m || is_ix) ? i - 1 : i;
      const int nj = (is_m || is_iy) ? j - 1 : j;
      st = is_m ? (byte & 3)
                : (is_ix ? (((byte >> 2) & 1) ? IX_ST : M_ST)
                         : (((byte >> 3) & 1) ? IY_ST : M_ST));
      i = ni;
      j = nj;
      done = i == 0 && j == 0;
    }
    const bool ok = !edge && !oob && !res.edge && res.score > NEGV / 2;
    k_s = k;
    float* o = rec + pair * 8;
    o[0] = res.score;
    o[1] = (float)la;
    o[2] = (float)lb;
    o[3] = (float)res.state;
    o[4] = (float)k;
    o[5] = ok ? 1.0f : 0.0f;
    o[6] = res.edge ? 1.0f : 0.0f;
    o[7] = 0.0f;
  }
  __syncthreads();

  // shift the k emitted columns [out_len - k, out_len) to [0, k), in chunks
  // of T: a chunk reads only past what earlier chunks wrote
  const int k = k_s;
  const int shift = out_len - k;
  for (int base = 0; base < k; base += T) {
    const int p = base + threadIdx.x;
    int8_t va = 0, vb = 0;
    if (p < k) {
      va = ar[p + shift];
      vb = br[p + shift];
    }
    __syncthreads();
    if (p < k) {
      ar[p] = va;
      br[p] = vb;
    }
    __syncthreads();
  }
  for (int p = k + threadIdx.x; p < out_len; p += T) {
    ar[p] = (int8_t)gap_code;
    br[p] = (int8_t)gap_code;
  }
}

}  // namespace

// a: (B, n) int8 with row stride a_stride; b: (B, m) int8 with row stride
// b_stride (0 = broadcast), m >= 1; lens: (B, 2) int32 [la, lb],
// 0 <= la <= n, 0 <= lb <= m; sub: (S, S) f32, S <= 32; a_row, b_row:
// (B, n + m) int8; rec: (B, 8) f32; work: (B, n, W) int8 for the global
// variant (unused with smem = 1); 1 <= W <= 1024. Returns a cudaError_t.
extern "C" int banded_fused(const void* a, long long a_stride, const void* b,
                            long long b_stride, const void* lens, const void* sub, int S,
                            void* a_row, void* b_row, void* rec, void* work, int B, int n,
                            int m, int W, float go, float ge, int gap_code, int smem,
                            void* stream) {
  if (S < 1 || S > banded::MAX_S || B < 1 || n < 0 || m < 1 || W < 1 || W > banded::MAX_W)
    return (int)cudaErrorInvalidValue;
  const int threads = (W + 31) / 32 * 32;
  size_t shmem = banded::shared_bytes(S, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* A = (const int8_t*)a;
  const int8_t* Bp = (const int8_t*)b;
  const int* L = (const int*)lens;
  const float* SUB = (const float*)sub;
  if (smem) {
    shmem += (size_t)n * W;
    cudaError_t err = cudaFuncSetAttribute(banded_fused_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shmem);
    if (err != cudaSuccess) return (int)err;
    banded_fused_kernel<true><<<B, threads, shmem, s>>>(
        A, a_stride, Bp, b_stride, L, SUB, S, (int8_t*)a_row, (int8_t*)b_row, (float*)rec,
        nullptr, n, m, W, go, ge, gap_code);
  } else {
    banded_fused_kernel<false><<<B, threads, shmem, s>>>(
        A, a_stride, Bp, b_stride, L, SUB, S, (int8_t*)a_row, (int8_t*)b_row, (float*)rec,
        (int8_t*)work, n, m, W, go, ge, gap_code);
  }
  return (int)cudaGetLastError();
}
