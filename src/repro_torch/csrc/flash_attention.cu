// Blocked online-softmax attention (FlashAttention-2 forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_kernel.py::
// flash_attention_kernel (body _kernel). It computes what that kernel and the
// reference LM's prefill attention (repro/models/layers.py::xla_flash)
// compute: for query row i (absolute position q_offset + i) and key j < T,
//   s = (q_i . k_j) * scale, masked to -1e30 unless (causal: pos_i >= j) and
//   (window > 0: pos_i - j < window); an online softmax over key tiles with
//   the masked p zeroed after the exp; out = acc / max(l, 1e-30), in q's type.
// GQA maps q-head h to KV head h / (H / KH), as the Pallas index maps do.
// Scores, p and P.V are f32 (v is read as f32, as the reference casts it);
// inputs are f32 or bf16.
//
// What bounds it on the H100: operations. At the serve shape (32 heads of
// 120 over 8,192 tokens, window 4,096) each K/V element is reused by ~4,000
// query rows, so the 4*D FLOP per unmasked (query, key) pair dwarf the
// bytes. This first version does them as scalar f32 FMAs from shared memory
// (67 TFLOP/s peak outside the tensor cores, against 989 bf16 in them); the
// mma/wgmma formulation is later work.
//
// Design (simple first): one CTA of 256 threads per (q-tile of 64 rows,
// q-head, batch); the KV loop runs inside the CTA (the Pallas grid's
// sequential kv dimension). The Q tile is loaded once, K/V tiles of 64 keys
// are streamed through shared memory, the output is stored once. Thread
// (ty, tx) owns query rows 4*ty..4*ty+3: their running m and l, 4x4 scores
// (keys tx + 16*j) and the accumulator columns tx + 16*j of D padded to DP;
// row max and sum reduce across the 16 tx lanes by warp shuffles. Key tiles
// wholly above the causal diagonal or wholly outside the window are skipped
// (exact: a fully masked tile leaves m, l and acc unchanged). A ragged last
// q tile and key tile are masked, so any S >= 1 and T >= 1 work. Operands
// are addressed through 64-bit (batch, position, head) strides; the last
// dimension is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int PP = BK + 1;      // pitch of the P tile
constexpr float NEG = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KH, D;
  long long qs[3], ks[3], vs[3], os[3];   // (batch, position, head) strides, elements
  float scale;
  int causal, window, q_offset;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DP>
constexpr int shared_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * PP;
}

// rows [0, rows) of a (rows_tile, DP) f32 tile from a strided source; zeros
// past `rows` and past D
template <typename T, int DP, int PITCH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int rows, int D) {
  for (int i = threadIdx.x; i < BK * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (r < rows && d < D) x = to_f32(src[(long long)r * row_stride + d]);
    dst[r * PITCH + d] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, DP <= 128 ? 2 : 1) flash_fwd_kernel(Args a) {
  constexpr int QP = DP + 1;      // odd pitch: the 16 key rows a warp reads hit 16 banks
  constexpr int NC = DP / 16;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x QP
  float* Ks = Qs + BQ * QP;       // BK x QP
  float* Vs = Ks + BK * QP;       // BK x DP
  float* Ps = Vs + BK * DP;       // BQ x PP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int nq = min(BQ, a.S - q0);
  const T* Q = (const T*)a.q + b * a.qs[0] + (long long)q0 * a.qs[1] + h * a.qs[2];
  const T* K = (const T*)a.k + b * a.ks[0] + kh * a.ks[2];
  const T* V = (const T*)a.v + b * a.vs[0] + kh * a.vs[2];
  T* O = (T*)a.o + b * a.os[0] + (long long)q0 * a.os[1] + h * a.os[2];

  for (int i = threadIdx.x; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (r < nq && d < a.D) x = to_f32(Q[(long long)r * a.qs[1] + d]);
    Qs[r * QP + d] = x;
  }

  // keys any row of this tile can see
  const int pos_lo = a.q_offset + q0, pos_hi = a.q_offset + q0 + nq - 1;
  int k_begin = 0, k_end = a.T;
  if (a.window > 0) k_begin = max(0, pos_lo - a.window + 1);
  if (a.causal) k_end = min(a.T, pos_hi + 1);
  k_begin = k_begin / BK * BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();              // the previous tile's K/V/P reads are done
    const int nk = min(BK, a.T - k0);
    load_tile<T, DP, QP>(Ks, K + (long long)k0 * a.ks[1], a.ks[1], nk, a.D);
    load_tile<T, DP, DP>(Vs, V + (long long)k0 * a.vs[1], a.vs[1], nk, a.D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = pos_lo + ty * 4 + i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool keep = kp < a.T;
        if (a.causal) keep = keep && pos >= kp;
        if (a.window > 0) keep = keep && pos - kp < a.window;
        ok[j] = keep;
        s[i][j] = keep ? s[i][j] * a.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) store(O + (long long)r * a.os[1] + d, acc[i][j] / l_safe);
    }
  }
}

template <typename T, int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int bytes = shared_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 16>(a, B, stream);
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

}  // namespace

// q: (B, S, H, D), k/v: (B, T, KH, D), o: (B, S, H, D), each addressed by its
// (batch, position, head) strides in elements with a contiguous last
// dimension; dtype 0 = float32, 1 = bfloat16 (all four tensors). Returns a
// cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int T, int H, int KH, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh, float scale,
                                   int causal, int window, int q_offset, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KH < 1 || H < 1 || H % KH != 0 || D < 1 || D > 256 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, S, T, H, KH, D,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh},
         scale, causal, window, q_offset};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? dispatch<float>(a, B, s) : dispatch<__nv_bfloat16>(a, B, s);
}
