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
// inputs are f32 or bf16. Operands are addressed through 64-bit (batch,
// position, head) strides; the last dimension is contiguous.
//
// What bounds it on the H100: operations, by the bound; in fact the softmax.
// At the serve shape (32 heads of 120 over 8,192 tokens, window 4,096) each
// K/V element is reused by ~4,000 query rows, so the 4*D FLOP per unmasked
// (query, key) pair dwarf the bytes; only the tensor cores (989 bf16 TFLOP/s,
// against 67 for scalar f32) come near the bound. With the products there,
// what is left in the way is the online softmax of each 64 x 64 tile (an
// exp, a max and a sum per score, in f32 on the CUDA cores) at two warps a
// scheduler, which the products do not overlap (PERF.md §6, the variants
// and ablations of tools/flash_variants.py).
//
// bf16 (the serve path): a tensor-core kernel. One CTA of one warpgroup (4
// warps) per (q tile of 64 rows, q head, batch), the longest rows first;
// warp w owns rows 16w..16w + 15. Q.K^T is one wgmma m64n64k16 per 16
// columns of D, both operands in shared memory; bf16 x bf16 products are
// exact in f32, so only the order of the f32 sum differs from the plain
// version. The row max and sum stay in registers (the 4 lanes of an
// accumulator row reduce by shuffles; l sums the unrounded f32 p). P.V runs
// on the tensor cores without rounding p: each f32 p is split into three
// bf16 terms, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), which
// sum to p exactly (for p >= 2^-80), and each term meets the same bf16 V in
// its own wgmma (A from registers: the S accumulator is the A fragment, so p
// never leaves registers; V from shared memory, transposed), so every
// product p.v is exact in f32, as the reference's f32 P.V is. The three
// passes are the price of f32 p, not work of the function. K and V tiles of
// 64 keys reach a two-stage ring in shared memory by TMA, one thread issuing
// the next tile's boxes while the current one is computed, completing on an
// mbarrier; they land in wgmma's 128-byte swizzle, with zeros past D and T.
// Q is loaded once (cp.async). Key tiles wholly above the causal diagonal or
// outside the window are skipped (exact: they leave m, l and acc
// unchanged); only tiles that straddle the diagonal, the window's edge or
// the end of the keys compute a mask. D is padded with zero columns to DP =
// 64, 128 or 256 (whole 64-column blocks of the swizzle; D <= 32 included:
// TMA fills the columns past D with zeros). The other load route of the
// same kernel (template TMA false) moves every operand element by element,
// for D % 8 != 0, a pointer or stride not 16-byte aligned, or a K/V stride
// of 0 (TMA needs positive strides). The output goes through the warp's own
// Q rows in shared memory to 16-byte stores (the element route: element
// stores).
//
// f32: the scalar kernel (no f32 tensor-core path: that would need q and k
// split as well). One CTA of 256 threads per (q tile of 64 rows, q head,
// batch); thread (ty, tx) owns query rows 4*ty..4*ty+3 and accumulator
// columns tx + 16*j, with scalar f32 FMAs from shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

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

// ------------------------------------------------------------ f32: scalar

namespace scalar {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int PP = BK + 1;      // pitch of the P tile

template <int DP>
constexpr int shared_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * PP;
}

// rows [0, rows) of a (rows_tile, DP) f32 tile from a strided source; zeros
// past `rows` and past D
template <int DP, int PITCH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int rows, int D) {
  for (int i = threadIdx.x; i < BK * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (r < rows && d < D) x = src[(long long)r * row_stride + d];
    dst[r * PITCH + d] = x;
  }
}

template <int DP>
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
  const float* Q = (const float*)a.q + b * a.qs[0] + (long long)q0 * a.qs[1] + h * a.qs[2];
  const float* K = (const float*)a.k + b * a.ks[0] + kh * a.ks[2];
  const float* V = (const float*)a.v + b * a.vs[0] + kh * a.vs[2];
  float* O = (float*)a.o + b * a.os[0] + (long long)q0 * a.os[1] + h * a.os[2];

  for (int i = threadIdx.x; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (r < nq && d < a.D) x = Q[(long long)r * a.qs[1] + d];
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
    load_tile<DP, QP>(Ks, K + (long long)k0 * a.ks[1], a.ks[1], nk, a.D);
    load_tile<DP, DP>(Vs, V + (long long)k0 * a.vs[1], a.vs[1], nk, a.D);
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
      if (d < a.D) O[(long long)r * a.os[1] + d] = acc[i][j] / l_safe;
    }
  }
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int bytes = shared_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<DP><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 16) return launch<16>(a, B, stream);
  if (a.D <= 32) return launch<32>(a, B, stream);
  if (a.D <= 64) return launch<64>(a, B, stream);
  if (a.D <= 128) return launch<128>(a, B, stream);
  return launch<256>(a, B, stream);
}

}  // namespace scalar

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int WARPS = 4;              // 16 query rows each
constexpr int BQ = 16 * WARPS;        // query rows per CTA
constexpr int BK = 64;                // keys per tile
constexpr int STAGES = 2;             // K/V tiles in the shared-memory ring
constexpr int P_TERMS = 3;            // bf16 terms of each f32 p in P.V (3: exact)
constexpr int THREADS = 32 * WARPS;

using bf16 = __nv_bfloat16;

// Q, the K and V rings, one mbarrier a stage (TMA: the stage's tile landed)
template <int DP>
constexpr int shared_bytes() {
  return (BQ + 2 * STAGES * BK) * DP * (int)sizeof(bf16) + STAGES * 8;
}

// element offset of 16-byte chunk c of row r in a (ROWS, DP) bf16 tile:
// blocks of 64 columns, each ROWS rows of 128 bytes with chunk c ^ (r % 8),
// which is wgmma's and TMA's 128-byte swizzle (blocks 1,024-byte aligned)
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile in shared memory:
// lbo / sbo are the byte strides between 64-element blocks along the
// leading dimension and between 8-row groups (lbo is unused K-major)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// shared-memory writes of this thread (generic proxy) visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the barrier's one arrival, expecting `bytes` of copies to land on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of this parity completes; a copy that never
// lands traps (a launch error) after ~2^31 cycles instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 31)) __trap();
  } while (!done);
}

// one (64 columns, 1 head, BK rows, 1 batch) box of a 4-D tensor map into
// shared memory (128-byte swizzled, zeros outside the tensor), landing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// d (64 x 64, f32) += a (64 x 16) . b (16 x 64), both from shared memory,
// K-major; the warpgroup's 4 warps hold d as 8 n-tiles of the m16n8
// accumulator layout (warp w: rows 16w..16w + 15)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16: each warp's 16 x 16 A fragment in the
// m16n8k16 layout) . b (16 x 64, from shared memory, MN-major: trans-b)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16: each warp's 16 x 16 A fragment in the
// m16n8k16 layout) . b (16 x 128, from shared memory, MN-major: trans-b)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// the A fragment of P.V for keys 16kk..16kk + 15 (the S fragments of
// n-tiles 2kk, 2kk + 1) as P_TERMS bf16 terms: term u holds what terms
// 0..u-1 left of p, rounded to bf16; three terms sum to p exactly (p >=
// 2^-80), so every product with a bf16 v is exact in f32
template <int NT>
__device__ __forceinline__ void split_p(const float (&s)[NT][4], int kk,
                                        uint32_t (&pa)[P_TERMS][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = s[2 * kk + (i >> 1)][(i & 1) * 2], y = s[2 * kk + (i >> 1)][(i & 1) * 2 + 1];
#pragma unroll
    for (int u = 0; u < P_TERMS; ++u) {
      const __nv_bfloat162 hx = __floats2bfloat162_rn(x, y);
      pa[u][i] = bits(hx);
      x -= __low2float(hx);
      y -= __high2float(hx);
    }
  }
}

// rows [0, rows) of a (ROWS, DP) swizzled tile from a strided source; zeros
// past `rows` and past D. VEC: 16-byte cp.async (D % 8 == 0, 16-byte aligned
// rows), else element by element.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int rows, int D) {
  constexpr int CPR = DP / 8;   // chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    bf16* d = dst + swz<ROWS>(r, c);
    const bool in = r < rows;
    const bf16* s = src + (in ? (long long)r * row_stride : 0) + c * 8;
    if constexpr (VEC) {
      const bool full = in && c * 8 < D;
      cp_async16(d, full ? s : src, full ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = in && c * 8 + e < D ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// TMA: K and V tiles come by TMA (tmk, tmv), Q by 16-byte cp.async and the
// output leaves in 16-byte stores; else every operand goes element by element
template <int DP, bool TMA>
__global__ void __launch_bounds__(THREADS, DP <= 128 ? 8 / WARPS : 1)
    flash_fwd_tc(Args a, const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv) {
  constexpr int KT = DP / 16;             // k-steps of Q.K^T
  constexpr int NT = BK / 8;              // 8-key column tiles of S
  static_assert(BK == 64 && DP % 64 == 0, "wgmma tiles: 64 keys, 64-column blocks");
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);     // BQ x DP
  bf16* Ks = Qs + BQ * DP;                      // STAGES x BK x DP
  bf16* Vs = Ks + STAGES * BK * DP;             // STAGES x BK x DP
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * BK * DP);   // STAGES

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;  // fragment row g (and g + 8), columns 2t, 2t + 1
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int nq = min(BQ, a.S - q0);
  const bf16* Q = (const bf16*)a.q + b * a.qs[0] + (long long)q0 * a.qs[1] + h * a.qs[2];
  const bf16* K = (const bf16*)a.k + b * a.ks[0] + kh * a.ks[2];
  const bf16* V = (const bf16*)a.v + b * a.vs[0] + kh * a.vs[2];
  bf16* O = (bf16*)a.o + b * a.os[0] + (long long)q0 * a.os[1] + h * a.os[2];

  // keys any row of this tile can see
  const int pos_lo = a.q_offset + q0, pos_hi = pos_lo + nq - 1;
  int k_begin = 0, k_end = a.T;
  if (a.window > 0) k_begin = max(0, pos_lo - a.window + 1);
  if (a.causal) k_end = min(a.T, pos_hi + 1);
  k_begin = k_begin / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int tile) {
    const int k0 = k_begin + tile * BK, st = tile % STAGES;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        mbar_expect(&bars[st], 2 * BK * DP * (int)sizeof(bf16));
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb) {
          tma_load(Ks + st * BK * DP + cb * BK * 64, &tmk, &bars[st], cb * 64, kh, k0, b);
          tma_load(Vs + st * BK * DP + cb * BK * 64, &tmv, &bars[st], cb * 64, kh, k0, b);
        }
      }
    } else {
      const int nk = min(BK, a.T - k0);
      load_tile<DP, BK, false>(Ks + st * BK * DP, K + (long long)k0 * a.ks[1], a.ks[1], nk, a.D);
      load_tile<DP, BK, false>(Vs + st * BK * DP, V + (long long)k0 * a.vs[1], a.vs[1], nk, a.D);
    }
  };

  if constexpr (TMA) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int st = 0; st < STAGES; ++st) mbar_init(&bars[st]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  load_tile<DP, BQ, TMA>(Qs, Q, a.qs[1], nq, a.D);   // TMA: one cp.async group
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < n_tiles) load_kv(st);

  float o[2 * KT][4];
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // rows g, g + 8; l is this lane's part
  const int pos0 = pos_lo + warp * 16 + g;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();           // Q has landed (TMA)
    fence_async_smem();            // this thread's stores of Q and K/V visible to wgmma
    if constexpr (TMA) mbar_wait(&bars[it % STAGES], (it / STAGES) & 1);   // tile it landed
    __syncthreads();               // ... for every thread, and tile it - 1 is read
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    const int k0 = k_begin + it * BK;
    const bf16* Kt = Ks + (it % STAGES) * BK * DP;
    const bf16* Vt = Vs + (it % STAGES) * BK * DP;

    // S = Q . K^T: n-tile j holds keys k0 + 8j .. 8j + 7; one warpgroup-wide
    // wgmma per 16 columns of DP, both operands from shared memory (K-major),
    // the warpgroup's 64 rows of Q
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      wgmma_ss_n64(s, sw128_desc(Qs + (kk >> 2) * BQ * 64 + wg * 64 * 64 + (kk & 3) * 16, 16, 1024),
                   sw128_desc(Kt + (kk >> 2) * BK * 64 + (kk & 3) * 16, 16, 1024));
    wgmma_commit_wait();

    // only tiles at an edge of what the rows may see compute a mask
    const bool edge = k0 + BK > a.T
                      || (a.causal && k0 + BK - 1 > pos_lo)
                      || (a.window > 0 && pos_hi - k0 >= a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (edge) {
          const int pos = pos0 + (e >> 1) * 8, kp = k0 + 8 * j + 2 * t + (e & 1);
          bool ok = kp < a.T;
          if (a.causal) ok = ok && pos >= kp;
          if (a.window > 0) ok = ok && pos - kp < a.window;
          if (!ok) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // a masked p is 0: exp(-1e30 - m) underflows to 0 once the row has seen
    // a key; a row that has seen none keeps m = -1e30 and subtracts 0 instead
    float alpha[2], mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      mu[r] = mx[r] == NEG ? 0.f : mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mu[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {   // a row max moved
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }

    // O += P . V over 16-key steps, p split into P_TERMS bf16 terms; V from
    // shared memory as MN-major B (trans-b): 64-column blocks BK * 128 bytes
    // apart, 8-key groups 1,024 apart; at most 128 columns a wgmma
    uint32_t pa[BK / 16][P_TERMS][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) split_p(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int u = 0; u < P_TERMS; ++u) {
        if constexpr (DP == 64) {
          wgmma_rs_n64(o, pa[kk][u], sw128_desc(Vt + kk * 16 * 64, BK * 128, 1024));
        } else {
#pragma unroll
          for (int nb = 0; nb < DP / 128; ++nb)
            wgmma_rs_n128(*reinterpret_cast<float(*)[16][4]>(&o[16 * nb]), pa[kk][u],
                          sw128_desc(Vt + nb * 2 * BK * 64 + kk * 16 * 64, BK * 128, 1024));
        }
      }
    wgmma_commit_wait();
  }

  cp_async_wait_all();
  __syncthreads();   // every copy into Q's rows has landed and been read

  // out = acc / max(l, 1e-30) in bf16, through the warp's own Q rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(Qs + swz<BQ>(warp * 16 + g + 8 * r, n) + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
  __syncwarp();
  constexpr int CPR = DP / 8;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = warp * 16 + i / CPR, c = i % CPR;
    if (r >= nq || c * 8 >= a.D) continue;
    const bf16* src = Qs + swz<BQ>(r, c);
    bf16* dst = O + (long long)r * a.os[1] + c * 8;
    if constexpr (TMA) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < a.D; ++e) dst[e] = src[e];
    }
  }
}

template <int DP, bool TMA>
int launch(const Args& a, int B, cudaStream_t stream, const CUtensorMap& tmk,
           const CUtensorMap& tmv) {
  const int bytes = shared_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<DP, TMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_tc<DP, TMA>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_tc<DP, TMA><<<grid, THREADS, bytes, stream>>>(a, tmk, tmv);
  return (int)cudaGetLastError();
}

// D padded with zero columns to a whole number of wgmma's 64-column blocks
template <bool TMA>
int dispatch_dp(const Args& a, int B, cudaStream_t stream, const CUtensorMap& tmk,
                const CUtensorMap& tmv) {
  if (a.D <= 64) return launch<64, TMA>(a, B, stream, tmk, tmv);
  if (a.D <= 128) return launch<128, TMA>(a, B, stream, tmk, tmv);
  return launch<256, TMA>(a, B, stream, tmk, tmv);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA library, looked up through the
// runtime's entry-point query (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a (B, T, KH, D) bf16 operand with (batch, position, head) strides as a
// 4-D tensor map of (64 columns, 1 head, BK rows, 1 batch) boxes, 128-byte
// swizzled, zeros past D and T
int kv_map(CUtensorMap* map, const void* base, const long long (&st)[3], int B, int T, int KH,
           int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KH, (cuuint64_t)T, (cuuint64_t)B};
  // bytes between heads, positions, batches (a dim of size 1 may have any)
  const cuuint64_t strides[3] = {(cuuint64_t)(KH > 1 ? st[2] * 2 : 16),
                                 (cuuint64_t)(T > 1 ? st[1] * 2 : 16),
                                 (cuuint64_t)(B > 1 ? st[0] * 2 : 16)};
  const cuuint32_t box[4] = {64, 1, BK, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the TMA route needs whole 16-byte chunks (D % 8 == 0, 16-byte aligned
// base pointers, strides that are multiples of 8 elements) and positive K/V
// strides over every dim longer than 1; anything else (an unaligned view, K/V
// expanded over heads) takes the element route
int dispatch(const Args& a, int B, cudaStream_t stream) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  bool tma = a.D % 8 == 0;
  for (const void* p : ptrs) tma = tma && (uintptr_t)p % 16 == 0;
  for (int i = 0; i < 3; ++i)
    tma = tma && a.qs[i] % 8 == 0 && a.ks[i] % 8 == 0 && a.vs[i] % 8 == 0 && a.os[i] % 8 == 0;
  const int len[3] = {B, a.T, a.KH};
  for (int i = 0; i < 3; ++i) tma = tma && (len[i] == 1 || (a.ks[i] > 0 && a.vs[i] > 0));
  CUtensorMap tmk, tmv;
  memset(&tmk, 0, sizeof(tmk));
  memset(&tmv, 0, sizeof(tmv));
  if (!tma) return dispatch_dp<false>(a, B, stream, tmk, tmv);
  int err = kv_map(&tmk, a.k, a.ks, B, a.T, a.KH, a.D);
  if (err == 0) err = kv_map(&tmv, a.v, a.vs, B, a.T, a.KH, a.D);
  return err != 0 ? err : dispatch_dp<true>(a, B, stream, tmk, tmv);
}

}  // namespace tc

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
  return dtype == 0 ? scalar::dispatch(a, B, s) : tc::dispatch(a, B, s);
}
