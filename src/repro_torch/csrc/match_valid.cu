// Pairwise match/valid column counts over int8 row sets, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/distance/distance_kernel.py::
// match_valid_kernel (body _kernel). For rows i of A (N, L) and j of B (M, L):
//   match[i, j] = #columns with A == B, A != gap, 0 <= A < n_chars
//   valid[i, j] = #columns with both A and B != gap and < n_chars
// exactly as the reference's one-hot products count them (a negative code is
// valid and never matches); counts are exact int32.
//
// Three routes of the same function; the wrapper (kernels/distance/ops.py)
// picks one from the shapes and n_chars alone:
//
// Tensor cores (tc; 1 <= n_chars <= 32, both sides at least 9 rows). What
// bounds it on the H100: operations. Each output pair compares all L
// columns, so the inputs are reused ~N times; as in the reference, the
// compares become int8 one-hot matrix products: one plane per symbol and
// one validity plane, K = (n_chars + 1) * L. The int8 wgmma (1,979 TOP/s)
// does the products. What is left on the CUDA cores is to expand the int8
// tiles into one-hot planes in shared memory, ~30 integer operations a
// word; the expansion, its stores and the products' shared-memory reads
// each cost about as much as the products (PERF.md: the ablations of
// tools/match_valid_variants.py), so the design overlaps them. A CTA of two
// warpgroups owns a 128 x 128 output tile; per chunk of 32 columns each
// thread loads 16 raw bytes of one A row and one B row (one chunk ahead, in
// registers), classifies them four to a word (valid, countable) and writes
// one 16-byte plane per symbol (bytes 1 where the code equals it) and the
// validity plane (bytes -128) straight into wgmma's 128-byte swizzle. A
// stage is one swizzle block (4 k-steps of 32 bytes) of A and of B, two
// stages ring in 64 KB, so two CTAs share an SM (at most 128 registers):
// one expands while the other's products run, and within a CTA stage s + 1
// is expanded while wgmma m64n128k32 s8 reads stage s, both operands
// K-major from shared memory (each one-hot row is contiguous in K). One
// int32 accumulator holds match + 16384 * valid (symbol planes 1 x 1, the
// validity plane -128 x -128): exact while a CTA covers < 16,384 columns,
// so a CTA takes at most 511 chunks. Symmetric calls (A is B, and every
// group call) launch only tiles with column block >= row block and write
// (i, j) and (j, i). Grids of fewer tiles than SMs split L across CTAs,
// whose partial counts meet in outputs zeroed first by integer atomicAdd
// (order-free, so still exact and deterministic).
//
// Skinny (min(N, M) <= 8). Bound by bytes: the long side is read once
// (409 x 6,344 bytes ~ 0.8 us at the H100's 3.35 TB/s), less than a
// launch. One warp per long row reads 16 bytes a lane and compares them
// with the short rows, which sit recoded in shared memory: __vcmpeq4 +
// __popc for match, AND + __popc for valid; the lanes' sums meet by
// shuffles.
//
// SIMD (n_chars outside 1..32). Bound by operations on the CUDA cores: two
// __popc for every 4 columns of every pair, 16 a clock on an SM. The first
// Hopper kernel's arithmetic: 64 x 64 tiles, 256 threads of 4 x 4
// counters, L through shared memory in 64-byte chunks recoded on the way
// in (invalid bytes get sentinels that differ between A and B), __vcmpeq4
// / AND + __popc; with the same upper triangle, split L and group rows as
// the tensor-core route.
//
// Group calls (match_valid_groups): G squares in one launch; row r of group
// g is msa row index[g, r], -1 a pad row that counts nothing. On a TPU the
// L reduction ran over a sequential grid dimension; here it is a loop inside
// the CTA, cut across CTAs only on small grids.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

// ------------------------------------------------------------------ common

struct Problem {
  const int8_t* a;           // (rows, L); group calls: the msa
  const int8_t* b;           // (rows_b, L); symmetric and group calls: a
  const long long* index;    // group calls: (G, N) row ids, -1 a pad row; else null
  int N, M, L;               // output (N, M), per group
  int rows;                  // group calls: rows of the msa (ids past it are pads)
  int n_chars, gap;
  int* match;                // (G, N, M) / (N, M)
  int* valid;
  int tri;                   // upper-triangle tiles, both halves written
  int tiles_n;               // tiles along a row of tiles (per side when tri)
  int chunks, chunks_per_cta;  // L in chunks, and per CTA along blockIdx.y
  int atomic;                // split L: the CTAs of a tile add their counts
};

// row r (< N or M) of operand `base` in this CTA's group; null: a pad row
__device__ __forceinline__ const int8_t* row_ptr(const Problem& p, const int8_t* base, int r) {
  if (p.index != nullptr) {
    const long long id = p.index[(long long)blockIdx.z * p.N + r];
    return id >= 0 && id < p.rows ? p.a + id * (long long)p.L : nullptr;
  }
  return base + (long long)r * p.L;
}

// output tile (bi, bj) of linear tile t: row-major, or the upper triangle
__device__ __forceinline__ void tile_of(const Problem& p, int t, int& bi, int& bj) {
  if (p.tri) {
    bi = 0;
    while (t >= p.tiles_n - bi) t -= p.tiles_n - bi++;
    bj = bi + t;
  } else {
    bi = t / p.tiles_n;
    bj = t % p.tiles_n;
  }
}

__device__ __forceinline__ void emit(int* dst, int x, bool atomic) {
  if (!atomic) *dst = x;
  else if (x != 0) atomicAdd(dst, x);
}

// pair (i, j), i < N and j < M; symmetric calls keep i <= j and mirror it
__device__ __forceinline__ void put(const Problem& p, int i, int j, int m, int v) {
  if (p.tri && i > j) return;
  const long long g = (long long)blockIdx.z * p.N * p.M;
  emit(p.match + g + (long long)i * p.M + j, m, p.atomic);
  emit(p.valid + g + (long long)i * p.M + j, v, p.atomic);
  if (p.tri && i != j) {
    emit(p.match + g + (long long)j * p.M + i, m, p.atomic);
    emit(p.valid + g + (long long)j * p.M + i, v, p.atomic);
  }
}

// 16 bytes of a row from column col (a multiple of 16); bytes at or past L
// and of a null row are 0 (the callers mask them). VEC: the widest load that
// L and the base address allow (16, 8, 4 or 1 bytes).
template <int VEC>
__device__ __forceinline__ uint4 load16(const int8_t* row, int col, int L) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row == nullptr) return r;
  if constexpr (VEC == 16) {
    if (col < L) r = __ldg(reinterpret_cast<const uint4*>(row + col));
  } else if constexpr (VEC == 8) {
    if (col < L) {
      const uint2 lo = __ldg(reinterpret_cast<const uint2*>(row + col));
      r.x = lo.x, r.y = lo.y;
    }
    if (col + 8 < L) {
      const uint2 hi = __ldg(reinterpret_cast<const uint2*>(row + col + 8));
      r.z = hi.x, r.w = hi.y;
    }
  } else if constexpr (VEC == 4) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + 4 * k < L) w[k] = __ldg(reinterpret_cast<const uint32_t*>(row + col + 4 * k));
    r = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (col + e < L) w[e >> 2] |= (uint32_t)(uint8_t)__ldg(row + col + e) << (8 * (e & 3));
    r = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return r;
}

// 4 bytes of a row from column col (a multiple of 4), as load16
template <int VEC>
__device__ __forceinline__ uint32_t load4(const int8_t* row, int col, int L) {
  uint32_t w = 0u;
  if constexpr (VEC >= 4) {
    if (col < L) w = __ldg(reinterpret_cast<const uint32_t*>(row + col));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < L) w |= (uint32_t)(uint8_t)__ldg(row + col + e) << (8 * e);
  }
  return w;
}

// bytes 0..live-1 of a word (live may be <= 0 or >= 4)
__device__ __forceinline__ uint32_t bytes_below(int live) {
  return live >= 4 ? 0xFFFFFFFFu : live <= 0 ? 0u : 0xFFFFFFFFu >> (8 * (4 - live));
}

// scalar recode of 4 codes (bytes past `live` invalid): countable bytes keep
// their code, the others become `sentinel`; ok gets 1 in each valid byte
__device__ __forceinline__ uint32_t recode(uint32_t w, int live, int n_chars, int gap,
                                           uint32_t sentinel, uint32_t& ok) {
  uint32_t c = 0u;
  ok = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int x = (int)(int8_t)(w >> (8 * q));
    const bool valid = q < live && x != gap && x < n_chars;
    const bool countable = valid && x >= 0;
    c |= (countable ? (uint32_t)x : sentinel) << (8 * q);
    ok |= (valid ? 1u : 0u) << (8 * q);
  }
  return c;
}

// ------------------------------------------------------- route tc: wgmma

namespace tc {

constexpr int BT = 128;            // output rows and columns per CTA
constexpr int THREADS = 256;       // two warpgroups of 64 rows
constexpr int CW = 32;             // columns per chunk: one k-step per plane
constexpr int STEPS = 4;           // k-steps a stage: one 128-byte swizzle block
constexpr int BLK = BT * 128;      // one swizzle block of one operand tile, bytes
constexpr int STAGE = 2 * BLK;     // the A block and the B block
constexpr int SMEM = 2 * STAGE;    // two stages: 64 KB, two CTAs an SM
constexpr int MAX_CHARS = 32;
constexpr int MAX_CHUNKS = 511;    // columns a CTA < 16,384: match stays below 2^14
constexpr int VALID_SHIFT = 14;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma operand descriptor of a K-major 128-byte-swizzled tile: 8-row groups
// 1,024 bytes apart (the leading offset is unused K-major)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// this thread's shared-memory writes (generic proxy) visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128, s32) += a (64 x 32, s8) . b (128 x 32, s8)^T, both from
// shared memory, K-major; the warpgroup's 4 warps hold d as 16 n-tiles of
// the m16n8 accumulator layout (warp w: rows 16w..16w + 15)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// 16 codes classified four to a word, each byte's verdict in its bit 7:
// xp = the code's low 7 bits; cnt = countable (0 <= x < n_chars, x != gap);
// val = valid (x != gap, x < n_chars, signed). `live` (0x80 bits) clears
// pad rows and columns past L.
struct Coded {
  uint32_t xp[4], cnt[4], val[4];
};

struct Consts {
  uint32_t k1;      // (0x80 - n_chars) in each byte: bit 7 of xp + k1 <=> xp >= n_chars
  uint32_t gap4;    // the gap in each byte
  bool gap_in;      // the gap is an int8 value (else no byte equals it)
};

__device__ __forceinline__ void classify(const uint4 raw, uint32_t live, int col, int L, bool tail,
                                         const Consts& k, Coded& c) {
  const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w = w4[q];
    const uint32_t lv = tail ? live & bytes_below(L - (col + 4 * q)) : live;
    const uint32_t xp = w & 0x7F7F7F7Fu;
    const uint32_t t = xp + k.k1;                       // bit 7: xp >= n_chars
    uint32_t ne = lv;                                   // bit 7: x != gap
    if (k.gap_in) {
      const uint32_t z = w ^ k.gap4;
      ne = (((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z) & lv;
    }
    c.xp[q] = xp;
    c.cnt[q] = ~(t | w) & ne;                           // x >= 0 and x < n_chars
    c.val[q] = (~t | w) & ne;                           // x < 0 or x < n_chars
  }
}

// the one-hot plane of symbol q (q4: q in each byte): 1 where the code is q
__device__ __forceinline__ uint4 plane(const Coded& c, uint32_t q4) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (~((c.xp[i] ^ q4) + 0x7F7F7F7Fu) & c.cnt[i]) >> 7;
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2) tc_kernel(const Problem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int bi, bj;
  tile_of(p, blockIdx.x, bi, bj);
  const int row0 = bi * BT, col0 = bj * BT;

  // this thread expands half h of tile row r of A and of B
  const int r = tid >> 1, h = tid & 1;
  const int8_t* pa = row0 + r < p.N ? row_ptr(p, p.a, row0 + r) : nullptr;
  const int8_t* pb = col0 + r < p.M ? row_ptr(p, p.b, col0 + r) : nullptr;
  const uint32_t live_a = pa != nullptr ? 0x80808080u : 0u;
  const uint32_t live_b = pb != nullptr ? 0x80808080u : 0u;
  Consts k;
  k.k1 = (uint32_t)(0x80 - p.n_chars) * 0x01010101u;
  k.gap_in = p.gap >= -128 && p.gap <= 127;
  k.gap4 = (uint32_t)(uint8_t)p.gap * 0x01010101u;
  // match planes: symbols 0..n_chars-1 but the gap; then the validity plane
  const int skip = p.gap >= 0 && p.gap < p.n_chars ? p.gap : p.n_chars;
  const int n_sym = p.n_chars - (skip < p.n_chars ? 1 : 0);
  const int planes = n_sym + 1;

  // this item's byte offset in a stage at k-step j, both operands
  const uint32_t base = smem_addr(smem);
  const uint32_t row_off = r * 128, r7 = r & 7;

  int acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  const int ch0 = blockIdx.y * p.chunks_per_cta;
  const int ch1 = min(ch0 + p.chunks_per_cta, p.chunks);
  uint4 next_a = load16<VEC>(pa, ch0 * CW + h * 16, p.L);
  uint4 next_b = load16<VEC>(pb, ch0 * CW + h * 16, p.L);
  int stage = 0;
  for (int ch = ch0; ch < ch1; ++ch) {
    const uint4 ra = next_a, rb = next_b;
    const int col = ch * CW + h * 16;
    if (ch + 1 < ch1) {
      next_a = load16<VEC>(pa, col + CW, p.L);
      next_b = load16<VEC>(pb, col + CW, p.L);
    }
    const bool tail = (ch + 1) * CW > p.L;
    Coded ca, cb;
    classify(ra, live_a, col, p.L, tail, k, ca);
    classify(rb, live_b, col, p.L, tail, k, cb);
    for (int s0 = 0; s0 < planes; s0 += STEPS, ++stage) {
      const int steps = min(STEPS, planes - s0);
      const uint32_t st = base + (stage & 1) * STAGE;
      // expand: plane s0 + j of both rows into k-step j of this stage (a
      // stage's buffer was last read by the wgmma of stage - 2, which every
      // warpgroup waited for before the barrier of stage - 1)
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        if (j < steps) {
          const int s = s0 + j;
          uint4 wa, wb;
          if (s < n_sym) {
            const uint32_t q4 = (uint32_t)(s + (s >= skip ? 1 : 0)) * 0x01010101u;
            wa = plane(ca, q4);
            wb = plane(cb, q4);
          } else {
            wa = make_uint4(ca.val[0], ca.val[1], ca.val[2], ca.val[3]);   // -128 a valid byte
            wb = make_uint4(cb.val[0], cb.val[1], cb.val[2], cb.val[3]);
          }
          const uint32_t off = (j >> 2) * BLK + row_off + (((((j & 3) << 1) | h) ^ r7) << 4);
          st_shared16(st + off, wa);
          st_shared16(st + BLK + off, wb);
        }
      }
      wgmma_wait_all();      // this warpgroup's products of the previous stage
      fence_async_smem();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        if (j < steps) {
          const uint32_t koff = (j >> 2) * BLK + (j & 3) * 32;
          wgmma_s8_n128(acc, sw128_desc(st + koff + wg * 64 * 128),
                        sw128_desc(st + BLK + koff));
        }
      }
      wgmma_commit();
    }
  }
  wgmma_wait_all();

  // acc = match + 16384 * valid
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row0 + wg * 64 + warp * 16 + (lane >> 2) + (e >> 1) * 8;
      const int c = col0 + j * 8 + (lane & 3) * 2 + (e & 1);
      if (i < p.N && c < p.M)
        put(p, i, c, acc[j][e] & ((1 << VALID_SHIFT) - 1), acc[j][e] >> VALID_SHIFT);
    }
}

}  // namespace tc

// ----------------------------------------------------- route simd: popc

namespace simd {

constexpr int TILE = 64;          // output rows/cols per CTA
constexpr int KB = 64;            // L bytes per chunk
constexpr int KW = KB / 4;        // 32-bit words per row chunk
constexpr int PAD = KW + 1;       // row pitch in words (bank-conflict free)
constexpr int THREADS = 256;

// chunk k0 of the tile's rows, recoded (invalid bytes -> sentinel) with
// each byte's validity bit beside it
__device__ __forceinline__ void load_tile(const int8_t* const* rows, int L, int k0, int n_chars,
                                          int gap, uint32_t sentinel, uint32_t (*code)[PAD],
                                          uint32_t (*ok)[PAD]) {
  for (int w = threadIdx.x; w < TILE * KW; w += THREADS) {
    const int r = w / KW, kw = w % KW;
    const int col = k0 + kw * 4;
    const int8_t* src = rows[r];
    uint32_t raw = 0u;
    int live = 0;
    if (src != nullptr) {
      live = L - col;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < L) raw |= (uint32_t)(uint8_t)src[col + q] << (8 * q);
    }
    uint32_t v;
    code[r][kw] = recode(raw, live, n_chars, gap, sentinel, v);
    ok[r][kw] = v;
  }
}

__global__ void __launch_bounds__(THREADS) simd_kernel(const Problem p) {
  __shared__ uint32_t a_code[TILE][PAD], a_ok[TILE][PAD];
  __shared__ uint32_t b_code[TILE][PAD], b_ok[TILE][PAD];
  __shared__ const int8_t* rows_a[TILE];
  __shared__ const int8_t* rows_b[TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int bi, bj;
  tile_of(p, blockIdx.x, bi, bj);
  const int row0 = bi * TILE, col0 = bj * TILE;
  if (threadIdx.x < TILE) {
    const int r = row0 + threadIdx.x;
    rows_a[threadIdx.x] = r < p.N ? row_ptr(p, p.a, r) : nullptr;
  } else if (threadIdx.x < 2 * TILE) {
    const int c = col0 + threadIdx.x - TILE;
    rows_b[threadIdx.x - TILE] = c < p.M ? row_ptr(p, p.b, c) : nullptr;
  }
  __syncthreads();
  uint32_t acc_m[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_m[i][j] = acc_v[i][j] = 0;

  const int ch0 = blockIdx.y * p.chunks_per_cta;
  const int ch1 = min(ch0 + p.chunks_per_cta, p.chunks);
  for (int ch = ch0; ch < ch1; ++ch) {
    load_tile(rows_a, p.L, ch * KB, p.n_chars, p.gap, 0xFEu, a_code, a_ok);
    load_tile(rows_b, p.L, ch * KB, p.n_chars, p.gap, 0xFFu, b_code, b_ok);
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < p.N && c < p.M) put(p, r, c, (int)(acc_m[i][j] >> 3), (int)acc_v[i][j]);
    }
  }
}

}  // namespace simd

// ------------------------------------------------- route skinny: one warp a row

namespace skinny {

constexpr int MAX_SHORT = 8;       // rows of the short side
constexpr int THREADS = 256;       // 8 warps, one long row each
constexpr int SMEM = 32768;        // the short rows' recoded chunk: codes + valid bits

// X: the long side (R rows), Y: the short side (S rows); pair (x, y) goes to
// out[x * ox + y * oy]. Chunks of `cl` columns (a multiple of 512) of Y are
// recoded into shared memory; each lane of a warp takes 16 bytes of its X
// row at a time.
template <int VEC>
__global__ void __launch_bounds__(THREADS) skinny_kernel(const int8_t* X, int R, const int8_t* Y,
                                                         int S, int L, int cl, int n_chars,
                                                         int gap, int* match, int* valid,
                                                         long long ox, long long oy) {
  extern __shared__ __align__(16) uint32_t sh[];
  uint32_t* y_code = sh;                       // S rows of cl / 4 words
  uint32_t* y_ok = sh + S * (cl / 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x = blockIdx.x * (THREADS / 32) + warp;
  const int8_t* px = x < R ? X + (long long)x * L : nullptr;
  uint32_t am[MAX_SHORT], av[MAX_SHORT];
#pragma unroll
  for (int s = 0; s < MAX_SHORT; ++s) am[s] = av[s] = 0u;

  const int words = cl / 4;
  for (int c0 = 0; c0 < L; c0 += cl) {
    __syncthreads();
    for (int w = threadIdx.x; w < S * words; w += THREADS) {
      const int s = w / words, col = c0 + 4 * (w % words);
      uint32_t ok;
      y_code[w] = recode(load4<VEC>(Y + (long long)s * L, col, L), L - col, n_chars, gap, 0xFFu,
                         ok);
      y_ok[w] = ok;
    }
    __syncthreads();
    if (px == nullptr) continue;
#pragma unroll 2
    for (int k = lane * 16; k < cl && c0 + k < L; k += 512) {
      const uint4 raw = load16<VEC>(px, c0 + k, L);
      const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t xc[4], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xc[q] = recode(w4[q], L - (c0 + k + 4 * q), n_chars, gap, 0xFEu,
                                                 xv[q]);
#pragma unroll
      for (int s = 0; s < MAX_SHORT; ++s) {
        if (s < S) {
          const uint4 yc = *reinterpret_cast<const uint4*>(y_code + s * words + k / 4);
          const uint4 yv = *reinterpret_cast<const uint4*>(y_ok + s * words + k / 4);
          am[s] += __popc(__vcmpeq4(xc[0], yc.x)) + __popc(__vcmpeq4(xc[1], yc.y)) +
                   __popc(__vcmpeq4(xc[2], yc.z)) + __popc(__vcmpeq4(xc[3], yc.w));
          av[s] += __popc(xv[0] & yv.x) + __popc(xv[1] & yv.y) + __popc(xv[2] & yv.z) +
                   __popc(xv[3] & yv.w);
        }
      }
    }
  }
  if (px == nullptr) return;
#pragma unroll
  for (int s = 0; s < MAX_SHORT; ++s) {
    if (s < S) {
      uint32_t m = am[s], v = av[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m += __shfl_xor_sync(0xFFFFFFFFu, m, o);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
      }
      if (lane == 0) {
        match[x * ox + s * oy] = (int)(m >> 3);   // __vcmpeq4: 8 bits per equal byte
        valid[x * ox + s * oy] = (int)v;
      }
    }
  }
}

}  // namespace skinny

// ------------------------------------------------------------------ host

enum Route { SKINNY = 0, TC = 1, SIMD = 2 };

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// the widest load (16, 8, 4 or 1 bytes) every row start allows
int vec_width(const void* base, int L) {
  const uintptr_t a = (uintptr_t)base;
  for (int v = 16; v >= 4; v /= 2)
    if (L % v == 0 && a % v == 0) return v;
  return 1;
}

template <typename F>
int by_vec(int vec, F&& f) {
  switch (vec) {
    case 16: return f(std::integral_constant<int, 16>());
    case 8: return f(std::integral_constant<int, 8>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 1>());
  }
}

// L split across CTAs while the tiles (times the groups) fill fewer than
// `per_sm` CTAs an SM; a split keeps at least `min_chunks` chunks, and the
// tensor-core route at most tc::MAX_CHUNKS. Returns the CTAs along L; when
// there are several they add into outputs zeroed here.
int plan_split(Problem& p, long long ctas, int per_sm, int min_chunks, int max_chunks) {
  const long long want = (long long)per_sm * sm_count();
  long long split = ctas >= want ? 1 : want / ctas;
  split = std::min<long long>(split, std::max(1, p.chunks / min_chunks));
  if (max_chunks > 0) split = std::max<long long>(split, (p.chunks + max_chunks - 1) / max_chunks);
  split = std::max<long long>(split, 1);
  p.chunks_per_cta = std::max(1, (int)((p.chunks + split - 1) / split));
  const int used = std::max(1, (p.chunks + p.chunks_per_cta - 1) / p.chunks_per_cta);
  p.atomic = used > 1;
  return used;
}

int launch_tiled(Problem p, int route, int groups, cudaStream_t stream) {
  const int bt = route == TC ? tc::BT : simd::TILE;
  const int tn = (p.M + bt - 1) / bt, tm = (p.N + bt - 1) / bt;
  p.tiles_n = tn;
  const long long tiles = p.tri ? (long long)tn * (tn + 1) / 2 : (long long)tn * tm;
  int split;
  if (route == TC) {
    p.chunks = (p.L + tc::CW - 1) / tc::CW;
    split = plan_split(p, tiles * groups, 1, 4, tc::MAX_CHUNKS);
  } else {
    p.chunks = (p.L + simd::KB - 1) / simd::KB;
    split = plan_split(p, tiles * groups, 2, 4, 0);
  }
  if (tiles > 0x7FFFFFFFll || split > 65535 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (p.atomic) {   // the CTAs along L add into zeros
    const size_t bytes = (size_t)groups * p.N * p.M * sizeof(int);
    cudaError_t e = cudaMemsetAsync(p.match, 0, bytes, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(p.valid, 0, bytes, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)tiles, split, groups);
  if (route == SIMD) {
    simd::simd_kernel<<<grid, simd::THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
  return by_vec(std::min(vec_width(p.a, p.L), vec_width(p.b, p.L)), [&](auto v) {
    constexpr int V = decltype(v)::value;
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          tc::tc_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
    tc::tc_kernel<V><<<grid, tc::THREADS, tc::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

int launch_skinny(const int8_t* a, const int8_t* b, int N, int M, int L, int n_chars, int gap,
                  int* match, int* valid, cudaStream_t stream) {
  // the long side is X; the output stays (N, M) row-major
  const bool a_long = N >= M;
  const int8_t* X = a_long ? a : b;
  const int8_t* Y = a_long ? b : a;
  const int R = a_long ? N : M, S = a_long ? M : N;
  if (S > skinny::MAX_SHORT) return (int)cudaErrorInvalidValue;
  const long long ox = a_long ? M : 1, oy = a_long ? 1 : M;
  // the short rows' chunk: codes and valid bits of S rows in SMEM bytes
  int cl = (skinny::SMEM / (2 * S)) / 512 * 512;
  cl = std::max(512, std::min(cl, (L + 511) / 512 * 512));
  const dim3 grid((R + skinny::THREADS / 32 - 1) / (skinny::THREADS / 32));
  const size_t smem = (size_t)2 * S * cl;
  return by_vec(std::min(vec_width(X, L), vec_width(Y, L)), [&](auto v) {
    constexpr int V = decltype(v)::value;
    skinny::skinny_kernel<V><<<grid, skinny::THREADS, smem, stream>>>(
        X, R, Y, S, L, cl, n_chars, gap, match, valid, ox, oy);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// a: (N, L) int8, b: (M, L) int8, both contiguous; sym != 0: b is a (N ==
// M) and only the upper triangle of tiles is computed. route: 0 skinny, 1
// tensor cores, 2 simd. match, valid: (N, M) int32, every entry written.
// Returns a cudaError_t.
extern "C" int match_valid(const void* a, const void* b, int N, int M, int L, int n_chars,
                           int gap, int sym, int route, void* match, void* valid, void* stream) {
  if (N < 1 || M < 1 || L < 0 || (sym && (N != M || a != b))) return (int)cudaErrorInvalidValue;
  if (route == TC && (n_chars < 1 || n_chars > tc::MAX_CHARS)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == SKINNY)
    return launch_skinny((const int8_t*)a, (const int8_t*)b, N, M, L, n_chars, gap, (int*)match,
                         (int*)valid, s);
  Problem p{};
  p.a = (const int8_t*)a;
  p.b = (const int8_t*)b;
  p.N = N, p.M = M, p.L = L, p.rows = N;
  p.n_chars = n_chars, p.gap = gap;
  p.match = (int*)match, p.valid = (int*)valid;
  p.tri = sym != 0;
  return launch_tiled(p, route, 1, s);
}

// msa: (rows, L) int8 contiguous; index: (G, S) int64, row ids of each
// group, -1 a pad row. match, valid: (G, S, S) int32, every entry written.
// route: 1 tensor cores, 2 simd. Returns a cudaError_t.
extern "C" int match_valid_groups(const void* msa, int rows, int L, const void* index, int G,
                                  int S, int n_chars, int gap, int route, void* match,
                                  void* valid, void* stream) {
  if (rows < 0 || L < 0 || G < 1 || S < 1 || (route != TC && route != SIMD))
    return (int)cudaErrorInvalidValue;
  if (route == TC && (n_chars < 1 || n_chars > tc::MAX_CHARS)) return (int)cudaErrorInvalidValue;
  Problem p{};
  p.a = p.b = (const int8_t*)msa;
  p.index = (const long long*)index;
  p.N = p.M = S, p.L = L, p.rows = rows;
  p.n_chars = n_chars, p.gap = gap;
  p.match = (int*)match, p.valid = (int*)valid;
  p.tri = 1;
  return launch_tiled(p, route, G, (cudaStream_t)stream);
}
