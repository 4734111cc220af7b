// Batched affine-gap Gotoh forward pass (global or local) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sw/sw_kernel.py::gotoh_forward_kernel
// (body _kernel, row math _row_update). Same contract: for each pair the
// packed direction bytes of DP rows 1..n (row 0 is written by the wrapper;
// rows past la are computed from the frozen row state and written too) and a
// record [score, start_i, start_j, start_state, 0, 0, 0, 0]. Results are
// bit-exact with the plain version (repro_torch/kernels/sw/ref.py): every
// score is an integer-valued float below 2^24, so no operation rounds and
// any order of the same maxima gives the same values; the tie rules are the
// reference's (>= picks M, then Ix, then Iy; strict > for the Ix and Iy
// extensions; the first maximal column of a row and strict > between rows
// for the local best; the first maximum of the three end values).
//
// What bounds it on the H100: instruction issue. Each DP cell takes ~20
// instructions and emits one direction byte, so at the main path's shapes
// the arithmetic takes longer than the B * n * (m+1) direction bytes take to
// reach device memory. The design spends the issue slots on the cells:
//   - a pair a warp (WARPS pairs a CTA, a persistent grid of as many CTAs as
//     the card holds at once), no block barrier anywhere in the row loop.
//     Lane l owns C consecutive columns of a strip of 32 C columns; C (1..12)
//     and the number of strips come from m (sw_strips, sw_cols), so a strip
//     wastes fewer than 32 columns. Targets wider than 384 columns are swept
//     in vertical strips, left to right: each strip stores its last column's
//     (M, Ix, Iy) of every row into the warp's slot of a device workspace,
//     and the next strip reads them back as its left edge (32 rows a
//     coalesced load, a chunk ahead of use, handed to lane 0 by shuffles).
//     So any width runs;
//   - a strip's substitution scores sit in the warp's shared memory as a
//     profile, a row per query code, a lane's C columns contiguous: a few
//     vector loads a row and no address arithmetic a cell;
//   - the previous row's h = max(M, Ix, Iy) and its argmax, and this row's
//     M, cross lanes by one shuffle each;
//   - the horizontal gap Iy[j] = max(M[j-1] - go, Iy[j-1] - ge) is a
//     sequential carry inside a lane, seeded by one warp max-scan (5
//     shuffles) of the lanes' totals in offset form u = Iy + j * ge, where
//     it is a running max; the strip's left edge enters the scan at lane 0;
//   - the cell's flags (argmax, dirIx, dirIy, a fresh local start) and the
//     direction byte are integer-valued floats made on the FMA pipe (a
//     saturated subtract is 1 exactly when a > b for integers) rather than
//     compares and selects on the half-rate ALU pipe; the maxima stay there;
//   - local mode keeps each column's best M and its first row in registers
//     (a column whose j > lb starts at +inf, so it never updates) and
//     reduces (value desc, row asc, column asc) once per pair, which equals
//     the reference's first maximal column per row with strict > between
//     rows;
//   - at C <= 4 each lane stores its C bytes one by one; at C >= 5 they are
//     packed in registers, staged a row at a time in the warp's shared
//     memory (two rows, ping-pong: one __syncwarp a row) and written as
//     aligned 32-bit words at the row's own byte offset (the row pitch
//     m + 1 is odd), the at most 3 + 3 bytes of partial words at the
//     segment's ends as bytes (tools/sw_variants.py times both at both
//     widths). Streaming stores: nothing reads them back.
// Products go through __fmul_rn and FMAs are written out, so nvcc contracts
// nothing; no operation rounds for integer scores below 2^24. The wrapper
// refuses non-integer gap penalties; the table must be integer-valued too.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEGV = -1.0e7f;
constexpr int M_ST = 0, IX_ST = 1, IY_ST = 2, FRESH = 3;
constexpr int MAX_S = 32;
constexpr int MAX_C = 12;              // columns a lane
constexpr int WARPS = 4;               // pairs (warps) a CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__host__ __device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Strips of a target of m + 1 columns and the columns a lane holds in each:
// as few strips of at most 32 * MAX_C columns as cover them, then the least C
// with 32 * C * strips >= m + 1 (ops.strip_layout is the same arithmetic).
__host__ __device__ inline int sw_strips(int m) {
  return (m + 1 + 32 * MAX_C - 1) / (32 * MAX_C);
}
__host__ __device__ inline int sw_cols(int m) {
  const int s = sw_strips(m);
  return (m + 1 + 32 * s - 1) / (32 * s);
}

// The row-0 values (M, Ix, Iy) of column j.
__device__ __forceinline__ void row0(int j, float go, float ge, float& mv, float& xv,
                                     float& yv) {
  mv = j == 0 ? 0.0f : NEGV;
  xv = NEGV;
  yv = j >= 1 ? -(go + __fmul_rn((float)(j - 1), ge)) : NEGV;
}

// (v, i, j) beats (w, k, l): larger value, then smaller row, then smaller column.
__device__ __forceinline__ bool beats(float v, int i, int j, float w, int k, int l) {
  return v > w || (v == w && (i < k || (i == k && j < l)));
}

// The cells' flags as floats on the FMA pipe, with no compare and no select:
// for integer-valued a and b, a - b >= 1 when a > b, so sat(a - b) is 1.0
// when a > b and 0.0 otherwise (sat(NaN) and sat(-inf) are 0).
__device__ __forceinline__ float gt01(float a, float b) {
  float r;
  asm("sub.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The argmax code of h as a float: 0 when M = h, else 1 when Ix = h, else 2.
__device__ __forceinline__ float amax_f(float mv, float xv, float h) {
  const float a1 = gt01(h, mv), a2 = gt01(h, xv);
  return __fmaf_rn(a1, a2, a1);
}

// Two direction bytes (integer-valued floats below 16) packed into the low
// 16 bits of a word: MAGIC = 1.5 * 2^23 puts an integer below 2^22 into the
// low mantissa bits, exactly.
constexpr float MAGIC = 12582912.0f;
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return __float_as_uint(__fmaf_rn(hi, 256.0f, __fadd_rn(lo, MAGIC)));
}

// x when B, else y (a compile-time choice of register arrays).
template <bool B, typename T>
__device__ __forceinline__ T& pick(T& x, T& y) {
  if constexpr (B) return x;
  else return y;
}

// A lane's C profile values (C consecutive floats) in the widest loads the
// alignment of lane * C floats allows.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int q = 0; q < C / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

// 4 CTAs an SM (at most 128 registers): left free, the local instantiation
// at C = 12 takes 167 and fits 3, ~8% slower even with no spills
// (tools/sw_variants.py: min3 against the kernel).
template <int C, bool LOCAL>
__global__ void __launch_bounds__(WARPS * 32, 4)
    sw_forward_kernel(const int8_t* __restrict__ a, long long a_stride,
                      const int8_t* __restrict__ b, long long b_stride,
                      const int* __restrict__ lens, const float* __restrict__ sub_g, int S,
                      int8_t* __restrict__ dirs, float* __restrict__ rec,
                      float4* __restrict__ work, int B, int n, int m, float go, float ge) {
  // a warp's row stage: 8 bytes of front pad (an aligned word may start up
  // to 3 bytes before the strip), 32 C bytes, 8 of tail pad
  constexpr int SB = 32 * C + 16;
  constexpr int ROUNDS = (8 * C + 31) / 32;   // 32-bit words a row segment, over 32 lanes
  __shared__ float sub[MAX_S * MAX_S];
  __shared__ __align__(16) uint8_t stage_all[WARPS][2][SB];
  // each warp's strip profile: prof[a][32 C] = sub[a][b[j - 1]] of the
  // strip's columns, a lane's C values contiguous
  extern __shared__ __align__(16) float prof_all[];
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) sub[i] = sub_g[i];
  __syncthreads();                            // once, before any pair

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * WARPS + warp;
  const int slots = gridDim.x * WARPS;
  const int strips = sw_strips(m);
  float4* edge = work + (size_t)slot * n;     // this slot's strip edge, a row
  uint8_t* stage = stage_all[warp][0];
  float* prof = prof_all + (size_t)warp * S * 32 * C + lane * C;
  const int src = (lane - 1) & 31;
  // dirIy at columns 0 and 1: the reference reads Iy = NEG and M = NEG left
  const unsigned diy01 = (NEGV - ge) > (NEGV - go) ? 8u : 0u;
  const float fy01 = diy01 ? 1.0f : 0.0f;

  for (int pair = slot; pair < B; pair += slots) {
    const int la = lens[2 * pair];
    const int lb = lens[2 * pair + 1];
    const int lbc = clamp_i(lb, 0, m);        // the reference's clamped gather
    const int lbm = lb < m ? lb : m;          // last column of the local mask
    const int live = clamp_i(la, 0, n);       // rows that move the state
    const int8_t* arow = a + pair * a_stride;
    const int8_t* brow = b + pair * b_stride;
    int8_t* drow = dirs + (long long)pair * (n + 1) * (m + 1);
    float bv = NEGV;                          // this lane's local best so far
    int bi = 0, bj = 0;

    for (int s = 0; s < strips; ++s) {
      const int j0s = s * 32 * C;
      const int j0 = j0s + lane * C;
      const bool first = s == 0 && lane == 0;  // holds column 0
      const bool edge_out = s < strips - 1 && lane == 31;  // the next strip's left edge
      const int len = min(32 * C, m + 1 - j0s);  // columns of the strip
      int8_t* dstrip = drow + j0s;                // row 0 of the strip's columns
      float mp[C], xp[C], yp[C];
      // local: each column's best M and its first row
      float cbv[C];
      int cbr[C];
      // the lane's own profile columns (only the lane itself reads them)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const int code = (j >= 1 && j <= m) ? clamp_i(brow[j - 1], 0, S - 1) : 0;
        for (int x = 0; x < S; ++x) prof[x * 32 * C + c] = sub[x * S + code];
        row0(j, go, ge, mp[c], xp[c], yp[c]);
        cbv[c] = j <= lbm ? NEGV : pos_inf();
        cbr[c] = 0;
      }
      const float j0ge = __fmul_rn((float)j0, ge);
      // M[j]'s term of the offset-form running max, M + (j + 1) ge - go, is
      // (M[j0 + c] + c ge) + kc0
      const float kc0 = __fmul_rn((float)(j0 + 1), ge) - go;
      // lane 0: h and argmax of column j0s - 1 in the state's row
      float eh = NEGV, eam = M_ST;
      if (s > 0) {
        float em, ex, ey;
        row0(j0s - 1, go, ge, em, ex, ey);
        eh = fmaxf(em, fmaxf(ex, ey));
        eam = amax_f(em, ex, eh);
      }

      // 32 rows a chunk: lane l holds row base + l + 1's profile offset and
      // left-edge entry; the next chunk's are loaded a chunk ahead
      auto load = [&](int base, int& aoff, float4& e) {
        const int r = base + lane;            // row r + 1
        aoff = r < n ? clamp_i(arow[r], 0, S - 1) * 32 * C : 0;
        e = (s > 0 && r < n) ? __ldcg(edge + r) : make_float4(0.f, 0.f, 0.f, 0.f);
      };
      int a_cur, a_nxt;
      float4 e_cur, e_nxt;
      load(0, a_cur, e_cur);

      for (int base = 0; base < n; base += 32) {
        // orders the last chunk's edge loads before this chunk's edge stores
        __syncwarp();
        load(base + 32, a_nxt, e_nxt);
        // this lane's row's left-edge values: h and argmax of the edge column
        // (for the next row's diagonal), Iy of the strip's first column and
        // its dirIy bit
        float xh, xiy;
        unsigned xbits;
        if (s > 0) {
          xh = fmaxf(e_cur.x, fmaxf(e_cur.y, e_cur.z));
          const float open = e_cur.x - go, ext = e_cur.z - ge;
          xiy = fmaxf(open, ext);
          xbits = (unsigned)amax_f(e_cur.x, e_cur.y, xh) | (ext > open ? 8u : 0u);
        } else {
          xh = NEGV;
          xiy = neg_inf();                    // Iy's carry into column 1 starts at -inf
          xbits = M_ST | diy01;
        }
        xbits |= (unsigned)a_cur << 4;
        const int hi = min(32, n - base);
        const int split = clamp_i(live - base, 0, hi);

        auto row = [&](int t, auto update) {
          constexpr bool UPD = decltype(update)::value;
          const int r = base + t + 1;
          const unsigned bits = __shfl_sync(FULL, xbits, t);
          const float e_iy = __shfl_sync(FULL, xiy, t);
          float sc[C];
          load_cols<C>(prof + (bits >> 4), sc);
          // the state's h and argmax, per column
          float h[C], am[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            h[c] = fmaxf(mp[c], fmaxf(xp[c], yp[c]));
            am[c] = amax_f(mp[c], xp[c], h[c]);
          }
          float hl = __shfl_sync(FULL, h[C - 1], src);
          float al = __shfl_sync(FULL, am[C - 1], src);
          if (lane == 0) {
            hl = eh;
            al = eam;
          }
          // the new row: in place when it moves the state; v[c] is the
          // direction byte as a float (dirM + 4 dirIx + 8 dirIy)
          float mt[C], xt[C], yt[C];
          float(&MN)[C] = pick<UPD>(mp, mt);
          float(&IX)[C] = pick<UPD>(xp, xt);
          float(&IY)[C] = pick<UPD>(yp, yt);
          float v[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float hd = c == 0 ? hl : h[c > 0 ? c - 1 : 0];
            float d = c == 0 ? al : am[c > 0 ? c - 1 : 0];
            const float ixo = mp[c] - go, ixe = xp[c] - ge;
            float mv = hd + sc[c];
            if (LOCAL) {
              const float f = gt01(1.0f, hd);            // hd <= 0: a fresh start
              mv = __fmaf_rn(-f, hd, mv);                // then exactly sc
              d = __fmaf_rn(f, __fsub_rn(3.0f, d), d);   // FRESH
            }
            v[c] = __fmaf_rn(gt01(ixe, ixo), 4.0f, d);
            IX[c] = fmaxf(ixo, ixe);
            MN[c] = mv;
          }
          if (first) MN[0] = NEGV;            // column 0
          // the lane's total, as a tree (its depth is on the row's critical path)
          float w[C];
#pragma unroll
          for (int c = 0; c < C; ++c) w[c] = __fmaf_rn((float)c, ge, MN[c]);
#pragma unroll
          for (int d = 1; d < C; d *= 2)
#pragma unroll
            for (int c = 0; c + d < C; c += 2 * d) w[c] = fmaxf(w[c], w[c + d]);
          float T = w[0] + kc0;
          // the strip's left edge enters the scan at lane 0, in offset form
          if (lane == 0) T = fmaxf(T, e_iy + j0ge);
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) T = fmaxf(T, __shfl_up_sync(FULL, T, off));
          const float excl = __shfl_up_sync(FULL, T, 1);
          const float ml = __shfl_sync(FULL, MN[C - 1], src);
          // column 0 of a lane: Iy from the scan; then a sequential carry
          // (dirIy of columns 0 and 1 read NEG left in the reference)
          float yl, fy;
          if (lane == 0) {
            yl = e_iy;
            fy = (float)((bits >> 3) & 1u);
          } else {
            yl = excl - j0ge;
            fy = gt01(yl, ml - go);
          }
          if (first || (C == 1 && s == 0 && lane == 1)) fy = fy01;
          v[0] = __fmaf_rn(fy, 8.0f, v[0]);
#pragma unroll
          for (int c = 1; c < C; ++c) {
            const float open = MN[c - 1] - go, ext = yl - ge;
            fy = (c == 1 && first) ? fy01 : gt01(ext, open);
            v[c] = __fmaf_rn(fy, 8.0f, v[c]);
            IY[c - 1] = yl;
            yl = fmaxf(open, ext);
          }
          IY[C - 1] = yl;
          if (first) IY[0] = NEGV;            // column 0's Iy (the carry kept -inf)

          if constexpr (C <= 4) {
            // a few bytes a lane: each straight from its register (at C <= 4
            // the stage's loads and barrier cost more than they save)
            int8_t* g = dstrip + (long long)r * (m + 1) + lane * C;
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (lane * C + c < len)
                __stcs(reinterpret_cast<signed char*>(g + c),
                       (signed char)__float_as_uint(__fadd_rn(v[c], MAGIC)));
          } else {
            // direction bytes: pack, stage, store as aligned words
            uint8_t* sb = stage + (r & 1) * SB;
            uint8_t* mine = sb + 8 + lane * C;
            if constexpr (C % 8 == 0) {
#pragma unroll
              for (int q = 0; q < C / 8; ++q)
                reinterpret_cast<uint2*>(mine)[q] = make_uint2(
                    __byte_perm(pack2(v[8 * q], v[8 * q + 1]), pack2(v[8 * q + 2], v[8 * q + 3]),
                                0x5410),
                    __byte_perm(pack2(v[8 * q + 4], v[8 * q + 5]),
                                pack2(v[8 * q + 6], v[8 * q + 7]), 0x5410));
            } else if constexpr (C % 4 == 0) {
#pragma unroll
              for (int q = 0; q < C / 4; ++q)
                reinterpret_cast<uint32_t*>(mine)[q] = __byte_perm(
                    pack2(v[4 * q], v[4 * q + 1]), pack2(v[4 * q + 2], v[4 * q + 3]), 0x5410);
            } else if constexpr (C % 2 == 0) {
#pragma unroll
              for (int q = 0; q < C / 2; ++q)
                reinterpret_cast<uint16_t*>(mine)[q] = (uint16_t)pack2(v[2 * q], v[2 * q + 1]);
            } else {
#pragma unroll
              for (int c = 0; c < C; ++c)
                mine[c] = (uint8_t)__float_as_uint(__fadd_rn(v[c], MAGIC));
            }
            __syncwarp();
            // the row's strip segment [g, g + len): full aligned words from
            // gw = g + hb (g rounded up to 4; stage word 2 + q holds its word
            // q from byte hb), then at most 3 + 3 bytes at the ends
            int8_t* g = dstrip + (long long)r * (m + 1);
            const int hb = (int)(0u - (uint32_t)(uintptr_t)g) & 3;
            const int nfull = (len - hb) >> 2;
            uint32_t* gw = reinterpret_cast<uint32_t*>(g + hb) + lane;
            const uint32_t* s32 = reinterpret_cast<const uint32_t*>(sb) + 2 + lane;
#pragma unroll
            for (int k = 0; k < ROUNDS; ++k)
              if (lane + 32 * k < nfull)
                __stcs(gw + 32 * k, __funnelshift_r(s32[32 * k], s32[32 * k + 1], 8 * hb));
            // lanes 0..2: the head bytes [0, hb); 3..5: the tail [hb + 4 nfull, len)
            const int x = lane < 3 ? lane : hb + 4 * max(nfull, 0) + lane - 3;
            const bool part = lane < 3 ? x < min(hb, len) : (lane < 6 && x < len);
            const signed char pb = (signed char)sb[8 + (part ? x : 0)];
            if (part) __stcs(reinterpret_cast<signed char*>(g + x), pb);
          }
          // the strip's right edge for the next strip
          if (edge_out) __stcg(edge + (r - 1), make_float4(MN[C - 1], IX[C - 1], IY[C - 1], 0.0f));
          if constexpr (UPD) {
            if (LOCAL) {
#pragma unroll
              for (int c = 0; c < C; ++c)
                if (MN[c] > cbv[c]) {             // strict: the first row stays
                  cbv[c] = MN[c];
                  cbr[c] = r;
                }
            }
            eh = __shfl_sync(FULL, xh, t);
            eam = (float)(bits & 3u);
          }
        };
        for (int t = 0; t < split; ++t) row(t, std::true_type{});
        for (int t = split; t < hi; ++t) row(t, std::false_type{});
        a_cur = a_nxt;
        e_cur = e_nxt;
      }
      // every lane's edge stores before the next strip's loads
      __syncwarp();

      if (LOCAL) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (cbv[c] != pos_inf() && beats(cbv[c], cbr[c], j0 + c, bv, bi, bj)) {
            bv = cbv[c];
            bi = cbr[c];
            bj = j0 + c;
          }
      } else if (j0 <= lbc && lbc < j0 + C) {
        float cm = NEGV, cx = NEGV, cy = NEGV;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (j0 + c == lbc) {
            cm = mp[c];
            cx = xp[c];
            cy = yp[c];
          }
        if (la > n) row0(lbc, go, ge, cm, cx, cy);   // row la never reached
        int st = M_ST;
        float sc = cm;
        if (cx > sc) {
          st = IX_ST;
          sc = cx;
        }
        if (cy > sc) {
          st = IY_ST;
          sc = cy;
        }
        float* o = rec + (size_t)pair * 8;
        o[0] = sc;
        o[1] = (float)la;
        o[2] = (float)lb;
        o[3] = (float)st;
        o[4] = o[5] = o[6] = o[7] = 0.0f;
      }
    }
    if (LOCAL) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        const int oj = __shfl_xor_sync(FULL, bj, off);
        if (beats(ov, oi, oj, bv, bi, bj)) {
          bv = ov;
          bi = oi;
          bj = oj;
        }
      }
      if (lane == 0) {
        if (!(bv > NEGV)) bi = bj = 0;        // no cell above NEG: (NEG, 0, 0)
        float* o = rec + (size_t)pair * 8;
        o[0] = bv > NEGV ? bv : NEGV;
        o[1] = (float)bi;
        o[2] = (float)bj;
        o[3] = (float)M_ST;
        o[4] = o[5] = o[6] = o[7] = 0.0f;
      }
    }
  }
}

// f(std::integral_constant<int, C>) for C = c, 1 <= c <= MAX_C.
template <int C = 1, typename F>
int with_c(int c, F&& f) {
  if constexpr (C == MAX_C)
    return f(std::integral_constant<int, C>{});
  else
    return c == C ? f(std::integral_constant<int, C>{}) : with_c<C + 1>(c, f);
}

// f(std::integral_constant<int, C>) for the C of target width m.
template <typename F>
int with_cols(int m, F&& f) {
  return with_c(sw_cols(m), f);
}

// Dynamic shared memory of a CTA: each warp's strip profile.
inline size_t prof_bytes(int S, int C) { return (size_t)WARPS * S * 32 * C * sizeof(float); }

template <int C>
const void* kernel_of(bool local) {
  return local ? (const void*)sw_forward_kernel<C, true> : (const void*)sw_forward_kernel<C, false>;
}

}  // namespace

// Workspace bytes a pair slot needs: one 16-byte edge entry a row when the
// target takes more than one strip (ops.sw_plan is the same arithmetic).
extern "C" long long sw_slot_bytes(int n, int m) {
  return sw_strips(m) > 1 ? 16LL * n : 0LL;
}

// a: (B, n) int8 with row stride a_stride; b: (B, m) int8 with row stride
// b_stride (0 = one target broadcast to every pair); lens: (B, 2) int32
// [la, lb]; sub: (S, S) f32 row-major, S <= 32; dirs: (B, n+1, m+1) int8
// (rows 1..n are written); rec: (B, 8) f32; work: work_bytes of device
// memory, at least grid * WARPS * sw_slot_bytes(n, m); grid: CTAs of WARPS
// pair slots (ops.sw_plan). Returns a cudaError_t.
extern "C" int sw_forward(const void* a, long long a_stride, const void* b,
                          long long b_stride, const void* lens, const void* sub, int S,
                          void* dirs, void* rec, void* work, long long work_bytes, int B,
                          int n, int m, float go, float ge, int local, int grid,
                          void* stream) {
  if (S < 1 || S > MAX_S || B < 1 || n < 0 || m < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (work_bytes < (long long)grid * WARPS * sw_slot_bytes(n, m))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_cols(m, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    const void* k = kernel_of<C>(local != 0);
    const size_t smem = prof_bytes(S, C);
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (local)
      sw_forward_kernel<C, true><<<grid, WARPS * 32, smem, st>>>(
          (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
          (const float*)sub, S, (int8_t*)dirs, (float*)rec, (float4*)work, B, n, m, go, ge);
    else
      sw_forward_kernel<C, false><<<grid, WARPS * 32, smem, st>>>(
          (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
          (const float*)sub, S, (int8_t*)dirs, (float*)rec, (float4*)work, B, n, m, go, ge);
    return (int)cudaGetLastError();
  });
}

// Registers and local-memory (spill) bytes a thread of the instantiation for
// target width m uses, and its CTAs an SM holds at once with an S x S table.
extern "C" int sw_forward_attrs(int m, int local, int S, int* regs, int* local_bytes,
                                int* ctas_per_sm) {
  if (m < 0 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  return with_cols(m, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    const void* k = kernel_of<C>(local != 0);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    const size_t smem = prof_bytes(S, C);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k, WARPS * 32,
                                                              smem);
  });
}
