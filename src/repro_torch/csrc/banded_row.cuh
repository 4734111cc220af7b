// The banded Gotoh forward for one pair on one warp, shared by the two
// banded kernels (banded_forward.cu, banded_fused.cu).
//
// It is the device form of the plain version's band math
// (repro_torch/kernels/banded/ref.py: band_lo, band_row_init,
// band_row_update, edge_pressure), with the same operations in the same
// order on every cell (products through __fmul_rn, so none is contracted
// into an FMA the reference does not make). Maxima are exact in any order;
// the tie rules are the reference's (amax M >= Ix >= Iy, strict > for the
// Ix extension and the Iy extension, the first maximum of the three end
// captures). So the results are bit-exact.
//
// What bounds it on the H100 is instruction issue: ~25 f32 operations a
// cell, plus the work a row needs across the band (the previous row's cells
// shifted by the band's slide, a running max, the row's best), which a lane
// pays once a row whatever its number of cells. So:
//   - a pair runs on a warp, lane l holding the K = cells_per_lane(W) (a
//     power of two, 32 K >= W) cells l*K .. l*K+K-1 of M, Ix and Iy in
//     registers (a blocked layout); no block barrier; the warp's lanes
//     share every per-pair value, so its branches are uniform;
//   - the previous row at offsets c+s-1 and c+s, for any slide s >= 0, comes
//     from in-lane moves and index shuffles (one shuffle an array for the
//     common s in {0, 1}, two sets and a barrel shift for s >= 2);
//   - interior rows (the whole band inside the matrix, s <= 1; most rows)
//     take a path whose masks reduce to the band's two ends;
//   - the Iy running max is an in-lane prefix, one 5-step scan of the lane
//     totals and one shuffle for the exclusive prefix;
//   - the row best is one redux.sync on an order-preserving integer key of
//     the floats, and the three edge-pressure maxima become one vote
//     (max >= t iff some cell >= t);
//   - the band's left column floor(i*lb/la) is a 32-bit quotient and
//     remainder stepped by lb/la and lb%la with a carry, up in the forward
//     and down in the traceback: no division (and no 64-bit product) in the
//     loop, the same integer as the reference's floor division, negative i
//     included;
//   - the pair's two sequences are staged in the warp's shared memory as
//     clamped substitution indices, in windows that follow the band
//     (A_CHUNK rows of a, b_window(W) columns of b), so a CTA's shared
//     memory is the same few KB for any length; the S x S table once per
//     CTA.
//
// Bands wider than MAX_W (1,024) take a second route, band_forward_wide: a
// pair a CTA of WIDE_THREADS threads, thread t holding the K = wide_cells(W)
// cells t*K .. t*K+K-1 (a blocked layout, as a lane does above). The
// previous row's M, Ix and Iy live in shared memory (three rows of 512 K
// floats with a pad float every 32, so blocked reads hit distinct banks:
// 198 KB at W = 16,384), read at c+s-1 and c+s for any slide s; the row
// being computed stays in registers until every thread has read the old
// one. A row costs two barriers: the first after the reads (the Iy prefix's
// warp totals are then in shared memory), the second after the new row is
// written (the row best's warp maxima and the left neighbour of each warp's
// first cell are then in shared memory).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace banded {

constexpr float NEGV = -1.0e7f;
constexpr int M_ST = 0, IX_ST = 1, IY_ST = 2, FRESH = 3;
constexpr int MAX_S = 32;
constexpr int MAX_W = 1024;             // the warp route's widest band
constexpr int MAX_WIDE_W = 16384;       // the CTA route's widest band
constexpr int WIDE_THREADS = 512;       // threads of a CTA-route pair
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int PAIRS = 8;                // pairs (warps) a CTA
constexpr int A_CHUNK = 256;            // rows of a staged at a time
constexpr int B_SLACK = 512;            // b's window past the band's 32 K cells
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_LIMIT = 0x7fffffff;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__host__ __device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// Band cells a lane holds: the least power of two K with 32 K >= W.
__host__ __device__ inline int cells_per_lane(int W) {
  int K = 1;
  while (32 * K < W) K *= 2;
  return K;
}

// Bytes of a packed direction row (two cells a byte, 32 K cells).
__host__ __device__ inline int band_pitch(int W) { return 16 * cells_per_lane(W); }

// Columns of b a warp holds staged: the band's 32 K cells and B_SLACK more,
// so the window moves once in ~B_SLACK rows of a band sliding a column a row.
__host__ __device__ inline int b_window(int W) { return 32 * cells_per_lane(W) + B_SLACK; }

// Bytes of the S x S substitution table at the head of a CTA's shared memory.
__host__ __device__ inline size_t sub_bytes(int S) { return round16((size_t)S * S * 4); }

// A CTA's shared memory: the table, then each warp's staged windows (at
// most 18 KB, inside the 48 KB a launch gets without opting in).
__host__ __device__ inline size_t cta_smem_bytes(int S, int W) {
  return sub_bytes(S) + (size_t)PAIRS * (A_CHUNK + b_window(W));
}

// f(std::integral_constant<int, K>) for the K of band W: the instantiation
// of a kernel templated on K.
template <typename F>
int with_cells(int W, F&& f) {
  switch (cells_per_lane(W)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return f(std::integral_constant<int, 32>{});
  }
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// floor(i * lb / la) (lb when la == 0) for a row i that moves by one at a
// time: c * la + rem == i * lb with 0 <= rem < la.
struct BandCol {
  int c, rem, q, d, div;
  __device__ __forceinline__ BandCol(int la, int lb, bool at_la) {
    div = la > 0 ? la : 1;
    q = la > 0 ? lb / la : 0;
    d = la > 0 ? lb % la : 0;
    c = (la == 0 || at_la) ? lb : 0;
    rem = 0;
  }
  __device__ __forceinline__ void up() {
    c += q;
    rem += d;
    if (rem >= div) {
      rem -= div;
      ++c;
    }
  }
  __device__ __forceinline__ void down() {
    c -= q;
    rem -= d;
    if (rem < 0) {
      rem += div;
      --c;
    }
  }
};

// Order-preserving integer key of a float (an involution): the warp's max
// of floats is one redux.sync. -0 sorts below +0, which compare equal.
__device__ __forceinline__ int fkey(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

__device__ __forceinline__ float warp_max(float v) {
  return __int_as_float(fkey(__reduce_max_sync(FULL, fkey(__float_as_int(v)))));
}

// r[q] = v at band cell lane*K + q + d (d >= -1), not checked: a cell past
// the band's ends reads a wrapped lane, which the caller masks.
template <int K, typename T>
__device__ __forceinline__ void shift(const T (&v)[K], T (&r)[K], int d) {
  if (d == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) r[q] = v[q];
  } else if (d == 1) {
#pragma unroll
    for (int q = 0; q + 1 < K; ++q) r[q] = v[q + 1];
    r[K - 1] = __shfl_down_sync(FULL, v[0], 1);
  } else if (d == -1) {
#pragma unroll
    for (int q = K - 1; q > 0; --q) r[q] = v[q - 1];
    r[0] = __shfl_up_sync(FULL, v[K - 1], 1);
  } else {
    // d >= 2: cell lane*K + q + d is cell q + dr of lane lane + dl
    const int lane = lane_id(), dl = d / K, dr = d % K;
    T u[2 * K];
#pragma unroll
    for (int x = 0; x < K; ++x) u[x] = __shfl_sync(FULL, v[x], lane + dl);
    if (dr == 0) {
#pragma unroll
      for (int q = 0; q < K; ++q) r[q] = u[q];
      return;
    }
#pragma unroll
    for (int x = 0; x < K; ++x) u[K + x] = __shfl_sync(FULL, v[x], lane + dl + 1);
#pragma unroll
    for (int b = 1; b < K; b <<= 1)
      if (dr & b) {
#pragma unroll
        for (int x = 0; x + b < 2 * K; ++x) u[x] = u[x + b];
      }
#pragma unroll
    for (int q = 0; q < K; ++q) r[q] = u[q];
  }
}

// v[q] for a q known only at run time (no local-memory array).
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K], int q) {
  float x = v[0];
#pragma unroll
  for (int t = 1; t < K; ++t) x = t == q ? v[t] : x;
  return x;
}

// Store the NB bytes of w (little-endian words) at p, aligned to NB.
template <int NB>
__device__ __forceinline__ void store_bytes(void* p, const uint32_t (&w)[(NB + 3) / 4]) {
  if constexpr (NB == 1) {
    *reinterpret_cast<uint8_t*>(p) = (uint8_t)w[0];
  } else if constexpr (NB == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)w[0];
  } else if constexpr (NB == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (NB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int t = 0; t < NB / 16; ++t)
      reinterpret_cast<uint4*>(p)[t] = make_uint4(w[4 * t], w[4 * t + 1], w[4 * t + 2], w[4 * t + 3]);
  }
}

// Load the S x S table into the CTA's shared memory (all threads; ends in a
// barrier) and return its maximum, one diagonal step of headroom.
__device__ inline float load_sub(const float* __restrict__ sub_g, float* sub, int S) {
  for (int x = threadIdx.x; x < S * S; x += blockDim.x) sub[x] = sub_g[x];
  __syncthreads();
  float mx = neg_inf();
  for (int x = threadIdx.x & 31; x < S * S; x += 32) mx = fmaxf(mx, sub[x]);
  return warp_max(mx);
}

// A pair's two sequences staged in its warp's (CTA route: its CTA's) shared
// memory (buf, A_CHUNK + b_window(W) bytes) as substitution indices, clamped
// to 0..S-1 as the reference's lookups clamp them. Row r reads a[r - 1] and b[j - 1] for its
// cells j (j - 1 clamped to 0..m-1 outside the interior), all of it within
// the 32 K cells from the band's left column lo, which never moves left: the
// window of b starts at column clamp(lo - 1) and moves when a row's cells
// pass its end; a moves A_CHUNK rows at a time. rows(r, lo, q) stages what
// row r reads and returns the last row the windows serve as they stand.
template <bool CTA>
struct StagedT {
  const int8_t* a;
  const int8_t* b;
  int n, m, S, KW, BW;
  int8_t* buf;
  const int8_t* acol;   // acol[i] = a[i] clamped, for the rows staged
  const int8_t* bcol;   // bcol[j] = b[j] clamped, for the columns staged
  int a_lim, b_lim;     // stage again at row index a_lim, at band column b_lim

  __device__ __forceinline__ StagedT(const int8_t* a_, int n_, const int8_t* b_, int m_, int S_,
                                     int W, int8_t* buf_)
      : a(a_), b(b_), n(n_), m(m_), S(S_), KW(32 * cells_per_lane(W)), BW(b_window(W)),
        buf(buf_), acol(buf_), bcol(buf_ + A_CHUNK), a_lim(0), b_lim(-NO_LIMIT - 1) {}

  __device__ __forceinline__ void fill(const int8_t* src, int len, int8_t* dst) const {
    if constexpr (CTA) {
      __syncthreads();
      for (int x = threadIdx.x; x < len; x += blockDim.x) dst[x] = (int8_t)clamp_i(src[x], 0, S - 1);
      __syncthreads();
    } else {
      __syncwarp();
      for (int x = lane_id(); x < len; x += 32) dst[x] = (int8_t)clamp_i(src[x], 0, S - 1);
      __syncwarp();
    }
  }
  // row r (1-based) has band column lo, and each row's lo is at most q + 1
  // past the one before
  __device__ __forceinline__ int rows(int r, int lo, int q) {
    if (r - 1 >= a_lim) {
      const int a0 = r - 1;
      fill(a + a0, min(A_CHUNK, n - a0), buf);
      acol = buf - a0;
      a_lim = a0 + A_CHUNK;
    }
    if (lo >= b_lim) {
      const int b0 = clamp_i(lo - 1, 0, m - 1);
      fill(b + b0, min(BW, m - b0), buf + A_CHUNK);
      bcol = buf + A_CHUNK - b0;
      // row cells reach column lo + KW - 2 (clamped to m - 1)
      b_lim = b0 + BW >= m ? NO_LIMIT : b0 + BW - KW + 2;
    }
    const int last = min(n, a_lim);
    return b_lim == NO_LIMIT ? last : min(last, r + (b_lim - lo - 1) / (q + 1));
  }
};

using Staged = StagedT<false>;        // a warp's pair
using StagedWide = StagedT<true>;     // a CTA's pair (the wide route)

struct Result {
  float score;
  int state;
  bool edge;
};

// One DP row's M, Ix, Iy and direction values from the previous row's
// (band_row_update). FAST: an interior row (every lane's cells in the band,
// all of them inside the matrix, 1 <= j <= lb, and a slide s <= 1), where
// the masks reduce to the band's two ends; the general row takes any slide
// and any position. hp/am: the previous row's max of the three states and
// its argmax.
template <int K, bool FAST>
__device__ __forceinline__ void band_row(const float (&mv)[K], const float (&xv)[K],
                                         const float (&hp)[K], const int (&am)[K], int s,
                                         int lo_i, const int8_t* bcol, int m, const float* srow,
                                         float go, float ge, const float (&cge)[K],
                                         const float (&c1ge)[K], int W, int lb,
                                         float (&mn)[K], float (&xn)[K], float (&yn)[K],
                                         int (&dir)[K]) {
  const int lane = lane_id();
  const int base = lane * K;
  const float NINF = neg_inf();
  float hd[K], mup[K], xup[K];
  int dm[K];
  if (FAST && s == 1) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      hd[q] = hp[q];
      dm[q] = am[q];
    }
    shift(mv, mup, 1);
    shift(xv, xup, 1);
  } else if (FAST) {
    shift(hp, hd, -1);
    shift(am, dm, -1);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      mup[q] = mv[q];
      xup[q] = xv[q];
    }
  } else {
    shift(hp, hd, s - 1);
    shift(am, dm, s - 1);
    shift(mv, mup, s);
    shift(xv, xup, s);
  }
  float pre[K];
  float run = NINF;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int c = base + q, j = lo_i + c;
    // the previous row's cells at c + s - 1 and c + s, NEG outside the band
    const bool dok = FAST ? (s == 1 || c > 0) : (c + s >= 1 && c + s - 1 < W);
    const bool uok = FAST ? (s == 0 || c < W - 1) : c + s < W;
    const float hdq = dok ? hd[q] : NEGV;
    const float mu = uok ? mup[q] : NEGV, xu = uok ? xup[q] : NEGV;
    const int bc = bcol[FAST ? j - 1 : clamp_i(j - 1, 0, m - 1)];
    const bool in_mat = FAST || (j >= 1 && j <= lb), in_row = FAST || (j >= 0 && j <= lb);
    mn[q] = in_mat ? hdq + srow[bc] : NEGV;
    const float ix_open = mu - go, ix_ext = xu - ge;
    xn[q] = in_row ? fmaxf(ix_open, ix_ext) : NEGV;
    dir[q] = (dok ? dm[q] : M_ST) | ((ix_ext > ix_open ? 1 : 0) << 2);
    // Iy via the running max of M[c] + c*ge over the band offsets
    run = fmaxf(run, mn[q] + cge[q]);
    pre[q] = run;
  }
  // inclusive max-scan of the lane totals: a lane below off reads its own
  // value, which leaves a max unchanged
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) incl = fmaxf(incl, __shfl_up_sync(FULL, incl, off));
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = NINF;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int c = base + q, j = lo_i + c;
    const float ex = q == 0 ? excl : fmaxf(excl, pre[q - 1]);
    const float y = c == 0 ? NEGV : (ex - go) - c1ge[q];
    yn[q] = (FAST || (j >= 1 && j <= lb)) ? y : NEGV;
  }
  const float m_l0 = __shfl_up_sync(FULL, mn[K - 1], 1);
  const float y_l0 = __shfl_up_sync(FULL, yn[K - 1], 1);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const float ml = q > 0 ? mn[q - 1] : (lane > 0 ? m_l0 : NEGV);
    const float yl = q > 0 ? yn[q - 1] : (lane > 0 ? y_l0 : NEGV);
    dir[q] |= ((yl - ge) > (ml - go) ? 1 : 0) << 3;
  }
}

// Edge pressure of a live row (edge_pressure): a competitive cell (within
// margin of the row best hb) in an exit zone — offset 0, the
// slide-clipped right rim, or a previous-row cell that slid out of storage
// — presses the band. Returns whether any lane saw one; hb is the row best.
template <int K, bool FAST>
__device__ __forceinline__ bool pressed_row(const float (&mn)[K], const float (&xn)[K],
                                            const float (&yn)[K], const float (&hp)[K],
                                            int s, int lo_i, int W, int lb, float margin,
                                            float hb_prev, float& hb) {
  const int lane = lane_id();
  const int base = lane * K;
  float hn[K];
  float best = neg_inf();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = lo_i + base + q;
    const float h = fmaxf(mn[q], fmaxf(xn[q], yn[q]));
    hn[q] = (FAST || (j >= 0 && j <= lb)) ? h : NEGV;
    if (FAST || base + q < W) best = fmaxf(best, hn[q]);
  }
  hb = warp_max(best);
  const float zt = hb - margin, pt = hb_prev - margin;
  const bool zon = hb > NEGV / 2, pon = hb_prev > NEGV / 2;
  if (FAST) {                          // s <= 1: the zones are cells 0 and W - 1
    return __any_sync(FULL, (lane == 0 && ((zon && hn[0] >= zt) || (pon && s == 1 && hp[0] >= pt))) ||
                                (lane == 31 && zon && hn[K - 1] >= zt));
  }
  const int smin1 = s > 1 ? s : 1;
  bool pressed = false;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int c = base + q;
    if (c < W) {
      pressed = pressed || (zon && (c == 0 || c >= W - smin1) && hn[q] >= zt);
      pressed = pressed || (pon && c < s && hp[q] >= pt);
    }
  }
  return __any_sync(FULL, pressed);
}

// The banded forward of one pair by its warp. seq: the pair's staged
// sequences; sub: the S x S table (shared). store(dirs) takes DP rows 1..n
// in order, each with the lane's K direction values (dm | dix << 2 | diy << 3
// of cells lane*K + q; cells >= W are don't-care). The band state advances
// through every row, past la too; only live rows (r <= la) feed the capture
// and the flag. Returns the end score, its state and the edge-pressure
// flag, the same in every lane. Needs m >= 1.
template <int K, typename Store>
__device__ __forceinline__ Result band_forward(Staged& seq, int la, int lb, const float* sub,
                                               float go, float ge, int W, float margin,
                                               Store& store) {
  const int n = seq.n, m = seq.m, S = seq.S;
  const int base = lane_id() * K;
  const int mid = W / 2;
  const float NINF = neg_inf();
  const bool full = W == 32 * K;

  // row 0 (band_row_init)
  BandCol col(la, lb, false);
  int lo_prev = col.c - W / 2;
  float mv[K], xv[K], yv[K];
  float hrow = NINF;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int c = base + q, j = lo_prev + c;
    mv[q] = j == 0 ? 0.0f : NEGV;
    xv[q] = NEGV;
    yv[q] = (j >= 1 && j <= lb) ? -(go + __fmul_rn((float)j - 1.0f, ge)) : NEGV;
    const float h = (j >= 0 && j <= lb) ? fmaxf(mv[q], yv[q]) : NEGV;
    if (c < W) hrow = fmaxf(hrow, h);
  }
  float hb_prev = warp_max(hrow);
  // the band offsets' gap terms c*ge and (c-1)*ge, as the reference rounds them
  float cge[K], c1ge[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    cge[q] = __fmul_rn((float)(base + q), ge);
    c1ge[q] = __fmul_rn((float)(base + q) - 1.0f, ge);
  }
  float cap_m = __shfl_sync(FULL, pick(mv, mid % K), mid / K);
  float cap_x = __shfl_sync(FULL, pick(xv, mid % K), mid / K);
  float cap_y = __shfl_sync(FULL, pick(yv, mid % K), mid / K);
  bool edge = false;

  for (int r = 1; r <= n;) {
    // stage what the next rows read; no row below checks the windows
    BandCol next = col;
    next.up();
    const int last = seq.rows(r, next.c - W / 2, col.q);
    for (; r <= last; ++r) {
      col.up();
      const int lo_i = col.c - W / 2;
      const int s = lo_i - lo_prev;                   // band slide (>= 0)
      float hp[K];
      int am[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        hp[q] = fmaxf(mv[q], fmaxf(xv[q], yv[q]));
        am[q] = mv[q] >= hp[q] ? M_ST : (xv[q] >= hp[q] ? IX_ST : IY_ST);
      }
      const float* srow = sub + seq.acol[r - 1] * S;
      const bool fast = full && s <= 1 && lo_i >= 1 && lo_i + W - 1 <= lb;
      float mn[K], xn[K], yn[K];
      int dir[K];
      if (fast)
        band_row<K, true>(mv, xv, hp, am, s, lo_i, seq.bcol, m, srow, go, ge, cge, c1ge, W, lb,
                          mn, xn, yn, dir);
      else
        band_row<K, false>(mv, xv, hp, am, s, lo_i, seq.bcol, m, srow, go, ge, cge, c1ge, W, lb,
                           mn, xn, yn, dir);
      store(dir);

      if (r <= la) {                                  // live rows: edge pressure
        float hb;
        const bool pressed =
            fast ? pressed_row<K, true>(mn, xn, yn, hp, s, lo_i, W, lb, margin, hb_prev, hb)
                 : pressed_row<K, false>(mn, xn, yn, hp, s, lo_i, W, lb, margin, hb_prev, hb);
        edge = edge || pressed;
        hb_prev = hb;
        if (r == la) {                                // end cell (la, lb) sits at mid
          cap_m = __shfl_sync(FULL, pick(mn, mid % K), mid / K);
          cap_x = __shfl_sync(FULL, pick(xn, mid % K), mid / K);
          cap_y = __shfl_sync(FULL, pick(yn, mid % K), mid / K);
        }
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        mv[q] = mn[q];
        xv[q] = xn[q];
        yv[q] = yn[q];
      }
      lo_prev = lo_i;
    }
  }

  // argmax of the three end captures, first maximum
  Result res;
  res.state = M_ST;
  res.score = cap_m;
  if (cap_x > res.score) {
    res.state = IX_ST;
    res.score = cap_x;
  }
  if (cap_y > res.score) {
    res.state = IY_ST;
    res.score = cap_y;
  }
  res.edge = edge;
  return res;
}

// ---------------------------------------------------------------- wide route

// Band cells a thread of the wide route holds: the least power of two K with
// WIDE_THREADS K >= W (4 .. 32 for 1,024 < W <= 16,384).
__host__ __device__ inline int wide_cells(int W) {
  int K = 1;
  while (WIDE_THREADS * K < W) K *= 2;
  return K;
}

// Floats of one shared band row: 512 K cells and a pad float every 32.
__host__ __device__ inline int wide_row_floats(int W) {
  const int cap = WIDE_THREADS * wide_cells(W);
  return cap + cap / 32;
}

__device__ __forceinline__ int pad_ix(int c) { return c + (c >> 5); }

// A wide-route CTA's shared memory: the table, the three band rows, the
// warp totals and maxima, then the staged windows of the pair.
__host__ __device__ inline size_t wide_smem_bytes(int S, int W) {
  return sub_bytes(S) + (3 * (size_t)wide_row_floats(W) + 2 * WIDE_WARPS) * 4 + A_CHUNK +
         b_window(W);
}

// Pointers into that memory.
struct WideSmem {
  float* sub;
  float* m;
  float* x;
  float* y;
  float* wsum;    // each warp's inclusive Iy prefix total
  float* wbest;   // each warp's row best
  int8_t* buf;    // the staged windows
  __device__ __forceinline__ WideSmem(uint8_t* smem, int S, int W) {
    const int rf = wide_row_floats(W);
    sub = reinterpret_cast<float*>(smem);
    m = reinterpret_cast<float*>(smem + sub_bytes(S));
    x = m + rf;
    y = x + rf;
    wsum = y + rf;
    wbest = wsum + WIDE_WARPS;
    buf = reinterpret_cast<int8_t*>(wbest + WIDE_WARPS);
  }
};

// f(std::integral_constant<int, K>) for the wide route's K of band W.
template <typename F>
int with_wide_cells(int W, F&& f) {
  switch (wide_cells(W)) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return f(std::integral_constant<int, 32>{});
  }
}

// The max of v over the CTA (every thread gets it); wbest is free for the
// call, and the barrier inside also publishes the shared writes before it.
__device__ __forceinline__ float cta_max(float v, float* wbest) {
  v = warp_max(v);
  if (lane_id() == 0) wbest[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = wbest[0];
#pragma unroll
  for (int w = 1; w < WIDE_WARPS; ++w) r = fmaxf(r, wbest[w]);
  return r;
}

// The banded forward of one pair by its CTA (the wide route, W > MAX_W):
// the same operations on every cell as band_forward, in the same order.
// store(dw) takes DP rows 1..n in order, each with the thread's K direction
// nibbles packed 8 a word (cell t*K + q in bits 4(q%8) of word q/8; cells
// >= W are don't-care). Returns the end score, its state and the
// edge-pressure flag, the same in every thread. Needs m >= 1.
template <int K, typename Store>
__device__ __forceinline__ Result band_forward_wide(StagedWide& seq, int la, int lb,
                                                    const WideSmem& sh, float go, float ge,
                                                    int W, float margin, Store& store) {
  constexpr int NWORD = (K + 7) / 8;
  const int n = seq.n, m = seq.m, S = seq.S;
  const int t = threadIdx.x, lane = lane_id(), warp = t >> 5;
  const int base = t * K;
  const int mid = W / 2;
  const float NINF = neg_inf();

  // row 0 (band_row_init)
  BandCol col(la, lb, false);
  int lo_prev = col.c - W / 2;
  float hrow = NINF, cap_m = 0.0f, cap_x = 0.0f, cap_y = 0.0f;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int c = base + q, j = lo_prev + c;
    const float mv = j == 0 ? 0.0f : NEGV;
    const float yv = (j >= 1 && j <= lb) ? -(go + __fmul_rn((float)j - 1.0f, ge)) : NEGV;
    const int p = pad_ix(c);
    sh.m[p] = mv;
    sh.x[p] = NEGV;
    sh.y[p] = yv;
    const float h = (j >= 0 && j <= lb) ? fmaxf(mv, yv) : NEGV;
    if (c < W) hrow = fmaxf(hrow, h);
    if (c == mid) {
      cap_m = mv;
      cap_x = NEGV;
      cap_y = yv;
    }
  }
  float hb_prev = cta_max(hrow, sh.wbest);
  bool pressed = false;

  for (int r = 1; r <= n;) {
    // stage what the next rows read (every thread takes part)
    BandCol next = col;
    next.up();
    const int last = seq.rows(r, next.c - W / 2, col.q);
    for (; r <= last; ++r) {
      col.up();
      const int lo_i = col.c - W / 2;
      const int s = lo_i - lo_prev;                   // band slide (>= 0)
      const float* srow = sh.sub + seq.acol[r - 1] * S;
      const bool live = r <= la;
      const bool pon = live && hb_prev > NEGV / 2;
      const float pt = hb_prev - margin;

      // the previous row at c+s-1 and c+s (band_row_update), M and Ix of
      // this row, the M argmax and Ix extension bits, and the thread's
      // running max of M[c] + c*ge
      float mn[K], xn[K];
      uint32_t dw[NWORD];
#pragma unroll
      for (int w = 0; w < NWORD; ++w) dw[w] = 0;
      float run = NINF;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int c = base + q, j = lo_i + c;
        float hd = NEGV, mu = NEGV, xu = NEGV;
        int dm = M_ST;
        if (c + s >= 1 && c + s - 1 < W) {
          const int d = pad_ix(c + s - 1);
          const float m0 = sh.m[d], x0 = sh.x[d], y0 = sh.y[d];
          hd = fmaxf(m0, fmaxf(x0, y0));
          dm = m0 >= hd ? M_ST : (x0 >= hd ? IX_ST : IY_ST);
        }
        if (c + s < W) {
          const int u = pad_ix(c + s);
          mu = sh.m[u];
          xu = sh.x[u];
        }
        const int bc = seq.bcol[clamp_i(j - 1, 0, m - 1)];
        mn[q] = (j >= 1 && j <= lb) ? hd + srow[bc] : NEGV;
        const float ix_open = mu - go, ix_ext = xu - ge;
        xn[q] = (j >= 0 && j <= lb) ? fmaxf(ix_open, ix_ext) : NEGV;
        dw[q / 8] |= (uint32_t)(dm | ((ix_ext > ix_open ? 1 : 0) << 2)) << (4 * (q % 8));
        run = fmaxf(run, mn[q] + __fmul_rn((float)c, ge));
        // bottom-left exit: a previous-row cell about to slide out
        if (pon && c < s && c < W) {
          const int o = pad_ix(c);
          pressed = pressed || fmaxf(sh.m[o], fmaxf(sh.x[o], sh.y[o])) >= pt;
        }
      }
      // the Iy prefix across the CTA: a warp scan of the thread totals, then
      // the totals of the warps before
      float incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) incl = fmaxf(incl, __shfl_up_sync(FULL, incl, d));
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NINF;
      if (lane == 31) sh.wsum[warp] = incl;
      __syncthreads();                                // every old cell is read
      for (int w = 0; w < warp; ++w) excl = fmaxf(excl, sh.wsum[w]);

      // Iy, the new row into shared memory, the row best, the right-rim
      // and offset-0 zone, the Iy extension bits of cells q >= 1
      const int smin1 = s > 1 ? s : 1;
      float pre = excl, best = NINF, zmax = NINF, ml = NEGV, yl = NEGV;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int c = base + q, j = lo_i + c;
        const bool in_mat = j >= 1 && j <= lb;
        const float y = c == 0 ? NEGV : (pre - go) - __fmul_rn((float)c - 1.0f, ge);
        const float yq = in_mat ? y : NEGV;
        pre = fmaxf(pre, mn[q] + __fmul_rn((float)c, ge));
        if (q > 0) dw[q / 8] |= (uint32_t)((yl - ge) > (ml - go) ? 1 : 0) << (4 * (q % 8) + 3);
        const int p = pad_ix(c);
        sh.m[p] = mn[q];
        sh.x[p] = xn[q];
        sh.y[p] = yq;
        const float h = (j >= 0 && j <= lb) ? fmaxf(mn[q], fmaxf(xn[q], yq)) : NEGV;
        if (c < W) {
          best = fmaxf(best, h);
          if (c == 0 || c >= W - smin1) zmax = fmaxf(zmax, h);
        }
        if (live && r == la && c == mid) {           // end cell (la, lb) sits at mid
          cap_m = mn[q];
          cap_x = xn[q];
          cap_y = yq;
        }
        ml = mn[q];
        yl = yq;
      }
      const float ml_up = __shfl_up_sync(FULL, ml, 1), yl_up = __shfl_up_sync(FULL, yl, 1);
      best = warp_max(best);
      if (lane == 0) sh.wbest[warp] = best;
      __syncthreads();                                // the new row is written
      if (live) {
        float hb = sh.wbest[0];
#pragma unroll
        for (int w = 1; w < WIDE_WARPS; ++w) hb = fmaxf(hb, sh.wbest[w]);
        pressed = pressed || (hb > NEGV / 2 && zmax >= hb - margin);
        hb_prev = hb;
      }
      // cell base - 1: the lane below, or for a warp's lane 0 the shared row
      float m_left = ml_up, y_left = yl_up;
      if (lane == 0) {
        m_left = NEGV;
        y_left = NEGV;
        if (t > 0) {
          m_left = sh.m[pad_ix(base - 1)];
          y_left = sh.y[pad_ix(base - 1)];
        }
      }
      dw[0] |= (uint32_t)((y_left - ge) > (m_left - go) ? 1 : 0) << 3;
      store(dw);
      lo_prev = lo_i;
    }
  }

  // the end captures from their thread, the flag from every thread
  if (base <= mid && mid < base + K) {
    sh.wsum[0] = cap_m;
    sh.wsum[1] = cap_x;
    sh.wsum[2] = cap_y;
  }
  const bool edge = __syncthreads_or(pressed) != 0;
  Result res;
  res.state = M_ST;
  res.score = sh.wsum[0];
  if (sh.wsum[1] > res.score) {
    res.state = IX_ST;
    res.score = sh.wsum[1];
  }
  if (sh.wsum[2] > res.score) {
    res.state = IY_ST;
    res.score = sh.wsum[2];
  }
  res.edge = edge;
  __syncthreads();                                    // wsum is read
  return res;
}

// Registers, local-memory (spill) bytes and CTAs an SM of one instantiation
// at smem bytes of shared memory (past 48 KB the kernel is opted in first,
// as its launch does).
template <typename Kernel>
int kernel_attrs(Kernel kernel, int threads, size_t smem, int* regs, int* local_bytes,
                 int* ctas_per_sm) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes at;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}

}  // namespace banded
