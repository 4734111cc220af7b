// The banded Gotoh forward for one pair per CTA, shared by the two banded
// kernels (banded_forward.cu, banded_fused.cu).
//
// It is the device form of the plain version's band math
// (repro_torch/kernels/banded/ref.py: band_lo, band_row_init,
// band_row_update, edge_pressure), with the same operations in the same
// order. Every score is an integer-valued float below 2^24 in magnitude, so
// no operation rounds and the results are bit-exact; the tie rules are the
// reference's (amax M >= Ix >= Iy, strict > for the Ix extension and the Iy
// extension, the first maximum of the three end captures).
//
// Layout: thread o of the block owns band cell o (blockDim.x is W rounded up
// to a warp; threads o >= W take part in barriers and shuffles with neutral
// values). M/Ix/Iy of the current row sit in registers. The previous row
// crosses threads through shared memory, read at offsets o+s-1 and o+s for
// the band slide s = lo_i - lo_prev (NEG outside the band); the Iy running
// max is a block max-scan (warp shuffles, one shared slot per warp); the
// left neighbours of M and Iy go through shared memory; the edge-pressure
// flags need the row's best, the best of its exit zone and the best of the
// previous row's cells sliding out, which one block max-reduction of three
// values gives. Four barriers per row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace banded {

constexpr float NEGV = -1.0e7f;
constexpr int M_ST = 0, IX_ST = 1, IY_ST = 2, FRESH = 3;
constexpr int MAX_S = 32;
constexpr int MAX_W = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Leftmost absolute column stored for DP row i (la, lb >= 0).
__device__ __forceinline__ int band_lo(int i, int la, int lb, int W) {
  const int c = la == 0 ? lb : (int)(((long long)i * lb) / (la > 1 ? la : 1));
  return c - W / 2;
}

// The block's shared memory, carved from one dynamic allocation.
struct Shared {
  float* sub;     // (S, S)
  float* h;       // previous row: max of the three states, per cell
  float* m;       // previous row: M
  float* ix;      // previous row: Ix
  float* mcur;    // this row: M
  float* iycur;   // this row: Iy
  float* wscan;   // per-warp totals of the Iy max-scan
  float* red;     // per-warp triples of the edge-pressure reduction
  int8_t* am;     // previous row: argmax state
  int8_t* tail;   // what follows (the fused kernel's direction band)
};

// Bytes of the shared memory above for S x S scores and T threads.
__host__ __device__ inline size_t shared_bytes(int S, int T) {
  const size_t floats = (size_t)S * S + 5 * (size_t)T + 32 + 3 * 32;
  return (floats * 4 + T + 15) / 16 * 16;
}

__device__ inline Shared carve(int8_t* base, int S, int T) {
  Shared sh;
  float* f = reinterpret_cast<float*>(base);
  sh.sub = f;
  f += S * S;
  sh.h = f;
  f += T;
  sh.m = f;
  f += T;
  sh.ix = f;
  f += T;
  sh.mcur = f;
  f += T;
  sh.iycur = f;
  f += T;
  sh.wscan = f;
  f += 32;
  sh.red = f;
  f += 3 * 32;
  sh.am = reinterpret_cast<int8_t*>(f);
  sh.tail = base + shared_bytes(S, T);
  return sh;
}

struct Result {
  float score;
  int state;
  bool edge;
};

// The banded forward of one pair: writes the W direction bytes of DP rows
// 1..n to dirs[(r-1)*W + o] (device or shared memory) and returns the end
// score, its state and the edge-pressure flag, the same in every thread.
// The band state advances through every row, past la too; only live rows
// (r <= la) feed the capture and the flag. Needs m >= 1.
__device__ inline Result band_forward(const int8_t* __restrict__ arow,
                                      const int8_t* __restrict__ brow, int n, int m,
                                      int la, int lb, const float* __restrict__ sub_g,
                                      int S, float go, float ge, int W, Shared sh,
                                      int8_t* dirs) {
  const int o = threadIdx.x;
  const int T = blockDim.x;
  const int lane = o & 31, warp = o >> 5, nwarps = T >> 5;
  const bool active = o < W;
  const int mid = W / 2;
  const float NINF = neg_inf();

  for (int x = o; x < S * S; x += T) sh.sub[x] = sub_g[x];
  __syncthreads();
  float margin = NINF;                  // one diagonal step of headroom
  for (int x = 0; x < S * S; ++x) margin = fmaxf(margin, sh.sub[x]);

  // row 0 (band_row_init)
  int lo_prev = band_lo(0, la, lb, W);
  int j = lo_prev + o;
  float mv = j == 0 ? 0.0f : NEGV;
  float xv = NEGV;
  float yv = (j >= 1 && j <= lb) ? -(go + ((float)j - 1.0f) * ge) : NEGV;
  float cap_m = mv, cap_x = xv, cap_y = yv;     // meaningful in thread mid
  float hv = active ? ((j >= 0 && j <= lb) ? fmaxf(mv, yv) : NEGV) : NINF;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) hv = fmaxf(hv, __shfl_xor_sync(FULL, hv, off));
  if (lane == 0) sh.red[3 * warp] = hv;
  __syncthreads();
  float hb_prev = NINF;
  for (int w = 0; w < nwarps; ++w) hb_prev = fmaxf(hb_prev, sh.red[3 * w]);
  bool edge = false;

  for (int r = 1; r <= n; ++r) {
    const int lo_i = band_lo(r, la, lb, W);
    const int s = lo_i - lo_prev;               // band slide (>= 0)
    j = lo_i + o;
    const float hp = fmaxf(mv, fmaxf(xv, yv));
    const int amx = mv >= hp ? M_ST : (xv >= hp ? IX_ST : IY_ST);
    sh.h[o] = hp;
    sh.am[o] = (int8_t)amx;
    sh.m[o] = mv;
    sh.ix[o] = xv;
    __syncthreads();                                           // (1)

    const int d = o + s - 1, u = o + s;
    const bool dok = d >= 0 && d < W, uok = u >= 0 && u < W;
    const float hd = dok ? sh.h[d] : NEGV;
    const int dm = dok ? (int)sh.am[d] : M_ST;
    const float mup = uok ? sh.m[u] : NEGV;
    const float xup = uok ? sh.ix[u] : NEGV;
    const int ac = clamp_i(arow[r - 1], 0, S - 1);
    const int bc = clamp_i(brow[clamp_i(j - 1, 0, m - 1)], 0, S - 1);
    const float srow = sh.sub[ac * S + bc];
    const bool in_mat = j >= 1 && j <= lb;
    const bool in_row = j >= 0 && j <= lb;
    const float mn = in_mat ? hd + srow : NEGV;
    const float ix_open = mup - go;
    const float ix_ext = xup - ge;
    const float xn = in_row ? fmaxf(ix_open, ix_ext) : NEGV;
    const int dix = ix_ext > ix_open ? 1 : 0;

    // Iy via the running max of M[o] + o*ge over the band offsets
    float incl = active ? mn + (float)o * ge : NINF;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = fmaxf(incl, t);
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NINF;
    if (lane == 31) sh.wscan[warp] = incl;
    sh.mcur[o] = mn;
    __syncthreads();                                           // (2)

    for (int w = 0; w < warp; ++w) excl = fmaxf(excl, sh.wscan[w]);
    float yn = o == 0 ? NEGV : (excl - go) - ((float)o - 1.0f) * ge;
    yn = in_mat ? yn : NEGV;
    sh.iycur[o] = yn;
    const float m_left = o > 0 ? sh.mcur[o - 1] : NEGV;
    __syncthreads();                                           // (3)

    const float y_left = o > 0 ? sh.iycur[o - 1] : NEGV;
    const int diy = (y_left - ge) > (m_left - go) ? 1 : 0;
    if (active) dirs[(long long)(r - 1) * W + o] = (int8_t)(dm | (dix << 2) | (diy << 3));
    const float hn = in_row ? fmaxf(mn, fmaxf(xn, yn)) : NEGV;

    // edge pressure: the row best, the best of the exit zone, and the best
    // of the previous row's cells that slid out of storage
    const int smin1 = s > 1 ? s : 1;
    float r0 = active ? hn : NINF;
    float r1 = (active && (o == 0 || o >= W - smin1)) ? hn : NINF;
    float r2 = (active && o < s) ? hp : NINF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      r0 = fmaxf(r0, __shfl_xor_sync(FULL, r0, off));
      r1 = fmaxf(r1, __shfl_xor_sync(FULL, r1, off));
      r2 = fmaxf(r2, __shfl_xor_sync(FULL, r2, off));
    }
    if (lane == 0) {
      sh.red[3 * warp] = r0;
      sh.red[3 * warp + 1] = r1;
      sh.red[3 * warp + 2] = r2;
    }
    __syncthreads();                                           // (4)
    float hb = NINF, zmax = NINF, pmax = NINF;
    for (int w = 0; w < nwarps; ++w) {
      hb = fmaxf(hb, sh.red[3 * w]);
      zmax = fmaxf(zmax, sh.red[3 * w + 1]);
      pmax = fmaxf(pmax, sh.red[3 * w + 2]);
    }
    const bool comp = (zmax >= hb - margin && hb > NEGV / 2) ||
                      (pmax >= hb_prev - margin && hb_prev > NEGV / 2);
    const bool live = r <= la;
    edge = edge || (live && comp);
    if (live) hb_prev = hb;
    if (r == la && o == mid) {                 // end cell (la, lb) sits at mid
      cap_m = mn;
      cap_x = xn;
      cap_y = yn;
    }
    mv = mn;
    xv = xn;
    yv = yn;
    lo_prev = lo_i;
  }

  // argmax of the three end captures, first maximum; broadcast from mid
  if (o == mid) {
    int st = M_ST;
    float sc = cap_m;
    if (cap_x > sc) { st = IX_ST; sc = cap_x; }
    if (cap_y > sc) { st = IY_ST; sc = cap_y; }
    sh.wscan[0] = sc;
    sh.wscan[1] = (float)st;
  }
  __syncthreads();
  Result res;
  res.score = sh.wscan[0];
  res.state = (int)sh.wscan[1];
  res.edge = edge;
  __syncthreads();
  return res;
}

}  // namespace banded
