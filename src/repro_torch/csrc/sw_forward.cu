// Batched affine-gap Gotoh forward pass (global or local) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sw/sw_kernel.py::gotoh_forward_kernel
// (body _kernel, row math _row_update). Same contract: for each pair the
// packed direction bytes of DP rows 1..n (row 0 is written by the wrapper)
// and a record [score, start_i, start_j, start_state, 0, 0, 0, 0]. Results
// are bit-exact with the plain version (repro_torch/kernels/sw/ref.py): every
// score is an integer-valued float below 2^24, so no operation rounds, and
// the tie rules are the reference's (>= picks M, then Ix, then Iy; the first
// maximal column; strict > to replace the local best).
//
// What bounds it on the H100: the output. Every DP cell emits one direction
// byte to device memory (B * n * (m+1) bytes, ~2 GB on the 16S main path),
// while the score rows are needed only one row at a time. The design keeps
// the three score rows (M, Ix, Iy) in registers for the whole pass, so the
// only device-memory traffic is the direction bytes, the two sequences and
// the record.
//
// Design (simple first): one CTA per pair, a loop over DP rows inside the
// block (the Pallas grid's sequential row-block dimension). Thread t owns
// CPT contiguous columns [t*CPT, t*CPT + CPT). Neighbour values (h_diag,
// m_left, iy_left) cross thread boundaries through one shared-memory slot per
// thread. The horizontal gap recurrence Iy[j] = max(M[j-1]-go, Iy[j-1]-ge) is
// re-expressed, as in the reference, as a running max over M[k] + k*ge: a
// block inclusive max-scan (per-thread prefix, warp shuffles, per-warp totals
// in shared memory). The substitution matrix sits in shared memory. The
// target may have a batch stride of 0 (one broadcast center for all pairs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEGV = -1.0e7f;
constexpr int M_ST = 0, IX_ST = 1, IY_ST = 2, FRESH = 3;
constexpr int MAX_S = 32;
constexpr int MAX_T = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int clamp_code(int c, int S) {
  return c < 0 ? 0 : (c >= S ? S - 1 : c);
}

template <int CPT, bool LOCAL>
__global__ void sw_forward_kernel(const int8_t* __restrict__ a, long long a_stride,
                                  const int8_t* __restrict__ b, long long b_stride,
                                  const int* __restrict__ lens,
                                  const float* __restrict__ sub_g, int S,
                                  int8_t* __restrict__ dirs, float* __restrict__ rec,
                                  int n, int m, float go, float ge) {
  __shared__ float sub[MAX_S * MAX_S];
  __shared__ float edge_h[MAX_T];
  __shared__ int edge_amax[MAX_T];
  __shared__ float edge_m[MAX_T];
  __shared__ float edge_y[MAX_T];
  __shared__ float warp_max[32];
  __shared__ float red_v[32];
  __shared__ int red_j[32];

  const long long pair = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  for (int i = t; i < S * S; i += T) sub[i] = sub_g[i];

  const int la = lens[2 * pair];
  const int lb = lens[2 * pair + 1];
  const int lbc = lb < 0 ? 0 : (lb > m ? m : lb);   // the reference's clamped gather
  const int8_t* arow = a + pair * a_stride;
  const int8_t* brow = b + pair * b_stride;
  int8_t* drow = dirs + pair * (long long)(n + 1) * (m + 1) + (m + 1);   // DP row 1
  const int j0 = t * CPT;

  int bc[CPT];
  float mp[CPT], xp[CPT], yp[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c;
    bc[c] = (j >= 1 && j <= m) ? clamp_code(brow[j - 1], S) : 0;
    mp[c] = (j == 0) ? 0.0f : NEGV;
    xp[c] = NEGV;
    yp[c] = (j >= 1) ? -(go + (float)(j - 1) * ge) : NEGV;
  }
  // global mode: the (M, Ix, Iy) values at column lb of row la
  float cap_m = NEGV, cap_x = NEGV, cap_y = NEGV;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (j0 + c == lbc) { cap_m = mp[c]; cap_x = xp[c]; cap_y = yp[c]; }
  // local mode: the best M cell so far (held by thread 0)
  float best_v = NEGV;
  int best_i = 0, best_j = 0;
  __syncthreads();

  for (int r = 1; r <= n; ++r) {
    const float* srow = sub + clamp_code(arow[r - 1], S) * S;
    float h[CPT];
    int am[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      h[c] = fmaxf(mp[c], fmaxf(xp[c], yp[c]));
      am[c] = mp[c] >= h[c] ? M_ST : (xp[c] >= h[c] ? IX_ST : IY_ST);
    }
    edge_h[t] = h[CPT - 1];
    edge_amax[t] = am[CPT - 1];
    __syncthreads();                                         // (1)
    const float h_left = t > 0 ? edge_h[t - 1] : NEGV;
    const int a_left = t > 0 ? edge_amax[t - 1] : M_ST;

    float mn[CPT], incl[CPT];
    int dm[CPT];
    float run = neg_inf();
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + c;
      const float hd = c == 0 ? h_left : h[c > 0 ? c - 1 : 0];
      const int ad = c == 0 ? a_left : am[c > 0 ? c - 1 : 0];
      const float s = j == 0 ? 0.0f : srow[bc[c]];
      float mv = hd + s;
      int d = ad;
      if (LOCAL && hd <= 0.0f) { mv = s; d = FRESH; }
      if (j == 0) mv = NEGV;
      mn[c] = mv;
      dm[c] = d;
      run = fmaxf(run, j <= m ? mv + (float)j * ge : neg_inf());
      incl[c] = run;
    }
    // block inclusive max-scan of the per-thread totals
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, tot, off);
      if (lane >= off) tot = fmaxf(tot, o);
    }
    if (lane == 31) warp_max[warp] = tot;
    edge_m[t] = mn[CPT - 1];
    __syncthreads();                                         // (2)
    if (warp == 0) {
      float w = lane < nwarps ? warp_max[lane] : neg_inf();
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w = fmaxf(w, o);
      }
      if (lane < nwarps) warp_max[lane] = w;
    }
    __syncthreads();                                         // (3)
    float excl_lane = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) excl_lane = neg_inf();
    const float excl = fmaxf(warp > 0 ? warp_max[warp - 1] : neg_inf(), excl_lane);
    float iy[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + c;
      const float cm_prev = c == 0 ? excl : fmaxf(excl, incl[c > 0 ? c - 1 : 0]);
      iy[c] = j == 0 ? NEGV : (cm_prev - go) - (float)(j - 1) * ge;
    }
    edge_y[t] = iy[CPT - 1];
    const float m_left0 = t > 0 ? edge_m[t - 1] : NEGV;
    __syncthreads();                                         // (4)
    const float y_left0 = t > 0 ? edge_y[t - 1] : NEGV;

    const bool live = r <= la;
    int8_t* out = drow + (long long)(r - 1) * (m + 1);
    float bv = neg_inf();
    int bj = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + c;
      const float m_left = c == 0 ? m_left0 : mn[c > 0 ? c - 1 : 0];
      const float y_left = c == 0 ? y_left0 : iy[c > 0 ? c - 1 : 0];
      const float ix_open = mp[c] - go;
      const float ix_ext = xp[c] - ge;
      const float ixn = fmaxf(ix_open, ix_ext);
      const int dix = ix_ext > ix_open ? 1 : 0;
      const int diy = (y_left - ge) > (m_left - go) ? 1 : 0;
      if (j <= m) out[j] = (int8_t)(dm[c] | (dix << 2) | (diy << 3));
      if (r == la && j == lbc) { cap_m = mn[c]; cap_x = ixn; cap_y = iy[c]; }
      if (LOCAL) {
        const float v = j > m ? neg_inf() : ((live && j <= lb) ? mn[c] : NEGV);
        if (v > bv) { bv = v; bj = j; }
      }
      if (live) { mp[c] = mn[c]; xp[c] = ixn; yp[c] = iy[c]; }
    }
    if (LOCAL) {
      // block argmax, first maximal column on ties
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(FULL, bv, off);
        const int oj = __shfl_down_sync(FULL, bj, off);
        if (ov > bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
      }
      if (lane == 0) { red_v[warp] = bv; red_j[warp] = bj; }
      __syncthreads();                                       // (5)
      if (t == 0) {
        float v = red_v[0];
        int jb = red_j[0];
        for (int w = 1; w < nwarps; ++w)
          if (red_v[w] > v || (red_v[w] == v && red_j[w] < jb)) { v = red_v[w]; jb = red_j[w]; }
        if (v > best_v) { best_v = v; best_i = r; best_j = jb; }
      }
    }
  }

  float* o = rec + pair * 8;
  if (LOCAL) {
    if (t == 0) {
      o[0] = best_v; o[1] = (float)best_i; o[2] = (float)best_j; o[3] = (float)M_ST;
      o[4] = o[5] = o[6] = o[7] = 0.0f;
    }
  } else if (j0 <= lbc && lbc < j0 + CPT) {
    int st = M_ST;
    float sc = cap_m;
    if (cap_x > sc) { st = IX_ST; sc = cap_x; }
    if (cap_y > sc) { st = IY_ST; sc = cap_y; }
    o[0] = sc; o[1] = (float)la; o[2] = (float)lb; o[3] = (float)st;
    o[4] = o[5] = o[6] = o[7] = 0.0f;
  }
}

template <int CPT>
void launch(bool local, int B, int threads, cudaStream_t stream, const int8_t* a,
            long long a_stride, const int8_t* b, long long b_stride, const int* lens,
            const float* sub, int S, int8_t* dirs, float* rec, int n, int m, float go,
            float ge) {
  if (local)
    sw_forward_kernel<CPT, true><<<B, threads, 0, stream>>>(
        a, a_stride, b, b_stride, lens, sub, S, dirs, rec, n, m, go, ge);
  else
    sw_forward_kernel<CPT, false><<<B, threads, 0, stream>>>(
        a, a_stride, b, b_stride, lens, sub, S, dirs, rec, n, m, go, ge);
}

}  // namespace

// a: (B, n) int8 with row stride a_stride; b: (B, m) int8 with row stride
// b_stride (0 = one target broadcast to every pair); lens: (B, 2) int32
// [la, lb]; sub: (S, S) f32 row-major, S <= 32; dirs: (B, n+1, m+1) int8
// (rows 1..n are written); rec: (B, 8) f32. Returns a cudaError_t.
extern "C" int sw_forward(const void* a, long long a_stride, const void* b,
                          long long b_stride, const void* lens, const void* sub, int S,
                          void* dirs, void* rec, int B, int n, int m, float go, float ge,
                          int local, void* stream) {
  if (S < 1 || S > MAX_S || B < 1 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int cols = m + 1;
  int cpt = 1;
  while (cpt < 16 && (cols + cpt - 1) / cpt > 256) cpt *= 2;
  const int threads = ((cols + cpt - 1) / cpt + 31) / 32 * 32;
  if (threads > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* A = (const int8_t*)a;
  const int8_t* Bp = (const int8_t*)b;
  const int* L = (const int*)lens;
  const float* SUB = (const float*)sub;
  int8_t* D = (int8_t*)dirs;
  float* R = (float*)rec;
  const bool loc = local != 0;
  switch (cpt) {
    case 1: launch<1>(loc, B, threads, s, A, a_stride, Bp, b_stride, L, SUB, S, D, R, n, m, go, ge); break;
    case 2: launch<2>(loc, B, threads, s, A, a_stride, Bp, b_stride, L, SUB, S, D, R, n, m, go, ge); break;
    case 4: launch<4>(loc, B, threads, s, A, a_stride, Bp, b_stride, L, SUB, S, D, R, n, m, go, ge); break;
    case 8: launch<8>(loc, B, threads, s, A, a_stride, Bp, b_stride, L, SUB, S, D, R, n, m, go, ge); break;
    default: launch<16>(loc, B, threads, s, A, a_stride, Bp, b_stride, L, SUB, S, D, R, n, m, go, ge); break;
  }
  return (int)cudaGetLastError();
}
