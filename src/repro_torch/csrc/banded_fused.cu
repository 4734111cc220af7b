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
// (2 * B * (n + m) bytes) against ~25 f32 operations a band cell, so the
// operation bound is the larger; the forward's issue and the walk's chain
// of dependent steps are what the design works on:
//   - the forward is banded_row.cuh's barrier-free core, a pair a warp,
//     PAIRS warps a CTA, a persistent grid of the CTAs the card holds at
//     once;
//   - the direction band at 4 bits a cell (the M argmax, the Ix and the Iy
//     extension bits: all the byte held), rows of band_pitch(W) bytes,
//     written by the forward one lane store a row into the pair slot's
//     workspace slot (fused_slot_bytes: the band, then the walk's moves;
//     the workspace is grid * PAIRS slots, independent of B), so shared
//     memory holds only the table and the staged sequences;
//   - the warp walks the path together: it holds a window of 512 bytes of
//     packed rows (16 a lane) and prefetches the next one below it while
//     walking; each step takes its nibble from the owning lane by a
//     shuffle, the band column steps down with a carry (no division), and
//     the step's move is packed into a register, 16 steps a word;
//   - when the walk's length k is known, the warp writes the aligned rows
//     once, in order, 32 columns at a time, each column's sequence position
//     a ballot count of the moves before it: the walk reads no sequence,
//     and no read-back shift pass.
// Bands wider than MAX_W take the wide route: a pair a CTA of WIDE_THREADS
// threads on band_forward_wide (banded_row.cuh), the same 4-bit band in the
// same workspace slots (one slot a CTA), then warp 0 walks the pair as
// above, reading each step's nibble from the slot (a row of band_pitch(W) >=
// 1,024 bytes does not fit the warp's register window).
// The forward runs every row, as the reference does: the traceback of a
// degenerate pair (a path that crosses row 0 in state M or Ix) reads the
// reference's clamped index (i - 1) * W + o at negative i, which can land
// on rows past la.
#include "banded_row.cuh"

namespace {

using namespace banded;

// Bytes of a pair slot's workspace: its packed band (n rows of
// band_pitch(W)), then its walk's 2-bit move codes, 16 a word (n + m steps
// at most).
__host__ __device__ inline size_t fused_slot_bytes(int n, int m, int W) {
  return (size_t)n * band_pitch(W) + round16(((size_t)n + m + 15) / 16 * 4);
}

// The lane's K nibbles of each row in turn into the packed band (row pitch
// band_pitch(W)): byte c / 2 of a row holds cell c in its low (c even) or
// high nibble.
template <int K>
struct NibbleStore {
  uint8_t* row;       // this lane's first byte of the next row
  int pitch;
  __device__ __forceinline__ void operator()(const int (&d)[K]) {
    if constexpr (K == 1) {
      const int hi = __shfl_down_sync(FULL, d[0], 1);
      if ((lane_id() & 1) == 0) *row = (uint8_t)(d[0] | (hi << 4));
    } else {
      uint32_t w[(K / 2 + 3) / 4] = {};
#pragma unroll
      for (int t = 0; t < K / 2; ++t)
        w[t / 4] |= (uint32_t)(d[2 * t] | (d[2 * t + 1] << 4)) << (8 * (t % 4));
      store_bytes<K / 2>(row, w);
    }
    row += pitch;
  }
};

// A window of packed band rows [lo, lo + R) in the warp's registers (16
// bytes a lane, 512 bytes) and the R rows below it in flight.
struct Window {
  const uint8_t* band;
  long long nbytes;
  int pitch, R, lo;
  uint4 cur, nxt;

  __device__ __forceinline__ uint4 load(int row) const {
    const long long off = (long long)row * pitch + 16 * lane_id();
    if (off < 0 || off + 16 > nbytes) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(band + off);
  }
  // top row `top` sits at the top of the first window
  __device__ __forceinline__ void start(const uint8_t* b, int n, int p, int top) {
    band = b;
    pitch = p;
    nbytes = (long long)n * p;
    R = 512 / p;
    lo = top - R + 1;
    cur = load(lo);
    nxt = load(lo - R);
  }
  // the nibble of cell col in row (row < lo + R: the walk never moves
  // down; usually up by one row at most, into the prefetched window);
  // every lane of the warp takes part
  __device__ __forceinline__ int fetch(int row, int col) {
    if (row < lo) {
      if (row >= lo - R) {
        cur = nxt;
        lo -= R;
      } else {
        lo = row - R + 1;
        cur = load(lo);
      }
      nxt = load(lo - R);
    }
    const int bi = (row - lo) * pitch + (col >> 1);
    const uint32_t w01 = (bi & 4) ? cur.y : cur.x, w23 = (bi & 4) ? cur.w : cur.z;
    const uint32_t w = (bi & 8) ? w23 : w01;
    const uint32_t got = __shfl_sync(FULL, w, bi >> 4);
    return (int)(got >> (8 * (bi & 3) + 4 * (col & 1))) & 15;
  }
};

// The walk of one pair by one warp, its aligned rows and its record: every
// lane of the warp takes part. win.fetch(row, col) gives the packed band's
// nibble of an in-band cell (every lane at once); band is the slot's band
// (the degenerate path's clamped reads), moves its move words.
template <typename Fetch>
__device__ __forceinline__ void walk_pair(Fetch& win, const uint8_t* band, uint32_t* moves,
                                          const Result& res, long long pair,
                                          const int8_t* arow, const int8_t* brow, int la, int lb,
                                          int n, int m, int W, int pitch, int8_t gap,
                                          int8_t* __restrict__ a_row, int8_t* __restrict__ b_row,
                                          float* __restrict__ rec) {
  const int lane = lane_id();
  const int out_len = n + m;
  // the warp's lanes walk the same path and pack one 2-bit move code a step
  // (bit 0: a consumed, bit 1: b consumed) into a word, 16 steps a word,
  // which lane 0 stores in the slot's moves
  BandCol col(la, lb, true);
  int i = la, j = lb, st = res.state, k = 0;
  uint32_t word = 0;
  bool done = la == 0 && lb == 0, edge = false, oob = false;
  while (!done && k < out_len) {
    const int o = j - (col.c - W / 2);
    const bool in_band = o >= 0 && o < W && i >= 1;
    int byte;
    if (in_band && j >= 1) {
      // an interior cell in the band (most steps); an edge cell whose
      // clipped neighbour is a real DP cell flags the pair
      byte = win.fetch(i - 1, o);
      edge = edge || o == 0 || (o == W - 1 && j < lb);
    } else if (i > 0 && j > 0) {
      oob = true;                            // the path left the band
      break;
    } else if (in_band && j != 0) {
      byte = win.fetch(i - 1, o);        // j < 0 (a degenerate path)
    } else if (i == 0) {
      // boundary cells are pure gap runs with closed-form directions
      byte = FRESH | ((j == 1 ? 0 : 1) << 3);
    } else if (j == 0) {
      byte = M_ST | ((i == 1 ? 0 : 1) << 2);
    } else if (n == 0) {
      byte = 0;
    } else {
      // i < 0 or j < 0 (a degenerate path): the reference's clamped index
      const long long at = (long long)(i - 1) * W + o;
      const long long idx = at < 0 ? 0 : (at > (long long)n * W - 1 ? (long long)n * W - 1 : at);
      const int row = (int)(idx / W), c = (int)(idx - (long long)row * W);
      byte = (band[(size_t)row * pitch + (c >> 1)] >> (4 * (c & 1))) & 15;
    }
    const int take_a = (st == M_ST || st == IX_ST) ? 1 : 0;
    const int take_b = (st == M_ST || st == IY_ST) ? 1 : 0;
    // step k's code goes in at the top; 16 steps later step k - 15 is in
    // bits 0-1 and the word is full
    word = (word >> 2) | ((uint32_t)(take_a | (take_b << 1)) << 30);
    if ((k & 15) == 15 && lane == 0) moves[k >> 4] = word;
    ++k;
    // M: the argmax bits; Ix: extend (Ix) or open (M); Iy and FRESH:
    // extend (Iy) or open (M)
    const int next_m = byte & 3, next_x = (byte >> 2) & 1, next_y = (byte >> 2) & 2;
    st = st == M_ST ? next_m : (st == IX_ST ? next_x : next_y);
    i -= take_a;
    if (take_a) col.down();
    j -= take_b;
    done = (i | j) == 0;
  }
  if (lane == 0 && (k & 15) != 0) moves[k >> 4] = word >> (2 * (16 - (k & 15)));
  __syncwarp();

  // the k columns in order, then gaps: column p is step k - 1 - p, which
  // read a[i - 1] at i = (the walk's last i) + (a moves in columns 0..p),
  // clamped as the reference reads; the counts come from ballots
  int8_t* ar = a_row + pair * (long long)out_len;
  int8_t* br = b_row + pair * (long long)out_len;
  const unsigned upto = 0xffffffffu >> (31 - lane);
  int ia = i, jb = j;
  for (int p0 = 0; p0 < out_len; p0 += 32) {
    const int p = p0 + lane, t = k - 1 - p;
    const int mv = p < k ? (int)(moves[t >> 4] >> (2 * (t & 15))) & 3 : 0;
    const unsigned ba = __ballot_sync(FULL, mv & 1), bb = __ballot_sync(FULL, mv & 2);
    int8_t ca = gap, cb = gap;
    if (mv & 1 && n > 0) ca = arow[clamp_i(ia + __popc(ba & upto) - 1, 0, n - 1)];
    if (mv & 2) cb = brow[clamp_i(jb + __popc(bb & upto) - 1, 0, m - 1)];
    if (p < out_len) {
      ar[p] = ca;
      br[p] = cb;
    }
    ia += __popc(ba);
    jb += __popc(bb);
  }
  if (lane == 0) {
    const bool ok = !edge && !oob && !res.edge && res.score > NEGV / 2;
    float* r = rec + pair * 8;
    r[0] = res.score;
    r[1] = (float)la;
    r[2] = (float)lb;
    r[3] = (float)res.state;
    r[4] = (float)k;
    r[5] = ok ? 1.0f : 0.0f;
    r[6] = res.edge ? 1.0f : 0.0f;
    r[7] = 0.0f;
  }
}

template <int K>
__global__ void __launch_bounds__(32 * PAIRS, K <= 2 ? 4 : (K == 4 ? 3 : 1))
    banded_fused_kernel(const int8_t* __restrict__ a, long long a_stride,
                        const int8_t* __restrict__ b, long long b_stride,
                        const int* __restrict__ lens, const float* __restrict__ sub_g, int S,
                        int8_t* __restrict__ a_row, int8_t* __restrict__ b_row,
                        float* __restrict__ rec, uint8_t* __restrict__ work, int B, int n, int m,
                        int W, float go, float ge, int gap_code) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sub = reinterpret_cast<float*>(smem);
  const float margin = load_sub(sub_g, sub, S);
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int pitch = band_pitch(W);
  int8_t* buf = reinterpret_cast<int8_t*>(smem + sub_bytes(S)) + warp * (A_CHUNK + b_window(W));
  uint8_t* band = work + ((size_t)blockIdx.x * PAIRS + warp) * fused_slot_bytes(n, m, W);
  uint32_t* moves = reinterpret_cast<uint32_t*>(band + (size_t)n * pitch);
  const int8_t gap = (int8_t)gap_code;

  for (long long pair = (long long)blockIdx.x * PAIRS + warp; pair < B;
       pair += (long long)gridDim.x * PAIRS) {
    const int la = lens[2 * pair], lb = lens[2 * pair + 1];
    const int8_t* arow = a + pair * a_stride;
    const int8_t* brow = b + pair * b_stride;
    Staged seq(arow, n, brow, m, S, W, buf);
    NibbleStore<K> store{band + (K == 1 ? lane >> 1 : lane * (K / 2)), pitch};
    const Result res = band_forward<K>(seq, la, lb, sub, go, ge, W, margin, store);
    __syncwarp();

    // ---- traceback, from the warp's register window of packed rows
    Window win;
    win.start(band, n, pitch, la - 1);
    walk_pair(win, band, moves, res, pair, arow, brow, la, lb, n, m, W, pitch, gap, a_row, b_row,
              rec);
    __syncwarp();
  }
}

// The wide route's packed band: the thread's K nibbles of each row in turn,
// K / 2 bytes at t * K / 2 of a row of band_pitch(W) = 256 K bytes.
template <int K>
struct WideNibbleStore {
  uint8_t* dst;       // this thread's first byte of the next row
  int pitch;
  __device__ __forceinline__ void operator()(const uint32_t (&dw)[(K + 7) / 8]) {
    store_bytes<K / 2>(dst, dw);
    dst += pitch;
  }
};

// The wide route's walk reads each nibble from the slot's band (a row of
// 1,024 bytes or more is past a warp's register window); the CTA's barrier
// after the forward makes the band's bytes visible to the walking warp.
struct BandFetch {
  const uint8_t* band;
  int pitch;
  __device__ __forceinline__ int fetch(int row, int col) const {
    return (band[(size_t)row * pitch + (col >> 1)] >> (4 * (col & 1))) & 15;
  }
};

// Kernel 4's wide route (W > MAX_W): a pair a CTA on band_forward_wide, a
// persistent grid of slots (slot = CTA), then warp 0 walks the pair.
template <int K>
__global__ void __launch_bounds__(WIDE_THREADS, K <= 8 ? 2 : 1)
    banded_fused_wide_kernel(const int8_t* __restrict__ a, long long a_stride,
                             const int8_t* __restrict__ b, long long b_stride,
                             const int* __restrict__ lens, const float* __restrict__ sub_g,
                             int S, int8_t* __restrict__ a_row, int8_t* __restrict__ b_row,
                             float* __restrict__ rec, uint8_t* __restrict__ work, int B, int n,
                             int m, int W, float go, float ge, int gap_code) {
  extern __shared__ __align__(16) uint8_t smem[];
  const WideSmem sh(smem, S, W);
  const float margin = load_sub(sub_g, sh.sub, S);
  const int pitch = band_pitch(W);
  uint8_t* band = work + (size_t)blockIdx.x * fused_slot_bytes(n, m, W);
  uint32_t* moves = reinterpret_cast<uint32_t*>(band + (size_t)n * pitch);
  const int8_t gap = (int8_t)gap_code;

  for (long long pair = blockIdx.x; pair < B; pair += gridDim.x) {
    const int la = lens[2 * pair], lb = lens[2 * pair + 1];
    const int8_t* arow = a + pair * a_stride;
    const int8_t* brow = b + pair * b_stride;
    StagedWide seq(arow, n, brow, m, S, W, sh.buf);
    WideNibbleStore<K> store{band + threadIdx.x * (K / 2), pitch};
    const Result res = band_forward_wide<K>(seq, la, lb, sh, go, ge, W, margin, store);
    __syncthreads();                      // the band is written
    if (threadIdx.x < 32) {
      BandFetch fetch{band, pitch};
      walk_pair(fetch, band, moves, res, pair, arow, brow, la, lb, n, m, W, pitch, gap, a_row,
                b_row, rec);
    }
    __syncthreads();                      // the walk is done with the slot
  }
}

}  // namespace

// The registers and local-memory (spill) bytes a thread of the
// instantiation for band W uses, and how many of its CTAs an SM holds at
// once with an S x S table (the wrapper's persistent grid is that many
// CTAs an SM). Returns a cudaError_t.
extern "C" int banded_fused_attrs(int W, int S, int* regs, int* local_bytes, int* ctas_per_sm) {
  if (W < 1 || W > MAX_WIDE_W || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  if (W > MAX_W)
    return with_wide_cells(W, [&](auto k) {
      return kernel_attrs(banded_fused_wide_kernel<decltype(k)::value>, WIDE_THREADS,
                          wide_smem_bytes(S, W), regs, local_bytes, ctas_per_sm);
    });
  return with_cells(W, [&](auto k) {
    return kernel_attrs(banded_fused_kernel<decltype(k)::value>, 32 * PAIRS, cta_smem_bytes(S, W),
                        regs, local_bytes, ctas_per_sm);
  });
}

// a: (B, n) int8 with row stride a_stride; b: (B, m) int8 with row stride
// b_stride (0 = broadcast), m >= 1; lens: (B, 2) int32 [la, lb],
// 0 <= la <= n, 0 <= lb <= m; sub: (S, S) f32, S <= 32; a_row, b_row:
// (B, n + m) int8; rec: (B, 8) f32; 1 <= W <= 16,384; grid CTAs of P pair
// slots (P = PAIRS up to MAX_W, 1 on the wide route), slot p taking pairs
// p, p + grid * P, ...; work: at least grid * P * fused_slot_bytes(n, m, W)
// bytes (work_bytes, checked). Returns a cudaError_t.
extern "C" int banded_fused(const void* a, long long a_stride, const void* b,
                            long long b_stride, const void* lens, const void* sub, int S,
                            void* a_row, void* b_row, void* rec, void* work,
                            long long work_bytes, int B, int n, int m, int W, float go,
                            float ge, int gap_code, int grid, void* stream) {
  const int slots = W > MAX_W ? 1 : PAIRS;
  if (S < 1 || S > MAX_S || B < 1 || n < 0 || m < 1 || W < 1 || W > MAX_WIDE_W || grid < 1 ||
      work == nullptr || work_bytes < 0 ||
      (size_t)grid * slots * fused_slot_bytes(n, m, W) > (size_t)work_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (W > MAX_W) {
    const size_t smem = wide_smem_bytes(S, W);
    return with_wide_cells(W, [&](auto k) {
      const auto kernel = banded_fused_wide_kernel<decltype(k)::value>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<grid, WIDE_THREADS, smem, st>>>(
          (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
          (const float*)sub, S, (int8_t*)a_row, (int8_t*)b_row, (float*)rec, (uint8_t*)work, B,
          n, m, W, go, ge, gap_code);
      return (int)cudaGetLastError();
    });
  }
  const size_t shmem = cta_smem_bytes(S, W);
  return with_cells(W, [&](auto k) {
    banded_fused_kernel<decltype(k)::value><<<grid, 32 * PAIRS, shmem, st>>>(
        (const int8_t*)a, a_stride, (const int8_t*)b, b_stride, (const int*)lens,
        (const float*)sub, S, (int8_t*)a_row, (int8_t*)b_row, (float*)rec, (uint8_t*)work, B,
        n, m, W, go, ge, gap_code);
    return (int)cudaGetLastError();
  });
}
