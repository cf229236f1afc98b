// Sparse rescore of the top-K selected components, grouped by component
// (sm_90a).
//
// Replaces: src/repro/kernels/gmm_rescore.py, gmm_rescore (_kernel).
//
//   out[f, k] = A[s, 0] + sum_d x_fd A[s, 1+d]
//               - 0.5 sum_ij x_fi x_fj A[s, 1+D+iD+j],   s = sel[f, k]
//
// x [F, D] f32, sel [F, K] int64 in [0, C) (the wrapper clips), A [C, E]
// f32 packed rows [const | lin | vec(P)] with E >= 1 + D + D*D; out [F, K].
// P is used whole, as given, so the result is exact for a P that is not
// symmetric too.
//
// Why not the TPU design: the TPU kernel DMA-gathers the K rows of each
// 8-frame tile into fast memory, issuing the copies sorted by id so that
// duplicate and neighbouring ids walk A in address order. Among 8 frames
// few ids repeat, and a block of one frame (the previous kernel here) or
// of 64 frames still reads about one 21 KB row per (frame, slot) pair:
// 6.9 GB from L2 at F = 16,384, K = 20, D = 72, for a pack of 43 MB. The
// reuse lies across the whole launch, whose 327,680 pairs name at most
// C = 2,048 rows. So the TPU's sort of one tile's DMA issue order becomes
// a counting sort of every pair of the launch, and each row is read once
// per work item of up to BP pairs, scored against them as a small SGEMM.
//
// Bound on the H100: operations, 2 F K (D^2 + D + 1) FLOPs at the f32 rate
// of the CUDA cores (0.0514 ms at F = 16,384, K = 20, D = 72). The bytes,
// each touched row once and the frames, take ~0.03 ms.
//
// Design: a memset and five launches on the caller's stream, no host sync.
//   1. hist: counts[c] = the pairs naming c. A block counts its chunk of
//      the pairs in a shared-memory histogram, then adds its non-zero
//      bins; a serving bucket's padded frames, which all select the same
//      ids, queue on shared atomics only.
//   2. scan, one block: exclusive scans of counts and of ceil(counts / BP)
//      give each component's first pair (into counts: the scatter's
//      cursor) and first work item (wstart; wstart[C] is their number).
//   3. cut: the work items (c, first pair, pairs <= BP), a thread each,
//      by a binary search of wstart. At most ceil(F K / BP) + C items: the
//      wrapper allocates that many and the rescore's grid covers them;
//      surplus blocks exit at once.
//   4. scatter: a block counts its chunk again, takes a run of each
//      component's segment by one atomic a bin and hands its places out by
//      shared atomics, so each pair's index f K + k lands in its
//      component's segment. The order inside a segment varies from run to
//      run; no output depends on it (below).
//   5. rescore, one block of 4 warps a work item, 4 blocks an SM. Row c's
//      P comes by 16-byte cp.async from the 16-byte boundary before it (a
//      row of A starts at any word) and is moved back into line in shared
//      memory; lin and const by 4-byte copies; the item's frames by
//      16-byte copies into xs [BP][Dp]. Then Y = X P as a register-tiled
//      SIMT product: a warp takes 32 rows and half the sum over i, a
//      thread 8 rows x 9 columns (float2 reads of x, float4 reads of P's
//      row). The accumulators start at -2 lin_j in the first i-warp, so on
//      the way out sum_j x_j (Y_j - 2 lin_j) = x'Px - 2 x.lin; a shuffle
//      tree adds the 8 column groups, the i-warps' parts are added in warp
//      order, and out = const - q / 2. An output is summed in the same
//      order whatever its slot in an item, so two calls are bitwise equal.
//      f32 on the CUDA cores: TF32 is off in this port. An instance with D
//      = 72 fixed at compile time folds the shared-memory offsets into the
//      loads; any other D takes the general one (4-byte copies of P when D
//      is not a multiple of 72, up to D = 200).
// Shared memory of a rescore block at D = 72: 40 KB. `geometry` (below)
// sets the sizes for the launch and for kernels/gmm_rescore.geometry's
// check (gmm_rescore_geometry); the entry refuses a wrapper whose sizes
// differ from its own. A persistent two-stage version, items of 128 pairs,
// 8-warp blocks and items of several 64-pair passes were each slower on
// the card (PERF.md, section 6).
//
// Two forms past the one above, each taken only where it does not fit:
//   strips (D >= 201, where P_c whole and the item's frames outgrow a
//     block): P_c comes in strips of STRIP = 32 rows, one at a time by
//     4-byte cp.async; each strip's rows are split between the two
//     i-warps as P's rows are above, and each pair's quadratic gains the
//     strip's part x_S' (P_S x) column pass by column pass, added onto
//     the i-warp's sum in strip order (the -2 lin term in the first strip
//     only). A fixed order, so two calls are bitwise equal. 224 KB at D =
//     512 (the item's frames 147 KB of it), one block an SM.
//   a histogram in device memory (C >= 58,113, where C counts outgrow a
//     sort block's shared memory): the sort's counts and its scatter take
//     one device-memory atomic a pair. Counts are integers, so their order
//     changes nothing; the order inside a segment varies, as above.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BP = 64;            // pairs a work item at most
constexpr int THREADS = 128;      // the rescore
constexpr int RW = BP / 32;       // its warps along the rows
constexpr int IW = THREADS / 32 / RW;   // and along the sum over i
constexpr int COLS = 72;          // columns of Y a pass: 8 lane groups x 9
constexpr int STRIP = 32;         // rows of P a strip, in the strip form
constexpr int SORT_THREADS = 512;
constexpr int CHUNK_MIN = 4096;   // pairs a sort block at least
constexpr int CUT_THREADS = 1024;
constexpr long long MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline long long round_up(long long n, long long m) {
  return (n + m - 1) / m * m;
}

// Rows of P a rescore block keeps: each i-warp takes an even number
__host__ __device__ inline int p_rows(int D) {
  return (int)round_up(D, 2 * IW);
}

// Shared memory of a rescore block in 4-byte words: `rows` rows of P_c
// [rows][Dp] (all of it, Di = p_rows(D), or a strip; Dp = round_up(D,
// COLS) columns, zero past D), the item's frames [BP][Dp] (zero past D and
// past its pairs), lin [Dp], const [4], the i-warps' partial sums [IW][BP],
// the pairs' indices and frames [2][BP].
inline long long smem_words(int D, int rows) {
  const long long Dp = round_up(D, COLS);
  return rows * Dp + 4 + BP * Dp + Dp + 4 + IW * BP + 2 * BP;
}

// Scratch, in int32 words: counts [C], the items' starts [C + 1] (the
// last: their number), padding to 16 bytes, the items [max_items] (int4),
// the sorted pair indices [F K].
struct Geometry {
  long long max_items;          // ceil(F K / BP) + C
  long long scratch_words;
  long long smem;               // bytes a rescore block
  long long strip;              // rows of P a pass: p_rows(D), or STRIP
  long long hist_global;        // 1: the sort counts in device memory
};

// The sizes for these shapes: P whole where it fits, else in strips; the
// sort's histogram in shared memory where C counts fit, else in device
// memory. False where F K >= 2^31 or where a rescore block exceeds
// MAX_SMEM even with strips (D above 576).
inline bool geometry(long long F, long long K, long long C, int D,
                     Geometry& g) {
  if (F < 0 || K < 0 || C < 1 || D < 1) return false;
  const long long pairs = F * K;
  if (pairs >= (1LL << 31)) return false;
  g.max_items = (pairs + BP - 1) / BP + C;
  g.scratch_words = round_up(2 * C + 1, 4) + 4 * g.max_items + pairs;
  g.hist_global = 4 * C > MAX_SMEM ? 1 : 0;
  g.strip = p_rows(D);
  g.smem = 4 * smem_words(D, (int)g.strip);
  if (g.smem > MAX_SMEM) {
    g.strip = STRIP;
    g.smem = 4 * smem_words(D, STRIP);
  }
  return g.smem <= MAX_SMEM;
}

// 1. counts[c] += the pairs naming c: each block counts its chunk of the
// pairs in shared memory, then adds its non-zero bins
__global__ void __launch_bounds__(SORT_THREADS)
hist_kernel(const long long* __restrict__ sel, int* __restrict__ counts,
            int pairs, int C, int chunk) {
  extern __shared__ int h[];                          // [C]
  for (int c = threadIdx.x; c < C; c += SORT_THREADS) h[c] = 0;
  __syncthreads();
  const int p0 = blockIdx.x * chunk, p1 = min(pairs, p0 + chunk);
  for (int p = p0 + threadIdx.x; p < p1; p += SORT_THREADS)
    atomicAdd(h + (int)sel[p], 1);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += SORT_THREADS)
    if (h[c] != 0) atomicAdd(counts + c, h[c]);
}

// 1 and 3 where C counts do not fit in a block's shared memory: one
// device-memory atomic a pair (the counts, then each pair's place)
__global__ void __launch_bounds__(SORT_THREADS)
hist_global_kernel(const long long* __restrict__ sel, int* __restrict__ counts,
                   int pairs) {
  const int stride = gridDim.x * SORT_THREADS;
  for (int p = blockIdx.x * SORT_THREADS + threadIdx.x; p < pairs; p += stride)
    atomicAdd(counts + (int)sel[p], 1);
}

__global__ void __launch_bounds__(SORT_THREADS)
scatter_global_kernel(const long long* __restrict__ sel,
                      int* __restrict__ cursor, int* __restrict__ order,
                      int pairs) {
  const int stride = gridDim.x * SORT_THREADS;
  for (int p = blockIdx.x * SORT_THREADS + threadIdx.x; p < pairs; p += stride)
    order[atomicAdd(cursor + (int)sel[p], 1)] = p;
}

// 2. one block: counts -> each component's first pair (into counts: the
// scatter's cursor) and first work item (wstart [C + 1]; wstart[C] is the
// number of items)
__global__ void __launch_bounds__(CUT_THREADS)
scan_kernel(int* __restrict__ counts, int* __restrict__ wstart, int C) {
  __shared__ int wp[32], wi[32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int cp = 0, ci = 0;           // pairs and items of the tiles before
  for (int c0 = 0; c0 < C; c0 += CUT_THREADS) {
    const int c = c0 + tid;
    const int n = c < C ? counts[c] : 0;
    const int w = (n + BP - 1) / BP;
    int sn = n, sw = w;         // inclusive scans over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(FULL, sn, o);
      const int b = __shfl_up_sync(FULL, sw, o);
      if (lane >= o) {
        sn += a;
        sw += b;
      }
    }
    if (lane == 31) {
      wp[warp] = sn;
      wi[warp] = sw;
    }
    __syncthreads();
    if (warp == 0) {            // over the 32 warps' totals
      int a = wp[lane], b = wi[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a2 = __shfl_up_sync(FULL, a, o);
        const int b2 = __shfl_up_sync(FULL, b, o);
        if (lane >= o) {
          a += a2;
          b += b2;
        }
      }
      wp[lane] = a;
      wi[lane] = b;
    }
    __syncthreads();
    if (c < C) {
      counts[c] = cp + sn - n + (warp ? wp[warp - 1] : 0);
      wstart[c] = ci + sw - w + (warp ? wi[warp - 1] : 0);
    }
    cp += wp[31];
    ci += wi[31];
    __syncthreads();            // wp and wi are rewritten by the next tile
  }
  if (tid == 0) wstart[C] = ci;
}

// 2b. the work items, a thread each: item v is the (v - wstart[c])-th of
// the last component c whose first item is <= v (components without
// items share their first item with the next)
__global__ void __launch_bounds__(SORT_THREADS)
cut_kernel(const int* __restrict__ first, const int* __restrict__ wstart,
           int4* __restrict__ items, int C, int pairs) {
  const int v = blockIdx.x * SORT_THREADS + threadIdx.x;
  if (v >= wstart[C]) return;
  int lo = 0, hi = C - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (wstart[mid] <= v) lo = mid; else hi = mid - 1;
  }
  const int j = v - wstart[lo];
  const int p0 = first[lo] + j * BP;
  const int end = lo + 1 < C ? first[lo + 1] : pairs;
  items[v] = make_int4(lo, p0, min(BP, end - p0), 0);
}

// 3. each pair's index into its component's segment: each block counts
// its chunk again, takes a run of each component's segment for it, and
// hands the run's places out by shared-memory atomics
__global__ void __launch_bounds__(SORT_THREADS)
scatter_kernel(const long long* __restrict__ sel, int* __restrict__ cursor,
               int* __restrict__ order, int pairs, int C, int chunk) {
  extern __shared__ int h[];                          // [C]
  for (int c = threadIdx.x; c < C; c += SORT_THREADS) h[c] = 0;
  __syncthreads();
  const int p0 = blockIdx.x * chunk, p1 = min(pairs, p0 + chunk);
  for (int p = p0 + threadIdx.x; p < p1; p += SORT_THREADS)
    atomicAdd(h + (int)sel[p], 1);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += SORT_THREADS)
    if (h[c] != 0) h[c] = atomicAdd(cursor + c, h[c]);
  __syncthreads();
  for (int p = p0 + threadIdx.x; p < p1; p += SORT_THREADS)
    order[atomicAdd(h + (int)sel[p], 1)] = p;
}

// Rows i_s .. i_s + rows - 1 of P_c [D][D] from a row of A into Ps
// [rows][Dp] (zero past D), 4-byte cp.async: for any D (the slow path; rows
// of A start at any word)
__device__ __forceinline__ void load_p_words(float* Ps,
                                             const float* __restrict__ src,
                                             int D, int Dp, int i_s,
                                             int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < rows; i += THREADS / 32)
    for (int j = lane; j < Dp; j += 32) {
      const bool in = i_s + i < D && j < D;
      cp_async4_zfill(Ps + i * Dp + j, in ? src + (i_s + i) * D + j : src,
                      in ? 4 : 0);
    }
}

// chunks of P a thread moves back into line at a time: the 1296 of D = 72
// in one round of 128 threads
constexpr int ALIGN_BATCH = 11;

// P_c [D][D] from a row of A into Ps flat (row stride D), for D a
// multiple of COLS (no padding), by 16-byte cp.async from the 16-byte
// boundary at or before it: P then starts `shift` words into Ps, the
// returned value. The last chunk is copied only as far as P goes.
__device__ __forceinline__ int load_p_chunks(float* Ps,
                                             const float* __restrict__ src,
                                             int D) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) / 4) % 4);
  const float* g = src - shift;             // 16-byte aligned
  const int words = D * D + shift;
  for (int q = threadIdx.x; 4 * q < words; q += THREADS)
    cp_async16_zfill(Ps + 4 * q, g + 4 * q, 4 * min(4, words - 4 * q));
  return shift;
}

// 4. one work item a block: its pairs' scores against row c of A. DC: D
// fixed at compile time (the instance for D = COLS, whose shared-memory
// offsets then fold into the loads), or 0 for any D. `strip`: rows of P a
// pass (p_rows(D): all of P at once; or STRIP, the strip form).
template <int DC>
__global__ void __launch_bounds__(THREADS, 4)
rescore_kernel(const float* __restrict__ x, const float* __restrict__ A,
               const int* __restrict__ order, const int4* __restrict__ items,
               const int* __restrict__ n_items, float* __restrict__ out,
               int K, int D_any, int E, int strip) {
  const int D = DC ? DC : D_any;
  const int total = *n_items;
  const int4 it = items[blockIdx.x];      // in the allocation either way
  if ((int)blockIdx.x >= total) return;
  const int c = it.x, first = it.y, n = it.z;
  const int Dp = (D + COLS - 1) / COLS * COLS, Di = p_rows(D);
  const int S = DC ? Di : strip;
  extern __shared__ __align__(16) float smem[];
  float* Ps = smem;                                   // [S][Dp]
  float* xs = Ps + S * Dp + 4;                        // [BP][Dp]
  float* lin = xs + BP * Dp;                          // [Dp]
  float* cst = lin + Dp;                              // [4]
  float* red = cst + 4;                               // [IW][BP]
  int* pid = reinterpret_cast<int*>(red + IW * BP);   // [BP]
  int* frm = pid + BP;                                // [BP]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Row c by cp.async while the item's pairs are read, then its frames.
  // P is kept flat (row stride D) where D is a multiple of COLS, copied in
  // 16-byte chunks from the boundary before it and moved back into line
  // below; else padded to Dp columns by 4-byte copies, and in the strip
  // form only its first strip, the rest after each strip is done.
  const float* row = A + (size_t)c * E;
  const bool flat = D == Dp && Di == D && S == Di;
  const int pstride = flat ? D : Dp;
  const int shift = flat ? load_p_chunks(Ps, row + 1 + D, D) : 0;
  if (!flat) load_p_words(Ps, row + 1 + D, D, Dp, 0, min(S, Di));
  for (int d = tid; d < Dp; d += THREADS)
    cp_async4_zfill(lin + d, row + 1 + (d < D ? d : 0), d < D ? 4 : 0);
  if (tid == 0) cp_async4_zfill(cst, row, 4);
  for (int r = tid; r < BP; r += THREADS) {
    const int p = r < n ? order[first + r] : -1;
    pid[r] = p;
    frm[r] = p < 0 ? -1 : p / K;
  }
  __syncthreads();
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int q4 = Dp / 4;                  // 16-byte chunks a frame row
    for (int idx = tid; idx < BP * q4; idx += THREADS) {
      const int r = idx / q4, d = (idx - r * q4) * 4;
      const int f = frm[r];
      const bool in = f >= 0 && d < D;
      cp_async16_zfill(xs + r * Dp + d, in ? x + (size_t)f * D + d : x,
                       in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < BP * Dp; idx += THREADS) {
      const int r = idx / Dp, d = idx - r * Dp;
      const int f = frm[r];
      const bool in = f >= 0 && d < D;
      cp_async4_zfill(xs + idx, in ? x + (size_t)f * D + d : x, in ? 4 : 0);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (shift != 0) {
    // Ps[e] = Ps[e + shift]: all of a round's chunks read, then written
    const int nq = D * D / 4;
    for (int q0 = 0; q0 < nq; q0 += THREADS * ALIGN_BATCH) {
      float4 v[ALIGN_BATCH];
#pragma unroll
      for (int b = 0; b < ALIGN_BATCH; ++b) {
        const int q = q0 + b * THREADS + tid;
        if (q < nq) {
          const float4 a = *reinterpret_cast<const float4*>(Ps + 4 * q);
          const float4 h = *reinterpret_cast<const float4*>(Ps + 4 * q + 4);
          v[b] = shift == 1   ? make_float4(a.y, a.z, a.w, h.x)
                 : shift == 2 ? make_float4(a.z, a.w, h.x, h.y)
                              : make_float4(a.w, h.x, h.y, h.z);
        }
      }
      __syncthreads();
#pragma unroll
      for (int b = 0; b < ALIGN_BATCH; ++b) {
        const int q = q0 + b * THREADS + tid;
        if (q < nq) *reinterpret_cast<float4*>(Ps + 4 * q) = v[b];
      }
      __syncthreads();
    }
  }

  // q_r = sum_j x_rj (Y_rj - 2 lin_j), Y = X P, so that out = const -
  // q / 2. Warp (rw, iw) takes rows rw*32.. and i in [iw*Di/2,
  // (iw+1)*Di/2), the -2 lin term in iw = 0. A thread: rows r0 + 4u (u =
  // 0..7), columns cg*4..+3, 32+cg*4..+3 and 64+cg of each pass; x read
  // two i at a time, the rows' float2s on distinct banks. In the strip
  // form each strip's rows i_s.. are split so, and its part of q added on.
  const int rw = warp % RW, iw = warp / RW;
  const int rg = lane >> 3, cg = lane & 7;
  const int r0 = rw * 32 + rg;
  for (int i_s = 0; i_s < Di; i_s += S) {
    if (i_s > 0) {
      __syncthreads();            // every warp is done with the last strip
      load_p_words(Ps, row + 1 + D, D, Dp, i_s, min(S, Di - i_s));
      cp_commit();
      cp_wait<0>();
      __syncthreads();
    }
    const int span = min(S, Di - i_s) / IW, i0 = iw * span;
    if (rw * 32 >= n) continue;
    for (int jc = 0; jc < Dp; jc += COLS) {
      const float* lc = lin + jc;
      float acc[8][9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int j = t < 4 ? cg * 4 + t : t < 8 ? 28 + cg * 4 + t : 64 + cg;
        const float a0 = iw == 0 && i_s == 0 ? -2.f * lc[j] : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u][t] = a0;
      }
      for (int i = i0; i < i0 + span; i += 2) {
        float2 xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          xv[u] = *reinterpret_cast<const float2*>(xs + (r0 + 4 * u) * Dp +
                                                   i_s + i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* pr = Ps + (i + h) * pstride + jc;
          const float4 pa = *reinterpret_cast<const float4*>(pr + cg * 4);
          const float4 pb = *reinterpret_cast<const float4*>(pr + 32 + cg * 4);
          const float pv[9] = {pa.x, pa.y, pa.z, pa.w, pb.x,
                               pb.y, pb.z, pb.w, pr[64 + cg]};
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float xu = h == 0 ? xv[u].x : xv[u].y;
#pragma unroll
            for (int t = 0; t < 9; ++t) acc[u][t] = fmaf(xu, pv[t], acc[u][t]);
          }
        }
      }
      float s[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* xr = xs + (r0 + 4 * u) * Dp + jc;
        const float4 xa = *reinterpret_cast<const float4*>(xr + cg * 4);
        const float4 xb = *reinterpret_cast<const float4*>(xr + 32 + cg * 4);
        const float xj[9] = {xa.x, xa.y, xa.z, xa.w, xb.x,
                             xb.y, xb.z, xb.w, xr[64 + cg]};
        s[u] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) s[u] = fmaf(xj[t], acc[u][t], s[u]);
      }
      // the 8 column groups of a row group: lanes cg = 0..7
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          s[u] += __shfl_xor_sync(FULL, s[u], o);
      if (cg == 0)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float* q = red + iw * BP + r0 + 4 * u;
          *q = jc == 0 && i_s == 0 ? s[u] : *q + s[u];
        }
    }
  }
  __syncthreads();

  for (int r = tid; r < n; r += THREADS) {
    float q = red[r];
#pragma unroll
    for (int w = 1; w < IW; ++w) q += red[w * BP + r];
    out[pid[r]] = cst[0] - 0.5f * q;
  }
}

template <int DC>
int launch_rescore(const float* x, const float* A, const int* order,
                   const int4* items, const int* n_items, float* out, int K,
                   int D, int E, const Geometry& g, cudaStream_t stream) {
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rescore_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  rescore_kernel<DC><<<(unsigned)g.max_items, THREADS, g.smem, stream>>>(
      x, A, order, items, n_items, out, K, D, E, (int)g.strip);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper's geometry (max_items, scratch_words, smem, strip) must be
// the kernel's own for these shapes, or nothing is launched.
extern "C" int gmm_rescore_f32(const float* x, const long long* sel,
                               const float* A, float* out, int* scratch,
                               int F, int K, int C, int D, int E,
                               long long max_items, long long scratch_words,
                               long long smem, long long strip, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  if (!geometry(F, K, C, D, g) || max_items != g.max_items ||
      scratch_words != g.scratch_words || smem != g.smem ||
      strip != g.strip || E < 1 + D + D * D)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || K == 0) return 0;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int pairs = F * K;
  // sort blocks: two an SM, of CHUNK_MIN pairs at least
  const long long share = (pairs + 2LL * n_sm - 1) / (2LL * n_sm);
  const int chunk =
      (int)round_up(share > CHUNK_MIN ? share : CHUNK_MIN, SORT_THREADS);
  const int sort_blocks = (pairs + chunk - 1) / chunk;
  const size_t hist_bytes = g.hist_global ? 0 : sizeof(int) * (size_t)C;
  if (hist_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hist_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)hist_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int* counts = scratch;
  int* wstart = scratch + C;
  int4* items = reinterpret_cast<int4*>(scratch + round_up(2 * C + 1, 4));
  int* order = scratch + round_up(2 * C + 1, 4) + 4 * g.max_items;
  err = cudaMemsetAsync(counts, 0, sizeof(int) * C, st);
  if (err != cudaSuccess) return (int)err;
  if (g.hist_global)
    hist_global_kernel<<<sort_blocks, SORT_THREADS, 0, st>>>(sel, counts,
                                                             pairs);
  else
    hist_kernel<<<sort_blocks, SORT_THREADS, hist_bytes, st>>>(
        sel, counts, pairs, C, chunk);
  scan_kernel<<<1, CUT_THREADS, 0, st>>>(counts, wstart, C);
  cut_kernel<<<(unsigned)((g.max_items + SORT_THREADS - 1) / SORT_THREADS),
               SORT_THREADS, 0, st>>>(counts, wstart, items, C, pairs);
  if (g.hist_global)
    scatter_global_kernel<<<sort_blocks, SORT_THREADS, 0, st>>>(
        sel, counts, order, pairs);
  else
    scatter_kernel<<<sort_blocks, SORT_THREADS, hist_bytes, st>>>(
        sel, counts, order, pairs, C, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (D == COLS && g.strip == p_rows(D))
    return launch_rescore<COLS>(x, A, order, items, wstart + C, out, K, D, E,
                                g, st);
  return launch_rescore<0>(x, A, order, items, wstart + C, out, K, D, E, g,
                           st);
}

// (BP, max_items, scratch_words, smem bytes, strip rows, histogram in
// device memory) for these shapes into out[0..5]; cudaErrorInvalidValue
// where it refuses them (kernels/gmm_rescore.geometry is checked against
// this)
extern "C" int gmm_rescore_geometry(long long F, long long K, long long C,
                                    int D, long long* out) {
  Geometry g;
  if (!geometry(F, K, C, D, g)) return (int)cudaErrorInvalidValue;
  out[0] = BP;
  out[1] = g.max_items;
  out[2] = g.scratch_words;
  out[3] = g.smem;
  out[4] = g.strip;
  out[5] = g.hist_global;
  return 0;
}
