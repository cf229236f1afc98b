// Dense Baum-Welch moments on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bw_stats.py, bw_stats (_kernel).
//
//   n[c]        = sum_f G[f, c]
//   f[c, d]     = sum_f G[f, c] x[f, d]
//   S[c, i*D+j] = sum_f G[f, c] x[f, i] x[f, j]
//
// G [F, C] posteriors, x [F, D], all f32; n [C], f [C, D], S [C, D*D] f32.
//
// Bound on the H100: operations. As one SGEMM out[c, e] = sum_f G[f, c]
// X2[f, e] over the E = P + D + 1 extended columns, P = D(D+1)/2: X2[f, e]
// is x_i x_j for the e-th upper-triangle pair i <= j (row-major, as
// ref._quad_pairs orders them), then x_d, then 1 (which gives n). That is
// 2*F*C*E FLOPs against F*C + F*D floats read and C*(D*D + D + 1) written:
// at D = 72 some 1,350 FLOPs per byte of G. Without tensor cores (the
// contract is full f32) the ceiling is the CUDA cores' f32 FMA rate.
//
// Design: gmm_loglik.cu's pipelined SGEMM with the operands' roles
// swapped. Each block owns one tile of 128 components x 128 e-columns and
// walks one run of its frames (below). G's [16 frames x 128 components]
// slabs are 16 rows of 512 contiguous bytes, and come with the slab's x
// rows through a 4-stage ring of 16-byte cp.async copies (zero-filled past
// the run's frames and past C). X2 is never read from memory: the block
// loads its 128 columns' entries of the wrapper's pair table
// (kernels/bw_stats.pair_table: i0 | i1 << 16, with x's row extended by a
// 1 at column D and a 0 at D+1) into shared memory at its start, and forms
// each 16 x 128 slab of X2 = x_i0 x_i1 from the slab's x rows -- the next
// slab while the current one multiplies, with one barrier per slab -- so the
// [F, D*D] expansion never reaches device memory, the property of the TPU
// kernel worth keeping. Each thread holds an 8 x 8 tile of sums and reads
// its operands as float4 from shared memory. Two blocks share an SM.
//
// Frames a component tile never sees are skipped. Γ comes from top-K
// alignments (K = 20 of C = 2048, fewer after a posterior floor), so in
// most frames a 128-component tile holds only zeros. A first pass
// (bw_tile_flags, one warp per 512-byte row segment, Γ read once) flags
// each (frame, tile) with a non-zero Γ; bw_tile_lists turns each tile's
// flags, by a block-wide prefix sum in frame order, into the list of its
// frames. The main kernel then walks its tile's list, gathering those Γ
// row segments and x rows by index with the same 16-byte copies. A
// skipped frame adds exactly zero to every sum of the tile (0 * x = 0 for
// finite x), so the function is the same on every finite input; a dense Γ
// lists every frame. The entry point takes null lists to walk every frame.
//
// The 22 x 16 tiles of the paper's width fill 352 of the card's 264 block
// slots (1.33 waves), so each tile's frames are cut into `nsplit` equal
// runs (kernels/bw_stats.splits picks the count that fills the waves best)
// and every block writes its partial sums, densely, to part[run][c][e].
// bw_stats_finish then adds the runs in run order and scatters each
// column: S's pairs to both halves (S is exactly symmetric), x_d's to f,
// the ones column's to n. No partial sum crosses blocks any other way: no
// atomics, and every output is summed in one fixed order (the result is
// bitwise repeatable).
//
// Two forms; `pairs_form` (below) picks one for D, bw_stats_geometry
// exports it for kernels/bw_stats.geometry's check:
//   rows (D a multiple of 4 up to 252, the paper's D = 72 among them): the
//     design above. Each slab brings whole x rows (D + 2 floats a frame)
//     to form 128 columns, which is cheap at D = 72, and two blocks share
//     an SM up to D = 252.
//   pairs (every other D, up to MAX_D): the columns tile S's upper
//     triangle in two dimensions. x's D indices are cut into blocks of PB
//     = 16; a block of the kernel owns PM = 64 components x one (I, J)
//     pair of index blocks, I <= J: the PN = 256 columns x_i x_j, i in I,
//     j in J (i <= j on the diagonal tiles, whose other 120 slots carry f
//     -- x_i times a ones column -- and, in the first, n). Each slab
//     brings Γ's 64-component row segments and x at only the 2 x 16
//     indices of I and J, by 4-byte cp.async copies at any D (zero past
//     D), so x's traffic no longer grows with D and a block's shared
//     memory does not depend on D: 82,944 bytes, two blocks an SM. Γ's
//     16-byte copies depend only on C and Γ's alignment. The table
//     (kernels/bw_stats.pairs_table) holds each column's (i, j), i == D
//     for the ones column and D + 1 for an unused slot; a tile's first
//     column is the pair of its blocks' first indices, which is where the
//     block finds I and J. 64-component tiles also lower the share of
//     (frame, tile) pairs that a top-K Γ touches (random top-20 of 2048:
//     0.47, against 0.72 at 128). The unused slots of the diagonal tiles
//     and of a ragged last index block cost 5-6% of the columns at D =
//     255 and 256, 2.5% at 512.
// Both forms write part[run][c][e] and the same finishing pass scatters
// each used column by its code; neither has atomics, and two calls are
// bitwise equal.
//
// The codes' 16-bit fields index x's row up to MAX_D (8-bit fields had
// capped D at 254, and the rows form's x rows cap it at 710).
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                 // components per block
constexpr int BN = 128;                 // extended columns per block
constexpr int BK = 16;                  // frames per slab
constexpr int STAGES = 4;               // (G, x) slabs in flight
constexpr int THREADS = 256;            // 16 x 16, 8 x 8 outputs each
constexpr int MAX_SMEM = 232448;
constexpr int MAX_D = 4095;             // 16-bit codes, Ep well inside int
// the pairs form for D: every D but the multiples of 4 up to 252
__host__ __device__ inline bool pairs_form(int D) {
  return D % 4 != 0 || D > 252;
}

__host__ __device__ inline int xs_ld(int D) { return (D + 2 + 3) / 4 * 4; }

__host__ __device__ inline int stage_floats(int D) {
  return BK * BM + BK * xs_ld(D);
}

__host__ __device__ inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)STAGES * stage_floats(D) + 2 * BK * BN) +
         sizeof(int) * (BN + STAGES * BK);
}

// frames per split: n frames in `splits` runs of a multiple of BK
// (kernels/bw_stats.split_len)
__device__ inline int split_len(int n, int splits) {
  return ((n + splits - 1) / splits + BK - 1) / BK * BK;
}

// flags[t * Fp + f] = 1 if any of G[f, tw t .. tw t + tw - 1] is non-zero
// (tw: the form's component tile, 128 or 64): one warp per (frame, tile),
// a 512- or 256-byte row segment
__global__ void bw_tile_flags(const float* __restrict__ G,
                              unsigned char* __restrict__ flags, int F,
                              int Fp, int C, int T, int tw) {
  const int lane = threadIdx.x % 32;
  const long long w0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const long long nw = (long long)gridDim.x * blockDim.x / 32;
  for (long long w = w0; w < (long long)F * T; w += nw) {
    const int f = (int)(w / T), t = (int)(w - (long long)f * T);
    bool any = false;
    for (int q = 0; q < tw / 32; ++q) {
      const int c = t * tw + q * 32 + lane;
      any |= c < C && G[(size_t)f * C + c] != 0.f;
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flags[(size_t)t * Fp + f] = any;
  }
}

// One block per tile: the flagged frames in frame order into list[t * Fp
// ..], their number into count[t]. A block-wide prefix sum over 4,096
// frames at a time.
constexpr int LIST_THREADS = 1024;
__global__ void __launch_bounds__(LIST_THREADS)
bw_tile_lists(const unsigned char* __restrict__ flags, int* __restrict__ list,
              int* __restrict__ count, int F, int Fp) {
  __shared__ int warp_sum[LIST_THREADS / 32];
  const unsigned char* fl = flags + (size_t)blockIdx.x * Fp;
  int* out = list + (size_t)blockIdx.x * Fp;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int base = 0;
  for (int f0 = 0; f0 < F; f0 += 4 * LIST_THREADS) {
    const int f = f0 + 4 * tid;
    int mine[4], n = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mine[q] = f + q < F && fl[f + q];
      n += mine[q];
    }
    int incl = n;   // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += v;
      }
      warp_sum[lane] = w;   // inclusive over warps
    }
    __syncthreads();
    int pos = base + (warp ? warp_sum[warp - 1] : 0) + incl - n;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (mine[q]) out[pos++] = f + q;
    base += warp_sum[LIST_THREADS / 32 - 1];
    __syncthreads();   // warp_sum is rewritten next round
  }
  if (tid == 0) count[blockIdx.x] = base;
}

// list: null (every frame, in order) or the frame lists of bw_tile_lists
// (list[t * Fp + j], count[t], t the block's component tile)
__global__ void __launch_bounds__(THREADS, 2)
bw_stats_kernel(const float* __restrict__ G, const float* __restrict__ x,
                const int* __restrict__ table, const int* __restrict__ list,
                const int* __restrict__ count, float* __restrict__ part,
                int F, int Fp, int C, int D, int Ep, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int XLD = xs_ld(D);
  const int SF = stage_floats(D);
  float* ring = smem;                           // [STAGES][G slab | x slab]
  float* Bs = ring + STAGES * SF;               // [2][BK][BN]: X2 slabs
  int* pairs = reinterpret_cast<int*>(Bs + 2 * BK * BN);   // [BN]
  int* fids = pairs + BN;                       // [STAGES][BK]: slab frames

  const int tid = threadIdx.x;
  // a warp is 4 x 8 threads: its float4 reads of each operand's slab row
  // span 64 and 128 bytes, one shared-memory wavefront each
  const int tx = (tid / 32) % 2 * 8 + tid % 8;
  const int ty = (tid / 64) * 4 + (tid % 32) / 8;
  const int e0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;
  // this split's run [j_lo, j_hi) of the tile's frames, in frame order; a
  // tile that lists every frame walks them without the list
  const int n_frames = list ? count[blockIdx.y] : F;
  const int* frames =
      n_frames < F ? list + (size_t)blockIdx.y * Fp : nullptr;
  const int per = split_len(n_frames, gridDim.z);
  const int j_lo = blockIdx.z * per;
  const int j_hi = min(n_frames, j_lo + per);
  const int nslab = j_hi > j_lo ? (j_hi - j_lo + BK - 1) / BK : 0;
  // the frame of run position j, or -1 past the run
  auto frame = [&](int j) {
    return j < j_hi ? (frames ? frames[j] : j) : -1;
  };

  // x slab rows carry a 1 at column D and a 0 at D + 1 (the table's codes
  // for n's column and for columns past E); the copies never touch them
  for (int idx = tid; idx < STAGES * BK; idx += THREADS) {
    float* row = ring + (idx / BK) * SF + BK * BM + (idx % BK) * XLD;
    row[D] = 1.f;
    row[D + 1] = 0.f;
  }
  for (int e = tid; e < BN; e += THREADS) pairs[e] = table[e0 + e];

  // the frames of a slab's rows reach shared memory (fids) one slab before
  // its copies are issued, so no copy waits on a read of the list
  for (int idx = tid; idx < STAGES * BK; idx += THREADS)
    fids[idx] = frame(j_lo + idx);
  __syncthreads();

  auto load = [&](int slab, int st) {
    float* gs = ring + st * SF;
    float* xs = gs + BK * BM;
    const int* fs = fids + st * BK;
#pragma unroll
    for (int i = 0; i < BK * BM / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / (BM / 4), m = (idx % (BM / 4)) * 4;
      const int f = fs[k], c = c0 + m;
      const int valid = f >= 0 ? max(0, min(4, C - c)) : 0;
      const float* src = valid ? G + (size_t)f * C + c : G;
      if (vec) {
        cp_async16_zfill(gs + k * BM + m, src, 4 * valid);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) gs[k * BM + m + j] = j < valid ? src[j] : 0.f;
      }
    }
    if (vec) {   // D % 4 == 0: D/4 chunks a row
      const int cpr = D / 4;
      for (int idx = tid; idx < BK * cpr; idx += THREADS) {
        const int k = idx / cpr, d = (idx - k * cpr) * 4;
        const int f = fs[k];
        cp_async16_zfill(xs + k * XLD + d, f >= 0 ? x + (size_t)f * D + d : x,
                         f >= 0 ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BK * D; idx += THREADS) {
        const int k = idx / D, d = idx - k * D;
        const int f = fs[k];
        xs[k * XLD + d] = f >= 0 ? x[(size_t)f * D + d] : 0.f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_commit();
  }
  __syncthreads();   // the pair table and the constant x columns

  // this thread forms X2 column bn = tid % BN at slab rows tid / BN + 2r
  const int bn = tid % BN;
  const int code = pairs[bn];
  const int i0 = code & 0xffff, i1 = code >> 16;
  auto form_x2 = [&](int slab, int buf) {
    const float* xs = ring + (slab % STAGES) * SF + BK * BM;
    float* dst = Bs + buf * BK * BN;
#pragma unroll
    for (int r = tid / BN; r < BK; r += THREADS / BN)
      dst[r * BN + bn] = xs[r * XLD + i0] * xs[r * XLD + i1];
  };
  if (nslab > 0) {
    cp_wait<STAGES - 2>();   // slab 0
    __syncthreads();
    form_x2(0, 0);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 3>();   // slab s + 1 has landed (this thread's copies)
    __syncthreads();         // everyone's; X2 slab s formed; slab s-1 free
    const int nx = s + STAGES - 1;
    if (nx < nslab) load(nx, nx % STAGES);
    cp_commit();
    // slab s + STAGES's frames: read now, stored after the products (its
    // ids take slab s's place, which no thread reads any more)
    const int pf = tid < BK ? frame(j_lo + (s + STAGES) * BK + tid) : 0;
    if (s + 1 < nslab) form_x2(s + 1, (s + 1) & 1);
    const float* a_s = ring + (s % STAGES) * SF;
    const float* b_s = Bs + (s & 1) * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k * BM + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[k * BM + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[k * BN + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[k * BN + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (tid < BK) fids[(s % STAGES) * BK + tid] = pf;
  }

  // partial sums, dense: part[split][c][e], rows of Ep (a multiple of BN)
  float* out = part + (size_t)blockIdx.z * C * Ep;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (c >= C) continue;
    float* row = out + (size_t)c * Ep + e0;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// The pairs form (see the header)
namespace pairs {

constexpr int PM = 64;                  // components per block
constexpr int PB = 16;                  // x indices an index block
constexpr int PN = PB * PB;             // columns per block (= THREADS)
constexpr int PX = 2 * PB + 1;          // x slab columns: I, J, the ones
constexpr int STAGES = 8;               // (Γ, x) slabs in flight

// columns: a tile for each (I, J) of ceil(D / PB) index blocks, I <= J
__host__ __device__ inline int columns(int D) {
  const int nb = (D + PB - 1) / PB;
  return nb * (nb + 1) / 2 * PN;
}

__host__ __device__ inline size_t smem_bytes() {
  return sizeof(float) * ((size_t)STAGES * (BK * PM + BK * PX) +
                          2 * BK * PN) +
         sizeof(int) * STAGES * BK;
}

// The pairs form's main pass: as bw_stats_kernel, with blocks of PM
// components x one (I, J) tile of PN columns (see the header).
__global__ void __launch_bounds__(THREADS, 2)
bw_pairs_kernel(const float* __restrict__ G, const float* __restrict__ x,
                const int* __restrict__ table, const int* __restrict__ list,
                const int* __restrict__ count, float* __restrict__ part,
                int F, int Fp, int C, int D, int Ep, bool gvec) {
  constexpr int SF = BK * PM + BK * PX;         // floats a stage
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                           // [STAGES][G slab | x slab]
  float* Bs = ring + STAGES * SF;              // [2][BK][PN]: X2 slabs
  int* fids = reinterpret_cast<int*>(Bs + 2 * BK * PN);   // [STAGES][BK]

  const int tid = threadIdx.x;
  // a warp is 4 x 8 threads: its float4 reads of each operand's slab row
  // span 64 and 128 bytes, one shared-memory wavefront each
  const int lane = tid % 32, warp = tid / 32;
  const int ty = (warp / 4) * 4 + lane / 8;     // components ty*4, 32 + ty*4
  const int tx = (warp % 4) * 8 + lane % 8;     // columns tx*4, 128 + tx*4
  const int e0 = blockIdx.x * PN;
  const int c0 = blockIdx.y * PM;
  // the tile's index blocks I and J, from its first column's pair
  const int code0 = table[e0];
  const int ib = code0 & 0xffff, jb = code0 >> 16;
  // this thread forms column tid: x slab operands p and q (0..15 I, 16..31
  // J, 32 the ones); an unused slot forms x_ib^2 and is never read
  const int code = table[e0 + tid];
  const int ci = code & 0xffff, cj = code >> 16;
  int p = 0, q = 0;
  if (ci <= D) {
    p = ci == D ? 2 * PB : ci - ib;
    q = cj == D ? 2 * PB : cj - jb + PB;
  }
  const int n_frames = list ? count[blockIdx.y] : F;
  const int* frames =
      n_frames < F ? list + (size_t)blockIdx.y * Fp : nullptr;
  const int per = split_len(n_frames, gridDim.z);
  const int j_lo = blockIdx.z * per;
  const int j_hi = min(n_frames, j_lo + per);
  const int nslab = j_hi > j_lo ? (j_hi - j_lo + BK - 1) / BK : 0;
  auto frame = [&](int j) {
    return j < j_hi ? (frames ? frames[j] : j) : -1;
  };

  // the ones column of every stage's x slab; the copies never touch it
  for (int idx = tid; idx < STAGES * BK; idx += THREADS)
    ring[(idx / BK) * SF + BK * PM + (idx % BK) * PX + 2 * PB] = 1.f;
  for (int idx = tid; idx < STAGES * BK; idx += THREADS)
    fids[idx] = frame(j_lo + idx);
  __syncthreads();

  auto load_pairs = [&](int slab, int st) {
    float* gs = ring + st * SF;
    float* xs = gs + BK * PM;
    const int* fs = fids + st * BK;
    if (gvec) {   // one 16-byte copy a thread: 16 frames x 16 chunks
      const int k = tid / (PM / 4), m = (tid % (PM / 4)) * 4;
      const int f = fs[k], c = c0 + m;
      const int valid = f >= 0 ? max(0, min(4, C - c)) : 0;
      cp_async16_zfill(gs + k * PM + m, valid ? G + (size_t)f * C + c : G,
                       4 * valid);
    } else {
#pragma unroll
      for (int i = 0; i < BK * PM / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / PM, m = idx % PM;
        const int f = fs[k], c = c0 + m;
        const bool ok = f >= 0 && c < C;
        cp_async4_zfill(gs + k * PM + m, ok ? G + (size_t)f * C + c : G,
                        ok ? 4 : 0);
      }
    }
    // x at I's and J's indices, zero past D and past the run
#pragma unroll
    for (int i = 0; i < BK * 2 * PB / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / (2 * PB), l = idx % (2 * PB);
      const int d = l < PB ? ib + l : jb + l - PB;
      const int f = fs[k];
      const bool ok = f >= 0 && d < D;
      cp_async4_zfill(xs + k * PX + l, ok ? x + (size_t)f * D + d : x,
                      ok ? 4 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load_pairs(s, s);
    cp_commit();
  }

  auto form_pairs = [&](int slab, int buf) {
    const float* xs = ring + (slab % STAGES) * SF + BK * PM;
    float* dst = Bs + buf * BK * PN;
#pragma unroll
    for (int r = 0; r < BK; ++r)
      dst[r * PN + tid] = xs[r * PX + p] * xs[r * PX + q];
  };
  if (nslab > 0) {
    cp_wait<STAGES - 2>();   // slab 0
    __syncthreads();
    form_pairs(0, 0);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 3>();  // slab s + 1 has landed (this thread's copies)
    __syncthreads();         // everyone's; X2 slab s formed; slab s-1 free
    const int nx = s + STAGES - 1;
    if (nx < nslab) load_pairs(nx, nx % STAGES);
    cp_commit();
    const int pf = tid < BK ? frame(j_lo + (s + STAGES) * BK + tid) : 0;
    if (s + 1 < nslab) form_pairs(s + 1, (s + 1) & 1);
    const float* a_s = ring + (s % STAGES) * SF;
    const float* b_s = Bs + (s & 1) * BK * PN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k * PM + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[k * PM + 32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[k * PN + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[k * PN + 128 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (tid < BK) fids[(s % STAGES) * BK + tid] = pf;
  }

  float* out = part + (size_t)blockIdx.z * C * Ep;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
    if (c >= C) continue;
    float* row = out + (size_t)c * Ep + e0;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 128 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace pairs

// The splits added in split order, each used column scattered by its
// code (both forms' tables).
__global__ void bw_stats_finish(const float* __restrict__ part,
                                const int* __restrict__ table,
                                float* __restrict__ n_out,
                                float* __restrict__ f_out,
                                float* __restrict__ S_out, int nsplit, int C,
                                int D, int Ep) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)C * Ep) return;
  const int c = (int)(idx / Ep), e = (int)(idx - (size_t)c * Ep);
  const int code = table[e];
  const int i0 = code & 0xffff, i1 = code >> 16;
  if (i0 > D) return;   // an unused column
  float v = 0.f;
  for (int z = 0; z < nsplit; ++z) v += part[((size_t)z * C + c) * Ep + e];
  if (i0 == D) {
    n_out[c] = v;
  } else if (i1 == D) {
    f_out[(size_t)c * D + i0] = v;
  } else {
    float* S = S_out + (size_t)c * D * D;
    S[i0 * D + i1] = v;
    if (i0 != i1) S[i1 * D + i0] = v;
  }
}

}  // namespace

// table: kernels/bw_stats.table(D), Ep entries (the rows form's
// pair_table or the pairs form's pairs_table); part: [nsplit, C, Ep]
// scratch. flags (uint8), list (int32): [T, Fp] scratch and count [T], T
// = ceil(C / the form's component tile), or all three null to walk every
// frame.
extern "C" int bw_stats_f32(const float* G, const float* x, const int* table,
                            float* part, unsigned char* flags, int* list,
                            int* count, float* n, float* f, float* S, int F,
                            int Fp, int C, int D, int Ep, int nsplit,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const bool use_pairs = pairs_form(D);
  const int E = D * (D + 1) / 2 + D + 1;
  const int want_ep = use_pairs ? pairs::columns(D) : (E + BN - 1) / BN * BN;
  const bool compact = list != nullptr;
  if (Ep != want_ep || nsplit < 1 || Fp < F ||
      compact != (flags != nullptr) || compact != (count != nullptr))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const size_t smem = use_pairs ? pairs::smem_bytes() : smem_bytes(D);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      use_pairs ? (const void*)pairs::bw_pairs_kernel : (const void*)bw_stats_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool gvec = C % 4 == 0 && (uintptr_t)G % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tw = use_pairs ? pairs::PM : BM;
  const int T = (C + tw - 1) / tw;
  if (compact) {
    bw_tile_flags<<<132 * 8, 256, 0, s>>>(G, flags, F, Fp, C, T, tw);
    bw_tile_lists<<<T, LIST_THREADS, 0, s>>>(flags, list, count, F, Fp);
  }
  if (use_pairs) {
    const dim3 grid(Ep / pairs::PN, T, nsplit);
    pairs::bw_pairs_kernel<<<grid, THREADS, smem, s>>>(
        G, x, table, list, count, part, F, Fp, C, D, Ep, gvec);
  } else {
    const bool vec = gvec && (uintptr_t)x % 16 == 0;   // D % 4 == 0 here
    const dim3 grid(Ep / BN, T, nsplit);
    bw_stats_kernel<<<grid, THREADS, smem, s>>>(G, x, table, list, count,
                                                part, F, Fp, C, D, Ep, vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)C * Ep;
  bw_stats_finish<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part, table, n, f, S, nsplit, C, D, Ep);
  return (int)cudaGetLastError();
}

// The launch for D into out[0..4]: the pairs form?, a block's shared-memory
// bytes, its components, the columns Ep, and the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, on the current device);
// cudaErrorInvalidValue where D is out of range
// (kernels/bw_stats.geometry is checked against this)
extern "C" int bw_stats_geometry(int D, int* out) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const bool use_pairs = pairs_form(D);
  const size_t smem = use_pairs ? pairs::smem_bytes() : smem_bytes(D);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const void* k =
      use_pairs ? (const void*)pairs::bw_pairs_kernel : (const void*)bw_stats_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const int E = D * (D + 1) / 2 + D + 1;
  out[0] = use_pairs ? 1 : 0;
  out[1] = (int)smem;
  out[2] = use_pairs ? pairs::PM : BM;
  out[3] = use_pairs ? pairs::columns(D) : (E + BN - 1) / BN * BN;
  out[4] = blocks;
  return 0;
}
