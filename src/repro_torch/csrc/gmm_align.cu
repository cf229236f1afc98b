// Fused alignment on Hopper (sm_90a): diagonal preselection, per-frame
// top-K and the full-covariance rescore of the selected set, in one kernel.
//
// Replaces: src/repro/kernels/gmm_align.py, gmm_align (_kernel).
//
//   score[f, c] = dconst[c] + sum_d x_fd dlin[d, c] + sum_d x_fd^2 dquad[d, c]
//   sel[f, :]   = the K best components of score[f, :], best first; ties go
//                 to the lowest id; a frame with a NaN score takes C-1 in
//                 every slot (a NaN at C-1 alone: C-1 in slot 0, then the
//                 best K-1 of the others); a slot past the frame's scores
//                 above -inf takes id 0 -- all as the TPU kernel's masked
//                 argmax passes give it (ref.argmax_topk)
//   ll[f, k]    = xe_f . A2[sel[f, k]],  xe_f = [1 | x_f | w (x_fi x_fj)_{i<=j}]
//
// x [F, D] f32; dconst [C], dlin and dquad [D, C] f32 (ubm.diag_coeffs);
// A2 [C, E2] f32 packed-symmetric rows [const | lin | -0.5 triu(P)]
// (ref.align_pack), E2 = 1 + D + D(D+1)/2. Out: ll [F, K] f32, sel [F, K]
// int64. With sel_in given, the selection is read from it instead and only
// the rescore runs (ops.gmm_rescore_fused).
//
// Why not the TPU design: it gathers the BF*K selected rows of a frame tile
// into fast memory at once (8 x 20 rows of 10.8 KB at D = 72: 1.73 MB,
// against the 227 KB of shared memory a block may have) and extracts each
// slot's score with a one-hot matmul. Those served the TPU's DMA engine
// and matrix unit, not an SM.
//
// Bound on the H100: operations by the card's table, 2*F*C*(2D+1) +
// 2*F*K*E2 FLOPs. Two limits lie above it: the preselect's 2*F*C*D FMAs on
// the f32 pipe, and the rescore's F*K rows of 10.8 KB read from L2 (the 22
// MB pack stays resident in the 50 MB L2): 3.5 GB at F = 16,384, K = 20.
//
// The previous kernel held 8 frames' full score rows and expansions in 151
// KB of shared memory (one block of 8 warps an SM), read every diag
// coefficient once per 8 frames, took K serial argmax passes per frame and
// streamed each selected row with 4 loads in flight a lane. Design:
//   1. Preselect as a register-tiled SIMT product. A block takes 64 frames
//      and walks the components in chunks of 128; [dlin; dquad] slabs of 8
//      d-rows stream through a 3-stage cp.async ring, the frames' x stays
//      in shared memory (d-major), and each thread keeps 4 frames x 8
//      components of sums in registers. Each score is summed as before:
//      the lin and quad sums apart, each over d ascending, then
//      (k0 + a) + b -- so a chunk's scores are bitwise those of the
//      previous kernel and the selection cannot drift. No tensor cores:
//      TF32 is off in this port (repro_torch.resolve_device).
//   2. Streaming top-K. Each frame keeps a best-K list, best first (lane k
//      of a warp holds entry k). After each chunk, warp w takes its 8
//      frames: the chunk's scores that beat the K-th entry are appended to
//      the frame's 32-slot buffer, one ballot a 32 scores; a buffer that
//      would overflow, and at the end the rest, is sorted by a warp bitonic
//      network and joined to the list by a bitonic merge. The order is
//      (score descending, id ascending), so ties go to the lowest id in
//      whatever order the chunks come; the NaN rule is applied when the
//      list is written. Only the lists, the buffers and one [64, 128]
//      chunk of scores live on chip; the scores never reach device memory.
//      A slot whose list entry is -inf is written as id 0: once every
//      remaining score is -inf, a masked-argmax pass (the TPU kernel's, and
//      this kernel's whole-row instance) takes the first id of a row that is
//      -inf throughout. Inserting each
//      entrant into the list on its own, tried first, was slower on the
//      card; merging 4 frames at once with their networks interleaved, or
//      delaying one block's merges by half a chunk (so that the two blocks
//      of an SM would not merge at the same moments), was no faster.
//   3. Rescore with the expansion formed on the fly. A warp takes a frame
//      and 8 of its slots at a time: each lane forms xe_e = xr[i0] xr[i1]
//      from the frame's [x | 1 | 2x | 1] row and a pair table in shared
//      memory, and adds xe_e times the 8 rows' element e: 32 row loads in
//      flight a lane, ~64 KB a SM, which is what reading from L2 needs
//      (more than a cp.async ring would hold in the shared memory left).
//      Each slot's sum runs over e = lane (mod 32) ascending, then a
//      shuffle tree (16, 8, 4, 2, 1): bitwise repeatable. Grouping the
//      rescore by component id would read each distinct row once per tile,
//      but a 64-frame tile's 1280 (frame, slot) pairs name ~70% distinct
//      ids on the synthetic frames, and grouping would give up the
//      expansion shared by a frame's slots; not taken.
// With K > 32 (train_ubm with top_k=0 asks K = C), a block keeps 16
// frames' whole score rows in shared memory instead, or 8 where 16 rows do
// not fit (the product still runs 16 frame slots; the other 8 read zeros
// and are not stored), and takes K argmax passes, as the previous kernel
// did; its ids go straight to sel.
//
// Shared memory: the streaming instance 109 KB at D = 72 (ring 24 KB, x 18
// KB, the chunk's scores 32 KB, lists and buffers 33 KB), 2 blocks (16
// warps) a SM: at F = 16,384 its 256 blocks fill the 264 slots in one wave
// (a third block a SM would need <= 85 registers a thread against the
// product's 64 sums). The rescore reuses it: the pair table and the
// frames' rows, 48 KB. The rows instance: 160 KB at C = 2048, D = 72 with
// 16 frames and at C = 4096 with 8, one block a SM; 8 frames reach C =
// 6272 at D = 72. `geometry` (below) sets the instance and the shared
// memory for the launch and for kernels/gmm_align.geometry's check
// (gmm_align_geometry). Frames past F are masked (x reads zero, nothing
// is written).
//
// Two forms past those, each taken only where the ones above do not fit:
//   wide phase B (D >= 235 at 64 frames: the pair table of E2 words and
//     the frames' rows outgrow a block, 527 KB of table alone at D = 512):
//     the rescore reads the pair table from device memory
//     (kernels/gmm_align.pair_table, the wrapper's, L2-resident; a warp's
//     32 lanes read 32 neighbouring codes, one 128-byte line) and each
//     warp keeps only the row of the frame it is rescoring, written by the
//     warp itself before each frame. Shared memory no longer grows with D
//     in phase B (8 rows of 2D + 2 words); phase A fits up to D = 552.
//   spill (K > STREAM_K where no whole-row block fits: C > 6272 at D =
//     72, train_ubm's top_k=0 asks K = C), three launches:
//     1. the preselect of design 1 (64-frame blocks) writes each chunk's
//        scores to a [F, Cp] scratch in device memory (Cp = C rounded up
//        to NC; 537 MB at F = 16,384, C = 8,192) instead of merging them;
//     2. select_kernel, one block a frame, picks its K exactly: scores
//        become order-preserving uint32 keys (NaN above every score, -0
//        as +0), a radix select over 8-bit digits, most significant first
//        (4 histogram passes over the row, for K < C), finds the K-th key
//        T and how many keys equal to T to take, the lowest ids first; a
//        compaction writes the winners in id order; then a stable LSD
//        radix sort of the K (4 passes, each digit descending) puts them
//        best first, equal keys in id order, so ties go to the lowest id
//        as everywhere above. The NaN rule is the one above: a NaN below
//        C-1 writes C-1 to every slot, a NaN at C-1 alone sorts first. A
//        slot whose key is -inf's takes id 0. Its plain version is
//        kernels/gmm_align.select_topk;
//     3. the rescore alone (the streaming instance given the selection).
//     The scratch (scores, then two [F, K] key and id buffers) is the
//     wrapper's (kernels/gmm_align.spill_words).
//   The rescore alone at K > SLOT_SPLIT (the spill form's, at K up to C)
//   also splits its grid over runs of SLOT_SPLIT slots (blockIdx.y), so
//   that a few frames still fill the card: at F = 128, K = C = 65,536 the
//   64-frame blocks alone were 2. At K <= SLOT_SPLIT the grid is as
//   before.
#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 256;
constexpr int NC = 128;         // components per chunk
constexpr int BKD = 8;          // d-rows per coefficient slab
constexpr int STAGES = 3;       // slabs in flight
constexpr unsigned FULL = 0xffffffffu;
constexpr int STREAM_K = 32;    // the largest K of the streaming merge
constexpr int MAX_SMEM = 232448;
constexpr int SEL_THREADS = 256;  // select_kernel: one thread a digit
constexpr int SLOT_SPLIT = 256;   // slots a block of the rescore alone
constexpr unsigned KEY_NINF = 0x007fffffu;   // order_key(-inf)

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__device__ inline bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// One compare-exchange step of a bitonic network over a warp, one (v, i) a
// lane: lanes j apart meet, and in a descending block the lower lane keeps
// the better of the two
__device__ __forceinline__ void bitonic_step(float& v, int& i, int j,
                                             bool desc, int lane) {
  const float ov = __shfl_xor_sync(FULL, v, j);
  const int oi = __shfl_xor_sync(FULL, i, j);
  const bool lower = (lane & j) == 0;
  if (lower == desc ? better(ov, oi, v, i) : better(v, i, ov, oi)) {
    v = ov;
    i = oi;
  }
}

// Merge a frame's buffer of n candidates (shared memory) into its list
// (lane k holds entry k, best first; past K, entries that cannot return):
// sort the buffer best first, keep the better of list entry k and buffer
// entry 31-k -- a bitonic sequence of the best 32 of both -- and merge it.
__device__ __forceinline__ void flush(float& v_l, int& i_l, const float* bv,
                                      const int* bi, int n, int lane) {
  __syncwarp();
  float v = lane < n ? bv[lane] : -INFINITY;
  int i = lane < n ? bi[lane] : INT_MAX;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
      bitonic_step(v, i, j, (lane & k) == 0, lane);
  const float rv = __shfl_sync(FULL, v, 31 - lane);
  const int ri = __shfl_sync(FULL, i, 31 - lane);
  if (better(rv, ri, v_l, i_l)) {
    v_l = rv;
    i_l = ri;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) bitonic_step(v_l, i_l, j, true, lane);
  __syncwarp();                 // the buffer may be refilled
}

// Shared memory in 4-byte words, for BF = 16 FM frame slots of the
// product of which a block keeps `rows`. Phase A (preselect and top-K): the
// slab ring [STAGES][2][BKD][NC], x d-major [Dp][BF], then either the
// chunk's scores [BF][NC], the lists [BF][STREAM_K] (values, ids), NaN
// flags [BF], the candidate buffers [BF][32] (values, ids) and their counts
// [BF], or the whole score rows [rows][Cp], or, in the spill form,
// nothing. Phase B (rescore), from word 0: the pair table [E2] and the
// frames' rows [rows][2D + 2], or, wide, a row a warp [8][2D + 2]; none in
// the spill form's preselect.
inline size_t smem_words(int C, int D, int E2, int FM, bool stream,
                         int rows, bool wide, bool spill) {
  const int BF = 16 * FM;
  const size_t a = (size_t)STAGES * 2 * BKD * NC +
                   (size_t)round_up(D, BKD) * BF +
                   (spill    ? 0
                    : stream ? (size_t)BF * NC + 4 * BF * STREAM_K + 2 * BF
                             : (size_t)rows * round_up(C, NC));
  const size_t b = spill ? 0
                   : wide ? (size_t)(THREADS / 32) * (2 * D + 2)
                          : (size_t)round_up(E2, 4) +
                                (size_t)rows * (2 * D + 2);
  return a > b ? a : b;
}

// The instance and its blocks for these shapes: the streaming one (FM = 4,
// 64 frames) for K <= STREAM_K and for the rescore alone, else whole score
// rows (FM = 1) for 16 frames a block, or 8 where 16 rows do not fit; each
// with phase B's pair table in shared memory, else wide. Past those, for
// K > STREAM_K, the spill form: `rows` and `smem` are its preselect's,
// `wide` its rescore's. False where none fits.
struct Geometry {
  bool stream;
  bool spill;
  bool wide;                    // phase B's pair table in device memory
  int rows;                     // frames a block keeps
  size_t smem;                  // bytes
};

inline bool geometry(int C, int D, int K, bool rescore_only, Geometry& g) {
  const int E2 = 1 + D + D * (D + 1) / 2;
  g.stream = rescore_only || K <= STREAM_K;
  g.spill = false;
  for (int w = 0; w < 2; ++w) {
    g.wide = w == 1;
    for (g.rows = g.stream ? 64 : 16; g.rows >= 8; g.rows /= 2) {
      g.smem = sizeof(float) * smem_words(C, D, E2, g.stream ? 4 : 1,
                                          g.stream, g.rows, g.wide, false);
      if (g.smem <= (size_t)MAX_SMEM) return true;
      if (g.stream) break;
    }
  }
  if (g.stream) return false;
  Geometry r;
  if (!geometry(C, D, K, true, r)) return false;
  g.spill = true;
  g.wide = r.wide;
  g.rows = 64;
  g.smem = sizeof(float) * smem_words(C, D, E2, 4, false, 64, false, true);
  return g.smem <= (size_t)MAX_SMEM;
}

// The rescore of G slots k0.. of one frame: ll[f, k0 + j] = xe_f . A2[id_j]
template <int G>
__device__ __forceinline__ void rescore_slots(
    const float* __restrict__ A2, const long long* ids, const int* pair,
    const float* xf, float* __restrict__ ll, size_t fk, int k0, int E2,
    int lane) {
  const float* row[G];
#pragma unroll
  for (int j = 0; j < G; ++j) row[j] = A2 + (size_t)ids[fk + k0 + j] * E2;
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;
  int e = lane;
  for (; e + 96 < E2; e += 128) {
    float xv[4], av[4][G];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) av[u][j] = __ldg(row[j] + e + 32 * u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = pair[e + 32 * u];
      xv[u] = xf[p & 0xffff] * xf[p >> 16];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = fmaf(xv[u], av[u][j], acc[j]);
  }
  for (; e < E2; e += 32) {
    const int p = pair[e];
    const float xv = xf[p & 0xffff] * xf[p >> 16];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = fmaf(xv, __ldg(row[j] + e), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[j] += __shfl_xor_sync(FULL, acc[j], o);
    if (lane == j) ll[fk + k0 + j] = acc[j];
  }
}

// FM frames a thread in the product (BF = 16 FM frame slots); STREAM: the
// streaming merge (K <= STREAM_K, rows = BF), else whole score rows of the
// first `rows` slots; WIDE: phase B reads the pair table pair_g from device
// memory, a row a warp; SPILL: phase A alone, the scores to `scores` [F,
// Cp] (rows = BF).
template <int FM, bool STREAM, bool WIDE = false, bool SPILL = false>
__global__ void __launch_bounds__(THREADS, STREAM || SPILL ? 2 : 1)
gmm_align_kernel(const float* __restrict__ x, const float* __restrict__ dconst,
                 const float* __restrict__ dlin,
                 const float* __restrict__ dquad,
                 const float* __restrict__ A2, const int* __restrict__ pair_g,
                 const long long* sel_in, float* __restrict__ ll,
                 long long* sel, float* __restrict__ scores, int F, int C,
                 int D, int K, int E2, int rows) {
  constexpr int BF = 16 * FM;
  const int R = STREAM ? BF : rows;   // frames the block keeps
  const int FPW = R / 8;          // frames a warp in the top-K and rescore
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * R;
  const long long* ids = sel_in;              // where the rescore reads

  if (sel_in == nullptr) {
    const int Dp = round_up(D, BKD);
    const int Cp = round_up(C, NC);
    float* ring = smem;                             // [STAGES][2][BKD][NC]
    float* xt = ring + STAGES * 2 * BKD * NC;             // [Dp][BF]
    float* sc = xt + Dp * BF;                       // [BF][NC] or [R][Cp]
    float* lv = sc + BF * NC;                             // [BF][STREAM_K]
    int* li = reinterpret_cast<int*>(lv + BF * STREAM_K); // [BF][STREAM_K]
    int* nanf = li + BF * STREAM_K;                       // [BF]
    float* bufv = reinterpret_cast<float*>(nanf + BF);    // [BF][32]
    int* bufi = reinterpret_cast<int*>(bufv + BF * 32);   // [BF][32]
    int* nbuf = bufi + BF * 32;                           // [BF]
    const int nsd = Dp / BKD;
    const int nslab = (Cp / NC) * nsd;
    const bool vec = (C % 4) == 0;

    // slab s = (chunk, d-block) into ring stage `stage`: BKD rows of dlin,
    // then BKD rows of dquad, NC components each; rows past D and
    // components past C read zero
    auto load_slab = [&](int s, int stage) {
      const int chunk = s / nsd;
      const int d0 = (s - chunk * nsd) * BKD, c0 = chunk * NC;
      float* dst = ring + stage * 2 * BKD * NC;
      if (vec) {
#pragma unroll
        for (int i = 0; i < 2 * BKD * NC / 4 / THREADS; ++i) {
          const int idx = tid + i * THREADS;
          const int r = idx / (NC / 4), c = (idx % (NC / 4)) * 4;
          const int d = d0 + r % BKD;
          const bool in = d < D && c0 + c < C;
          const float* src =
              in ? (r < BKD ? dlin : dquad) + (size_t)d * C + c0 + c : dlin;
          cp_async16_zfill(dst + r * NC + c, src, in ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < 2 * BKD * NC; idx += THREADS) {
          const int r = idx / NC, c = idx % NC;
          const int d = d0 + r % BKD;
          const bool in = d < D && c0 + c < C;
          const float* src =
              in ? (r < BKD ? dlin : dquad) + (size_t)d * C + c0 + c : dlin;
          cp_async4_zfill(dst + r * NC + c, src, in ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nslab) load_slab(s, s);
      cp_commit();
    }

    for (int idx = tid; idx < Dp * BF; idx += THREADS) {
      const int d = idx / BF, r = idx - d * BF;
      const int f = f0 + r;
      xt[idx] = (r < R && f < F && d < D) ? x[(size_t)f * D + d] : 0.f;
    }
    if (STREAM) {
      for (int idx = tid; idx < BF * STREAM_K; idx += THREADS) {
        lv[idx] = -INFINITY;
        li[idx] = INT_MAX;
      }
      for (int r = tid; r < BF; r += THREADS) nanf[r] = nbuf[r] = 0;
    }

    // the thread's FM frames fr.. and 8 components cc..cc+3, cc+32..cc+35
    // of the chunk: a warp is 4 frame groups x 8 component groups, so each
    // operand's float4 reads are one wavefront
    const int fr = (warp & 3) * 4 * FM + (lane >> 3) * FM;
    const int cc = (warp >> 2) * 64 + (lane & 7) * 4;
    float a[FM][8], b[FM][8];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) a[i][j] = b[i][j] = 0.f;

    // merge chunk c0..c0+NC-1 of the scores in sc into the lists of warp
    // `warp`'s frames: the candidates that beat a frame's K-th entry go
    // to its buffer; a buffer that would overflow is merged in first
    auto merge = [&](int c0) {
      for (int q = 0; q < FPW; ++q) {
        const int r = warp * FPW + q;
        if (f0 + r >= F) break;
        float v_l = lane < K ? lv[r * STREAM_K + lane] : -INFINITY;
        int i_l = lane < K ? li[r * STREAM_K + lane] : INT_MAX;
        float tv = __shfl_sync(FULL, v_l, K - 1);
        int ti = __shfl_sync(FULL, i_l, K - 1);
        float* bv = bufv + r * 32;
        int* bi = bufi + r * 32;
        int n = nbuf[r];
        unsigned nan_bits = 0;
#pragma unroll
        for (int rr = 0; rr < NC / 32; ++rr) {
          const int c = c0 + rr * 32 + lane;
          const float v = sc[r * NC + rr * 32 + lane];
          const bool in = c < C;
          if (in && isnan(v)) nan_bits |= (c == C - 1) ? 2u : 1u;
          unsigned m = __ballot_sync(FULL, in && better(v, c, tv, ti));
          if (n + __popc(m) > 32) {
            flush(v_l, i_l, bv, bi, n, lane);
            n = 0;
            tv = __shfl_sync(FULL, v_l, K - 1);
            ti = __shfl_sync(FULL, i_l, K - 1);
            m = __ballot_sync(FULL, in && better(v, c, tv, ti));
          }
          if ((m >> lane) & 1u) {
            const int pos = n + __popc(m & ((1u << lane) - 1u));
            bv[pos] = v;
            bi[pos] = c;
          }
          n += __popc(m);
        }
        nan_bits = __reduce_or_sync(FULL, nan_bits);
        if (lane < K) {
          lv[r * STREAM_K + lane] = v_l;
          li[r * STREAM_K + lane] = i_l;
        }
        if (lane == 0) {
          nbuf[r] = n;
          nanf[r] |= (int)nan_bits;
        }
      }
    };

    for (int s = 0; s < nslab; ++s) {
      cp_wait<STAGES - 2>();      // slab s has landed (this thread's copies)
      __syncthreads();            // everyone's, and slab s-1's stage is free
      const int nx = s + STAGES - 1;
      if (nx < nslab) load_slab(nx, nx % STAGES);
      cp_commit();
      const int chunk = s / nsd, d0 = (s - chunk * nsd) * BKD;
      const float* lin_s = ring + (s % STAGES) * 2 * BKD * NC;
      const float* quad_s = lin_s + BKD * NC;
#pragma unroll
      for (int k = 0; k < BKD; ++k) {
        float xv[FM];
        if constexpr (FM == 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&xt[(d0 + k) * BF + fr]);
          xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
        } else {
#pragma unroll
          for (int i = 0; i < FM; ++i) xv[i] = xt[(d0 + k) * BF + fr + i];
        }
        const float4 l0 =
            *reinterpret_cast<const float4*>(&lin_s[k * NC + cc]);
        const float4 l1 =
            *reinterpret_cast<const float4*>(&lin_s[k * NC + cc + 32]);
        const float4 q0 =
            *reinterpret_cast<const float4*>(&quad_s[k * NC + cc]);
        const float4 q1 =
            *reinterpret_cast<const float4*>(&quad_s[k * NC + cc + 32]);
        const float l[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const float q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const float x2 = xv[i] * xv[i];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            a[i][j] = fmaf(xv[i], l[j], a[i][j]);
            b[i][j] = fmaf(x2, q[j], b[i][j]);
          }
        }
      }
      if (d0 + BKD < Dp) continue;              // the chunk is not complete

      // the chunk's scores: (k0 + a) + b, as the plain version's products
      const int c0 = chunk * NC;
      float k0[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + cc + (j < 4 ? j : 28 + j);
        k0[j] = c < C ? __ldg(dconst + c) : 0.f;
      }
      float* dst = SPILL    ? scores + (size_t)f0 * Cp + c0
                   : STREAM ? sc
                            : sc + c0;
      const int ld = STREAM ? NC : Cp;
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if (!STREAM && fr + i >= R) break;      // a slot the block drops
        if (SPILL && f0 + fr + i >= F) break;   // past F: not written
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = (k0[j] + a[i][j]) + b[i][j];
          a[i][j] = b[i][j] = 0.f;
        }
        float* row = dst + (size_t)(fr + i) * ld + cc;
        *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(row + 32) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
      if (STREAM) {
        __syncthreads();
        merge(c0);
      }
    }

    if (SPILL) {
      cp_wait<0>();               // only empty groups are left
      return;                     // select_kernel picks from the scores
    }
    if (STREAM) {
      // the last buffers merged, the lists with the NaN rule to sel (each
      // warp reads its own frames)
      __syncwarp();
      for (int q = 0; q < FPW; ++q) {
        const int r = warp * FPW + q, f = f0 + r;
        if (f >= F) break;
        float v_l = lane < K ? lv[r * STREAM_K + lane] : -INFINITY;
        int i_l = lane < K ? li[r * STREAM_K + lane] : INT_MAX;
        const int n = nbuf[r];
        if (n > 0) flush(v_l, i_l, bufv + r * 32, bufi + r * 32, n, lane);
        const int nb = nanf[r];
        // past the scores above -inf, id 0 (a masked-argmax pass over a row
        // that is -inf throughout takes its first id)
        const int i_w = v_l == -INFINITY ? 0 : i_l;
        const int prev = __shfl_up_sync(FULL, i_w, 1);
        int id = (nb & 2) ? (lane == 0 ? C - 1 : prev) : i_w;
        if (nb & 1) id = C - 1;
        if (lane < K) sel[(size_t)f * K + lane] = min(id, C - 1);
      }
    } else {
      // K argmax passes over each whole score row (the previous kernel's
      // top-K): the first index attaining the max; a pass that meets a NaN
      // takes C-1
      __syncthreads();
      for (int q = 0; q < FPW; ++q) {
        const int r = warp * FPW + q, f = f0 + r;
        if (f >= F) break;
        float* s = sc + r * Cp;
        for (int k = 0; k < K; ++k) {
          float bv = -INFINITY;
          int bi = C;
          bool nan = false;
          for (int c = lane; c < C; c += 32) {
            const float v = s[c];
            nan |= isnan(v);
            if (better(v, c, bv, bi)) { bv = v; bi = c; }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(FULL, bv, o);
            const int oi = __shfl_xor_sync(FULL, bi, o);
            if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
          }
          nan = __any_sync(FULL, nan);
          if (nan || bi >= C) bi = C - 1;
          __syncwarp();
          if (lane == 0) {
            s[bi] = -INFINITY;
            sel[(size_t)f * K + k] = bi;
          }
          __syncwarp();
        }
      }
    }
    cp_wait<0>();                 // only empty groups are left; none writes
    ids = sel;
  }
  // sel's writes are visible to the block, and phase A's memory is free
  __syncthreads();

  // phase B: the pair table, pair[e] = i0 | i1 << 16 with xe_e = xr[i0]
  // xr[i1] over a frame's row xr = [x | 1 | 2x | 1]: e = 0 is 1 x 1,
  // e = 1 + d is x_d x 1, pair (i <= j) at 1 + D + i*D - i(i-1)/2 + (j - i)
  // is x_i x_j on the diagonal and x_i (2 x_j) off it -- both exactly
  // what expand_quadratic gives. WIDE: the same table from pair_g
  // (kernels/gmm_align.pair_table), and a warp's row at word warp * XR.
  int* pair_s = reinterpret_cast<int*>(smem);
  const int* pair = WIDE ? pair_g : pair_s;
  const int XR = 2 * D + 2;
  float* xr = WIDE ? smem + warp * XR : smem + round_up(E2, 4);  // [R][XR]
  if (!WIDE) {
    for (int e = tid; e < 1 + D; e += THREADS)
      pair_s[e] = (e == 0 ? D : e - 1) | D << 16;
    for (int idx = tid; idx < D * D; idx += THREADS) {
      const int i = idx / D, j = idx - (idx / D) * D;
      if (j >= i)
        pair_s[1 + D + i * D - i * (i - 1) / 2 + (j - i)] =
            i | (i == j ? j : D + 1 + j) << 16;
    }
    for (int idx = tid; idx < R * (D + 1); idx += THREADS) {
      const int r = idx / (D + 1), d = idx - r * (D + 1);
      const int f = f0 + r;
      const float v = d == D ? 1.f : (f < F ? x[(size_t)f * D + d] : 0.f);
      xr[r * XR + d] = v;
      xr[r * XR + D + 1 + d] = d == D ? 1.f : 2.f * v;
    }
  }
  __syncthreads();

  // warp w rescores its frames' slots k_lo.. (the block's run of them),
  // 8 slots at a time, then 4, then 1
  const int k_lo = blockIdx.y * SLOT_SPLIT;
  const int k_hi = gridDim.y == 1 ? K : min(K, k_lo + SLOT_SPLIT);
  for (int q = 0; q < FPW; ++q) {
    const int r = warp * FPW + q, f = f0 + r;
    if (f >= F) break;
    if (WIDE) {
      __syncwarp();               // the warp's last frame is scored
      for (int d = lane; d <= D; d += 32) {
        const float v = d == D ? 1.f : x[(size_t)f * D + d];
        xr[d] = v;
        xr[D + 1 + d] = d == D ? 1.f : 2.f * v;
      }
      __syncwarp();
    }
    const float* xf = WIDE ? xr : xr + r * XR;
    const size_t fk = (size_t)f * K;
    int k0 = k_lo;
    for (; k0 + 8 <= k_hi; k0 += 8)
      rescore_slots<8>(A2, ids, pair, xf, ll, fk, k0, E2, lane);
    if (k0 + 4 <= k_hi) {
      rescore_slots<4>(A2, ids, pair, xf, ll, fk, k0, E2, lane);
      k0 += 4;
    }
    for (; k0 < k_hi; ++k0)
      rescore_slots<1>(A2, ids, pair, xf, ll, fk, k0, E2, lane);
  }
}

// A score's key: larger keys for better scores, as unsigned integers; NaN
// above every score, -0 as +0 (they compare equal as scores)
__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The spill form's selection, one block a frame: from scores [F, Cp] (the
// preselect's) the frame's K best ids, best first, into sel [F, K]; work:
// keys and ids [F, K] twice, as uint32 / int32 (A keys, A ids, B keys, B
// ids). Design: the header, spill 2.
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ scores, int* __restrict__ work,
              long long* __restrict__ sel, int F, int C, int Cp, int K) {
  static_assert(SEL_THREADS == 256, "one thread a digit");
  constexpr int NW = SEL_THREADS / 32;
  __shared__ int hist[256];
  __shared__ int wcnt[NW][256];
  __shared__ int wsum[2][NW];
  __shared__ int sh_digit, sh_need;
  const int f = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned lt = (1u << lane) - 1u;
  const float* s = scores + (size_t)f * Cp;
  const size_t FK = (size_t)F * K;
  unsigned* keys = reinterpret_cast<unsigned*>(work);
  unsigned* ka = keys + (size_t)f * K;
  int* ia = work + FK + (size_t)f * K;
  unsigned* kb = keys + 2 * FK + (size_t)f * K;
  int* ib = work + 3 * FK + (size_t)f * K;
  long long* out = sel + (size_t)f * K;

  // a NaN below C-1: C-1 in every slot
  bool nan_low = false;
  for (int c = tid; c < C - 1; c += SEL_THREADS) nan_low |= isnan(s[c]);
  if (__syncthreads_or(nan_low)) {
    for (int k = tid; k < K; k += SEL_THREADS) out[k] = C - 1;
    return;
  }

  // radix select, most significant digit first: T the K-th key, `need`
  // the keys equal to T to take (K = C takes every key)
  unsigned T = 0, mask = 0;
  int need = 0;
  if (K < C) {
    need = K;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += SEL_THREADS) hist[b] = 0;
      __syncthreads();
      for (int c = tid; c < C; c += SEL_THREADS) {
        const unsigned k = order_key(s[c]);
        if ((k & mask) == T) atomicAdd(&hist[(k >> shift) & 255], 1);
      }
      __syncthreads();
      if (tid == 0) {
        int cum = 0, b = 255;
        for (; b > 0 && cum + hist[b] < need; --b) cum += hist[b];
        sh_digit = b;
        sh_need = need - cum;
      }
      __syncthreads();
      T |= (unsigned)sh_digit << shift;
      mask |= 255u << shift;
      need = sh_need;
    }
  }

  // the winners in id order into A: keys above T, and the first `need`
  // keys equal to T
  int seen_eq = 0, taken = 0;
  for (int c0 = 0; c0 < C; c0 += SEL_THREADS) {
    const int c = c0 + tid;
    const unsigned k = c < C ? order_key(s[c]) : 0u;
    const bool gt = c < C && (K >= C || k > T);
    const bool eq = c < C && K < C && k == T;
    const unsigned beq = __ballot_sync(FULL, eq);
    if (lane == 0) wsum[0][warp] = __popc(beq);
    __syncthreads();
    int eq_before = seen_eq + __popc(beq & lt), eq_tile = 0;
    for (int w = 0; w < NW; ++w) {
      if (w < warp) eq_before += wsum[0][w];
      eq_tile += wsum[0][w];
    }
    const bool take = gt || (eq && eq_before < need);
    const unsigned bt = __ballot_sync(FULL, take);
    if (lane == 0) wsum[1][warp] = __popc(bt);
    __syncthreads();
    int pos = taken + __popc(bt & lt), t_tile = 0;
    for (int w = 0; w < NW; ++w) {
      if (w < warp) pos += wsum[1][w];
      t_tile += wsum[1][w];
    }
    if (take) {
      ka[pos] = k;
      ia[pos] = c;
    }
    seen_eq += eq_tile;
    taken += t_tile;
    __syncthreads();              // wsum is rewritten by the next tile
  }

  // stable LSD radix sort of the K, 8-bit digits, each pass descending:
  // A -> B -> A -> B -> sel, where a key of -inf writes id 0
  for (int p = 0; p < 4; ++p) {
    const unsigned* sk = (p & 1) ? kb : ka;
    const int* si = (p & 1) ? ib : ia;
    unsigned* dk = (p & 1) ? ka : kb;
    int* di = (p & 1) ? ia : ib;
    const int shift = 8 * p;
    for (int b = tid; b < 256; b += SEL_THREADS) hist[b] = 0;
    __syncthreads();              // and the last pass's writes are seen
    for (int i = tid; i < K; i += SEL_THREADS)
      atomicAdd(&hist[(sk[i] >> shift) & 255], 1);
    __syncthreads();
    if (warp == 0) {              // hist[d] = the keys of digits above d
      int v[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = hist[255 - (lane * 8 + j)];
        sum += v[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      int run = incl - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        hist[255 - (lane * 8 + j)] = run;
        run += v[j];
      }
    }
    __syncthreads();
    for (int i0 = 0; i0 < K; i0 += SEL_THREADS) {
      const int i = i0 + tid;
      const bool valid = i < K;
      const unsigned k = valid ? sk[i] : 0u;
      const int id = valid ? si[i] : 0;
      const int d = valid ? (int)((k >> shift) & 255u) : 256 + lane;
      const unsigned peers = __match_any_sync(FULL, d);
      const int rank = __popc(peers & lt);     // same digit, lower lanes
      for (int b = tid; b < NW * 256; b += SEL_THREADS) (&wcnt[0][0])[b] = 0;
      __syncthreads();
      if (valid && rank == 0) wcnt[warp][d] = __popc(peers);
      __syncthreads();
      {                           // thread d: the tile's places of digit d
        int run = hist[tid];
        for (int w = 0; w < NW; ++w) {
          const int n = wcnt[w][tid];
          wcnt[w][tid] = run;
          run += n;
        }
        hist[tid] = run;
      }
      __syncthreads();
      if (valid) {
        const int at = wcnt[warp][d] + rank;
        if (p == 3) {
          out[at] = k == KEY_NINF ? 0 : id;
        } else {
          dk[at] = k;
          di[at] = id;
        }
      }
      __syncthreads();            // wcnt is rewritten by the next tile
    }
  }
}

template <int FM, bool STREAM, bool WIDE = false, bool SPILL = false>
int launch_instance(const float* x, const float* dconst, const float* dlin,
                    const float* dquad, const float* A2, const int* pair,
                    const long long* sel_in, float* ll, long long* sel,
                    float* scores, int F, int C, int D, int K, int E2,
                    const Geometry& g, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_align_kernel<FM, STREAM, WIDE, SPILL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  // the rescore alone: a block a run of SLOT_SPLIT slots too
  const dim3 blocks((F + g.rows - 1) / g.rows,
                    sel_in ? (K + SLOT_SPLIT - 1) / SLOT_SPLIT : 1);
  gmm_align_kernel<FM, STREAM, WIDE, SPILL><<<blocks, THREADS, g.smem,
                                              (cudaStream_t)stream>>>(
      x, dconst, dlin, dquad, A2, pair, sel_in, ll, sel, scores, F, C, D, K,
      E2, g.rows);
  return (int)cudaGetLastError();
}

// the rescore alone (or the streaming instance), narrow or wide
int launch_stream(const float* x, const float* dconst, const float* dlin,
                  const float* dquad, const float* A2, const int* pair,
                  const long long* sel_in, float* ll, long long* sel, int F,
                  int C, int D, int K, int E2, const Geometry& g,
                  void* stream) {
  if (g.wide)
    return launch_instance<4, true, true>(x, dconst, dlin, dquad, A2, pair,
                                          sel_in, ll, sel, nullptr, F, C, D,
                                          K, E2, g, stream);
  return launch_instance<4, true>(x, dconst, dlin, dquad, A2, pair, sel_in,
                                  ll, sel, nullptr, F, C, D, K, E2, g,
                                  stream);
}

// pair: kernels/gmm_align.pair_table(D) (read where the geometry is wide;
// may be NULL elsewhere); scratch: kernels/gmm_align.spill_words(F, C, K)
// int32 words (the spill form's; may be NULL elsewhere)
int launch(const float* x, const float* dconst, const float* dlin,
           const float* dquad, const float* A2, const int* pair,
           int* scratch, const long long* sel_in, float* ll, long long* sel,
           int F, int C, int D, int K, int E2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F == 0 || K == 0) return 0;
  if (E2 != 1 + D + D * (D + 1) / 2 || 2 * D + 2 > 0xffff)
    return (int)cudaErrorInvalidValue;
  if (sel_in == nullptr && K > C) return (int)cudaErrorInvalidValue;
  // the rescore alone runs with the streaming instance's blocks, so the
  // whole kernel and its rescore are timed like for like
  Geometry g;
  if (!geometry(C, D, K, sel_in != nullptr, g) ||
      (g.wide && pair == nullptr) || (g.spill && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (g.spill) {
    const int Cp = round_up(C, NC);
    float* scores = reinterpret_cast<float*>(scratch);
    err = (cudaError_t)launch_instance<4, false, false, true>(
        x, dconst, dlin, dquad, A2, pair, nullptr, ll, sel, scores, F, C, D,
        K, E2, g, stream);
    if (err != cudaSuccess) return (int)err;
    select_kernel<<<F, SEL_THREADS, 0, (cudaStream_t)stream>>>(
        scores, scratch + (size_t)F * Cp, sel, F, C, Cp, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    Geometry r;
    geometry(C, D, K, true, r);
    return launch_stream(x, dconst, dlin, dquad, A2, pair, sel, ll, nullptr,
                         F, C, D, K, E2, r, stream);
  }
  if (g.stream)
    return launch_stream(x, dconst, dlin, dquad, A2, pair, sel_in, ll, sel,
                         F, C, D, K, E2, g, stream);
  if (g.wide)
    return launch_instance<1, false, true>(x, dconst, dlin, dquad, A2, pair,
                                           sel_in, ll, sel, nullptr, F, C, D,
                                           K, E2, g, stream);
  return launch_instance<1, false>(x, dconst, dlin, dquad, A2, pair, sel_in,
                                   ll, sel, nullptr, F, C, D, K, E2, g,
                                   stream);
}

}  // namespace

extern "C" int gmm_align_f32(const float* x, const float* dconst,
                             const float* dlin, const float* dquad,
                             const float* A2, const int* pair, int* scratch,
                             float* ll, long long* sel, int F, int C, int D,
                             int K, int E2, int device, void* stream) {
  return launch(x, dconst, dlin, dquad, A2, pair, scratch, nullptr, ll, sel,
                F, C, D, K, E2, device, stream);
}

// (frames a block keeps, streaming instance?, shared-memory bytes, spill
// form?, wide phase B?) of the launch for these shapes into out[0..4];
// cudaErrorInvalidValue where they do not fit (kernels/gmm_align.geometry
// is checked against this)
extern "C" int gmm_align_geometry(int C, int D, int K, int rescore_only,
                                  int* out) {
  Geometry g;
  if (!geometry(C, D, K, rescore_only != 0, g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.rows;
  out[1] = g.stream ? 1 : 0;
  out[2] = (int)g.smem;
  out[3] = g.spill ? 1 : 0;
  out[4] = g.wide ? 1 : 0;
  return 0;
}

// the shared memory a block of this card may opt in to
// (cudaDevAttrMaxSharedMemoryPerBlockOptin) into out[0]: the budget
// chip_smoke.py holds the kernel registry's geometry against
extern "C" int device_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" int gmm_rescore_fused_f32(const float* x, const long long* sel_in,
                                     const float* A2, const int* pair,
                                     float* ll, int F, int C, int D, int K,
                                     int E2, int device, void* stream) {
  return launch(x, nullptr, nullptr, nullptr, A2, pair, nullptr, sel_in, ll,
                nullptr, F, C, D, K, E2, device, stream);
}
