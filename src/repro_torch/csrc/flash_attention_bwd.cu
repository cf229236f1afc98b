// Causal GQA flash attention, backward pass, on Hopper (sm_90a).
//
// Replaces: the derivative of src/repro/kernels/flash_attention.py,
// flash_attention (_kernel). The TPU kernel is forward only; the JAX package
// trains through jnp autodiff of its blockwise attention
// (src/repro/models/layers.py, blockwise_causal_attention), which keeps each
// block's probabilities. This is the derivative of the forward kernel in
// flash_attention.cu, recomputed tile by tile from the forward's row
// log-sum-exps:
//
//   P_ij  = exp(s q_i . k_j - lse_i)            (0 above the diagonal)
//   dV_j  = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j,   Delta_i = dO_i . o_i
//   dS_ij = P_ij (dP_ij - Delta_i)
//   dQ_i  = s sum_j dS_ij k_j,   dK_j = s sum_i dS_ij q_i
//
// with s = hd^-1/2 and, under GQA, dK and dV of a kv head summed over the
// G = H / KVH query heads that read it. q, o, dO, dQ [B, S, H, hd], k, v,
// dK, dV [B, S, KVH, hd], all in the input type (f32 or bf16); lse and
// Delta [B, H, S] f32.
//
// Bound on the H100: operations. Five products over the causal half
// (Q.K^T again, dO.V^T, P^T.dO, dS^T.Q, dS.K): 5 * 2 * B*H*hd*S^2/2 FLOPs
// against (4 B S H + 4 B S KVH) hd elements and the lse moved.
//
// Three kernels a call (four with a head split), no atomics, so
// the gradients are the same bits on every run: delta_kernel (one warp per
// (b, row, head), Delta = dO . o summed by a shuffle tree), then a dQ
// kernel, then a dK/dV kernel, both of which read Delta. Dispatch by input
// type and head dim (not a fallback): bf16 on the tensor cores at every
// head dim 1 to 512, each on the instance of its width (64, 128 or 256,
// namespace tc, or 512, namespace wide; 129 to 192 on the width-256 one:
// the TMA's zeros past the head dim add nothing to any product, and the
// stores skip those columns), f32 at every head dim on the CUDA cores
// (namespace simt, below). On the tensor cores the maps' row stride ld is
// a multiple of 8 (the TMA's 16-byte strides, the paired bf16 stores'
// alignment): at any other head dim the bf16 entry stages q, k, v, o and dO in buffers ld =
// ceil8(hd) columns wide, zeros past hd (restride.cuh, in a scratch the
// wrapper allocates), and narrows dQ, dK and dV, which the kernels write
// ld wide; the maps' extent and the scale come from hd.
//
// Precision contract of the tensor-core kernels:
//   - Exact products. Q, K, V and dO enter wgmma as the bf16 values they
//     are, so S = Q.K^T and dP = dO.V^T are exact up to the order of their
//     f32 summation.
//   - P and dS as hi/lo pairs. They are f32 values; each enters its product
//     (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K) as hi = bf16(x), lo =
//     bf16(x - hi): two wgmma into the same f32 accumulator, as the
//     forward does for p. The pair holds x to about 2^-16.
//   - f32 arithmetic. Every accumulator, the exponentials (ex2 of the
//     scaled score less lse, both in log2 units) and Delta are f32; each
//     result is rounded to bf16 once, at its store.
//   - No single-bf16 P or dS (FlashAttention-2/3 style): that would add up
//     to 2^-9 to each term, against a 2^-7 limit that the output's own
//     rounding already half fills.
//   - Cost: the split takes 3 of the 5 products twice, and each kernel
//     recomputes S and dP, so the kernels issue 10 products where the bound
//     counts 5 (14 at hd 256, below).
//
// tc, the dQ kernel (dq_tc_kernel): one block per (128 query rows, head,
// batch; at hd 256 see below), longest rows first: two consumer
// warpgroups of 64 rows and one producer warp, the forward's layout. The
// producer loads the block's q and dO tiles once and a ring of STAGES (k,
// v) tiles of 64 keys by TMA (4-d maps over [B, S, heads, hd], 128-byte
// swizzle, mbarriers; rows past S arrive as zeros). Per key tile up to the
// diagonal: S = Q.K^T and dP = dO.V^T (wgmma, both operands K-major in
// shared memory), P and dS on the accumulator fragments (masks only on the
// tile that crosses the diagonal or S; a row's lse and Delta in registers
// for the whole block), then dQ += dS.K with dS's hi and lo as register A
// fragments (the accumulator layout is the A fragment layout) and K
// MN-major from shared memory.
//
// tc, the dK/dV kernel (dkdv_tc_kernel): one block per (128 key rows, kv
// head, batch; at hd 256 see below), the key tile that sees the most
// queries first: two consumer warpgroups of 64 key rows and a producer
// warpgroup, of which one thread loads the block's k and v tiles once,
// then walks the group's query heads in order and, for each, the query
// tiles from the diagonal on, feeding the q and dO tiles through a ring.
// With the key rows as M, S^T = K.Q^T and dP^T = V.dO^T come out in the
// accumulator layout, so P^T and dS^T are register A fragments as they
// are: dV += P^T.dO and dK += dS^T.Q, with dO and Q MN-major from shared
// memory. GQA's sum over the group is a fixed-order sum in the block. A query column's lse and
// Delta come from global memory (L2) with the tile. Query tiles are 64
// rows at hd 64 and 32 at hd 128, so that S^T, dP^T and the four fragment
// sets fit beside the two hd-wide accumulators (128 f32 registers a
// thread at hd 128).
//
// Registers: ptxas gives a block of more than 256 threads at most 168
// registers a thread (it allocates by warpgroup: 65,536 / 384). With one
// producer warp (288 threads, as the dQ kernel and the forward) the dK/dV
// kernel spilled at both head dims, and at hd 128 ptxas serialized its
// wgmma (C7512). The producer is therefore a whole warpgroup that gives
// its registers back (setmaxnreg.dec to 24) and the consumers take them
// (setmaxnreg.inc to 240): no spill, the same bits, and a faster kernel
// on the card (PERF.md §6). The dQ kernel fits in 168 registers
// and gained nothing from the same change.
//
// tc at hd 256 (Gemma 2B, and 129 to 255; DqLayout::SPLIT and
// KvLayout::SPLIT), the
// forward's answer to the same wall: a warpgroup's hd-wide f32
// accumulators (128 registers a thread for dQ, 256 for dK and dV) do not
// fit beside the score fragments. So a block takes SPLIT_ROWS = 64 rows,
// both consumer warpgroups compute the same scores (the same bits in both)
// and each holds half of the gradients' columns:
//   - dQ: S = Q.K^T and dP = dO.V^T over 64-key tiles, then dQ[:, half] +=
//     dS.K[:, half], an n128 product over its half of K's columns (64 x 128
//     f32, 64 registers). With S, dP and the dS pair that is 160
//     registers before any address or mask, against the 168 of a
//     288-thread block, so the producer is a warpgroup that gives its
//     registers back, as in the dK/dV kernel. The q and dO tiles take 64
//     KB and a (k, v) stage 64 KB: a ring of DQ_SPLIT_STAGES = 2 (197,672
//     bytes).
//   - dK/dV: S^T = K.Q^T and dP^T = V.dO^T over 32-row query tiles, then
//     dV[:, half] += P^T.dO[:, half] and dK[:, half] += dS^T.Q[:, half]:
//     64 + 64 accumulator registers, the hd-128 instance's count. k and v
//     take 64 KB and the 4-stage (q, dO) ring 128 KB (197,704 bytes).
//   - Parallelism under MQA: a (key tile, kv head, batch) grid gives
//     Gemma's B = 1, S = 4096, KVH = 1 64 blocks for 132 SMs, each walking
//     all 8 query heads. The grid is (key tile, kv head x split, batch)
//     instead: a block walks G / nsplit of its group's query heads in
//     order and writes its partial dK and dV in f32 to a workspace [2]
//     [nsplit][B, S, KVH, hd]; sum_splits_kernel then adds the partials in
//     split order and rounds each sum once to bf16. No atomics, so the
//     same bits every run; with nsplit = 1 the kernel stores bf16 itself.
//     The caller picks nsplit (kernels/flash_attention.py, bwd_splits):
//     the smallest divisor of G up to 8 that brings the grid to 256
//     blocks, about two an SM. chip_smoke.py's sweep of 1, 2, 4 and 8 at
//     Gemma's S = 4096 (H100 80GB HBM3, 700 W; PERF.md §6) put the best
//     at 4 for B = 1 (0.946 ms against 2.391 at 1) and at 1 for B = 4,
//     its training micro-batch, whose 256 unsplit blocks fill the card
//     (3.529 ms against 4.019 at 8).
//   - Both kernels number their blocks longest first (longest_first): the
//     linear block index walks every (head or split, batch) of the first
//     tile before any of the second, so the blocks with the most work
//     start first. In blockIdx order (the hd-64/128 kernels') the last
//     head's or split's longest tiles start when most of the grid is done
//     and run on alone: chip_smoke.py at Gemma's S = 4096 (H100 80GB
//     HBM3, 700 W; PERF.md §6) took 1.229 ms at B = 1 and 4.151 at B = 4
//     in that order, 0.919 and 3.551 longest first.
// The split recomputes S and dP (S^T and dP^T) in both warpgroups: the
// kernels issue 14 products where the bound counts 5 (10 at hd 64, 128).
//
// Each consumer warpgroup runs its products and their pointwise work in
// turn; the other warpgroup's products overlap that work. This is the
// simple tensor-core design.
//
// wide, hd 257 to 512 (one instance of width 512, the hd-256 design taken
// further): the q and dO tiles of a dQ block, or the k and v tiles of a
// dK/dV block, 64 rows x 512 each, stay in shared memory (128 KB), since S
// and dP run over every column. A warpgroup's registers hold 64 x 128
// f32 of a gradient beside the score fragments, so each gradient's 512
// columns split over a grid axis of SLICES = 2 column slices and, inside
// a slice, over the two warpgroups, which both compute the block's S and
// dP (the same bits) and each hold 128 columns (dK's and dV's: 128 + 128
// accumulator registers, as at hd 256). Each slice recomputes S and dP.
// The ring's tiles are TILE = 16 rows at every column (keys for the dQ
// pass, queries for the dK/dV pass): 32 KB a stage, 3 stages, 230,456
// bytes. S and dP (S^T and dP^T) are n16 wgmma over the 64-column chunks
// that hold any of the first ld columns; the others are neither loaded
// nor multiplied, and a warpgroup whose columns all lie past ld issues no
// gradient product. The dK/dV pass splits the group's query heads as at
// hd 256 (bwd_splits, the workspace, sum_splits_kernel). The products'
// count: S and dP 4x each (two slices, two warpgroups), the hi/lo pairs
// of the other three 2x: 14 where the bound counts 5, as at hd 256, on
// 16-row tiles.
//
// simt (CUDA cores): f32 at every head dim 1 to 512. Precision contract:
// every product is a chain of exact f32 FMAs (no TF32), P = exp(S s - lse)
// with lse in natural-log units as the forward writes it, every sum in f32
// in a fixed order, no atomics: the same bits on every run. Bound by the
// CUDA cores' FMAs (67 TFLOP/s of f32 on the H100); the two kernels issue
// 7 products where the bound counts 5 (each recomputes S and dP), 9 past
// hd 256 (S and dP once for each of two column slices). The forward's
// design (flash_attention_simt.cuh: the score and apply products):
//   - dq_kernel: one block per (R query rows, head x column slice, batch
//     row), longest rows first; R = 128 up to width 128 (8 x 8 scores and
//     outputs a thread), else 64. Per step of 128 keys up to the diagonal:
//     S = Q.K^T, P = exp(S s - lse) into an [R][132] tile, dP = dO.V^T,
//     dS = P (dP - Delta) in place (each thread rereads what it wrote, so
//     S and dP share their registers), then dQ += dS.K over the slice's
//     columns.
//   - dkdv_kernel: one block per (R key rows, (kv head x column slice) x
//     split, batch row), key tile 0 (the most queries) first; R = 128 up
//     to width 64, else 64 (dK and dV hold 2 x 8 x 4 a thread at 128
//     wide). It walks its split's query heads of the group in order and,
//     for each, the query tiles of 128 from its diagonal on: S^T = K.Q^T,
//     P^T into a tile, dP^T = V.dO^T, dS^T into another, then dV +=
//     P^T.dO and dK += dS^T.Q over the slice's columns. GQA's sum over the
//     group is a fixed-order sum in the block.
//   - A ring of STAGES = 3 slabs of 20 KB streams the operands by 16-byte
//     cp.async copies, two slabs ahead: a step's score slabs for S, then
//     for dP (the other side's 128 rows, DC = 32 head-dim columns; or, where
//     the block's own rows are not resident, those rows first and DC2 =
//     16 columns), then its apply slabs (KC rows of k, or of dO and q, the
//     slice's columns). The block's own rows (q and dO, or k and v) stay
//     resident on 64-row blocks where they fit: up to ld 256 in the dQ
//     kernel, 192 in the dK/dV kernel. Rows past S and columns past the
//     head dim arrive as zeros.
//   - The gradients' columns: up to 256 in a block; past hd 256 two column
//     slices on a grid axis, each recomputing S and dP. The instances
//     (SIMT_BWD_WIDTHS) are 32, 64, .. 256; a head dim runs the least at
//     or above it, past 256 the least at or above half of it.
//   - Parallelism: where the dK/dV grid gives fewer than about two blocks
//     an SM (MQA, or small B and S), the group's query heads split over
//     bwd_splits blocks, as on the tensor cores: each writes its partial
//     dK (scaled) and dV in f32 to a workspace [2][nsplit][B, S, KVH, hd],
//     and sum_splits_kernel adds them in split order.
//   - 16-byte copies need rows of a multiple of 4 floats: at any other
//     head dim the entry stages q, dO, k and v ceil4(hd) wide (restride.cuh,
//     in a scratch the wrapper allocates); Delta reads o and dO as they
//     are, and the kernels write dQ, dK and dV hd wide themselves.
// Keys and queries at or past S arrive as zeros and are masked; a tile
// wholly above the diagonal is never visited.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_attention_simt.cuh"
#include "hopper.cuh"
#include "restride.cuh"

namespace {

namespace simt {

using namespace attn_simt;
using hopper::cp_async16_zfill;
using hopper::cp_commit;
using hopper::cp_wait;

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 3;        // ring slabs in flight
constexpr int DC = 32;           // head-dim columns of a score slab: B rows
constexpr int DC2 = 16;          // .. of one that holds A rows too
// floats a slab: a score slab [TILE][DC + 4] (B rows: k or v in the dQ
// kernel, q or dO in the dK/dV kernel) or [R + TILE][DC2 + 4] (A rows
// first: q or dO, k or v), an apply slab [KC][WC] (dQ: k) or [2 KC][WC]
// (dK/dV: dO, then q)
constexpr int STAGE = (128 + TILE) * (DC2 + 4);
static_assert(TILE * (DC + 4) <= STAGE, "score slab");
constexpr int MAX_SLICE = 256;   // most gradient columns a block
constexpr int KV_RESIDENT = 192; // widest ld whose k and v tiles stay

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the instance a head dim runs (simt_bwd_width in
// kernels/flash_attention.py): the least of 32, 64, .. 256 at or above
// it, and past 256 the one at or above half of it (slices(hd) = 2 column
// slices); 0 outside 1 to 512
__host__ __device__ constexpr int width(int hd) {
  return hd < 1 || hd > 512 ? 0
       : hd <= 256 ? (hd + 31) / 32 * 32 : (hd + 63) / 64 * 32;
}

// column slices of the gradients a head dim's blocks split over
__host__ __device__ constexpr int slices(int hd) {
  return hd <= MAX_SLICE ? 1 : 2;
}

// rows a block at instance width W: the dQ kernel's query rows, 128 up
// to 128 (8 x 8 scores and outputs a thread), else 64; the dK/dV kernel's
// key rows, 128 up to 64 (its dK and dV hold 2 x 8 x 4 a thread), else 64
__host__ __device__ constexpr int dq_rows(int W) {
  return W <= 128 ? 128 : 64;
}
__host__ __device__ constexpr int kv_rows(int W) {
  return W <= 64 ? 128 : 64;
}

// a resident tile's row stride for operands ld wide: whole slabs of DC
// columns and 4 more (an odd number of 16-byte units)
__host__ __device__ constexpr int tile_ld(int ld) {
  return (ld + DC - 1) / DC * DC + 4;
}

// whether a block keeps its own rows' operands (q and dO in the dQ kernel,
// k and v in the dK/dV kernel) resident, for operands ld wide on the
// instance of width W: 64-row blocks only, the dQ kernel with one slice,
// the dK/dV kernel up to KV_RESIDENT
__host__ __device__ constexpr bool dq_resident(int W, int ld) {
  return dq_rows(W) == 64 && ld <= MAX_SLICE;
}
__host__ __device__ constexpr bool kv_resident(int W, int ld) {
  return kv_rows(W) == 64 && ld <= KV_RESIDENT;
}

// a block's shared memory: the ring, the dS tile (dQ) or the P and dS
// tiles (dK/dV), the two resident tiles where they stay
__host__ __device__ constexpr int dq_bytes(int W, int ld) {
  return 4 * (STAGES * STAGE + dq_rows(W) * PLD +
              (dq_resident(W, ld) ? 2 * 64 * tile_ld(ld) : 0));
}
__host__ __device__ constexpr int kv_bytes(int W, int ld) {
  return 4 * (STAGES * STAGE + 2 * kv_rows(W) * PLD +
              (kv_resident(W, ld) ? 2 * 64 * tile_ld(ld) : 0));
}
static_assert(dq_bytes(MAX_SLICE, MAX_SLICE) <= 232448 &&
              kv_bytes(KV_RESIDENT, KV_RESIDENT) <= 232448 &&
              kv_bytes(64, 64) <= 232448, "over the block's shared memory");

// Delta[b, h, i] = dO[b, i, h] . o[b, i, h]: one warp a row, rows in the
// [B, S, H] order of o, hd their stride (f32, and bf16 for the tensor-core
// kernels, at their ld: the zeros past the head dim add nothing)
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int S, int H,
             int hd) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(ld(op + d), ld(dp + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % S);
    const long long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int H, int hd, cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  delta_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                    THREADS, 0, st>>>(static_cast<const T*>(o),
                                      static_cast<const T*>(dout), delta,
                                      rows, S, H, hd);
  return (int)cudaGetLastError();
}

// rows [0, R) x columns [0, 4 c4s) into dst (row stride dld): row r from
// src + (row0 + r) stride + col0, zeros at rows past S and at columns past
// ld (16-byte copies: ld and the strides are multiples of 4)
template <int R>
__device__ __forceinline__ void load_rows(float* dst, int dld, int c4s,
                                          const float* src, size_t stride,
                                          int row0, int S, int col0,
                                          int ld) {
  for (int p = threadIdx.x; p < R * c4s; p += THREADS) {
    const int r = p / c4s, c = 4 * (p % c4s);
    const bool in = row0 + r < S && col0 + c < ld;
    cp_async16_zfill(dst + r * dld + c,
                     in ? src + (size_t)(row0 + r) * stride + col0 + c : src,
                     in ? 16 : 0);
  }
}

// a score slab of head-dim columns d0 ..: the B rows (TILE from b0) and,
// unless A is resident, the R A rows (from a0) before them
template <int R, bool RES>
__device__ __forceinline__ void load_score(float* dst, const float* a,
                                           size_t as, int a0, const float* b,
                                           size_t bs, int b0, int S, int d0,
                                           int ld) {
  if (RES) {
    load_rows<TILE>(dst, DC + 4, DC / 4, b, bs, b0, S, d0, ld);
  } else {
    load_rows<R>(dst, DC2 + 4, DC2 / 4, a, as, a0, S, d0, ld);
    load_rows<TILE>(dst + R * (DC2 + 4), DC2 + 4, DC2 / 4, b, bs, b0, S, d0,
                    ld);
  }
}

// acc += A . B^T over a score slab for the thread's rows rs ..: A resident
// (At at the slab's columns, rows tld apart) or in the slab. U: the
// column loop's unroll (the kernels' SU)
template <int R, bool RES, int U>
__device__ __forceinline__ void score_slab(const float* At, int tld,
                                           const float* st,
                                           float (&acc)[8][Rows<R>::KJ],
                                           int rs, int kl) {
  if (RES)
    score<DC, R, U>(At + rs * tld, tld, st, acc, kl);
  else
    score<DC2, R, U>(st + rs * (DC2 + 4), DC2 + 4, st + R * (DC2 + 4), acc,
                     kl);
}

// dQ: one block per (R query rows, head x column slice, batch row),
// longest rows first. Per step of TILE keys up to the diagonal: S = Q.K^T
// over its score slabs, P = exp(S scale - lse) into the tile, dP = dO.V^T
// over its own slabs, dS = P (dP - Delta) over P in the tile (each thread
// rereads what it wrote), then dQ[:, slice] += dS.K[:, slice] over slabs
// of KC key rows. RES: q and dO resident. q, k, v, dO rows ld floats a
// head, dq rows hd.
template <int WC, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int KVH, int hd, int ld,
          int nslice, float scale) {
  constexpr int R = dq_rows(WC);
  using C = Cols<WC, R>;
  using G = Rows<R>;
  constexpr int KC = chunk_rows(WC, STAGE);   // k rows a slab
  constexpr int NV = TILE / KC;
  constexpr int SC = RES ? DC : DC2;          // a score slab's columns
  // the score loop's unroll: whole, but 1 on 128-row blocks and on the
  // widest streamed ones, where ptxas would otherwise spill
  constexpr int SU = R == 128 || (!RES && WC >= 224) ? 1 : SC / 4;
  const int tld = tile_ld(ld);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [STAGES][STAGE]
  float* dSs = ring + STAGES * STAGE;         // [R][PLD]: P, then dS
  float* Qs = dSs + R * PLD;                  // RES: [R][tld] each
  float* dOs = Qs + R * tld;

  const int3 blk = hopper::longest_first();
  const int nq = (S + R - 1) / R;
  const int qt = nq - 1 - blk.x;
  const int h = blk.y / nslice, sl = blk.y % nslice;
  const int b = blk.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int q0 = qt * R, c0 = sl * WC;
  // the score layout: rows rs .. rs + 7, keys kl + LG j
  const int rs = 8 * (G::RG * w + lane / G::LG), kl = lane % G::LG;
  const size_t qs = (size_t)H * ld, ks = (size_t)KVH * ld;
  const float* qb = q + (size_t)b * S * qs + (size_t)h * ld;
  const float* ob = dout + (size_t)b * S * qs + (size_t)h * ld;
  const float* kb = k + (size_t)b * S * ks + (size_t)kh * ld;
  const float* vb = v + (size_t)b * S * ks + (size_t)kh * ld;
  const int nd = (ld + SC - 1) / SC;
  const int per = 2 * nd + NV;
  const int steps = (q0 + R - 1 < S ? q0 + R - 1 : S - 1) / TILE + 1;
  const int total = steps * per;

  if (RES) {   // the resident tiles, in the first group of copies
    load_rows<R>(Qs, tld, tld / 4 - 1, qb, qs, q0, S, 0, ld);
    load_rows<R>(dOs, tld, tld / 4 - 1, ob, qs, q0, S, 0, ld);
  }
  // slab c of the block's sequence: a step's nd score slabs of S (k, and
  // q), nd of dP (v, and dO), then NV slabs of k rows
  auto issue = [&](int c) {
    if (c < total) {
      float* dst = ring + (c % STAGES) * STAGE;
      const int k0 = c / per * TILE, part = c % per;
      if (part < nd)
        load_score<R, RES>(dst, qb, qs, q0, kb, ks, k0, S, part * SC, ld);
      else if (part < 2 * nd)
        load_score<R, RES>(dst, ob, qs, q0, vb, ks, k0, S, (part - nd) * SC,
                           ld);
      else
        load_rows<KC>(dst, WC, WC / 4, kb, ks, k0 + (part - 2 * nd) * KC, S,
                      c0, ld);
    }
    cp_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  float Lr[8], Dr[8];   // rows rs + i
  const float* lrow = lse + ((size_t)b * H + h) * S;
  const float* drow = delta + ((size_t)b * H + h) * S;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + rs + i;
    Lr[i] = qpos < S ? lrow[qpos] : 0.f;
    Dr[i] = qpos < S ? drow[qpos] : 0.f;
  }
  const int r0 = C::TM * (tid / C::CT), c4 = tid % C::CT;
  float4 acc[C::TM][C::TN4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) acc[i][j] = make_float4(0, 0, 0, 0);

  int c = 0;
  for (int t = 0; t < steps; ++t) {
    const int k0 = t * TILE;
    float sc[8][G::KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) sc[i][j] = 0.f;
    for (int part = 0; part < nd; ++part, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();   // slab c landed; slab c - 1's readers are done
      issue(c + STAGES - 1);
      score_slab<R, RES, SU>(Qs + part * SC, tld,
                             ring + (c % STAGES) * STAGE, sc, rs, kl);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + rs + i;
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) {
        const int kpos = k0 + kl + G::LG * j;
        dSs[(rs + i) * PLD + kl + G::LG * j] =
            kpos <= qpos && qpos < S ? expf(fmaf(sc[i][j], scale, -Lr[i]))
                                     : 0.f;
        sc[i][j] = 0.f;
      }
    }
    for (int part = 0; part < nd; ++part, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      issue(c + STAGES - 1);
      score_slab<R, RES, SU>(dOs + part * SC, tld,
                             ring + (c % STAGES) * STAGE, sc, rs, kl);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) {
        float* at = dSs + (rs + i) * PLD + kl + G::LG * j;
        *at = *at * (sc[i][j] - Dr[i]);
      }
    for (int part = 0; part < NV; ++part, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();   // slab c landed; dS is written
      issue(c + STAGES - 1);
      apply<WC, R, KC>(dSs + part * KC, ring + (c % STAGES) * STAGE, acc, r0,
                       c4);
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= S) continue;
    float* row = dq + ((size_t)b * S + qpos) * H * hd + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) {
      const float4 a = acc[i][j];
      store4(row, c0 + 4 * (c4 + C::CT * j), hd,
             make_float4(a.x * scale, a.y * scale, a.z * scale,
                         a.w * scale));
    }
  }
}

// dK/dV: one block per (R key rows, (kv head x column slice) x split,
// batch row), numbered longest first (key tile 0 sees the most queries).
// The block walks its split's G / nsplit query heads of the group in
// order and, for each, the query tiles of TILE from its diagonal on: S^T
// = K.Q^T over its score slabs, P^T into its tile, dP^T = V.dO^T over its
// own, dS^T = P^T (dP^T - Delta) into its tile, then dV[:, slice] +=
// P^T.dO[:, slice] and dK[:, slice] += dS^T.Q[:, slice] over slabs of KC
// query rows of both. RES: k and v resident. nsplit 1: dK (scaled) and dV
// stored hd wide; else the split's partial sums to work [2][nsplit][B, S,
// KVH, hd], which sum_splits_kernel adds in split order.
template <int WC, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ work, int S, int H, int KVH, int hd, int ld,
            int nslice, int nsplit, float scale) {
  constexpr int R = kv_rows(WC);
  using C = Cols<WC, R>;
  using G = Rows<R>;
  constexpr int KC = chunk_rows(WC, STAGE / 2);   // dO and q rows a slab
  constexpr int NV = TILE / KC;
  constexpr int SC = RES ? DC : DC2;
  constexpr int SU = R == 128 || (!RES && WC >= 224) ? 1 : SC / 4;
  const int tld = tile_ld(ld);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [STAGES][STAGE]
  float* Ps = ring + STAGES * STAGE;          // [R][PLD]: [key][query]
  float* dSs = Ps + R * PLD;                  // [R][PLD]
  float* Ks = dSs + R * PLD;                  // RES: [R][tld] each
  float* Vs = Ks + R * tld;

  const int3 blk = hopper::longest_first();
  const int kt = blk.x;
  const int part = blk.y % nsplit;
  const int sl = (blk.y / nsplit) % nslice;
  const int kh = blk.y / (nsplit * nslice);
  const int b = blk.z;
  const int G_ = H / KVH, GS = G_ / nsplit;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int k0 = kt * R, c0 = sl * WC;
  // the score layout: key rows rs .. rs + 7, queries kl + LG j
  const int rs = 8 * (G::RG * w + lane / G::LG), kl = lane % G::LG;
  const size_t qs = (size_t)H * ld, ks = (size_t)KVH * ld;
  const float* kb = k + (size_t)b * S * ks + (size_t)kh * ld;
  const float* vb = v + (size_t)b * S * ks + (size_t)kh * ld;
  const int nd = (ld + SC - 1) / SC;
  const int per = 2 * nd + NV;
  const int qt0 = k0 / TILE;                  // the diagonal's query tile
  const int tps = (S + TILE - 1) / TILE - qt0;
  const int total = GS * tps * per;
  const int h0 = kh * G_ + part * GS;

  if (RES) {   // the resident tiles, in the first group of copies
    load_rows<R>(Ks, tld, tld / 4 - 1, kb, ks, k0, S, 0, ld);
    load_rows<R>(Vs, tld, tld / 4 - 1, vb, ks, k0, S, 0, ld);
  }
  auto issue = [&](int c) {
    if (c < total) {
      float* dst = ring + (c % STAGES) * STAGE;
      const int step = c / per, sp = c % per;
      const int h = h0 + step / tps;
      const int qa = (qt0 + step % tps) * TILE;
      const size_t qoff = (size_t)b * S * qs + (size_t)h * ld;
      if (sp < nd) {
        load_score<R, RES>(dst, kb, ks, k0, q + qoff, qs, qa, S, sp * SC, ld);
      } else if (sp < 2 * nd) {
        load_score<R, RES>(dst, vb, ks, k0, dout + qoff, qs, qa, S,
                           (sp - nd) * SC, ld);
      } else {
        const int r = qa + (sp - 2 * nd) * KC;
        load_rows<KC>(dst, WC, WC / 4, dout + qoff, qs, r, S, c0, ld);
        load_rows<KC>(dst + KC * WC, WC, WC / 4, q + qoff, qs, r, S, c0, ld);
      }
    }
    cp_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  const int r0 = C::TM * (tid / C::CT), c4 = tid % C::CT;
  float4 accK[C::TM][C::TN4], accV[C::TM][C::TN4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN4; ++j)
      accK[i][j] = accV[i][j] = make_float4(0, 0, 0, 0);

  int c = 0;
  for (int step = 0; step < GS * tps; ++step) {
    const int h = h0 + step / tps;
    const int qa = (qt0 + step % tps) * TILE;
    const float* lrow = lse + ((size_t)b * H + h) * S;
    const float* drow = delta + ((size_t)b * H + h) * S;
    float sc[8][G::KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) sc[i][j] = 0.f;
    for (int sp = 0; sp < nd; ++sp, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();   // slab c landed; slab c - 1's readers are done
      issue(c + STAGES - 1);
      score_slab<R, RES, SU>(Ks + sp * SC, tld, ring + (c % STAGES) * STAGE,
                             sc, rs, kl);
    }
#pragma unroll
    for (int j = 0; j < G::KJ; ++j) {
      const int qpos = qa + kl + G::LG * j;
      const float L = qpos < S ? lrow[qpos] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Ps[(rs + i) * PLD + kl + G::LG * j] =
            k0 + rs + i <= qpos && qpos < S ? expf(fmaf(sc[i][j], scale, -L))
                                            : 0.f;
        sc[i][j] = 0.f;
      }
    }
    for (int sp = 0; sp < nd; ++sp, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      issue(c + STAGES - 1);
      score_slab<R, RES, SU>(Vs + sp * SC, tld, ring + (c % STAGES) * STAGE,
                             sc, rs, kl);
    }
#pragma unroll
    for (int j = 0; j < G::KJ; ++j) {
      const int qpos = qa + kl + G::LG * j;
      const float D = qpos < S ? drow[qpos] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int at = (rs + i) * PLD + kl + G::LG * j;
        dSs[at] = Ps[at] * (sc[i][j] - D);
      }
    }
    for (int sp = 0; sp < NV; ++sp, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();   // slab c landed; P and dS are written
      issue(c + STAGES - 1);
      const float* st = ring + (c % STAGES) * STAGE;
      apply<WC, R, KC>(Ps + sp * KC, st, accV, r0, c4);
      apply<WC, R, KC>(dSs + sp * KC, st + KC * WC, accK, r0, c4);
    }
  }

  const size_t slab = (size_t)gridDim.z * S * KVH * hd;   // B S KVH hd
  float* outk = nsplit > 1 ? work + (size_t)part * slab : dk;
  float* outv = nsplit > 1 ? work + (size_t)(nsplit + part) * slab : dv;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int kpos = k0 + r0 + i;
    if (kpos >= S) continue;
    const size_t at = (((size_t)b * S + kpos) * KVH + kh) * hd;
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) {
      const int col = c0 + 4 * (c4 + C::CT * j);
      const float4 a = accK[i][j];
      store4(outk + at, col, hd,
             make_float4(a.x * scale, a.y * scale, a.z * scale,
                         a.w * scale));
      store4(outv + at, col, hd, accV[i][j]);
    }
  }
}

// dK and dV from the dK/dV kernel's partial sums, work [2][nsplit][n] f32
// (n = B S KVH hd): each element's partials added in split order. One
// thread an element; blockIdx.y 0 is dK, 1 dV.
__global__ void __launch_bounds__(THREADS)
sum_splits_kernel(const float* __restrict__ work, float* __restrict__ dk,
                  float* __restrict__ dv, long long n, int nsplit) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float* p = work + (size_t)blockIdx.y * nsplit * n + i;
  float a = p[0];
  for (int s = 1; s < nsplit; ++s) a += p[s * n];
  (blockIdx.y == 0 ? dk : dv)[i] = a;
}

// a kernel at its shared memory: the attribute, then the launch's error
template <typename K>
cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the dQ and dK/dV kernels of width WC, each with its operands resident
// where they fit (dq_resident, kv_resident), then the split sum
template <int WC>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, float* work, int B, int S, int H, int KVH, int hd,
           int ld, int nslice, int nsplit, cudaStream_t st) {
  constexpr int RQ = dq_rows(WC), RK = kv_rows(WC);
  const float scale = (float)std::pow((double)hd, -0.5);
  const dim3 dq_grid((S + RQ - 1) / RQ, H * nslice, B);
  const dim3 kv_grid((S + RK - 1) / RK, KVH * nslice * nsplit, B);
  const int dqb = dq_bytes(WC, ld), kvb = kv_bytes(WC, ld);
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (RQ == 64) {
    if (dq_resident(WC, ld) &&
        (err = allow(dq_kernel<WC, true>, dqb)) == cudaSuccess)
      dq_kernel<WC, true><<<dq_grid, THREADS, dqb, st>>>(
          q, k, v, dout, lse, delta, dq, S, H, KVH, hd, ld, nslice, scale);
  }
  if (!dq_resident(WC, ld) &&
      (err = allow(dq_kernel<WC, false>, dqb)) == cudaSuccess)
    dq_kernel<WC, false><<<dq_grid, THREADS, dqb, st>>>(
        q, k, v, dout, lse, delta, dq, S, H, KVH, hd, ld, nslice, scale);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return (int)err;
  err = cudaErrorInvalidValue;
  if constexpr (RK == 64 && WC <= KV_RESIDENT) {
    if (kv_resident(WC, ld) &&
        (err = allow(dkdv_kernel<WC, true>, kvb)) == cudaSuccess)
      dkdv_kernel<WC, true><<<kv_grid, THREADS, kvb, st>>>(
          q, k, v, dout, lse, delta, dk, dv, work, S, H, KVH, hd, ld, nslice,
          nsplit, scale);
  }
  if constexpr (RK == 128 || WC >= 160) {
    if (!kv_resident(WC, ld) &&
        (err = allow(dkdv_kernel<WC, false>, kvb)) == cudaSuccess)
      dkdv_kernel<WC, false><<<kv_grid, THREADS, kvb, st>>>(
          q, k, v, dout, lse, delta, dk, dv, work, S, H, KVH, hd, ld, nslice,
          nsplit, scale);
  }
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess ||
      nsplit == 1)
    return (int)err;
  const long long n = (long long)B * S * KVH * hd;
  sum_splits_kernel<<<dim3((unsigned)((n + THREADS - 1) / THREADS), 2),
                      THREADS, 0, st>>>(work, dk, dv, n, nsplit);
  return (int)cudaGetLastError();
}

// the instances, by width (SIMT_BWD_WIDTHS)
#define SIMT_WIDTH_LIST(X) \
  X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)

// Delta (from o and dO hd wide), then the dQ and dK/dV kernels (and the
// split sum) of a head dim's instance, on q, k, v and dO ld wide
inline int dispatch(const float* q, const float* k, const float* v,
                    const float* dout, const void* o_hd, const void* dout_hd,
                    const float* lse, float* dq, float* dk, float* dv,
                    float* delta, float* work, int B, int S, int H, int KVH,
                    int hd, int ld, int nsplit, cudaStream_t st) {
  if (nsplit < 1 || (H / KVH) % nsplit != 0 ||
      (nsplit > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (width(hd)) {
#define BWD_SIMT_CASE(W)                                                   \
  case W:                                                                  \
    if (int err = launch_delta<float>(o_hd, dout_hd, delta, B, S, H, hd,   \
                                      st))                                 \
      return err;                                                          \
    return launch<W>(q, k, v, dout, lse, delta, dq, dk, dv, work, B, S, H, \
                     KVH, hd, ld, slices(hd), nsplit, st);
    SIMT_WIDTH_LIST(BWD_SIMT_CASE)
#undef BWD_SIMT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef SIMT_WIDTH_LIST

// out = {width, key rows a dK/dV block, its shared memory}, or 0 where the
// head dim has no instance
inline int geometry(int hd, int* out) {
  if (width(hd) == 0) return 0;
  out[0] = width(hd);
  out[1] = kv_rows(width(hd));
  out[2] = kv_bytes(width(hd), (hd + 3) / 4 * 4);
  return 1;
}

}  // namespace simt

// ------------------------------------------------------------ bf16, wgmma --

namespace tc {

using namespace hopper;

constexpr int STAGES = 4;                // tiles in flight in a ring
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp (dQ)
// the dK/dV kernel, and the dQ kernel at hd 256: a whole producer
// warpgroup, so that its registers can go to the consumers (setmaxnreg):
// 128 x 24 + 256 x 240 of the 65,536
constexpr int KV_THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int CHUNK = 64;                // hd columns per 128-byte row
constexpr int ROW = 128;                 // bytes per swizzled row
// hd 256 (the SPLIT layouts): rows a block, both warpgroups', and the dQ
// kernel's (k, v) tiles in flight
constexpr int SPLIT_ROWS = 64;
constexpr int DQ_SPLIT_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the dQ kernel: the q and dO tiles of BQ rows, then the
// ring of (k, v) tiles of 64 keys; each tile hd/64 chunks of rows x 128
// bytes, 1024-byte aligned (the swizzle's period). SPLIT (hd 256): the
// block's rows are both warpgroups', and warpgroup wg holds dQ's columns
// [QD wg, QD wg + QD); otherwise warpgroup wg holds rows [64 wg, 64 wg +
// 64) and all hd columns.
template <int HD>
struct DqLayout {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BQ = SPLIT ? SPLIT_ROWS : 128;  // query rows a block
  static constexpr int QD = SPLIT ? HD / 2 : HD;  // dQ columns a warpgroup
  static constexpr int BKV = 64;                // keys a tile
  static constexpr int RING = SPLIT ? DQ_SPLIT_STAGES : STAGES;
  static constexpr int NTHREADS = SPLIT ? KV_THREADS : THREADS;
  static constexpr int NCH = HD / CHUNK;
  static constexpr int Q_BYTES = BQ * HD * 2;   // the q or the dO tile
  static constexpr int KV_BYTES = BKV * HD * 2; // one k or one v tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + RING * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + RING * KV_BYTES;
  // full[RING], empty[RING], the q/dO barrier; alignment slack
  static constexpr int BYTES = BAR_OFF + (2 * RING + 1) * 8 + 1024;
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// Shared memory of the dK/dV kernel: the k and v tiles of BK key rows,
// then the ring of (q, dO) tiles of BQ query rows. SPLIT (hd 256): the
// block's key rows are both warpgroups', and warpgroup wg holds dK's and
// dV's columns [KD wg, KD wg + KD).
template <int HD>
struct KvLayout {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BK = SPLIT ? SPLIT_ROWS : 128;  // key rows a block
  static constexpr int KD = SPLIT ? HD / 2 : HD;  // dK, dV columns a warpgroup
  static constexpr int BQ = HD <= 64 ? 64 : 32; // query rows a tile
  static constexpr int NCH = HD / CHUNK;
  static constexpr int K_BYTES = BK * HD * 2;   // the k or the v tile
  static constexpr int Q_BYTES = BQ * HD * 2;   // one q or one dO tile
  static constexpr int V_OFF = K_BYTES;
  static constexpr int Q_OFF = 2 * K_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int BAR_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// D (+)= A.B^T, both K-major in shared memory, N columns
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 32) mma_ss_n32(d, da, db, accumulate);
  else if constexpr (N == 64) mma_ss_n64(d, da, db, accumulate);
  else mma_ss_n128<0, 0>(d, da, db, accumulate);
}

// D += A.B, A from registers, B MN-major in shared memory, N columns
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 64) mma_rs_n64(d, a, db);
  else mma_rs_n128(d, a, db);
}

// D = X.Y^T over hd: X the warpgroup's 64 rows at `a` of a tile stored
// with `a_rows` rows a chunk, Y the N rows of a tile at `b`
template <int HD, int N>
__device__ __forceinline__ void mma_rows(float (&d)[N / 2], uint32_t a,
                                         int a_rows, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // k16 step in the 128-byte row
    mma_ss<N>(d, desc(a + (kk / 4) * a_rows * ROW + off, 16, 1024),
              desc(b + (kk / 4) * N * ROW + off, 16, 1024), kk > 0);
  }
}

// D += X.Y with X = hi + lo as register A fragments over K rows (k16 step
// kk is hi[4kk .. 4kk + 3]) and Y the [K][N] columns at `b` of a tile of K
// rows, MN-major: the hi products first, then the lo ones, into the same
// accumulator
template <int N, int K>
__device__ __forceinline__ void mma_split(float (&d)[N / 2],
                                          const uint32_t* hi,
                                          const uint32_t* lo, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs<N>(d, hi + 4 * kk, desc(b + kk * 16 * ROW, K * ROW, 1024));
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs<N>(d, lo + 4 * kk, desc(b + kk * 16 * ROW, K * ROW, 1024));
}

// (x0, x1) as a bf16 pair: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = bf16x2(x0, x1);
  lo = bf16x2(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
}

// Fragment layout (accumulator = A fragment): a thread of warp w holds rows
// r0 = 16w + lane/4 and r1 = r0 + 8 of its warpgroup's 64; element 4c + e
// of an N-column accumulator is row r0 (e < 2) or r1 (e >= 2), column 8c +
// 2 (lane % 4) + e % 2. Fragment word 2c holds row r0's pair of columns
// 8c.., word 2c + 1 row r1's.

template <int HD>
__global__ void __launch_bounds__(DqLayout<HD>::NTHREADS, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap omap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int S, int H, int KVH, int hd,
             float scale, float scale_log2) {
  using L = DqLayout<HD>;
  constexpr int BQ = L::BQ, BKV = L::BKV, QD = L::QD, RING = L::RING;
  constexpr int NS = BKV / 2;   // score fragment floats per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + L::DO_OFF;
  const uint32_t sk = base + L::K_OFF;
  const uint32_t sv = base + L::V_OFF;
  const uint32_t full = base + L::BAR_OFF;     // full[s] = full + 8 s
  const uint32_t empty = full + 8 * RING;      // empty[s] = empty + 8 s
  const uint32_t qbar = empty + 8 * RING;

  // longest rows first (at hd 256 across every head and batch row)
  const int3 blk = L::SPLIT ? longest_first()
                            : make_int3(blockIdx.x, blockIdx.y, blockIdx.z);
  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - blk.x;
  const int h = blk.y;
  const int b = blk.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * BQ;
  const int n_kv = (min(q0 + BQ, S) + BKV - 1) / BKV;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);   // one arrival per warp
    }
    bar_init(qbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: the q and dO tiles once, then the (k, v) ring
    if constexpr (L::SPLIT) regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      bar_expect_tx(qbar, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c) {
        tma_load_4d(sq + c * BQ * ROW, &qmap, qbar, c * CHUNK, h, q0, b);
        tma_load_4d(sdo + c * BQ * ROW, &omap, qbar, c * CHUNK, h, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % RING;
        bar_wait(empty + 8 * s, ((j / RING) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        bar_expect_tx(fb, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c) {
          const uint32_t off = s * L::KV_BYTES + c * BKV * ROW;
          tma_load_4d(sk + off, &kmap, fb, c * CHUNK, kh, j * BKV, b);
          tma_load_4d(sv + off, &vmap, fb, c * CHUNK, kh, j * BKV, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows row0 .. row0 + 63 and dQ's
  // columns col0 .. col0 + QD - 1, and walks the key tiles 0 .. nt - 1
  // (the rest lie above its rows)
  if constexpr (L::SPLIT) regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + (L::SPLIT ? 0 : 64 * wg);
  const int col0 = L::SPLIT ? QD * wg : 0;
  const int r0 = row0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int nt = min(n_kv, (row0 + 63) / BKV + 1);
  const uint32_t qa = sq + (L::SPLIT ? 0 : 64 * wg * ROW);
  const uint32_t oa = sdo + (L::SPLIT ? 0 : 64 * wg * ROW);
  const float* lrow = lse + ((size_t)b * H + h) * S;
  const float* drow = delta + ((size_t)b * H + h) * S;
  // the rows' lse in log2 units and Delta; rows past S read 0 (their q and
  // dO are zeros, so their dS is 0, and they are not stored)
  const float l0 = r0 < S ? lrow[r0] * LOG2E : 0.f;
  const float l1 = r1 < S ? lrow[r1] * LOG2E : 0.f;
  const float e0 = r0 < S ? drow[r0] : 0.f;
  const float e1 = r1 < S ? drow[r1] : 0.f;

  float acc[QD / 2];
#pragma unroll
  for (int i = 0; i < QD / 2; ++i) acc[i] = 0.f;
  float sc[NS], dp[NS];
  uint32_t dh[NS / 2], dl[NS / 2];   // dS as bf16 hi and lo A fragments
  // after a group's wait, the registers its products wrote or read: none
  // of them moves across the wait or is reused before it
  auto settle_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      pin(sc[i]);
      pin(dp[i]);
    }
  };
  auto settle_dq = [&]() {
#pragma unroll
    for (int i = 0; i < QD / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      pin(dh[i]);
      pin(dl[i]);
    }
  };

  bar_wait(qbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    bar_wait(full + 8 * (j % RING), (j / RING) & 1);
    if (j < nt) {
      const uint32_t kt = sk + (j % RING) * L::KV_BYTES;
      const uint32_t vt = sv + (j % RING) * L::KV_BYTES;
      wg_fence();
      mma_rows<HD, BKV>(sc, qa, BQ, kt);
      mma_rows<HD, BKV>(dp, oa, BQ, vt);
      wg_commit();
      wg_wait();
      settle_s();
      const int k0 = j * BKV;
      const bool edge = k0 + BKV - 1 > row0 || k0 + BKV > S;
#pragma unroll
      for (int c = 0; c < BKV / 8; ++c) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          float p = exp2_ftz(fmaf(sc[4 * c + e], scale_log2, top ? -l0 : -l1));
          if (edge) {
            const int kpos = k0 + 8 * c + 2 * (lane % 4) + (e & 1);
            if (kpos > (top ? r0 : r1) || kpos >= S) p = 0.f;
          }
          ds[e] = p * (dp[4 * c + e] - (top ? e0 : e1));
        }
        split(ds[0], ds[1], dh[2 * c], dl[2 * c]);
        split(ds[2], ds[3], dh[2 * c + 1], dl[2 * c + 1]);
      }
      // dQ's columns col0 .. col0 + QD - 1 over K's at chunk col0 / CHUNK
      wg_fence();
      mma_split<QD, BKV>(acc, dh, dl, kt + (col0 / CHUNK) * BKV * ROW);
      wg_commit();
      wg_wait();
      settle_dq();
    }
    if (lane == 0) bar_arrive(empty + 8 * (j % RING));
  }

  // dQ's columns of hd (an instance wider than hd holds zeros past it)
  const size_t row_stride = (size_t)H * hd;
  __nv_bfloat16* o0 =
      dq + ((size_t)b * S + r0) * row_stride + (size_t)h * hd + col0;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int c = 0; c < QD / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (col0 + col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * c] * scale, acc[4 * c + 1] * scale);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
  }
}

// work (SPLIT with nsplit > 1): [2][nsplit][B, S, KVH, hd] f32, dK's
// partial sums then dV's, for sum_splits_kernel; nsplit is 1 otherwise
template <int HD>
__global__ void __launch_bounds__(KV_THREADS, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap omap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ work, int S, int H, int KVH, int nsplit,
               int hd, float scale, float scale_log2) {
  using L = KvLayout<HD>;
  constexpr int BK = L::BK, BQ = L::BQ, KD = L::KD;
  constexpr int NS = BQ / 2;    // S^T fragment floats per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = base + L::V_OFF;
  const uint32_t sq = base + L::Q_OFF;
  const uint32_t sdo = base + L::DO_OFF;
  const uint32_t full = base + L::BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t kbar = empty + 8 * STAGES;

  // key tile 0 sees the most queries: first. At hd 256 the grid's y is
  // (kv head, split), and a block walks the split's GS query heads.
  const int3 blk = L::SPLIT ? longest_first()
                            : make_int3(blockIdx.x, blockIdx.y, blockIdx.z);
  const int kt = blk.x;
  const int kh = L::SPLIT ? blk.y / nsplit : blk.y;
  const int part = L::SPLIT ? blk.y % nsplit : 0;
  const int b = blk.z;
  const int G = H / KVH;
  const int GS = L::SPLIT ? G / nsplit : G;
  const int h0 = kh * G + part * GS;  // the block's first query head
  const int k0 = kt * BK;
  const int nq = (S + BQ - 1) / BQ;
  const int qt0 = k0 / BQ;      // the first query tile with a row >= k0
  const int ntq = nq - qt0;     // query tiles a head
  const int n_tiles = GS * ntq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);
    }
    bar_init(kbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: the k and v tiles once, then the (q, dO) ring, the block's
    // heads in order and each head's query tiles from the diagonal on
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      bar_expect_tx(kbar, 2 * L::K_BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c) {
        tma_load_4d(sk + c * BK * ROW, &kmap, kbar, c * CHUNK, kh, k0, b);
        tma_load_4d(sv + c * BK * ROW, &vmap, kbar, c * CHUNK, kh, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int h = h0 + j / ntq;
        const int q0 = (qt0 + j % ntq) * BQ;
        const int s = j % STAGES;
        bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        bar_expect_tx(fb, 2 * L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c) {
          const uint32_t off = s * L::Q_BYTES + c * BQ * ROW;
          tma_load_4d(sq + off, &qmap, fb, c * CHUNK, h, q0, b);
          tma_load_4d(sdo + off, &omap, fb, c * CHUNK, h, q0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns key rows kw .. kw + 63 and dK's and dV's
  // columns col0 .. col0 + KD - 1
  regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw = k0 + (L::SPLIT ? 0 : 64 * wg);
  const int col0 = L::SPLIT ? KD * wg : 0;
  const int r0 = kw + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const uint32_t ka = sk + (L::SPLIT ? 0 : 64 * wg * ROW);
  const uint32_t va = sv + (L::SPLIT ? 0 : 64 * wg * ROW);
  // dO's and Q's columns col0 .. col0 + KD - 1 in a ring tile
  const uint32_t half = (col0 / CHUNK) * BQ * ROW;

  float accK[KD / 2], accV[KD / 2];
#pragma unroll
  for (int i = 0; i < KD / 2; ++i) {
    accK[i] = 0.f;
    accV[i] = 0.f;
  }
  float st[NS], dpt[NS];             // S^T and dP^T of a tile
  uint32_t ph[NS / 2], pl[NS / 2];   // P^T as bf16 hi and lo A fragments
  uint32_t dh[NS / 2], dl[NS / 2];   // dS^T likewise
  auto settle_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      pin(st[i]);
      pin(dpt[i]);
    }
  };
  auto settle_kv = [&]() {
#pragma unroll
    for (int i = 0; i < KD / 2; ++i) {
      pin(accK[i]);
      pin(accV[i]);
    }
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      pin(ph[i]);
      pin(pl[i]);
      pin(dh[i]);
      pin(dl[i]);
    }
  };

  bar_wait(kbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int h = h0 + j / ntq;
    const int q0 = (qt0 + j % ntq) * BQ;
    const int s = j % STAGES;
    bar_wait(full + 8 * s, (j / STAGES) & 1);
    // a tile wholly above the warpgroup's keys (every query before them),
    // or keys all past S, contributes nothing
    if (q0 + BQ - 1 >= kw && kw < S) {
      const uint32_t qs = sq + s * L::Q_BYTES;
      const uint32_t os = sdo + s * L::Q_BYTES;
      // this thread's query columns' lse (log2 units) and Delta; columns
      // past S read 0 and are masked
      const float* lrow = lse + ((size_t)b * H + h) * S;
      const float* drow = delta + ((size_t)b * H + h) * S;
      float lc[NS / 2], ec[NS / 2];
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qpos = q0 + 8 * c + 2 * (lane % 4) + e;
          lc[2 * c + e] = qpos < S ? lrow[qpos] * LOG2E : 0.f;
          ec[2 * c + e] = qpos < S ? drow[qpos] : 0.f;
        }
      wg_fence();
      mma_rows<HD, BQ>(st, ka, BK, qs);
      mma_rows<HD, BQ>(dpt, va, BK, os);
      wg_commit();
      wg_wait();
      settle_s();
      const bool edge = kw + 63 > q0 || q0 + BQ > S;
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * c + (e & 1);
          p[e] = exp2_ftz(fmaf(st[4 * c + e], scale_log2, -lc[col]));
          if (edge) {
            const int qpos = q0 + 8 * c + 2 * (lane % 4) + (e & 1);
            if ((e < 2 ? r0 : r1) > qpos || qpos >= S) p[e] = 0.f;
          }
          ds[e] = p[e] * (dpt[4 * c + e] - ec[col]);
        }
        split(p[0], p[1], ph[2 * c], pl[2 * c]);
        split(p[2], p[3], ph[2 * c + 1], pl[2 * c + 1]);
        split(ds[0], ds[1], dh[2 * c], dl[2 * c]);
        split(ds[2], ds[3], dh[2 * c + 1], dl[2 * c + 1]);
      }
      wg_fence();
      mma_split<KD, BQ>(accV, ph, pl, os + half);
      mma_split<KD, BQ>(accK, dh, dl, qs + half);
      wg_commit();
      wg_wait();
      settle_kv();
    }
    if (lane == 0) bar_arrive(empty + 8 * s);
  }

  // dK's and dV's columns of hd (an instance wider than hd holds zeros
  // past it)
  const size_t row_stride = (size_t)KVH * hd;
  const size_t at0 =
      ((size_t)b * S + r0) * row_stride + (size_t)kh * hd + col0;
  const size_t at1 = at0 + 8 * row_stride;
  if (L::SPLIT && nsplit > 1) {
    // the block's partial sums, f32, at split `part` of the workspace
    const size_t slab = (size_t)gridDim.z * S * row_stride;
    float* pk = work + (size_t)part * slab;
    float* pv = pk + (size_t)nsplit * slab;
#pragma unroll
    for (int c = 0; c < KD / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col0 + col >= hd) continue;
      if (r0 < S) {
        *reinterpret_cast<float2*>(pk + at0 + col) =
            make_float2(accK[4 * c] * scale, accK[4 * c + 1] * scale);
        *reinterpret_cast<float2*>(pv + at0 + col) =
            make_float2(accV[4 * c], accV[4 * c + 1]);
      }
      if (r1 < S) {
        *reinterpret_cast<float2*>(pk + at1 + col) =
            make_float2(accK[4 * c + 2] * scale, accK[4 * c + 3] * scale);
        *reinterpret_cast<float2*>(pv + at1 + col) =
            make_float2(accV[4 * c + 2], accV[4 * c + 3]);
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < KD / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (col0 + col >= hd) continue;
    if (r0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at0 + col) =
          __floats2bfloat162_rn(accK[4 * c] * scale, accK[4 * c + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at0 + col) =
          __floats2bfloat162_rn(accV[4 * c], accV[4 * c + 1]);
    }
    if (r1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at1 + col) =
          __floats2bfloat162_rn(accK[4 * c + 2] * scale,
                                accK[4 * c + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at1 + col) =
          __floats2bfloat162_rn(accV[4 * c + 2], accV[4 * c + 3]);
    }
  }
}

// dK and dV from the dK/dV kernel's partial sums, work [2][nsplit][n] f32
// (n = B S KVH hd, in groups of 4): each element's partials added in split
// order, then rounded once to bf16. One thread a group; blockIdx.y 0 is
// dK, 1 dV.
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ work,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, long long n4, int nsplit) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4* p =
      reinterpret_cast<const float4*>(work) + blockIdx.y * nsplit * n4 + i;
  float4 a = p[0];
  for (int s = 1; s < nsplit; ++s) {
    const float4 x = p[s * n4];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  __nv_bfloat162* out =
      reinterpret_cast<__nv_bfloat162*>(blockIdx.y == 0 ? dk : dv) + 2 * i;
  out[0] = __floats2bfloat162_rn(a.x, a.y);
  out[1] = __floats2bfloat162_rn(a.z, a.w);
}

// the instance a bf16 head dim runs on the tensor cores (BWD_TC_WIDTHS and
// tc_width in kernels/flash_attention.py): the least width at or above it
// (no instance of width 192: 129 to 192 run 256), 512 (namespace wide)
// past 256; 0 outside 1 to 512
__host__ __device__ constexpr int width(int hd) {
  return hd < 1 || hd > 512 ? 0 : hd <= 64 ? 64 : hd <= 128 ? 128
       : hd <= 256 ? 256 : 512;
}

// HD: the instance's width (BWD_TC_WIDTHS in kernels/flash_attention.py),
// hd the head dim: the maps' extent, so that the TMA fills the tiles'
// columns past hd with zeros, which add nothing to any product, and the
// scale's; ld: the operands' and gradients' row stride, hd rounded up to
// a multiple of 8 (the kernels' own hd: they store columns up to ld).
// nsplit: the query-head splits of the dK/dV pass, 1 up to width 128;
// above, a divisor of the group, with work its [2][nsplit][B, S, KVH, ld]
// f32 workspace where nsplit > 1
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, void* work, int B, int S, int H, int KVH, int hd,
           int ld, int nsplit, cudaStream_t st) {
  using D = DqLayout<HD>;
  using K = KvLayout<HD>;
  if (nsplit < 1 || (H / KVH) % nsplit != 0 || (!K::SPLIT && nsplit != 1) ||
      (nsplit > 1 && work == nullptr) || width(hd) != HD)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qd, od, kd, vd, qk, ok, kk, vk;
  if (!make_map(&qd, q, B, S, H, hd, ld, D::BQ) ||
      !make_map(&od, dout, B, S, H, hd, ld, D::BQ) ||
      !make_map(&kd, k, B, S, KVH, hd, ld, D::BKV) ||
      !make_map(&vd, v, B, S, KVH, hd, ld, D::BKV) ||
      !make_map(&qk, q, B, S, H, hd, ld, K::BQ) ||
      !make_map(&ok, dout, B, S, H, hd, ld, K::BQ) ||
      !make_map(&kk, k, B, S, KVH, hd, ld, K::BK) ||
      !make_map(&vk, v, B, S, KVH, hd, ld, K::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      D::BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::BYTES);
  if (err != cudaSuccess) return (int)err;
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if ((err = (cudaError_t)simt::launch_delta<__nv_bfloat16>(
           o, dout, dl, B, S, H, ld, st)) != cudaSuccess)
    return (int)err;
  const double scale = std::pow((double)hd, -0.5);
  const float sc = (float)scale, sc_log2 = (float)(scale * 1.4426950408889634);
  dq_tc_kernel<HD><<<dim3((S + D::BQ - 1) / D::BQ, H, B), D::NTHREADS,
                     D::BYTES, st>>>(qd, od, kd, vd, lp, dl,
                                     static_cast<__nv_bfloat16*>(dq), S, H,
                                     KVH, ld, sc, sc_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(dv);
  float* wp = static_cast<float*>(work);
  dkdv_tc_kernel<HD><<<dim3((S + K::BK - 1) / K::BK, KVH * nsplit, B),
                       KV_THREADS, K::BYTES, st>>>(
      qk, ok, kk, vk, lp, dl, dkp, dvp, wp, S, H, KVH, nsplit, ld, sc,
      sc_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long n4 = (long long)B * S * KVH * ld / 4;
  sum_splits_kernel<<<dim3((unsigned)((n4 + 255) / 256), 2), 256, 0, st>>>(
      wp, dkp, dvp, n4, nsplit);
  return (int)cudaGetLastError();
}

// out = {width, key rows a dK/dV block, its shared memory}, or 0 where
// the head dim has no tensor-core instance
inline int geometry(int hd, int* out) {
  switch (width(hd)) {
#define BWD_TC_GEO(W)              \
  case W:                          \
    out[0] = W;                    \
    out[1] = KvLayout<W>::BK;      \
    out[2] = KvLayout<W>::BYTES;   \
    return 1;
    BWD_TC_GEO(64) BWD_TC_GEO(128) BWD_TC_GEO(256)
#undef BWD_TC_GEO
    default: return 0;
  }
}

}  // namespace tc

// ------------------------------------------------ bf16 past hd 256 ----

namespace wide {

using namespace hopper;
using tc::CHUNK;
using tc::CONSUMER_REGS;
using tc::CONSUMERS;
using tc::KV_THREADS;
using tc::LOG2E;
using tc::PRODUCER_REGS;
using tc::ROW;

constexpr int W = 512;                // the instance's width
constexpr int ROWS = 64;              // a dQ block's query rows, a dK/dV
                                      // block's key rows: both warpgroups'
constexpr int TILE = 16;              // rows a ring tile: keys (dQ pass),
                                      // queries (dK/dV pass)
constexpr int SLICES = 2;             // the gradients' column slices
constexpr int SW = W / SLICES;        // columns a slice
constexpr int GD = SW / 2;            // gradient columns a warpgroup
constexpr int STAGES = 3;             // ring tiles in flight
constexpr int RES_BYTES = ROWS * W * 2;   // a resident tile, every column
constexpr int T_BYTES = TILE * W * 2;     // a ring tile, every column
constexpr int B_OFF = RES_BYTES;          // the second resident tile
constexpr int R0_OFF = 2 * RES_BYTES;     // the ring's first tiles
constexpr int R1_OFF = R0_OFF + STAGES * T_BYTES;  // and its second
constexpr int BAR_OFF = R1_OFF + STAGES * T_BYTES;
// full[STAGES], empty[STAGES], the resident tiles' barrier; alignment
// slack
constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
static_assert(BYTES <= 232448, "over the block's shared memory");

// D = X.Y^T over the first nch 64-column chunks: X the 64 rows at a (a
// chunk of ROWS rows a chunk), Y the TILE rows at b; the first step
// overwrites D
__device__ __forceinline__ void mma_chunks(float (&d)[TILE / 2], uint32_t a,
                                           uint32_t b, int nch) {
  for (int c = 0; c < nch; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss_n16(d, desc(a + c * ROWS * ROW + kk * 32, 16, 1024),
                 desc(b + c * TILE * ROW + kk * 32, 16, 1024),
                 c > 0 || kk > 0);
  }
}

// One block per (64 query rows, head x slice, batch), numbered longest
// first; warpgroup wg holds dQ's columns sl SW + wg GD .. + GD - 1. ld: the
// row stride (a multiple of 8).
__global__ void __launch_bounds__(KV_THREADS, 1)
dq_wide_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap omap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int S, int H, int KVH, int ld,
               float scale, float scale_log2) {
  constexpr int NS = TILE / 2;   // score fragment floats per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + B_OFF;
  const uint32_t sk = base + R0_OFF;
  const uint32_t sv = base + R1_OFF;
  const uint32_t full = base + BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  const int3 blk = longest_first();
  const int nq = (S + ROWS - 1) / ROWS;
  const int qt = nq - 1 - blk.x;
  const int h = blk.y / SLICES;
  const int sl = blk.y % SLICES;
  const int b = blk.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * ROWS;
  const int n_kv = (min(q0 + ROWS, S) + TILE - 1) / TILE;
  const int nch = (ld + CHUNK - 1) / CHUNK;   // chunks holding columns < ld
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);   // one arrival per warp
    }
    bar_init(qbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: the q and dO tiles once, then the (k, v) ring
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      bar_expect_tx(qbar, 2 * nch * ROWS * ROW);
      for (int c = 0; c < nch; ++c) {
        tma_load_4d(sq + c * ROWS * ROW, &qmap, qbar, c * CHUNK, h, q0, b);
        tma_load_4d(sdo + c * ROWS * ROW, &omap, qbar, c * CHUNK, h, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        bar_expect_tx(fb, 2 * nch * TILE * ROW);
        for (int c = 0; c < nch; ++c) {
          const uint32_t off = s * T_BYTES + c * TILE * ROW;
          tma_load_4d(sk + off, &kmap, fb, c * CHUNK, kh, j * TILE, b);
          tma_load_4d(sv + off, &vmap, fb, c * CHUNK, kh, j * TILE, b);
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int col0 = sl * SW + wg * GD;
  const bool live = col0 < ld;                 // any column to store
  const int r0 = q0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const float* lrow = lse + ((size_t)b * H + h) * S;
  const float* drow = delta + ((size_t)b * H + h) * S;
  const float l0 = r0 < S ? lrow[r0] * LOG2E : 0.f;
  const float l1 = r1 < S ? lrow[r1] * LOG2E : 0.f;
  const float e0 = r0 < S ? drow[r0] : 0.f;
  const float e1 = r1 < S ? drow[r1] : 0.f;

  float acc[GD / 2];
#pragma unroll
  for (int i = 0; i < GD / 2; ++i) acc[i] = 0.f;
  float sc[NS], dp[NS];
  uint32_t dh[NS / 2], dl[NS / 2];   // dS as bf16 hi and lo A fragments
  auto settle_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      pin(sc[i]);
      pin(dp[i]);
    }
  };
  auto settle_dq = [&]() {
#pragma unroll
    for (int i = 0; i < GD / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      pin(dh[i]);
      pin(dl[i]);
    }
  };

  bar_wait(qbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    bar_wait(full + 8 * (j % STAGES), (j / STAGES) & 1);
    const uint32_t kt = sk + (j % STAGES) * T_BYTES;
    const uint32_t vt = sv + (j % STAGES) * T_BYTES;
    wg_fence();
    mma_chunks(sc, sq, kt, nch);
    mma_chunks(dp, sdo, vt, nch);
    wg_commit();
    wg_wait();
    settle_s();
    const int k0 = j * TILE;
    const bool edge = k0 + TILE - 1 > q0 || k0 + TILE > S;
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        float p = exp2_ftz(fmaf(sc[4 * c + e], scale_log2, top ? -l0 : -l1));
        if (edge) {
          const int kpos = k0 + 8 * c + 2 * (lane % 4) + (e & 1);
          if (kpos > (top ? r0 : r1) || kpos >= S) p = 0.f;
        }
        ds[e] = p * (dp[4 * c + e] - (top ? e0 : e1));
      }
      tc::split(ds[0], ds[1], dh[2 * c], dl[2 * c]);
      tc::split(ds[2], ds[3], dh[2 * c + 1], dl[2 * c + 1]);
    }
    if (live) {
      wg_fence();
      tc::mma_split<GD, TILE>(acc, dh, dl, kt + (col0 / CHUNK) * TILE * ROW);
      wg_commit();
      wg_wait();
      settle_dq();
    }
    if (lane == 0) bar_arrive(empty + 8 * (j % STAGES));
  }

  if (!live) return;
  const size_t row_stride = (size_t)H * ld;
  __nv_bfloat16* o0 =
      dq + ((size_t)b * S + r0) * row_stride + (size_t)h * ld + col0;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int c = 0; c < GD / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (col0 + col >= ld) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * c] * scale, acc[4 * c + 1] * scale);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
  }
}

// One block per (64 key rows, kv head x slice x split, batch), numbered
// longest first (key tile 0, which sees the most queries, first); grid y
// is (kv head SLICES + slice) nsplit + split. work as in tc.
__global__ void __launch_bounds__(KV_THREADS, 1)
dkdv_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, float* __restrict__ work,
                 int S, int H, int KVH, int nsplit, int ld, float scale,
                 float scale_log2) {
  constexpr int NS = TILE / 2;   // S^T fragment floats per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = base + B_OFF;
  const uint32_t sq = base + R0_OFF;
  const uint32_t sdo = base + R1_OFF;
  const uint32_t full = base + BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t kbar = empty + 8 * STAGES;

  const int3 blk = longest_first();
  const int kt = blk.x;
  const int part = blk.y % nsplit;
  const int sl = (blk.y / nsplit) % SLICES;
  const int kh = blk.y / (nsplit * SLICES);
  const int b = blk.z;
  const int G = H / KVH;
  const int GS = G / nsplit;
  const int h0 = kh * G + part * GS;   // the block's first query head
  const int k0 = kt * ROWS;
  const int nq = (S + TILE - 1) / TILE;
  const int qt0 = k0 / TILE;     // the first query tile with a row >= k0
  const int ntq = nq - qt0;      // query tiles a head
  const int n_tiles = GS * ntq;
  const int nch = (ld + CHUNK - 1) / CHUNK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);
    }
    bar_init(kbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: the k and v tiles once, then the (q, dO) ring, the block's
    // heads in order and each head's query tiles from the diagonal on
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      bar_expect_tx(kbar, 2 * nch * ROWS * ROW);
      for (int c = 0; c < nch; ++c) {
        tma_load_4d(sk + c * ROWS * ROW, &kmap, kbar, c * CHUNK, kh, k0, b);
        tma_load_4d(sv + c * ROWS * ROW, &vmap, kbar, c * CHUNK, kh, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int h = h0 + j / ntq;
        const int q0 = (qt0 + j % ntq) * TILE;
        const int s = j % STAGES;
        bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        bar_expect_tx(fb, 2 * nch * TILE * ROW);
        for (int c = 0; c < nch; ++c) {
          const uint32_t off = s * T_BYTES + c * TILE * ROW;
          tma_load_4d(sq + off, &qmap, fb, c * CHUNK, h, q0, b);
          tma_load_4d(sdo + off, &omap, fb, c * CHUNK, h, q0, b);
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int col0 = sl * SW + wg * GD;
  const bool live = col0 < ld;
  const int r0 = k0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  // dO's and Q's columns col0 .. col0 + GD - 1 in a ring tile
  const uint32_t cols = (col0 / CHUNK) * TILE * ROW;

  float accK[GD / 2], accV[GD / 2];
#pragma unroll
  for (int i = 0; i < GD / 2; ++i) {
    accK[i] = 0.f;
    accV[i] = 0.f;
  }
  float st[NS], dpt[NS];             // S^T and dP^T of a tile
  uint32_t ph[NS / 2], pl[NS / 2];   // P^T as bf16 hi and lo A fragments
  uint32_t dh[NS / 2], dl[NS / 2];   // dS^T likewise
  auto settle_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      pin(st[i]);
      pin(dpt[i]);
    }
  };
  auto settle_kv = [&]() {
#pragma unroll
    for (int i = 0; i < GD / 2; ++i) {
      pin(accK[i]);
      pin(accV[i]);
    }
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      pin(ph[i]);
      pin(pl[i]);
      pin(dh[i]);
      pin(dl[i]);
    }
  };

  bar_wait(kbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int h = h0 + j / ntq;
    const int q0 = (qt0 + j % ntq) * TILE;
    const int s = j % STAGES;
    bar_wait(full + 8 * s, (j / STAGES) & 1);
    const uint32_t qs = sq + s * T_BYTES;
    const uint32_t os = sdo + s * T_BYTES;
    const float* lrow = lse + ((size_t)b * H + h) * S;
    const float* drow = delta + ((size_t)b * H + h) * S;
    float lc[NS / 2], ec[NS / 2];
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qpos = q0 + 8 * c + 2 * (lane % 4) + e;
        lc[2 * c + e] = qpos < S ? lrow[qpos] * LOG2E : 0.f;
        ec[2 * c + e] = qpos < S ? drow[qpos] : 0.f;
      }
    wg_fence();
    mma_chunks(st, sk, qs, nch);
    mma_chunks(dpt, sv, os, nch);
    wg_commit();
    wg_wait();
    settle_s();
    const bool edge = k0 + ROWS - 1 > q0 || q0 + TILE > S;
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * c + (e & 1);
        p[e] = exp2_ftz(fmaf(st[4 * c + e], scale_log2, -lc[col]));
        if (edge) {
          const int qpos = q0 + 8 * c + 2 * (lane % 4) + (e & 1);
          if ((e < 2 ? r0 : r1) > qpos || qpos >= S) p[e] = 0.f;
        }
        ds[e] = p[e] * (dpt[4 * c + e] - ec[col]);
      }
      tc::split(p[0], p[1], ph[2 * c], pl[2 * c]);
      tc::split(p[2], p[3], ph[2 * c + 1], pl[2 * c + 1]);
      tc::split(ds[0], ds[1], dh[2 * c], dl[2 * c]);
      tc::split(ds[2], ds[3], dh[2 * c + 1], dl[2 * c + 1]);
    }
    if (live) {
      wg_fence();
      tc::mma_split<GD, TILE>(accV, ph, pl, os + cols);
      tc::mma_split<GD, TILE>(accK, dh, dl, qs + cols);
      wg_commit();
      wg_wait();
      settle_kv();
    }
    if (lane == 0) bar_arrive(empty + 8 * s);
  }

  if (!live) return;
  const size_t row_stride = (size_t)KVH * ld;
  const size_t at0 =
      ((size_t)b * S + r0) * row_stride + (size_t)kh * ld + col0;
  const size_t at1 = at0 + 8 * row_stride;
  if (nsplit > 1) {
    // the block's partial sums, f32, at split `part` of the workspace
    const size_t slab = (size_t)gridDim.z * S * row_stride;
    float* pk = work + (size_t)part * slab;
    float* pv = pk + (size_t)nsplit * slab;
#pragma unroll
    for (int c = 0; c < GD / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col0 + col >= ld) continue;
      if (r0 < S) {
        *reinterpret_cast<float2*>(pk + at0 + col) =
            make_float2(accK[4 * c] * scale, accK[4 * c + 1] * scale);
        *reinterpret_cast<float2*>(pv + at0 + col) =
            make_float2(accV[4 * c], accV[4 * c + 1]);
      }
      if (r1 < S) {
        *reinterpret_cast<float2*>(pk + at1 + col) =
            make_float2(accK[4 * c + 2] * scale, accK[4 * c + 3] * scale);
        *reinterpret_cast<float2*>(pv + at1 + col) =
            make_float2(accV[4 * c + 2], accV[4 * c + 3]);
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < GD / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (col0 + col >= ld) continue;
    if (r0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at0 + col) =
          __floats2bfloat162_rn(accK[4 * c] * scale, accK[4 * c + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at0 + col) =
          __floats2bfloat162_rn(accV[4 * c], accV[4 * c + 1]);
    }
    if (r1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at1 + col) =
          __floats2bfloat162_rn(accK[4 * c + 2] * scale,
                                accK[4 * c + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at1 + col) =
          __floats2bfloat162_rn(accV[4 * c + 2], accV[4 * c + 3]);
    }
  }
}

// hd in 257 .. 512 and ld as tc::launch's; nsplit likewise (a divisor of
// the group, with its workspace where above 1)
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, void* work, int B, int S, int H, int KVH, int hd,
           int ld, int nsplit, cudaStream_t st) {
  if (nsplit < 1 || (H / KVH) % nsplit != 0 ||
      (nsplit > 1 && work == nullptr) || tc::width(hd) != W)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qd, od, kd, vd, qk, ok, kk, vk;
  if (!make_map(&qd, q, B, S, H, hd, ld, ROWS) ||
      !make_map(&od, dout, B, S, H, hd, ld, ROWS) ||
      !make_map(&kd, k, B, S, KVH, hd, ld, TILE) ||
      !make_map(&vd, v, B, S, KVH, hd, ld, TILE) ||
      !make_map(&qk, q, B, S, H, hd, ld, TILE) ||
      !make_map(&ok, dout, B, S, H, hd, ld, TILE) ||
      !make_map(&kk, k, B, S, KVH, hd, ld, ROWS) ||
      !make_map(&vk, v, B, S, KVH, hd, ld, ROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BYTES);
  if (err != cudaSuccess) return (int)err;
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if ((err = (cudaError_t)simt::launch_delta<__nv_bfloat16>(
           o, dout, dl, B, S, H, ld, st)) != cudaSuccess)
    return (int)err;
  const double scale = std::pow((double)hd, -0.5);
  const float sc = (float)scale, sc_log2 = (float)(scale * 1.4426950408889634);
  const unsigned tiles = (unsigned)((S + ROWS - 1) / ROWS);
  dq_wide_kernel<<<dim3(tiles, H * SLICES, B), KV_THREADS, BYTES, st>>>(
      qd, od, kd, vd, lp, dl, static_cast<__nv_bfloat16*>(dq), S, H, KVH, ld,
      sc, sc_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(dv);
  float* wp = static_cast<float*>(work);
  dkdv_wide_kernel<<<dim3(tiles, KVH * SLICES * nsplit, B), KV_THREADS,
                     BYTES, st>>>(qk, ok, kk, vk, lp, dl, dkp, dvp, wp, S, H,
                                  KVH, nsplit, ld, sc, sc_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long n4 = (long long)B * S * KVH * ld / 4;
  tc::sum_splits_kernel<<<dim3((unsigned)((n4 + 255) / 256), 2), 256, 0,
                          st>>>(wp, dkp, dvp, n4, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace wide

// a bf16 head dim -> the tensor-core instance of its width (tc::width),
// on operands and gradients of row stride ld
int dispatch_bf16(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dout, void* dq, void* dk,
                  void* dv, void* delta, void* work, int B, int S, int H,
                  int KVH, int hd, int ld, int nsplit, cudaStream_t st) {
  switch (tc::width(hd)) {
#define BWD_TC_CASE(W)                                                      \
  case W:                                                                   \
    return tc::launch<W>(q, k, v, o, lse, dout, dq, dk, dv, delta, work, B, \
                         S, H, KVH, hd, ld, nsplit, st);
    BWD_TC_CASE(64) BWD_TC_CASE(128) BWD_TC_CASE(256)
#undef BWD_TC_CASE
    case wide::W:
      return wide::launch(q, k, v, o, lse, dout, dq, dk, dv, delta, work, B,
                          S, H, KVH, hd, ld, nsplit, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int prologue(int H, int KVH, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q, k, v, o, lse (the forward's), dout, then dq, dk, dv, the [B, H, S]
// f32 scratch for Delta, work, the dK/dV pass's f32 workspace [2][nsplit]
// [B, S, KVH, hd] (NULL where nsplit is 1), and stage: NULL where hd is a
// multiple of 4, else f32 scratch for q, dO, k and v staged ld = ceil4(hd)
// columns wide, (2 B S H + 2 B S KVH) ld elements; B, S, H, KVH, hd,
// nsplit (a divisor of H / KVH), device, stream
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       void* delta, void* work, void* stage,
                                       int B, int S, int H, int KVH, int hd,
                                       int nsplit, int device, void* stream) {
  int err = prologue(H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ld = (hd + 3) / 4 * 4;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  if (ld != hd) {
    if (stage == nullptr || simt::width(hd) == 0)
      return (int)cudaErrorInvalidValue;
    const long long nq = (long long)B * S * H, nk = (long long)B * S * KVH;
    float* qs = static_cast<float*>(stage);
    float* dos = qs + nq * ld;
    float* ks = dos + nq * ld;
    float* vs = ks + nk * ld;
    const void* in[4] = {q, dout, k, v};
    void* staged[4] = {qs, dos, ks, vs};
    const long long rows[4] = {nq, nq, nk, nk};
    if ((err = restride::copy<uint32_t>(4, in, staged, rows, hd, ld, st)) !=
        0)
      return err;
    qp = qs;
    dop = dos;
    kp = ks;
    vp = vs;
  }
  return simt::dispatch(qp, kp, vp, dop, o, dout,
                        static_cast<const float*>(lse),
                        static_cast<float*>(dq), static_cast<float*>(dk),
                        static_cast<float*>(dv), static_cast<float*>(delta),
                        static_cast<float*>(work), B, S, H, KVH, hd, ld,
                        nsplit, st);
}

// the f32 entry's arguments, but work is [2][nsplit][B, S, KVH, ld] and
// stage NULL where hd is a multiple of 8, else bf16 scratch for q, o, dO,
// dQ, k, v, dK and dV staged ld = ceil8(hd) columns wide, (4 B S H + 4 B S
// KVH) ld elements; nsplit is 1 but at widths 256 and 512 (a divisor of H
// / KVH there)
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        void* delta, void* work, void* stage,
                                        int B, int S, int H, int KVH, int hd,
                                        int nsplit, int device,
                                        void* stream) {
  int err = prologue(H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ld = (hd + 7) / 8 * 8;
  if (ld == hd)
    return dispatch_bf16(q, k, v, o, lse, dout, dq, dk, dv, delta, work, B,
                         S, H, KVH, hd, hd, nsplit, st);
  if (stage == nullptr) return (int)cudaErrorInvalidValue;
  const long long nq = (long long)B * S * H, nk = (long long)B * S * KVH;
  uint16_t* qs = static_cast<uint16_t*>(stage);
  uint16_t* os = qs + nq * ld;
  uint16_t* dos = os + nq * ld;
  uint16_t* dqs = dos + nq * ld;
  uint16_t* ks = dqs + nq * ld;
  uint16_t* vs = ks + nk * ld;
  uint16_t* dks = vs + nk * ld;
  uint16_t* dvs = dks + nk * ld;
  const void* in[5] = {q, o, dout, k, v};
  void* staged[5] = {qs, os, dos, ks, vs};
  const long long rows[5] = {nq, nq, nq, nk, nk};
  if ((err = restride::copy(5, in, staged, rows, hd, ld, st)) != 0 ||
      (err = dispatch_bf16(qs, ks, vs, os, lse, dos, dqs, dks, dvs, delta,
                           work, B, S, H, KVH, hd, ld, nsplit, st)) != 0)
    return err;
  const void* out[3] = {dqs, dks, dvs};
  void* narrowed[3] = {dq, dk, dv};
  const long long out_rows[3] = {nq, nk, nk};
  return restride::copy(3, out, narrowed, out_rows, ld, hd, st);
}

// the dK/dV launch a head dim gets, for kernels/flash_attention.bwd_geometry
// to be held against: out = {route (1 the tensor cores, 0 the CUDA cores),
// the instance's width, key rows a block, shared memory a block}; bf16 is
// 0 for f32, 1 for bf16. cudaErrorInvalidValue past the domain (1 to 512).
extern "C" int flash_attention_bwd_geometry(int bf16, int hd, int* out) {
  if (!bf16) {
    out[0] = 0;
    return simt::geometry(hd, out + 1) ? 0 : (int)cudaErrorInvalidValue;
  }
  out[0] = 1;
  if (tc::width(hd) == wide::W) {
    out[1] = wide::W;
    out[2] = wide::ROWS;
    out[3] = wide::BYTES;
    return 0;
  }
  return tc::geometry(hd, out + 1) ? 0 : (int)cudaErrorInvalidValue;
}
