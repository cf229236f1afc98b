// Causal GQA flash attention, forward pass, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (_kernel).
//
//   o[b, i, h] = sum_{j <= i} softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(hd))
//                v[b, j, h/G]
//
// q [B, S, H, hd], k and v [B, S, KVH, hd], G = H / KVH; o [B, S, H, hd] in
// the input type. Scores, softmax and sums in f32; masked scores are -1e30
// and o = acc / max(l, 1e-30), as in the TPU kernel. Any S: rows and keys
// at or past S are masked here (the TPU wrapper needs S % block == 0).
// Optionally (lse not null) both kernels also write each row's
// log-sum-exp of its scaled scores, lse [B, H, S] f32, in natural-log
// units: m + log(l) on the f32 path, (m + log2(l)) ln 2 on the bf16 path
// (whose running max is in log2 units); the backward pass
// (flash_attention_bwd.cu) recomputes p = exp(s scale - lse) from it.
//
// Bound on the H100: operations. The function needs 4*B*H*hd*S^2/2 FLOPs
// (two products over the causal half) against (2*B*S*H + 2*B*S*KVH)*hd
// elements moved: hundreds of FLOPs per byte at S in the thousands.
//
// bf16 runs on the tensor cores at every head dim 1 to 512 (namespaces tc
// and wide), f32 on the CUDA cores (namespace simt).
//
// bf16 (flash_attention_bf16): the tensor cores. One block per (tile of
// 128 query rows, head, batch), longest rows first: two consumer
// warpgroups of 64 rows and one producer warp. The producer fills the
// block's q tile once and a ring of STAGES (k, v) tiles by TMA (4-d tensor
// maps over [B, S, heads, hd], 128-byte swizzle, mbarriers; keys past S
// arrive as zeros); a tile is 128 keys up to hd = 128 and 64 above, for
// shared memory. S = Q.K^T is wgmma with both operands in shared memory and
// f32 accumulators in registers; bf16 inputs are exact, so S differs from
// the f32 plain S by summation order only. The online softmax works on the
// accumulator fragments: a row's max and sum across the four threads that
// share it by shuffles, masks only on tiles that cross the diagonal or S.
// P.V keeps p's f32 precision by splitting it: p_hi = bf16(p), p_lo =
// bf16(p - p_hi), two wgmma with A from registers (the S accumulator layout
// is the A fragment layout) and V MN-major from shared memory, both into
// the same f32 o. p_hi + p_lo holds p to about 2^-16; a single bf16 p
// would add up to 2^-9 per term, against a limit that the output's own
// bf16 rounding already nearly fills. The split costs one more P.V: 1.5x
// the function's operations.
//
// What bounds it is not the tensor cores: without any product the kernel
// keeps most of its time (PERF.md). Each warpgroup runs S, its softmax and
// P.V in turn, so the softmax (hundreds of instructions a thread per tile,
// with one warp per scheduler to hide their latency) lies on its critical
// path, and only the other warpgroup's products overlap it; a block's start
// (the q tile's load) and its epilogue overlap nothing. Issuing the next S
// before the softmax, to overlap a warpgroup's softmax with its own
// products, made ptxas serialize the wgmma here. Instances of width 64,
// 128, 192 and 256; every bf16 head dim up to 256 runs the least one at or
// above it (tc_width in kernels/flash_attention.py). The tensor maps' row
// stride ld must be a multiple of 8 elements (every global stride of a
// map a multiple of 16 bytes, as the TMA needs): at a head dim that is a
// multiple of 8, ld is the head dim and the kernel reads the caller's
// tensors; at any other the entry stages q, k and v in buffers ld =
// ceil8(hd) columns wide, zeros past hd (restride.cuh, in a scratch the
// wrapper allocates), and narrows o, which the kernel writes ld wide (the
// launch takes both: the maps' extent and the scale from hd, the row
// stride from ld). The maps' extent is the head dim, so
// the TMA fills the tiles' columns past it with zeros: they add nothing
// to S, P.V computes zeros there, and the store skips the columns past ld
// (its paired bf16 stores start on even columns of a row whose length is
// a multiple of 8, so they stay 4-byte aligned). A head dim of 8 thus
// does the work of 64 (the SMOKE configs' widths; no published config has
// one under 64 or between the widths).
//
// hd 256 (Gemma 2B): a consumer warpgroup's 64 x 256 f32 output would take
// 128 registers a thread, beside S (32) and the p pair (32), over what
// 288 threads can hold. So at hd 256 a block has 64 query rows, and both
// warpgroups take all 64: each computes the same S and softmax (the same
// bits) and accumulates half of o's columns, 64 x 128, with an n128 P.V
// over its half of V's columns. S is computed twice: 2x the function's
// operations against 1.5x at the other head dims. The q tile of 64 rows
// leaves room for the 3-stage ring of 64-key tiles (230,456 bytes).
//
// Past hd 256 (namespace wide, Gemma's hd 256 taken further): one
// instance of width 512 for every bf16 head dim 257 to 512, on buffers ld
// wide as above. Its limits: 227 KB of shared memory a block and a
// warpgroup's registers, which hold at most 64 x 128 f32 of o beside S
// and p. So a block has 64 query rows, both warpgroups take all 64 and
// compute the same S and softmax, and o's 512 columns split over a grid
// axis of SLICES = 2 column slices and, inside a slice, over the two
// warpgroups: 128 columns each, an n128 P.V as at hd 256. Each block
// recomputes S for its slice: 4x the S that the function needs (two
// slices, two warpgroups), against 2x at hd 256. The q tile, 64 rows x
// 512, stays in shared memory (64 KB); each ring stage holds a k tile of
// BKV = 32 keys at every column (S = Q.K^T over the head dim, an n32
// wgmma) and the v tile of the slice's 256 columns: 48 KB a stage, 3
// stages, 214,072 bytes. The 64-column chunks that hold none of the first
// ld columns are neither loaded nor multiplied, and a warpgroup whose
// columns all lie past ld issues no P.V: hd 320 pays for S over 320
// columns, not 512. Blocks are numbered longest first (hopper.cuh).
//
// The CUDA cores (namespace simt): f32 at every head dim 1 to 512.
// Precision contract: every product a chain of exact f32 FMAs (no TF32),
// the softmax in f32 with masked scores at -1e30, o = acc / max(l,
// 1e-30), lse = m + log(l) in natural-log units. Bound by the CUDA
// cores: 67 TFLOP/s of f32 FMAs on the H100 (an f32 SGEMM by torch.mm
// reaches 51.9 on the same card; PERF.md). The design
// (flash_attention_simt.cuh has the two products and their layouts):
//   - A block is 256 threads and R query rows: 128 up to width 128, where
//     a thread holds 8 x 8 scores and 8 x 8 outputs, 64 above (8 x 4
//     scores, up to 8 x 16 outputs at 512). It walks the keys up to its
//     diagonal in steps of 128: S = Q.K^T, the online softmax on those
//     registers (row max and sum by shuffles, p to an [R][132] tile in
//     shared memory), then o += P.V. m, l and o stay in registers.
//   - The q tile stays resident in shared memory, [R][ceil32(ld) + 4].
//     A ring of STAGES = 3 slabs of 18 KB streams k and v by 16-byte
//     cp.async copies issued two slabs ahead: a step's k slabs (128 keys
//     x DC = 32 head-dim columns, rows DC + 4 floats apart for
//     conflict-free loads), then its v slabs (KC keys x the block's
//     columns). Rows past S and columns past the head dim arrive as zeros
//     through the copy's source size.
//   - 16-byte copies need rows of a multiple of 4 floats, so at any other
//     head dim the entry stages q, k and v ld = ceil4(hd) wide (zeros past
//     hd; restride.cuh, in a scratch the wrapper allocates). o is written
//     hd wide by the kernel itself, float4 stores where hd allows.
//   - Instances of width 32, 64, .. 256 and 320, 384, 448, 512
//     (SIMT_WIDTHS); a head dim runs the least one at or above it, its
//     k slabs cut at the head dim, so only P.V pays for the width.
//   - A launch may split o's columns over a grid axis of nslice slices,
//     each block recomputing S for its slice (SLICES = 1 by default: the
//     widest block's outputs fit its registers); the wrapper's _slices
//     measures the split against that recompute.
//   - Blocks are numbered longest first (hopper.cuh).
//
// All keep the [S, S] scores out of device memory, the property of the
// TPU kernel worth keeping.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_attention_simt.cuh"
#include "hopper.cuh"
#include "restride.cuh"

namespace {

constexpr float NEG = -1e30f;

// ------------------------------------------------------------ CUDA cores --

namespace simt {

using namespace attn_simt;
using hopper::cp_async16_zfill;
using hopper::cp_commit;
using hopper::cp_wait;

constexpr int STAGES = 3;       // ring slabs in flight
constexpr int DC = 32;          // head-dim columns of a k slab
constexpr int SLD = DC + 4;     // its row stride
constexpr int STAGE = TILE * SLD;   // floats a slab: k [TILE][SLD], v [KC][WC]
constexpr int SLICES = 1;       // column slices a row tile, by default

// the instance a head dim runs (simt_width in kernels/flash_attention.py):
// the least of 32, 64, .. 256, 320, 384, 448, 512 at or above it; 0
// outside 1 to 512
__host__ __device__ constexpr int width(int hd) {
  return hd < 1 || hd > 512 ? 0
       : hd <= 256 ? (hd + 31) / 32 * 32 : (hd + 63) / 64 * 64;
}

// query rows a block at instance width W (simt_rows in
// kernels/flash_attention.py): 128 up to 128, where the registers hold
// 8 x 8 scores and 8 x 8 outputs a thread, else 64
__host__ __device__ constexpr int rows(int W) { return W <= 128 ? 128 : 64; }

// the resident q tile's row stride for operands ld wide: whole slabs of
// DC columns and 4 more (an odd number of 16-byte units)
__host__ __device__ constexpr int q_ld(int ld) {
  return (ld + DC - 1) / DC * DC + 4;
}

// a block's shared memory at R rows: the ring, the P tile, a row's
// rescale (then its l) and the resident q tile [R][q_ld]
__host__ __device__ constexpr int smem_bytes(int R, int ld) {
  return 4 * (STAGES * STAGE + R * PLD + R + R * q_ld(ld));
}
static_assert(smem_bytes(64, 512) <= 232448 && smem_bytes(128, 128) <=
              232448, "over the block's shared memory");

// rows [0, R) x columns [0, 4 C4) of a slab into dst (row stride DLD):
// row r from src + (row0 + r) stride + col0, zeros at rows past S and at
// columns past ld (16-byte copies: ld and the strides are multiples of 4)
template <int R, int C4, int DLD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t stride, int row0, int S,
                                          int col0, int ld) {
  for (int p = threadIdx.x; p < R * C4; p += THREADS) {
    const int r = p / C4, c = 4 * (p % C4);
    const bool in = row0 + r < S && col0 + c < ld;
    cp_async16_zfill(dst + r * DLD + c,
                     in ? src + (size_t)(row0 + r) * stride + col0 + c : src,
                     in ? 16 : 0);
  }
}

// WC: the block's columns of o (the instance's width; slice sl of nslice
// holds columns sl WC ..). q, k, v rows ld floats a head (ld = hd rounded
// up to 4, staged by the entry where that is not hd), o rows hd.
template <int WC>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int S, int H, int KVH, int hd, int ld,
           int nslice, float scale) {
  constexpr int R = rows(WC);
  using C = Cols<WC, R>;
  using G = Rows<R>;
  constexpr int KC = chunk_rows(WC, STAGE);   // v rows a slab
  constexpr int NV = TILE / KC;
  const int qld = q_ld(ld);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [STAGES][STAGE]
  float* Ps = ring + STAGES * STAGE;          // [R][PLD]
  float* Rs = Ps + R * PLD;                   // [R]
  float* Qs = Rs + R;                         // [R][qld]

  const int3 blk = hopper::longest_first();
  const int nq = (S + R - 1) / R;
  const int qt = nq - 1 - blk.x;              // longest rows first
  const int h = blk.y / nslice, sl = blk.y % nslice;
  const int b = blk.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int q0 = qt * R, c0 = sl * WC;
  // the score layout: rows rs .. rs + 7, keys kl + LG j
  const int rs = 8 * (G::RG * w + lane / G::LG), kl = lane % G::LG;
  const size_t qs = (size_t)H * ld, ks = (size_t)KVH * ld;
  const float* kb = k + (size_t)b * S * ks + (size_t)kh * ld;
  const float* vb = v + (size_t)b * S * ks + (size_t)kh * ld;
  const int nd = (ld + DC - 1) / DC;          // k slabs a step
  const int per = nd + NV;
  const int steps = (q0 + R - 1 < S ? q0 + R - 1 : S - 1) / TILE + 1;
  const int total = steps * per;

  // the q tile, resident, in the first group of copies
  {
    const float* qb = q + (size_t)b * S * qs + (size_t)h * ld;
    const int c4s = qld / 4 - 1;
    for (int p = tid; p < R * c4s; p += THREADS) {
      const int r = p / c4s, c = 4 * (p % c4s);
      const bool in = q0 + r < S && c < ld;
      cp_async16_zfill(Qs + r * qld + c,
                       in ? qb + (size_t)(q0 + r) * qs + c : qb, in ? 16 : 0);
    }
  }
  // slab c of the block's sequence: a step's nd slabs of k columns, then
  // its NV slabs of v rows
  auto issue = [&](int c) {
    if (c < total) {
      float* dst = ring + (c % STAGES) * STAGE;
      const int k0 = c / per * TILE, part = c % per;
      if (part < nd)
        load_rows<TILE, DC / 4, SLD>(dst, kb, ks, k0, S, part * DC, ld);
      else
        load_rows<KC, WC / 4, WC>(dst, vb, ks, k0 + (part - nd) * KC, S, c0,
                                  ld);
    }
    cp_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  const int r0 = C::TM * (tid / C::CT), c4 = tid % C::CT;
  float4 acc[C::TM][C::TN4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) acc[i][j] = make_float4(0, 0, 0, 0);
  float m[8], l[8];   // rows rs + i, the same in every lane of a group
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }

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
      score<DC, R, R == 128 ? 2 : DC / 4>(Qs + rs * qld + part * DC, qld,
                                          ring + (c % STAGES) * STAGE, sc,
                                          kl);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + rs + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) {
        const float s =
            k0 + kl + G::LG * j <= qpos ? sc[i][j] * scale : NEG;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], group_max<G::LG>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(rs + i) * PLD + kl + G::LG * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum<G::LG>(sum);
      m[i] = m_new;
      if (kl == i) Rs[rs + i] = alpha;
    }
    for (int part = 0; part < NV; ++part, ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();   // slab c landed; P and the rescale are written
      issue(c + STAGES - 1);
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          const float a = Rs[r0 + i];
#pragma unroll
          for (int j = 0; j < C::TN4; ++j) {
            acc[i][j].x *= a;
            acc[i][j].y *= a;
            acc[i][j].z *= a;
            acc[i][j].w *= a;
          }
        }
      }
      apply<WC, R, KC, R == 128 ? 2 : KC / 4>(
          Ps + part * KC, ring + (c % STAGES) * STAGE, acc, r0, c4);
    }
  }

  __syncthreads();   // the last step's readers of Rs are done
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + rs + i;
    if (kl == i) {
      Rs[rs + i] = fmaxf(l[i], 1e-30f);
      if (lse != nullptr && sl == 0 && qpos < S)
        lse[((size_t)b * H + h) * S + qpos] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= S) continue;
    const float denom = Rs[r0 + i];
    float* row = o + ((size_t)b * S + qpos) * H * hd + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) {
      const float4 a = acc[i][j];
      store4(row, c0 + 4 * (c4 + C::CT * j), hd,
             make_float4(a.x / denom, a.y / denom, a.z / denom,
                         a.w / denom));
    }
  }
}

template <int WC>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int H, int KVH, int hd, int ld,
           int nslice, cudaStream_t st) {
  constexpr int R = rows(WC);
  const int smem = smem_bytes(R, ld);
  if (smem > 232448) return (int)cudaErrorInvalidValue;   // a sliced ld
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<WC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + R - 1) / R, H * nslice, B);
  const float scale = (float)std::pow((double)hd, -0.5);
  fwd_kernel<WC><<<grid, THREADS, smem, st>>>(q, k, v, o, lse, S, H, KVH, hd,
                                              ld, nslice, scale);
  return (int)cudaGetLastError();
}

// the instances, by width (SIMT_WIDTHS)
#define SIMT_WIDTH_LIST(X)                                                  \
  X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256) X(320) X(384)      \
  X(448) X(512)

// a head dim's launch on operands ld wide: nslice column slices (0: the
// default, SLICES) of the instance width(ceil(ld / nslice))
inline int dispatch(const float* q, const float* k, const float* v,
                    float* o, float* lse, int B, int S, int H, int KVH,
                    int hd, int ld, int nslice, cudaStream_t st) {
  if (nslice == 0) nslice = SLICES;
  if (nslice < 1 || width(hd) == 0) return (int)cudaErrorInvalidValue;
  switch (width((ld + nslice - 1) / nslice)) {
#define SIMT_CASE(W) \
  case W:            \
    return launch<W>(q, k, v, o, lse, B, S, H, KVH, hd, ld, nslice, st);
    SIMT_WIDTH_LIST(SIMT_CASE)
#undef SIMT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef SIMT_WIDTH_LIST

// out = {width, query rows a block, shared memory} of a head dim's
// launch, or 0 where it has none
inline int geometry(int hd, int* out) {
  if (width(hd) == 0) return 0;
  out[0] = width(hd);
  out[1] = rows(width(hd));
  out[2] = smem_bytes(rows(width(hd)), (hd + 3) / 4 * 4);
  return 1;
}

}  // namespace simt

// --------------------------------------------------------------- bf16 ----

namespace tc {

using namespace hopper;

constexpr int BQ = 128;                 // query rows per block (64 at hd 256)
constexpr int STAGES = 3;               // (k, v) tiles in flight
constexpr int CONSUMERS = 256;          // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr int CHUNK = 64;               // hd columns per 128-byte swizzled row
constexpr int ROW = 128;                // bytes per swizzled row

// Tile sizes and shared memory, every tile 1024-byte aligned (the 128-byte
// swizzle's period). A tile of R rows x hd is hd/64 chunks of R rows x 128
// bytes. Keys per tile: 128 up to hd = 128, 64 above (shared memory).
// SPLIT (hd 256): the block's ROWS = 64 query rows are both warpgroups',
// and warpgroup wg holds o's columns [OD wg, OD wg + OD); otherwise
// warpgroup wg holds rows [64 wg, 64 wg + 64) and all hd columns.
template <int HD>
struct Layout {
  static constexpr bool SPLIT = HD > 192;
  static constexpr int ROWS = SPLIT ? BQ / 2 : BQ;    // query rows a block
  static constexpr int OD = SPLIT ? HD / 2 : HD;      // o columns a warpgroup
  static constexpr int BKV = HD <= 128 ? 128 : 64;
  static constexpr int NCH = HD / CHUNK;
  static constexpr int Q_BYTES = ROWS * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;      // one k or one v tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // full[STAGES], empty[STAGES], q barrier; 1024 bytes of alignment slack
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// O[64 x 192] += A[64 x 16] B[16 x 192], A from registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n192(float (&d)[96], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x N] += P[64 x 16] V[16 x N], N = the warpgroup's o columns
template <int N>
__device__ __forceinline__ void mma_pv(float (&o)[N / 2], const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 64) mma_rs_n64(o, a, db);
  else if constexpr (N == 128) mma_rs_n128(o, a, db);
  else mma_rs_n192(o, a, db);
}

// S (+)= Q K^T over one k16 step; the first step overwrites S
template <int BKV>
__device__ __forceinline__ void mma_qk(float (&s)[BKV / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (BKV == 64) mma_ss_n64(s, da, db, accumulate);
  else mma_ss_n128<0, 0>(s, da, db, accumulate);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int KVH,
                          int hd, float scale_log2) {
  using L = Layout<HD>;
  constexpr int BKV = L::BKV;
  constexpr int ROWS = L::ROWS;
  constexpr int OD = L::OD;
  constexpr int NS = BKV / 2;   // score fragment floats per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::K_OFF;
  const uint32_t sv = base + L::V_OFF;
  const uint32_t full = base + L::BAR_OFF;     // full[s] = full + 8 s
  const uint32_t empty = full + 8 * STAGES;    // empty[s] = empty + 8 s
  const uint32_t qbar = empty + 8 * STAGES;

  const int nq = (S + ROWS - 1) / ROWS;
  const int qt = nq - 1 - (int)blockIdx.x;     // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * ROWS;
  const int n_kv = (min(q0 + ROWS, S) + BKV - 1) / BKV;
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
    // producer: the q tile once, then the (k, v) ring
    if (tid == CONSUMERS) {
      bar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
        tma_load_4d(sq + c * ROWS * ROW, &qmap, qbar, c * CHUNK, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
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

  // consumers: warpgroup wg owns query rows row0 .. row0 + 63 and o's
  // columns col0 .. col0 + OD - 1, and computes kv tiles 0 .. nt - 1 (the
  // rest lie above its rows)
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + (L::SPLIT ? 0 : 64 * wg);
  const int col0 = L::SPLIT ? OD * wg : 0;
  const int r0 = row0 + 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int nt = min(n_kv, (row0 + 63) / BKV + 1);
  const uint32_t qa = sq + (L::SPLIT ? 0 : 64 * wg * ROW);

  float acc[OD / 2];
#pragma unroll
  for (int i = 0; i < OD / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG;   // running max of the scaled scores (log2 units)
  float l0 = 0.f, l1 = 0.f;   // this thread's share of the running sums
  float sc[NS];               // S of a tile
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  uint32_t ph[NS / 2], pl[NS / 2];   // bf16 hi and lo A fragments of p

  // V's columns col0 .. col0 + OD - 1 start at chunk col0 / CHUNK
  auto issue_pv = [&](int j) {
    const uint32_t vt = sv + (j % STAGES) * L::KV_BYTES +
                        (col0 / CHUNK) * BKV * ROW;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_pv<OD>(acc, ph + 4 * kk, desc(vt + kk * 16 * ROW, BKV * ROW, 1024));
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_pv<OD>(acc, pl + 4 * kk, desc(vt + kk * 16 * ROW, BKV * ROW, 1024));
  };
  auto issue_s = [&](int j) {
    const uint32_t kt = sk + (j % STAGES) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // k16 step in the row
      mma_qk<BKV>(sc, desc(qa + (kk / 4) * ROWS * ROW + off, 16, 1024),
                  desc(kt + (kk / 4) * BKV * ROW + off, 16, 1024), kk > 0);
    }
  };
  // after a group's wait: nothing it wrote or read moves across it
  auto settle = [&]() {
#pragma unroll
    for (int i = 0; i < OD / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < NS; ++i) pin(sc[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      pin(ph[i]);
      pin(pl[i]);
    }
  };
  auto release = [&](int j) {
    if (lane == 0) bar_arrive(empty + 8 * (j % STAGES));
  };
  // the online softmax of tile j on sc: m, l and acc rescaled; p into
  // ph (bf16 hi) and pl (bf16 lo)
  auto softmax = [&](int j) {
    // sc[4c + e]: row r0 (e < 2) or r1 (e >= 2), key k0 + 8c + 2(lane%4) + e%2
    const int k0 = j * BKV;
    if (k0 + BKV - 1 > row0 || k0 + BKV > S) {   // the diagonal, or past S
#pragma unroll
      for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * c + 2 * (lane % 4) + e;
          if (kpos > r0 || kpos >= S) sc[4 * c + e] = NEG;
          if (kpos > r1 || kpos >= S) sc[4 * c + 2 + e] = NEG;
        }
      }
    }
    // the row max on the raw scores; the scale (> 0) goes into the
    // exponent's fma: p = 2^(s * scale - m)
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = exp2_ftz(m0 - mx0);
    const float a1 = exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // p in f32, split into bf16 hi and lo: ph[2c] row r0 keys 8c..,
    // ph[2c + 1] row r1; the A fragment of k16 step kk is ph[4kk .. 4kk + 3]
    // (the accumulator layout is the A fragment layout)
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
      const float p00 = exp2_ftz(fmaf(sc[4 * c], scale_log2, -m0));
      const float p01 = exp2_ftz(fmaf(sc[4 * c + 1], scale_log2, -m0));
      const float p10 = exp2_ftz(fmaf(sc[4 * c + 2], scale_log2, -m1));
      const float p11 = exp2_ftz(fmaf(sc[4 * c + 3], scale_log2, -m1));
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      const uint32_t h0 = bf16x2(p00, p01);
      const uint32_t h1 = bf16x2(p10, p11);
      ph[2 * c] = h0;
      ph[2 * c + 1] = h1;
      pl[2 * c] = bf16x2(p00 - bf16_lo(h0), p01 - bf16_hi(h0));
      pl[2 * c + 1] = bf16x2(p10 - bf16_lo(h1), p11 - bf16_hi(h1));
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    // acc *= alpha, unless no row of the warp changed its max (alpha is
    // then exactly 1 for each)
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int c = 0; c < OD / 8; ++c) {
        acc[4 * c] *= a0;
        acc[4 * c + 1] *= a0;
        acc[4 * c + 2] *= a1;
        acc[4 * c + 3] *= a1;
      }
    }
  };

  // Per tile: S = Q.K^T, its softmax, P.V, each product waited for
  // before its results are read. The two warpgroups run independently, so
  // that one's softmax overlaps the other's products on the tensor cores.
  bar_wait(qbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    bar_wait(full + 8 * (j % STAGES), (j / STAGES) & 1);
    if (j < nt) {
      wg_fence();
      issue_s(j);
      wg_commit();
      wg_wait();
      settle();
      softmax(j);
      wg_fence();
      issue_pv(j);
      wg_commit();
      wg_wait();
      settle();
    }
    release(j);
  }

  // the four threads of a row hold a quarter of its sum each
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = 1.f / fmaxf(l0, 1e-30f);
  const float d1 = 1.f / fmaxf(l1, 1e-30f);
  // the log-sum-exp in natural-log units, the f32 path's quantity: m is
  // the running max in log2 units and l the sum of 2^(s scale log2e - m)
  // (under SPLIT both warpgroups hold the same rows: the first writes)
  if (lse != nullptr && lane % 4 == 0 && (!L::SPLIT || wg == 0)) {
    constexpr float LN2 = 0.6931471805599453f;
    float* lrow = lse + ((size_t)b * H + h) * S;
    if (r0 < S) lrow[r0] = (m0 + log2f(l0)) * LN2;
    if (r1 < S) lrow[r1] = (m1 + log2f(l1)) * LN2;
  }
  // o's columns col0 .. col0 + OD - 1 of hd (an instance wider than hd
  // holds zeros past it, not stored)
  const size_t row_stride = (size_t)H * hd;
  __nv_bfloat16* o0 =
      o + ((size_t)b * S + r0) * row_stride + (size_t)h * hd + col0;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int c = 0; c < OD / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (col0 + col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * c] * d0, acc[4 * c + 1] * d0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * d1, acc[4 * c + 3] * d1);
  }
}

// the instance a bf16 head dim runs on the tensor cores (TC_WIDTHS and
// tc_width in kernels/flash_attention.py): the least width at or above it,
// 512 (namespace wide) past 256; 0 outside 1 to 512
__host__ __device__ constexpr int width(int hd) {
  return hd < 1 || hd > 512 ? 0 : hd <= 64 ? 64 : hd <= 128 ? 128
       : hd <= 192 ? 192 : hd <= 256 ? 256 : 512;
}

// HD: the instance's width; hd the head dim in (HD - 64, HD]: the maps'
// extent, so that the TMA fills the tiles' columns past hd with zeros, and
// the scale's; ld: q's, k's, v's and o's row stride, hd rounded up to a
// multiple of 8 (the kernel's own hd: it stores o's columns up to ld)
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KVH, int hd, int ld,
           cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  if (width(hd) != HD) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  constexpr int ROWS = Layout<HD>::ROWS;
  if (!make_map(&qm, q, B, S, H, hd, ld, ROWS) ||
      !make_map(&km, k, B, S, KVH, hd, ld, Layout<HD>::BKV) ||
      !make_map(&vm, v, B, S, KVH, hd, ld, Layout<HD>::BKV))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  const float scale_log2 =
      (float)(std::pow((double)hd, -0.5) * 1.4426950408889634);
  flash_attention_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S,
      H, KVH, ld, scale_log2);
  return (int)cudaGetLastError();
}

// out = {width, query rows a block, shared memory}, or 0 where the head
// dim has no tensor-core instance
inline int geometry(int hd, int* out) {
  switch (width(hd)) {
#define TC_GEO(W)                     \
  case W:                             \
    out[0] = W;                       \
    out[1] = Layout<W>::ROWS;         \
    out[2] = Layout<W>::BYTES;        \
    return 1;
    TC_GEO(64) TC_GEO(128) TC_GEO(192) TC_GEO(256)
#undef TC_GEO
    default: return 0;
  }
}

}  // namespace tc

// ------------------------------------------------- bf16 past hd 256 ----

namespace wide {

using namespace hopper;
using tc::CHUNK;
using tc::CONSUMERS;
using tc::ROW;
using tc::THREADS;

constexpr int W = 512;                  // the instance's width
constexpr int ROWS = 64;                // query rows a block, both warpgroups'
constexpr int BKV = 32;                 // keys a (k, v) tile
constexpr int SLICES = 2;               // o's column slices, a grid axis
constexpr int SW = W / SLICES;          // columns a slice
constexpr int OD = SW / 2;              // o columns a warpgroup
constexpr int STAGES = 3;               // (k, v) tiles in flight
constexpr int Q_BYTES = ROWS * W * 2;   // the q tile, every column
constexpr int K_BYTES = BKV * W * 2;    // a k tile, every column
constexpr int V_BYTES = BKV * SW * 2;   // a v tile, the slice's columns
constexpr int K_OFF = Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
// full[STAGES], empty[STAGES], the q barrier; alignment slack
constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
static_assert(BYTES <= 232448, "over the block's shared memory");

// One block per (64 query rows, head x slice, batch), numbered longest
// first. ld: the row stride of q, k, v and o (a multiple of 8); the
// 64-column chunks at or past ld are neither loaded nor multiplied.
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S, int H, int KVH,
                            int ld, float scale_log2) {
  constexpr int NS = BKV / 2;   // score fragment floats per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + K_OFF;
  const uint32_t sv = base + V_OFF;
  const uint32_t full = base + BAR_OFF;     // full[s] = full + 8 s
  const uint32_t empty = full + 8 * STAGES;  // empty[s] = empty + 8 s
  const uint32_t qbar = empty + 8 * STAGES;

  const int3 blk = longest_first();
  const int nq = (S + ROWS - 1) / ROWS;
  const int qt = nq - 1 - blk.x;
  const int h = blk.y / SLICES;
  const int sl = blk.y % SLICES;
  const int b = blk.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * ROWS;
  const int n_kv = (min(q0 + ROWS, S) + BKV - 1) / BKV;
  // the chunks holding any of the first ld columns: of q and k, and of
  // the slice's v
  const int nch = (ld + CHUNK - 1) / CHUNK;
  const int vch = min(SW / CHUNK, max(0, nch - sl * (SW / CHUNK)));
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
    // producer: the q tile once, then the (k, v) ring
    if (tid == CONSUMERS) {
      bar_expect_tx(qbar, nch * ROWS * ROW);
      for (int c = 0; c < nch; ++c)
        tma_load_4d(sq + c * ROWS * ROW, &qmap, qbar, c * CHUNK, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        bar_expect_tx(fb, (nch + vch) * BKV * ROW);
        for (int c = 0; c < nch; ++c)
          tma_load_4d(sk + s * K_BYTES + c * BKV * ROW, &kmap, fb,
                      c * CHUNK, kh, j * BKV, b);
        for (int c = 0; c < vch; ++c)
          tma_load_4d(sv + s * V_BYTES + c * BKV * ROW, &vmap, fb,
                      (sl * (SW / CHUNK) + c) * CHUNK, kh, j * BKV, b);
      }
    }
    return;
  }

  // consumers: both warpgroups own the block's 64 rows; warpgroup wg
  // holds o's columns col0 .. col0 + OD - 1
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int col0 = sl * SW + wg * OD;
  const bool live = col0 < ld;                 // any column to store
  const int r0 = q0 + 16 * warp + lane / 4;    // this thread's rows r0, r1
  const int r1 = r0 + 8;

  float acc[OD / 2];
#pragma unroll
  for (int i = 0; i < OD / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG;   // running max of the scaled scores (log2 units)
  float l0 = 0.f, l1 = 0.f;   // this thread's share of the running sums
  float sc[NS];               // S of a tile
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  uint32_t ph[NS / 2], pl[NS / 2];   // bf16 hi and lo A fragments of p

  // S = Q.K^T over the live chunks, 4 k16 steps a chunk
  auto issue_s = [&](int j) {
    const uint32_t kt = sk + (j % STAGES) * K_BYTES;
    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n32(sc, desc(sq + c * ROWS * ROW + kk * 32, 16, 1024),
                   desc(kt + c * BKV * ROW + kk * 32, 16, 1024),
                   c > 0 || kk > 0);
    }
  };
  // the warpgroup's columns of V start at chunk wg OD / CHUNK of the
  // slice's tile
  auto issue_pv = [&](int j) {
    const uint32_t vt = sv + (j % STAGES) * V_BYTES +
                        wg * (OD / CHUNK) * BKV * ROW;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_rs_n128(acc, ph + 4 * kk, desc(vt + kk * 16 * ROW, BKV * ROW, 1024));
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_rs_n128(acc, pl + 4 * kk, desc(vt + kk * 16 * ROW, BKV * ROW, 1024));
  };
  auto settle = [&]() {
#pragma unroll
    for (int i = 0; i < OD / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < NS; ++i) pin(sc[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      pin(ph[i]);
      pin(pl[i]);
    }
  };
  // the online softmax of tile j, as namespace tc's
  auto softmax = [&](int j) {
    const int k0 = j * BKV;
    if (k0 + BKV - 1 > q0 || k0 + BKV > S) {   // the diagonal, or past S
#pragma unroll
      for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * c + 2 * (lane % 4) + e;
          if (kpos > r0 || kpos >= S) sc[4 * c + e] = NEG;
          if (kpos > r1 || kpos >= S) sc[4 * c + 2 + e] = NEG;
        }
      }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = exp2_ftz(m0 - mx0);
    const float a1 = exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
      const float p00 = exp2_ftz(fmaf(sc[4 * c], scale_log2, -m0));
      const float p01 = exp2_ftz(fmaf(sc[4 * c + 1], scale_log2, -m0));
      const float p10 = exp2_ftz(fmaf(sc[4 * c + 2], scale_log2, -m1));
      const float p11 = exp2_ftz(fmaf(sc[4 * c + 3], scale_log2, -m1));
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      const uint32_t h0 = bf16x2(p00, p01);
      const uint32_t h1 = bf16x2(p10, p11);
      ph[2 * c] = h0;
      ph[2 * c + 1] = h1;
      pl[2 * c] = bf16x2(p00 - bf16_lo(h0), p01 - bf16_hi(h0));
      pl[2 * c + 1] = bf16x2(p10 - bf16_lo(h1), p11 - bf16_hi(h1));
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int c = 0; c < OD / 8; ++c) {
        acc[4 * c] *= a0;
        acc[4 * c + 1] *= a0;
        acc[4 * c + 2] *= a1;
        acc[4 * c + 3] *= a1;
      }
    }
  };

  bar_wait(qbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    bar_wait(full + 8 * (j % STAGES), (j / STAGES) & 1);
    wg_fence();
    issue_s(j);
    wg_commit();
    wg_wait();
    settle();
    softmax(j);
    if (live) {
      wg_fence();
      issue_pv(j);
      wg_commit();
      wg_wait();
      settle();
    }
    if (lane == 0) bar_arrive(empty + 8 * (j % STAGES));
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // every block of the row tile holds the same rows: slice 0's first
  // warpgroup writes the log-sum-exp
  if (lse != nullptr && lane % 4 == 0 && sl == 0 && wg == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    float* lrow = lse + ((size_t)b * H + h) * S;
    if (r0 < S) lrow[r0] = (m0 + log2f(l0)) * LN2;
    if (r1 < S) lrow[r1] = (m1 + log2f(l1)) * LN2;
  }
  if (!live) return;
  const float d0 = 1.f / fmaxf(l0, 1e-30f);
  const float d1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t row_stride = (size_t)H * ld;
  __nv_bfloat16* o0 =
      o + ((size_t)b * S + r0) * row_stride + (size_t)h * ld + col0;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int c = 0; c < OD / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    if (col0 + col >= ld) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * c] * d0, acc[4 * c + 1] * d0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * d1, acc[4 * c + 3] * d1);
  }
}

// hd in 257 .. 512: the maps' extent and the scale's; ld its row stride
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KVH, int hd, int ld,
           cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  if (tc::width(hd) != W) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, S, H, hd, ld, ROWS) ||
      !make_map(&km, k, B, S, KVH, hd, ld, BKV) ||
      !make_map(&vm, v, B, S, KVH, hd, ld, BKV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + ROWS - 1) / ROWS, H * SLICES, B);
  const float scale_log2 =
      (float)(std::pow((double)hd, -0.5) * 1.4426950408889634);
  flash_attention_wide_kernel<<<grid, THREADS, BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S,
      H, KVH, ld, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace wide

// a bf16 head dim -> the tensor-core instance of its width
int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int H, int KVH, int hd, int ld,
                  cudaStream_t st) {
  if (ld % 8 != 0 || ld < hd || ld >= hd + 8) return (int)cudaErrorInvalidValue;
  switch (tc::width(hd)) {
#define TC_CASE(W) \
  case W:          \
    return tc::launch<W>(q, k, v, o, lse, B, S, H, KVH, hd, ld, st);
    TC_CASE(64) TC_CASE(128) TC_CASE(192) TC_CASE(256)
#undef TC_CASE
    case wide::W:
      return wide::launch(q, k, v, o, lse, B, S, H, KVH, hd, ld, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int prologue(int B, int S, int H, int KVH, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// lse: null, or [B, H, S] f32 for the row log-sum-exps; stage: NULL where
// hd is a multiple of 4, else f32 scratch for q, k and v staged ld =
// ceil4(hd) columns wide, (B S H + 2 B S KVH) ld elements; nslice: o's
// column slices a row tile (0: simt::SLICES)
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   void* stage, int B, int S, int H, int KVH,
                                   int hd, int nslice, int device,
                                   void* stream) {
  int err = prologue(B, S, H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ld = (hd + 3) / 4 * 4;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  if (ld != hd) {
    if (stage == nullptr || simt::width(hd) == 0)
      return (int)cudaErrorInvalidValue;
    const long long nq = (long long)B * S * H, nk = (long long)B * S * KVH;
    float* qs = static_cast<float*>(stage);
    float* ks = qs + nq * ld;
    float* vs = ks + nk * ld;
    const void* in[3] = {q, k, v};
    void* staged[3] = {qs, ks, vs};
    const long long rows[3] = {nq, nk, nk};
    if ((err = restride::copy<uint32_t>(3, in, staged, rows, hd, ld, st)) !=
        0)
      return err;
    qp = qs;
    kp = ks;
    vp = vs;
  }
  return simt::dispatch(qp, kp, vp, static_cast<float*>(o),
                        static_cast<float*>(lse), B, S, H, KVH, hd, ld,
                        nslice, st);
}

// bf16: the tensor cores at every head dim 1 to 512. stage: NULL where hd
// is a multiple of 8, else bf16 scratch for q, k, v and o staged ld =
// ceil8(hd) columns wide, (2 B S H + 2 B S KVH) ld elements
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    void* stage, int B, int S, int H,
                                    int KVH, int hd, int device,
                                    void* stream) {
  int err = prologue(B, S, H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ld = (hd + 7) / 8 * 8;
  if (ld == hd)
    return dispatch_bf16(q, k, v, o, lse, B, S, H, KVH, hd, hd, st);
  if (stage == nullptr) return (int)cudaErrorInvalidValue;
  const long long nq = (long long)B * S * H, nk = (long long)B * S * KVH;
  uint16_t* w = static_cast<uint16_t*>(stage);
  uint16_t* qs = w;
  uint16_t* ks = qs + nq * ld;
  uint16_t* vs = ks + nk * ld;
  uint16_t* os = vs + nk * ld;
  const void* in[3] = {q, k, v};
  void* staged[3] = {qs, ks, vs};
  const long long rows[3] = {nq, nk, nk};
  if ((err = restride::copy(3, in, staged, rows, hd, ld, st)) != 0 ||
      (err = dispatch_bf16(qs, ks, vs, os, lse, B, S, H, KVH, hd, ld, st)) !=
          0)
    return err;
  const void* out[1] = {os};
  void* narrowed[1] = {o};
  return restride::copy(1, out, narrowed, rows, ld, hd, st);
}

// the launch a head dim gets, for kernels/flash_attention.geometry to be
// held against: out = {route (1 the tensor cores, 0 the CUDA cores), the
// instance's width, query rows a block, shared memory a block}; bf16 is 0
// for f32, 1 for bf16. cudaErrorInvalidValue past the domain (1 to 512).
extern "C" int flash_attention_geometry(int bf16, int hd, int* out) {
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
