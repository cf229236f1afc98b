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
// The CUDA cores (namespace simt): f32 at every head dim 1 to 512, f32
// FMAs throughout. One block per (q tile, head, batch), 256
// threads as 16 x 16; thread (ty, tx) owns query rows ty + 16i. A head dim
// that is a multiple of 16 up to 256, or of 64 above (SIMT_WIDTHS), runs an
// EXACT kernel of its own width, whose masks, strides and stores are fixed
// at compile time, so that the configs' head dims pay nothing for the
// others. Any other head dim runs the masked kernel of the
// least of 32, 64, 128, 256, 384 and 512 at or above it (SIMT_MASKED_WIDTHS),
// its tiles' columns past hd zero and never stored, the scale from the true
// hd. A tile is 64 rows up to width 256 and 32
// above, so that the q, k, v and p tiles fit a block's shared memory at 512
// (201,088 bytes; 213,760 at 256). The q tile, then each k and v tile, are
// staged in shared memory (above the 48 KB default, so the entry point
// raises the block's dynamic shared memory limit). Each thread computes a
// 4 x 4 (2 x 2) block of scores, the row max and row sum go across the 16
// lanes of a row by warp shuffles, and the running max m, sum l and the
// output accumulator (4 or 2 rows x W/16 columns) stay in registers across
// kv tiles. Tiles wholly above the diagonal are skipped; the p tile goes
// through shared memory for P.V. It stores one element at a time, so a row
// may start on any element (an odd head dim).
//
// All keep the [S, S] scores out of device memory, the property of the
// TPU kernel worth keeping.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "restride.cuh"

namespace {

constexpr float NEG = -1e30f;

// ------------------------------------------------------------ CUDA cores --

namespace simt {

constexpr int BQ = 64;          // query rows (and keys) a tile up to width 256
constexpr int THREADS = 256;    // 16 x 16

// rows of a query or (k, v) tile at instance width W: BQ up to 256, half
// above, so that the tiles fit a block's shared memory at width 512
__host__ __device__ constexpr int rows(int W) { return W <= 256 ? BQ : BQ / 2; }

// the instance a head dim runs (simt_width in kernels/flash_attention.py):
// its own width where it is a multiple of 16 up to 256 or of 64 above (the
// EXACT kernel, SIMT_WIDTHS), else the least of the masked widths at or
// above it (SIMT_MASKED_WIDTHS); 0 outside 1 to 512
__host__ __device__ constexpr int width(int hd) {
  return hd < 1 || hd > 512 ? 0
       : hd % 16 == 0 && (hd <= 256 || hd % 64 == 0) ? hd
       : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= 256 ? 256
       : hd <= 384 ? 384 : 512;
}

// the widths with a masked kernel, for the head dims between the EXACT
// ones (SIMT_MASKED_WIDTHS)
__host__ __device__ constexpr bool masked(int W) {
  return W == 32 || W == 64 || W == 128 || W == 256 || W == 384 || W == 512;
}

// the q and k tiles [R][W + 1], the v tile [R][W] and p [R][R + 1], f32
template <int W>
constexpr size_t smem_bytes() {
  constexpr size_t R = rows(W);
  return sizeof(float) * (2 * R * (W + 1) + R * W + R * (R + 1));
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// T: the input type (f32); W: the instance's width. The
// tiles' columns hd .. W - 1 load as zeros and add nothing to the
// products; the stores skip them. EXACT (hd = W): the kernel of that one
// head dim, its masks and strides fixed at compile time.
template <typename T, int W, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int KVH, int hd,
                       float scale) {
  if (EXACT) hd = W;
  constexpr int R = rows(W);        // query rows a block, keys a tile
  constexpr int RI = R / 16;        // rows (and keys) a thread
  constexpr int LD = W + 1;         // q and k tile row stride
  constexpr int PLD = R + 1;        // p tile row stride
  constexpr int CPT = W / 16;       // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [R][LD]
  float* Ks = Qs + R * LD;          // [R][LD]
  float* Vs = Ks + R * LD;          // [R][W]
  float* Ps = Vs + R * W;           // [R][PLD]

  const int nq = (S + R - 1) / R;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = qt * R;

  const size_t qrow = (size_t)H * hd;        // row strides, in elements
  const size_t krow = (size_t)KVH * hd;
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * hd;
  const T* kb = k + (size_t)b * S * krow + (size_t)kh * hd;
  const T* vb = v + (size_t)b * S * krow + (size_t)kh * hd;
  T* ob = o + (size_t)b * S * qrow + (size_t)h * hd;

  for (int idx = tid; idx < R * W; idx += THREADS) {
    const int r = idx / W, d = idx - (idx / W) * W;
    const int s = q0 + r;
    Qs[r * LD + d] =
        s < S && (EXACT || d < hd) ? ld(qb + (size_t)s * qrow + d) : 0.f;
  }

  float acc[RI][CPT];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();   // the last tile's readers are done; Qs is written
    for (int idx = tid; idx < R * W; idx += THREADS) {
      const int r = idx / W, d = idx - (idx / W) * W;
      const int s = k0 + r;
      const bool in = s < S && (EXACT || d < hd);
      Ks[r * LD + d] = in ? ld(kb + (size_t)s * krow + d) : 0.f;
      Vs[r * W + d] = in ? ld(vb + (size_t)s * krow + d) : 0.f;
    }
    __syncthreads();

    float sc[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < W; ++d) {
      float qv[RI], kv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < RI; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float s = kpos <= qpos ? sc[i][j] * scale : NEG;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // the 16 lanes of a row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < R; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = Vs[c * W + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      if (EXACT || tx + 16 * cc < hd)
        st(ob + (size_t)qpos * qrow + tx + 16 * cc, acc[i][cc] / denom);
    // the 16 lanes of a row hold the same m and l
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + qpos] = m[i] + logf(l[i]);
  }
}

template <typename T, int W, bool EXACT>
int launch_kernel(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int H, int KVH, int hd,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<W>();
  static_assert(smem_bytes<W>() <= 232448, "over the block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, W, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + rows(W) - 1) / rows(W), H, B);
  const float scale = (float)std::pow((double)hd, -0.5);
  flash_attention_kernel<T, W, EXACT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, KVH, hd, scale);
  return (int)cudaGetLastError();
}

// a head dim of the width itself runs the EXACT kernel; any other the
// masked kernel of a masked width
template <typename T, int W>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KVH, int hd, cudaStream_t stream) {
  if (hd == W) {
    return launch_kernel<T, W, true>(q, k, v, o, lse, B, S, H, KVH, hd,
                                     stream);
  } else if constexpr (masked(W)) {
    return launch_kernel<T, W, false>(q, k, v, o, lse, B, S, H, KVH, hd,
                                      stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the instances, by width (SIMT_WIDTHS)
#define SIMT_WIDTH_LIST(X)                                                  \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)    \
  X(192) X(208) X(224) X(240) X(256) X(320) X(384) X(448) X(512)

// head dim -> the instance of its width
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int S, int H, int KVH, int hd, cudaStream_t st) {
  switch (width(hd)) {
#define SIMT_CASE(W) \
  case W:            \
    return launch<T, W>(q, k, v, o, lse, B, S, H, KVH, hd, st);
    SIMT_WIDTH_LIST(SIMT_CASE)
#undef SIMT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out = {width, query rows a block, shared memory} of a head dim's
// instance, or 0 where it has none
inline int geometry(int hd, int* out) {
  switch (width(hd)) {
#define SIMT_GEO(W)                 \
  case W:                           \
    out[0] = W;                     \
    out[1] = rows(W);               \
    out[2] = (int)smem_bytes<W>();  \
    return 1;
    SIMT_WIDTH_LIST(SIMT_GEO)
#undef SIMT_GEO
    default:
      return 0;
  }
}

#undef SIMT_WIDTH_LIST

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

// lse: null, or [B, H, S] f32 for the row log-sum-exps
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, int KVH, int hd, int device,
                                   void* stream) {
  const int err = prologue(B, S, H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  return simt::dispatch<float>(q, k, v, o, lse, B, S, H, KVH, hd,
                               (cudaStream_t)stream);
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
