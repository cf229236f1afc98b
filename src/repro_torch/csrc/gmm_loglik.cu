// Dense full-covariance GMM log-likelihood on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gmm_loglik.py, gmm_loglik (_kernel).
//
//   out[f, c] = const[c] + x_f . lin[:, c] - 0.5 vec(x_f x_f^T) . P[c]
//
// As one SGEMM over the packed-symmetric reduction e in [0, E2),
// E2 = 1 + D + D(D+1)/2:
//
//   out[f, c] = sum_e A[f, e] W[e, c],
//   A[f] = [1 | x_f | w_p x_{f,i0(p)} x_{f,i1(p)}]   (w = 2 off the diagonal)
//   W    = [const; lin; -0.5 triu((P + P^T) / 2)]     (kernels/gmm_loglik.py)
//
// x^T P x = x^T ((P + P^T) / 2) x for any P, and a symmetric form needs its
// upper triangle only: half the reduction of the full D*D expansion. The
// wrapper packs W once per call, [E2p, Cp] f32, E2-major (a slab of BK
// rows is BK contiguous runs of components), zero-padded to E2p, a
// multiple of BK, and Cp, a multiple of BN, so no slab load needs a mask.
//
// Bound on the H100 (narrow form): operations, 2*F*C*E2 FLOPs against F*D
// + C*(D*D+D+1) + F*C floats moved; without tensor cores (f32 on the CUDA
// cores) the ceiling is the 67 TFLOP/s f32 FMA rate.
//
// Design: one block of 256 threads per 128 frames x 128 components; each
// thread holds an 8 x 8 tile of f32 sums in registers and reads its
// operands as float4 from shared memory (broadcast for A, conflict-free
// for W). A is never read from memory: each block keeps its x tile in
// shared memory (transposed, with a row of ones) and forms each BK-wide
// slab of A from it through a pair table built at block start, so the
// [F, E2] expansion never reaches device memory -- the property of the TPU
// kernel worth keeping. W slabs stream in through a cp.async ring of
// STAGES slabs; the next A slab is formed while the current one is
// multiplied, with one barrier per slab. Ragged F and C are masked here:
// rows past F read zero and are not written, columns past C are not
// written. Two blocks fit on an SM.
//
// Pair codes are i0 | i1 << 10 | w << 20 (10-bit fields: x's row has D + 1
// <= 1024 entries). They were 8-bit before, which capped D at 254.
//
// Two forms; `geometry` (below) picks one for D and gmm_loglik_geometry
// exports it for kernels/gmm_loglik.geometry's check:
//   narrow (D <= 204): 128 frames a block, the pair table built in shared
//     memory at block start, as above (207 KB at D = 204).
//   rows (D >= 205): the sum factored by rows on the tensor cores, below.
//
// The rows form. The quadratic form factors by rows of the triangle:
//
//   out[f, c] = const[c] + sum_j x_j lin[j, c]
//             + sum_i x_i (sum_{j >= i} x_j W_(i,j)[c]),
//   W_(i,j) = -0.5 w_ij (P_ij + P_ji) / 2   (w = 2 off the diagonal),
//
// so each row's inner sum is a product of the frames' x tile itself with
// a run of W: no expansion is formed and there is no pair table. The
// linear part is row 0 with multiplier 1; quadratic row i is row i + 1,
// multiplier x_i. Row i's run covers x's columns from 8 floor(i / 8) (W
// zero below i) to Dx = D rounded up to 8 (zero past D), in chunks of 8:
// every chunk starts at a multiple of 8, 2.7% more positions than E2 at D
// = 256. pack_kernel packs the runs per call, component-major [Cp, K], K
// the chunks' positions rounded up to KS, from one read of each
// component's P (kernels/gmm_loglik.row_weights is its plain version).
//
// A block owns 32 MT frames x 128 components, 8 warps in 2 x 4, a warp
// (16 MT) x 32 outputs in m16n8k8 tiles of mma.sync. The x tile stays in
// shared memory for the block's life ([32 MT][ldx], frame-major); W
// streams in through a cp.async ring of 3 slabs of KS = 32 positions for
// the 128 components (namespace rows). A row's inner sum accumulates in
// the tensor cores' f32 accumulators; at the row's last chunk each thread
// adds its multiplier times them into its totals (f32 FMAs) and clears
// them. MT is 4 where the tile fits (D <= 328), else 2 (D <= 648), else
// 1. One block an SM (its totals and accumulators take 128 registers a
// thread).
//
// Precision contract (3xTF32). Each operand value v is split into hi =
// cvt.rna.tf32(v) and lo = v - hi (exact in f32, |lo| <= 2^-11 |v|), of
// which the tensor cores read the TF32 part (truncated); each product is
// lo_a hi_b + hi_a lo_b + hi_a hi_b, issued in that order into f32
// accumulators. hi_a hi_b is exact; the dropped lo_a lo_b and lo's
// truncation leave a relative error below 2^-20 a product, the order of
// f32's 2^-24 times the few roundings of a short sum. The tensor cores'
// f32 accumulation sums a row's inner products (at most Dx positions, 3
// issues each); the rows themselves (D + 1 of them) are added by f32 FMAs
// in row order, so the sums are two-level by construction. Phase 16 of chip_smoke.py holds the output to 2e-5 x
// max|value| of the float64 value at D = 205 .. 512. Its bound counts
// the three TF32 products at the TF32 rate (kernels/registry.py).
//
// Bound on the H100 (rows form): operations, 3 x 2 F C E2 TF32 FLOPs at
// 495 TFLOP/s, against F*D + C*(D*D+D+1) + F*C floats moved. mma.sync
// reaches about half that rate (the probe of chip_smoke.py); wgmma would
// take the rest.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                 // frames per block, narrow form
constexpr int BN = 128;                 // components per block
constexpr int BK = 16;                  // reduction slab (kernels/gmm_loglik.py)
constexpr int STAGES = 3;               // W slabs in flight
constexpr int THREADS = 256;            // 16 x 16, 8 x 8 outputs each
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// floats of a narrow block's shared memory: the W ring, two A slabs, the x
// tile [D + 1][BM + 1] and the E2p-word pair table
__host__ __device__ inline size_t smem_floats(int D, int E2p) {
  return (size_t)STAGES * BK * BN + 2 * BK * BM +
         round4((D + 1) * (BM + 1)) + E2p;
}

// The rows form (D >= 205; see the header)
namespace rows {

constexpr int BN = 128;                 // components per block
constexpr int KS = 32;                  // W positions a slab (4 chunks of 8)
constexpr int LDW = KS + 8;             // a W slab row's stride (floats)
constexpr int STAGES = 3;               // W slabs in flight
constexpr int NT = 4;                   // n8 tiles a warp (32 components)

// the rows form's x columns (D rounded up to 8) and the x tile's row
// stride: at least that, 8 more than a multiple of 32, so that a warp's
// 8-byte fragment loads of 8 frames x 4 column pairs hit every bank once
// a half-warp
__host__ __device__ inline int dx(int D) { return (D + 7) / 8 * 8; }
__host__ __device__ inline int ldx(int D) {
  const int w = dx(D);
  return w + ((8 - w) % 32 + 32) % 32;
}

// a rows block's shared memory: the W ring and the x tile of 32 MT frames
__host__ __device__ inline size_t smem_bytes(int D, int MT) {
  return sizeof(float) *
         ((size_t)STAGES * BN * LDW + (size_t)32 * MT * ldx(D));
}

// the rows form's W positions: 8 for each chunk of each row (the linear
// row Dx / 8 chunks, quadratic row i Dx / 8 - floor(i / 8)), rounded up to
// a whole slab
__host__ __device__ inline long long positions(int D) {
  const int ng = dx(D) / 8;
  long long q = ng;
  for (int g = 0; g < ng; ++g)
    q += (long long)(D - 8 * g < 8 ? D - 8 * g : 8) * (ng - g);
  return (8 * q + KS - 1) / KS * KS;
}

// v as a TF32 high part (round to nearest, ties away) and what is left,
// exact in f32; the tensor cores read lo's top 10 mantissa bits (its low 13
// ignored: truncated)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b on one m16n8k8 TF32 tile: a row-major 16 x 8 (a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), b 8 x 8 (b0 (t, g), b1 (t +
// 4, g)), d 16 x 8 (d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, ..)); g = lane
// / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The rows form (see the header): 32 MT frames x BN components a block.
// Wr: [Cp, K] row runs (pack_kernel), cst: const [C].
// A chunk's 8 positions k map to x columns j0 + j(k) with j(k) = 2 (k % 4)
// + k / 4 in both operands, so that a thread's two positions of a
// fragment are adjacent in shared memory (one 8-byte load).
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
gmm_loglik_rows_kernel(const float* __restrict__ x,
                       const float* __restrict__ Wr,
                       const float* __restrict__ cst, float* __restrict__ out,
                       int F, int C, int D, int K) {
  constexpr int BMr = 32 * MT;
  extern __shared__ __align__(16) float smem[];
  const int ld = ldx(D), cols = dx(D), ng = cols / 8;
  float* ring = smem;                           // [STAGES][BN][LDW]
  float* xs = ring + STAGES * BN * LDW;         // [BMr][ld], frame-major

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;       // 2 x 4 warps
  const int f0 = blockIdx.y * BMr;
  const int c0 = blockIdx.x * BN;
  const int nslab = K / KS;

  // W slab `slab` into ring stage `st`: BN component runs of KS positions,
  // 16 bytes a copy, 8 threads a run's 128 bytes
  auto load_w = [&](int slab, int st) {
    const float* src = Wr + (size_t)c0 * K + (size_t)slab * KS;
    float* dst = ring + st * BN * LDW;
#pragma unroll
    for (int i = 0; i < BN * KS / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int n = idx / (KS / 4), k4 = idx % (KS / 4);
      cp_async16(dst + n * LDW + k4 * 4, src + (size_t)n * K + k4 * 4);
    }
  };
  // the x tile: 4-byte copies at any D, zero past D and past F
  for (int idx = tid; idx < BMr * cols; idx += THREADS) {
    const int m = idx / cols, d = idx - m * cols;
    const bool ok = f0 + m < F && d < D;
    cp_async4_zfill(xs + m * ld + d, ok ? x + (size_t)(f0 + m) * D + d : x,
                    ok ? 4 : 0);
  }
  cp_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load_w(s, s);
    cp_commit();
  }

  float acc[MT][NT][4], tot[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = tot[i][j][v] = 0.f;

  // row r's inner sums times its multiplier (1 for r = 0, else x_{r-1} of
  // the output's frame) into the totals; the accumulators cleared
  auto flush = [&](int r) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = wm * 16 * MT + i * 16 + g;
      const float u0 = r == 0 ? 1.f : xs[m * ld + r - 1];
      const float u1 = r == 0 ? 1.f : xs[(m + 8) * ld + r - 1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tot[i][j][0] = fmaf(u0, acc[i][j][0], tot[i][j][0]);
        tot[i][j][1] = fmaf(u0, acc[i][j][1], tot[i][j][1]);
        tot[i][j][2] = fmaf(u1, acc[i][j][2], tot[i][j][2]);
        tot[i][j][3] = fmaf(u1, acc[i][j][3], tot[i][j][3]);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
      }
    }
  };

  // the schedule, the same in every thread: row r, its chunks left, the
  // current chunk's first x column
  int r = 0, left = ng, j0 = 0;
  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 2>();      // W slab s (and the x tile) landed
    __syncthreads();            // everyone's; slab s - 1 is free
    const int nx = s + STAGES - 1;
    if (nx < nslab) load_w(nx, nx % STAGES);
    cp_commit();
    const float* ws = ring + (s % STAGES) * BN * LDW;
#pragma unroll
    for (int q = 0; q < KS / 8; ++q) {
      float2 bv[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bv[j] = *reinterpret_cast<const float2*>(
            &ws[(wn * 32 + j * 8 + g) * LDW + q * 8 + 2 * t]);
      if (r > D) continue;      // the slab's padding past the last row
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(bv[j].x, bh[j][0], bl[j][0]);
        split_tf32(bv[j].y, bh[j][1], bl[j][1]);
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = wm * 16 * MT + i * 16 + g;
        const float2 u = *reinterpret_cast<const float2*>(
            &xs[m * ld + j0 + 2 * t]);
        const float2 w = *reinterpret_cast<const float2*>(
            &xs[(m + 8) * ld + j0 + 2 * t]);
        split_tf32(u.x, ah[i][0], al[i][0]);
        split_tf32(w.x, ah[i][1], al[i][1]);
        split_tf32(u.y, ah[i][2], al[i][2]);
        split_tf32(w.y, ah[i][3], al[i][3]);
      }
      // the three products in turn over all MT x NT tiles, so that an
      // accumulator's next product issues MT x NT products after its last
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
      j0 += 8;
      if (--left == 0) {        // row r's last chunk
        flush(r);
        ++r;
        left = ng - (r - 1) / 8;
        j0 = 8 * ((r - 1) / 8);
      }
    }
  }

  // out = totals + const; frames past F and components past C not written
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + wn * 32 + j * 8 + 2 * t;
    const float k0 = c < C ? cst[c] : 0.f;
    const float k1 = c + 1 < C ? cst[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + wm * 16 * MT + i * 16 + g + 8 * h;
        if (f >= F) continue;
        float* row = out + (size_t)f * C;
        const float v0 = tot[i][j][2 * h] + k0, v1 = tot[i][j][2 * h + 1] + k1;
        if (C % 2 == 0 && c + 1 < C) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          if (c < C) row[c] = v0;
          if (c + 1 < C) row[c + 1] = v1;
        }
      }
    }
  }
}

// The rows form's operand (kernels/gmm_loglik.row_weights, whose
// arithmetic this is, bitwise): Wr[c, k] = (P[c, first[k]] + P[c,
// second[k]]) * factor[k], lin[k, c] at the linear row's first D
// positions, zero past C. One block a component, so that P[c]'s strided
// reads of its transpose stay in cache.
__global__ void pack_kernel(const float* __restrict__ P,
                            const float* __restrict__ lin,
                            const int* __restrict__ first,
                            const int* __restrict__ second,
                            const float* __restrict__ factor,
                            float* __restrict__ Wr, int C, int D, int K) {
  const int c = blockIdx.x;
  float* row = Wr + (size_t)c * K;
  if (c >= C) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) row[k] = 0.f;
    return;
  }
  const float* Pc = P + (size_t)c * D * D;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    row[k] = k < D ? lin[(size_t)k * C + c]
                   : (Pc[first[k]] + Pc[second[k]]) * factor[k];
}

}  // namespace rows

// The form for D: narrow (128 frames, the table in shared memory) where it
// fits, else rows with the most frames a block that fit (mt 4, 2, 1);
// false where none fits (D above 1,320)
struct Geometry {
  bool wide;                    // the rows form
  int bm;                       // frames a block
  size_t smem;                  // bytes
};

inline bool geometry(int D, Geometry& g) {
  if (D < 1) return false;
  const int E2p = (1 + D + D * (D + 1) / 2 + BK - 1) / BK * BK;
  g.wide = false;
  g.bm = BM;
  g.smem = sizeof(float) * smem_floats(D, E2p);
  if (g.smem <= (size_t)MAX_SMEM) return true;
  g.wide = true;
  for (int mt = 4; mt >= 1; mt /= 2) {
    g.bm = 32 * mt;
    g.smem = rows::smem_bytes(D, mt);
    if (g.smem <= (size_t)MAX_SMEM) return true;
  }
  return false;
}

// The narrow form: 128 frames a block, the pair table in shared memory
__global__ void __launch_bounds__(THREADS, 2)
gmm_loglik_kernel(const float* __restrict__ x, const float* __restrict__ W,
                  float* __restrict__ out, int F, int C, int D, int E2,
                  int E2p, int Cp) {
  constexpr int TM = 8;                 // frames a thread
  constexpr int XS_LD = BM + 1;         // x tile row stride (no bank conflicts)
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                             // [STAGES][BK][BN]
  float* As = Ws + STAGES * BK * BN;            // [2][BK][BM]
  float* xs = As + 2 * BK * BM;                 // [D + 1][XS_LD], row D = 1
  int* pair = reinterpret_cast<int*>(xs + round4((D + 1) * XS_LD));  // [E2p]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int f0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int nslab = E2p / BK;

  // W slab `slab` into ring stage `stage`: BK rows of BN floats, 16 bytes
  // a copy, a warp's copies one contiguous 512-byte run
  auto load_w = [&](int slab, int stage) {
    const float* src = W + (size_t)slab * BK * Cp + c0;
    float* dst = Ws + stage * BK * BN;
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / 4), c4 = idx % (BN / 4);
      cp_async16(dst + r * BN + c4 * 4, src + (size_t)r * Cp + c4 * 4);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load_w(s, s);
    cp_commit();
  }

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int m = idx / D, d = idx - (idx / D) * D;
    const int f = f0 + m;
    xs[d * XS_LD + m] = (f < F) ? x[(size_t)f * D + d] : 0.f;
  }
  for (int m = tid; m < BM; m += THREADS) xs[D * XS_LD + m] = 1.f;
  // pair[e] = i0 | i1 << 10 | w << 20: A[f, e] = x_i0 x_i1 w, x_D = 1.
  // e = 0: 1; e = 1 + d: x_d; e = 1 + D + p: the p-th upper-triangle pair
  // in row-major order (ref._quad_pairs); e >= E2: 0.
  for (int e = tid; e < 1 + D; e += THREADS)
    pair[e] = (e == 0 ? D : e - 1) | D << 10 | 1 << 20;
  for (int e = E2 + tid; e < E2p; e += THREADS) pair[e] = D | D << 10;
  for (int idx = tid; idx < D * D; idx += THREADS) {
    const int i = idx / D, j = idx - (idx / D) * D;
    if (j >= i)
      pair[1 + D + i * D - i * (i - 1) / 2 + (j - i)] =
          i | j << 10 | (i == j ? 1 : 2) << 20;
  }
  __syncthreads();

  // A slab `slab` into buffer `buf`; a warp forms 32 frames of one e, so
  // its pair entry is a broadcast
  auto form_a = [&](int slab, int buf) {
    float* dst = As + buf * BK * BM;
#pragma unroll
    for (int i = 0; i < BK * BM / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / BM, m = idx % BM;
      const int p = pair[slab * BK + k];
      dst[k * BM + m] = xs[(p & 1023) * XS_LD + m] *
                        xs[((p >> 10) & 1023) * XS_LD + m] * (float)(p >> 20);
    }
  };
  form_a(0, 0);

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 2>();      // W slab s has landed (this thread's copies)
    __syncthreads();     // everyone's copies, A slab s, and slab s-1 is free
    const int nx = s + STAGES - 1;
    if (nx < nslab) load_w(nx, nx % STAGES);
    cp_commit();
    if (s + 1 < nslab) form_a(s + 1, (s + 1) & 1);
    const float* a_s = As + (s & 1) * BK * BM;
    const float* w_s = Ws + (s % STAGES) * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 t =
            *reinterpret_cast<const float4*>(&a_s[k * BM + 64 * q + ty * 4]);
        a[4 * q] = t.x; a[4 * q + 1] = t.y; a[4 * q + 2] = t.z;
        a[4 * q + 3] = t.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&w_s[k * BN + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&w_s[k * BN + 64 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const bool vec = (C % 4) == 0;   // rows of out 16-byte aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int f = f0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (f >= F) continue;
    float* row = out + (size_t)f * C;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + half * 64 + tx * 4;
      const float* v = &acc[i][4 * half];
      if (vec && c + 3 < C) {
        *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < C) row[c + j] = v[j];
      }
    }
  }
}

template <int MT>
int launch_rows(const float* x, const float* Wr, const float* cst,
                float* out, int F, int C, int D, int K, int Cp,
                const Geometry& g, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rows::gmm_loglik_rows_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Cp / rows::BN, (F + g.bm - 1) / g.bm);
  rows::gmm_loglik_rows_kernel<MT><<<grid, THREADS, g.smem, stream>>>(
      x, Wr, cst, out, F, C, D, K);
  return (int)cudaGetLastError();
}

}  // namespace

// W: the narrow form's packed operand [E2p, Cp] (kernels/gmm_loglik.
// packed_weights; Kw = E2p) or the rows form's runs [Cp, Kw]
// (row_weights); cst: const [C], read by the rows form (may be NULL for
// the narrow one, whose W carries it)
extern "C" int gmm_loglik_f32(const float* x, const float* W, const float* cst,
                              float* out, int F, int C, int D, int Kw,
                              int Cp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  if (!geometry(D, g) || Cp % BN != 0 || Cp < C)
    return (int)cudaErrorInvalidValue;
  const int E2 = 1 + D + D * (D + 1) / 2;
  if (g.wide ? (Kw != rows::positions(D) || cst == nullptr)
             : Kw != (E2 + BK - 1) / BK * BK)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || C == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.wide) {
    if (g.bm == 128)
      return launch_rows<4>(x, W, cst, out, F, C, D, Kw, Cp, g, s);
    if (g.bm == 64)
      return launch_rows<2>(x, W, cst, out, F, C, D, Kw, Cp, g, s);
    return launch_rows<1>(x, W, cst, out, F, C, D, Kw, Cp, g, s);
  }
  err = cudaFuncSetAttribute(gmm_loglik_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Cp / BN, (F + BM - 1) / BM);
  gmm_loglik_kernel<<<grid, THREADS, g.smem, s>>>(x, W, out, F, C, D, E2,
                                                  Kw, Cp);
  return (int)cudaGetLastError();
}

// The rows form's packing pass: P_flat [C, D*D], lin [D, C], the position
// tables of kernels/gmm_loglik._row_index (K entries each) -> Wr [Cp, K]
extern "C" int gmm_loglik_pack_f32(const float* P, const float* lin,
                                   const int* first, const int* second,
                                   const float* factor, float* Wr, int C,
                                   int Cp, int D, int K, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || Cp < C || Cp % rows::BN != 0 || K != rows::positions(D))
    return (int)cudaErrorInvalidValue;
  if (Cp == 0) return 0;
  rows::pack_kernel<<<Cp, THREADS, 0, (cudaStream_t)stream>>>(
      P, lin, first, second, factor, Wr, C, D, K);
  return (int)cudaGetLastError();
}

// (frames a block, rows form?, shared-memory bytes) of the launch for D
// into out[0..2], and the rows form's W positions K into out[3] (0 for the
// narrow form); cudaErrorInvalidValue where no form fits
// (kernels/gmm_loglik.geometry is checked against this)
extern "C" int gmm_loglik_geometry(int D, int* out) {
  Geometry g;
  if (!geometry(D, g)) return (int)cudaErrorInvalidValue;
  out[0] = g.bm;
  out[1] = g.wide ? 1 : 0;
  out[2] = (int)g.smem;
  out[3] = g.wide ? (int)rows::positions(D) : 0;
  return 0;
}
