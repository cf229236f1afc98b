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
// Bound on the H100: operations, 2*F*C*E2 FLOPs against F*D + C*(D*D+D+1)
// + F*C floats moved; without tensor cores (f32 on the CUDA cores) the
// ceiling is the 67 TFLOP/s f32 FMA rate.
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
// Two forms, one kernel template; `geometry` (below) picks one for D and
// gmm_loglik_geometry exports it for kernels/gmm_loglik.geometry's check:
//   narrow (D <= 204): 128 frames a block, the pair table built in shared
//     memory at block start, as above (207 KB at D = 204).
//   wide (D >= 205): 64 frames a block (a thread 4 x 8 sums), and the pair
//     table read from device memory (kernels/gmm_loglik.pair_table, the
//     wrapper's, 527 KB at D = 512 and L2-resident): a warp's 32 frames of
//     one e share its code, so each read is one broadcast. The x tile is
//     [D + 1][65]: 166 KB at D = 512, so the whole tile still fits. As in
//     the narrow form, x is read once per component block (Cp / 128
//     times); W is read once per 64 frames, twice as often as there. One
//     block an SM above D = 318. Its sums run in two levels: each group
//     of GROUP slabs (512 products) into a partial, the partials into the
//     total in order, so an output's rounding grows with E2 / 512 running
//     additions rather than with E2 (131,841 at D = 512, where a single
//     running f32 sum drifted 4e-5 of max|out| from the exact value).
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                 // frames per block, narrow form
constexpr int BM_WIDE = 64;             // frames per block, wide form
constexpr int BN = 128;                 // components per block
constexpr int BK = 16;                  // reduction slab (kernels/gmm_loglik.py)
constexpr int STAGES = 3;               // W slabs in flight
constexpr int GROUP = 32;               // slabs a partial sum, wide form
constexpr int THREADS = 256;            // 16 x 16, TM x 8 outputs each
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// floats of a block's shared memory: the W ring, two A slabs, the x tile
// [D + 1][bm + 1] and, in the narrow form, the E2p-word pair table
__host__ __device__ inline size_t smem_floats(int D, int E2p, int bm,
                                              bool table) {
  return (size_t)STAGES * BK * BN + 2 * BK * bm +
         round4((D + 1) * (bm + 1)) + (table ? E2p : 0);
}

// The form for D: narrow (128 frames, the table in shared memory) where it
// fits, else wide (64 frames, the table in device memory); false where
// neither fits (D above 767)
struct Geometry {
  bool wide;
  int bm;                       // frames a block
  size_t smem;                  // bytes
};

inline bool geometry(int D, Geometry& g) {
  if (D < 1) return false;
  const int E2p = (1 + D + D * (D + 1) / 2 + BK - 1) / BK * BK;
  for (int w = 0; w < 2; ++w) {
    g.wide = w == 1;
    g.bm = g.wide ? BM_WIDE : BM;
    g.smem = sizeof(float) * smem_floats(D, E2p, g.bm, !g.wide);
    if (g.smem <= (size_t)MAX_SMEM) return true;
  }
  return false;
}

// TM frames a thread (BMt = 16 TM a block); WIDE: the pair table from
// device memory (pairs_g), else built in shared memory
template <int TM, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
gmm_loglik_kernel(const float* __restrict__ x, const float* __restrict__ W,
                  const int* __restrict__ pairs_g, float* __restrict__ out,
                  int F, int C, int D, int E2, int E2p, int Cp) {
  constexpr int BMt = 16 * TM;
  constexpr int XS_LD = BMt + 1;        // x tile row stride (no bank conflicts)
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                             // [STAGES][BK][BN]
  float* As = Ws + STAGES * BK * BN;            // [2][BK][BMt]
  float* xs = As + 2 * BK * BMt;                // [D + 1][XS_LD], row D = 1
  int* pair = reinterpret_cast<int*>(xs + round4((D + 1) * XS_LD));  // [E2p]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int f0 = blockIdx.y * BMt;
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

  for (int idx = tid; idx < BMt * D; idx += THREADS) {
    const int m = idx / D, d = idx - (idx / D) * D;
    const int f = f0 + m;
    xs[d * XS_LD + m] = (f < F) ? x[(size_t)f * D + d] : 0.f;
  }
  for (int m = tid; m < BMt; m += THREADS) xs[D * XS_LD + m] = 1.f;
  // pair[e] = i0 | i1 << 10 | w << 20: A[f, e] = x_i0 x_i1 w, x_D = 1.
  // e = 0: 1; e = 1 + d: x_d; e = 1 + D + p: the p-th upper-triangle pair
  // in row-major order (ref._quad_pairs); e >= E2: 0.
  if (!WIDE) {
    for (int e = tid; e < 1 + D; e += THREADS)
      pair[e] = (e == 0 ? D : e - 1) | D << 10 | 1 << 20;
    for (int e = E2 + tid; e < E2p; e += THREADS) pair[e] = D | D << 10;
    for (int idx = tid; idx < D * D; idx += THREADS) {
      const int i = idx / D, j = idx - (idx / D) * D;
      if (j >= i)
        pair[1 + D + i * D - i * (i - 1) / 2 + (j - i)] =
            i | j << 10 | (i == j ? 1 : 2) << 20;
    }
  }
  __syncthreads();

  // A slab `slab` into buffer `buf`; a warp forms 32 frames of one e, so
  // its pair entry is a broadcast
  auto form_a = [&](int slab, int buf) {
    float* dst = As + buf * BK * BMt;
#pragma unroll
    for (int i = 0; i < BK * BMt / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / BMt, m = idx % BMt;
      const int p = WIDE ? __ldg(pairs_g + slab * BK + k) : pair[slab * BK + k];
      dst[k * BMt + m] = xs[(p & 1023) * XS_LD + m] *
                         xs[((p >> 10) & 1023) * XS_LD + m] * (float)(p >> 20);
    }
  };
  form_a(0, 0);

  float acc[TM][8], tot[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = tot[i][j] = 0.f;

  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 2>();      // W slab s has landed (this thread's copies)
    __syncthreads();     // everyone's copies, A slab s, and slab s-1 is free
    const int nx = s + STAGES - 1;
    if (nx < nslab) load_w(nx, nx % STAGES);
    cp_commit();
    if (s + 1 < nslab) form_a(s + 1, (s + 1) & 1);
    const float* a_s = As + (s & 1) * BK * BMt;
    const float* w_s = Ws + (s % STAGES) * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 t =
            *reinterpret_cast<const float4*>(&a_s[k * BMt + 64 * q + ty * 4]);
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
    if (WIDE && (s % GROUP == GROUP - 1 || s == nslab - 1)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tot[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }
  if (!WIDE) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) tot[i][j] = acc[i][j];
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
      const float* v = &tot[i][4 * half];
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

template <int TM, bool WIDE>
int launch_form(const float* x, const float* W, const int* pairs, float* out,
                int F, int C, int D, int E2, int E2p, int Cp,
                const Geometry& g, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_loglik_kernel<TM, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Cp / BN, (F + g.bm - 1) / g.bm);
  gmm_loglik_kernel<TM, WIDE><<<grid, THREADS, g.smem, stream>>>(
      x, W, pairs, out, F, C, D, E2, E2p, Cp);
  return (int)cudaGetLastError();
}

}  // namespace

// pairs: kernels/gmm_loglik.pair_table(D), E2p codes (read by the wide form;
// may be NULL where the narrow one runs)
extern "C" int gmm_loglik_f32(const float* x, const float* W, const int* pairs,
                              float* out, int F, int C, int D, int E2, int E2p,
                              int Cp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  if (!geometry(D, g) || E2 != 1 + D + D * (D + 1) / 2 || E2p % BK != 0 ||
      E2p < E2 || Cp % BN != 0 || Cp < C || (g.wide && pairs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (F == 0 || C == 0) return 0;
  if (g.wide)
    return launch_form<4, true>(x, W, pairs, out, F, C, D, E2, E2p, Cp, g,
                                (cudaStream_t)stream);
  return launch_form<8, false>(x, W, pairs, out, F, C, D, E2, E2p, Cp, g,
                               (cudaStream_t)stream);
}

// (frames a block, wide form?, shared-memory bytes) of the launch for D into
// out[0..2]; cudaErrorInvalidValue where no form fits
// (kernels/gmm_loglik.geometry is checked against this)
extern "C" int gmm_loglik_geometry(int D, int* out) {
  Geometry g;
  if (!geometry(D, g)) return (int)cudaErrorInvalidValue;
  out[0] = g.bm;
  out[1] = g.wide ? 1 : 0;
  out[2] = (int)g.smem;
  return 0;
}
