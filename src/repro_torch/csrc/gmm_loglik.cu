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
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                 // frames per block
constexpr int BN = 128;                 // components per block
constexpr int BK = 16;                  // reduction slab (kernels/gmm_loglik.py)
constexpr int STAGES = 3;               // W slabs in flight
constexpr int THREADS = 256;            // 16 x 16, 8 x 8 outputs each
constexpr int XS_LD = BM + 1;           // x tile row stride (no bank conflicts)
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline size_t smem_floats(int D, int E2p) {
  return (size_t)STAGES * BK * BN + 2 * BK * BM + round4((D + 1) * XS_LD) +
         E2p;
}

__global__ void __launch_bounds__(THREADS, 2)
gmm_loglik_kernel(const float* __restrict__ x, const float* __restrict__ W,
                  float* __restrict__ out, int F, int C, int D, int E2,
                  int E2p, int Cp) {
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
  // pair[e] = i0 | i1 << 8 | w << 16: A[f, e] = x_i0 x_i1 w, x_D = 1.
  // e = 0: 1; e = 1 + d: x_d; e = 1 + D + p: the p-th upper-triangle pair
  // in row-major order (ref._quad_pairs); e >= E2: 0.
  for (int e = tid; e < 1 + D; e += THREADS)
    pair[e] = (e == 0 ? D : e - 1) | D << 8 | 1 << 16;
  for (int e = E2 + tid; e < E2p; e += THREADS) pair[e] = D | D << 8;
  for (int idx = tid; idx < D * D; idx += THREADS) {
    const int i = idx / D, j = idx - (idx / D) * D;
    if (j >= i)
      pair[1 + D + i * D - i * (i - 1) / 2 + (j - i)] =
          i | j << 8 | (i == j ? 1 : 2) << 16;
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
      dst[k * BM + m] = xs[(p & 255) * XS_LD + m] *
                        xs[((p >> 8) & 255) * XS_LD + m] * (float)(p >> 16);
    }
  };
  form_a(0, 0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
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
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k * BM + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[k * BM + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&w_s[k * BN + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&w_s[k * BN + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const bool vec = (C % 4) == 0;   // rows of out 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = f0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
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

}  // namespace

extern "C" int gmm_loglik_f32(const float* x, const float* W, float* out,
                              int F, int C, int D, int E2, int E2p, int Cp,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F == 0 || C == 0) return 0;
  if (D + 1 > 255 || E2 != 1 + D + D * (D + 1) / 2 || E2p % BK != 0 ||
      E2p < E2 || Cp % BN != 0 || Cp < C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(D, E2p);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gmm_loglik_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Cp / BN, (F + BM - 1) / BM);
  gmm_loglik_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, W, out, F, C, D, E2, E2p, Cp);
  return (int)cudaGetLastError();
}
