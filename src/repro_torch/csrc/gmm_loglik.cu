// Dense full-covariance GMM log-likelihood on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gmm_loglik.py, gmm_loglik (_kernel).
//
//   out[f, c] = const[c] + x_f . lin[:, c] - 0.5 vec(x_f x_f^T) . P[c]
//
// x [F, D], const [C], lin [D, C], P [C, D*D] (row-major precisions), all
// f32; out [F, C] f32.
//
// Bound on the H100: operations. It is 2*F*C*(D*D + D) FLOPs against
// F*D + C*D*D + F*C floats moved, about 2*D*D/(4*(1 + F/C)) FLOPs per byte,
// far above the card's f32 ratio; without tensor cores the ceiling is the
// CUDA cores' f32 FMA rate.
//
// Design: one SGEMM over the extended reduction e in [0, D*D + D), with
// A[f, e] = x_i x_j (e = i*D + j) or x_d (the linear term, e = D*D + d)
// and B[e, c] = -0.5 P[c, e] or lin[d, c]. A is never read from memory:
// each block keeps its 128-frame x tile in shared memory and forms each
// 8-wide slab of A from it, so the [F, D*D] expansion never reaches device
// memory -- the property of the TPU kernel worth keeping. B slabs stream
// through shared memory; each thread holds an 8x8 tile of f32 sums in
// registers. Ragged F and C are masked here: rows past F read zero and
// are not written, columns past C likewise.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                       // frames per block
constexpr int BN = 128;                       // components per block
constexpr int BK = 8;                         // reduction slab
constexpr int THREADS = 256;                  // 16 x 16, 8x8 outputs each
constexpr int XS_LD = BM + 1;                 // x tile row stride (no bank conflicts)
constexpr int BS_LD = BN + 4;                 // B slab row stride (16-byte rows)

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

__global__ void __launch_bounds__(THREADS)
gmm_loglik_kernel(const float* __restrict__ x, const float* __restrict__ cst,
                  const float* __restrict__ lin, const float* __restrict__ P,
                  float* __restrict__ out, int F, int C, int D) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                           // [D][XS_LD]: x tile, transposed
  float* As = xs + round4(D * XS_LD);         // [BK][BM]
  float* Bs = As + BK * BM;                   // [BK][BS_LD]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int f0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int DD = D * D;
  const int E = DD + D;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int m = idx / D, d = idx - (idx / D) * D;
    const int f = f0 + m;
    xs[d * XS_LD + m] = (f < F) ? x[(size_t)f * D + d] : 0.f;
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int e0 = 0; e0 < E; e0 += BK) {
    for (int idx = tid; idx < BK * BM; idx += THREADS) {
      const int k = idx / BM, m = idx - (idx / BM) * BM;
      const int e = e0 + k;
      float v = 0.f;
      if (e < DD) {
        const int i = e / D, j = e - (e / D) * D;
        v = xs[i * XS_LD + m] * xs[j * XS_LD + m];
      } else if (e < E) {
        v = xs[(e - DD) * XS_LD + m];
      }
      As[k * BM + m] = v;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int n = idx / BK, k = idx - (idx / BK) * BK;
      const int e = e0 + k, c = c0 + n;
      float v = 0.f;
      if (c < C) {
        if (e < DD) v = -0.5f * P[(size_t)c * DD + e];
        else if (e < E) v = lin[(size_t)(e - DD) * C + c];
      }
      Bs[k * BS_LD + n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k * BM + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k * BM + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k * BS_LD + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k * BS_LD + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = f0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < C) out[(size_t)f * C + c] = cst[c] + acc[i][j];
    }
  }
}

}  // namespace

extern "C" int gmm_loglik_f32(const float* x, const float* cst,
                              const float* lin, const float* P, float* out,
                              int F, int C, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F == 0 || C == 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)round4(D * XS_LD) + BK * BM + BK * BS_LD);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gmm_loglik_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + BN - 1) / BN, (F + BM - 1) / BM);
  gmm_loglik_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, cst, lin, P, out, F, C, D);
  return (int)cudaGetLastError();
}
