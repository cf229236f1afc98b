// Sparse gather-and-rescore of the top-K selected components (sm_90a).
//
// Replaces: src/repro/kernels/gmm_rescore.py, gmm_rescore (_kernel).
//
//   out[f, k] = A[s, 0] + sum_d x_fd A[s, 1+d] - 0.5 sum_ij x_fi x_fj A[s, 1+D+iD+j]
//   with s = sel[f, k],
//
// x [F, D] f32, sel [F, K] int64 in [0, C) (the wrapper clips), A [C, E]
// f32 packed rows [const | lin | vec(P)] with E >= 1 + D + D*D; out [F, K].
//
// Why not the TPU design: the TPU kernel gathers the K rows of a whole
// frame tile into fast memory at once. At D = 72 a row is 5257 floats
// (21 KB), so K = 20 rows of one frame exceed the 227 KB of shared memory
// a block can have, and the sort-by-id DMA issue order served the TPU's
// DMA engine, not an SM.
//
// Bound on the H100: operations by the card's table (2*F*K*(D*D + D)
// FLOPs against each row read once), in practice the rate at which rows
// stream out of L2: every (frame, slot) pair reads its whole row, and the
// pack (C*E floats, 43 MB at the paper's width) stays resident in the
// 50 MB L2 across the frames that share rows.
//
// Design: one block of four warps per frame. The block expands its frame
// once into shared memory as xe = [1 | x | -0.5 vec(x x^T)], aligned with
// a packed row, so each slot's log-likelihood is one dot product xe . A[s].
// Each warp takes every fourth slot, streams the row with coalesced loads
// (four independent sums in flight per lane) and finishes with a warp
// shuffle reduction. Every sum is taken in a fixed order: the result is
// bitwise repeatable.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
gmm_rescore_kernel(const float* __restrict__ x,
                   const long long* __restrict__ sel,
                   const float* __restrict__ A, float* __restrict__ out,
                   int K, int D, int E) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [D]
  float* xe = smem + D;             // [1 + D + D*D]
  const int f = blockIdx.x;
  const int E0 = 1 + D + D * D;

  for (int d = threadIdx.x; d < D; d += THREADS) xs[d] = x[(size_t)f * D + d];
  __syncthreads();
  for (int e = threadIdx.x; e < E0; e += THREADS) {
    float v;
    if (e == 0) {
      v = 1.f;
    } else if (e <= D) {
      v = xs[e - 1];
    } else {
      const int q = e - 1 - D;
      const int i = q / D, j = q - (q / D) * D;
      v = -0.5f * xs[i] * xs[j];
    }
    xe[e] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < K; k += WARPS) {
    const float* row = A + (size_t)sel[(size_t)f * K + k] * E;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int e = lane;
    for (; e + 96 < E0; e += 128) {
      s0 = fmaf(xe[e], __ldg(row + e), s0);
      s1 = fmaf(xe[e + 32], __ldg(row + e + 32), s1);
      s2 = fmaf(xe[e + 64], __ldg(row + e + 64), s2);
      s3 = fmaf(xe[e + 96], __ldg(row + e + 96), s3);
    }
    for (; e < E0; e += 32) s0 = fmaf(xe[e], __ldg(row + e), s0);
    float s = (s0 + s1) + (s2 + s3);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[(size_t)f * K + k] = s;
  }
}

}  // namespace

extern "C" int gmm_rescore_f32(const float* x, const long long* sel,
                               const float* A, float* out, int F, int K,
                               int D, int E, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F == 0 || K == 0) return 0;
  if (E < 1 + D + D * D) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)D + 1 + D + (size_t)D * D);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gmm_rescore_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gmm_rescore_kernel<<<F, THREADS, smem, (cudaStream_t)stream>>>(
      x, sel, A, out, K, D, E);
  return (int)cudaGetLastError();
}
