// Fused alignment on Hopper (sm_90a): diagonal preselection, per-frame
// top-K and the full-covariance rescore of the selected set, in one kernel.
//
// Replaces: src/repro/kernels/gmm_align.py, gmm_align (_kernel).
//
//   score[f, c] = dconst[c] + sum_d x_fd dlin[d, c] + sum_d x_fd^2 dquad[d, c]
//   sel[f, :]   = the K best components of score[f, :], best first; ties go
//                 to the lowest id, and a pass that meets a NaN score takes
//                 C-1 (the TPU kernel's "first index attaining the max")
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
// against the 227 KB of shared memory a block may have), in sorted id order
// through a DMA ring, and extracts each slot's score with a one-hot matmul.
// Those served the TPU's DMA engine and matrix unit, not an SM.
//
// Bound on the H100: operations by the card's table,
// 2*F*C*(2D+1) + 2*F*K*E2 FLOPs. In practice the rate at which the diag
// coefficients (1.2 MB) and the selected rows stream from L2: the 22 MB
// pack and the coefficients stay resident in the 50 MB L2.
//
// Design: one block of eight warps per tile of eight frames.
//   1. The tile's x rows go to shared memory. Each thread scores its
//      components for all eight frames, reading each coefficient once per
//      tile; the [8, C] scores stay in shared memory (64 KB at C = 2048)
//      and never reach device memory.
//   2. Warp w takes frame w: K warp-wide argmax passes over the frame's
//      scores, each ending with the winner set to -inf.
//   3. Each frame is expanded once into shared memory as xe (10.8 KB).
//   4. Warp w scores the (frame, slot) pairs w, w+8, ...: a coalesced
//      stream of the slot's row dotted with xe, four sums in flight per
//      lane, a shuffle reduction at the end.
// Every sum is taken in a fixed order: the result is bitwise repeatable.
// Frames past F are masked (x reads zero, nothing is written).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FPB = 8;                        // frames per block = warps
constexpr int THREADS = FPB * 32;

__device__ inline bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
gmm_align_kernel(const float* __restrict__ x, const float* __restrict__ dconst,
                 const float* __restrict__ dlin,
                 const float* __restrict__ dquad,
                 const float* __restrict__ A2,
                 const long long* __restrict__ sel_in,
                 float* __restrict__ ll, long long* __restrict__ sel,
                 int F, int C, int D, int K, int E2) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                           // [FPB][D]
  float* xe = xs + FPB * D;                   // [FPB][E2]
  float* sc = xe + FPB * E2;                  // [FPB][C] (preselect only)
  int* ids = reinterpret_cast<int*>(sc + (sel_in ? 0 : FPB * C));  // [FPB][K]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * FPB;

  for (int idx = tid; idx < FPB * D; idx += THREADS) {
    const int r = idx / D;
    const int f = f0 + r;
    xs[idx] = (f < F) ? x[(size_t)f * D + (idx - r * D)] : 0.f;
  }
  __syncthreads();

  if (sel_in) {
    for (int idx = tid; idx < FPB * K; idx += THREADS) {
      const int r = idx / K;
      const int f = f0 + r;
      ids[idx] = (f < F) ? (int)sel_in[(size_t)f * K + (idx - r * K)] : 0;
    }
  } else {
    // 1. diagonal scores: lin and quad terms summed apart, then added to
    //    the constant, as the plain version's three products are
    for (int c = tid; c < C; c += THREADS) {
      float a[FPB], b[FPB];
#pragma unroll
      for (int r = 0; r < FPB; ++r) a[r] = b[r] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float l = __ldg(dlin + (size_t)d * C + c);
        const float q = __ldg(dquad + (size_t)d * C + c);
#pragma unroll
        for (int r = 0; r < FPB; ++r) {
          const float xv = xs[r * D + d];
          a[r] = fmaf(xv, l, a[r]);
          b[r] = fmaf(xv * xv, q, b[r]);
        }
      }
      const float k0 = __ldg(dconst + c);
#pragma unroll
      for (int r = 0; r < FPB; ++r) sc[r * C + c] = (k0 + a[r]) + b[r];
    }
    __syncthreads();

    // 2. top-K of frame `warp`: K warp-wide argmax passes
    float* s = sc + warp * C;
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
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      nan = __any_sync(0xffffffffu, nan);
      if (nan || bi >= C) bi = C - 1;
      __syncwarp();
      if (lane == 0) {
        s[bi] = -INFINITY;
        ids[warp * K + k] = bi;
      }
      __syncwarp();
    }
  }

  // 3. the packed expansion of each frame: e = 0 is 1, e = 1..D is x, and
  //    pair (i <= j) sits at 1 + D + i*D - i(i-1)/2 + (j - i)
  for (int idx = tid; idx < FPB * (1 + D); idx += THREADS) {
    const int r = idx / (1 + D), e = idx - r * (1 + D);
    xe[r * E2 + e] = (e == 0) ? 1.f : xs[r * D + e - 1];
  }
  for (int idx = tid; idx < D * D; idx += THREADS) {
    const int i = idx / D, j = idx - (idx / D) * D;
    if (j < i) continue;
    const int e = 1 + D + i * D - (i * (i - 1)) / 2 + (j - i);
    const float w = (i == j) ? 1.f : 2.f;
#pragma unroll
    for (int r = 0; r < FPB; ++r)
      xe[r * E2 + e] = xs[r * D + i] * xs[r * D + j] * w;
  }
  __syncthreads();

  // 4. rescore: warp w takes (frame, slot) pairs w, w + FPB, ...
  for (int p = warp; p < FPB * K; p += FPB) {
    const int r = p / K, k = p - (p / K) * K;
    const int f = f0 + r;
    if (f >= F) break;                        // pairs of later frames too
    const int id = ids[p];
    const float* row = A2 + (size_t)id * E2;
    const float* xr = xe + r * E2;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int e = lane;
    for (; e + 96 < E2; e += 128) {
      s0 = fmaf(xr[e], __ldg(row + e), s0);
      s1 = fmaf(xr[e + 32], __ldg(row + e + 32), s1);
      s2 = fmaf(xr[e + 64], __ldg(row + e + 64), s2);
      s3 = fmaf(xr[e + 96], __ldg(row + e + 96), s3);
    }
    for (; e < E2; e += 32) s0 = fmaf(xr[e], __ldg(row + e), s0);
    float v = (s0 + s1) + (s2 + s3);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      ll[(size_t)f * K + k] = v;
      if (!sel_in) sel[(size_t)f * K + k] = id;
    }
  }
}

size_t smem_bytes(int C, int D, int K, int E2, bool preselect) {
  return sizeof(float) * ((size_t)FPB * D + (size_t)FPB * E2 +
                          (preselect ? (size_t)FPB * C : 0)) +
         sizeof(int) * (size_t)FPB * K;
}

int launch(const float* x, const float* dconst, const float* dlin,
           const float* dquad, const float* A2, const long long* sel_in,
           float* ll, long long* sel, int F, int C, int D, int K, int E2,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F == 0 || K == 0) return 0;
  if (E2 != 1 + D + D * (D + 1) / 2) return (int)cudaErrorInvalidValue;
  if (sel_in == nullptr && K > C) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, D, K, E2, sel_in == nullptr);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gmm_align_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (F + FPB - 1) / FPB;
  gmm_align_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, dconst, dlin, dquad, A2, sel_in, ll, sel, F, C, D, K, E2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gmm_align_f32(const float* x, const float* dconst,
                             const float* dlin, const float* dquad,
                             const float* A2, float* ll, long long* sel,
                             int F, int C, int D, int K, int E2, int device,
                             void* stream) {
  return launch(x, dconst, dlin, dquad, A2, nullptr, ll, sel, F, C, D, K, E2,
                device, stream);
}

extern "C" int gmm_rescore_fused_f32(const float* x, const long long* sel_in,
                                     const float* A2, float* ll, int F, int C,
                                     int D, int K, int E2, int device,
                                     void* stream) {
  return launch(x, nullptr, nullptr, nullptr, A2, sel_in, ll, nullptr, F, C,
                D, K, E2, device, stream);
}
