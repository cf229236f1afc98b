// Packed-symmetric TVM E-step matmul (sm_90a): out[M, N] = a[M, K] @ b[K, N].
//
// Replaces: src/repro/kernels/tvm_estep.py, _packed_matmul (_matmul_kernel),
// which backs both tvm_estep_l (L = n @ U_packed, [U, C] @ [C, P]) and
// tvm_estep_a (A = n^T @ PP_packed, [C, U] @ [U, P]); P = R(R+1)/2.
//
// a is read through two strides, so tvm_estep_a passes n^T as
// (stride_m, stride_k) = (1, C) over n itself instead of a transposed copy.
// Inputs are f32 or bf16 (widened with __bfloat162float as they enter
// shared memory); products and sums are always f32.
//
// Bound on the H100: memory for L at serving. With M = 16 utterances the
// product does 2*M FLOPs per element of b and reads all of b once (C*P
// floats, 657 MB at C = 2048, R = 400), so the rate at which b streams from
// device memory sets the time. A at training (M = C) does 2*U FLOPs per
// element of b and is bound by the f32 FMA rate.
//
// Design: a shared-memory tiled SGEMM. The reduction runs as a loop inside
// each block, in place of the TPU's sequential third grid axis; blocks
// never share partial sums, so there are no atomics and every sum is taken
// in a fixed order. Small M (<= 16) takes a 16 x 128 tile that walks b once
// with 16 loads per thread in flight; larger M takes a 128 x 128 tile with
// 8 x 8 register blocking. Ragged M, K and N are masked in the loads and
// the stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
packed_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ out, int M, int K, int N,
                     long long sam, long long sak) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int THREADS = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool k_fast = (sak == 1);   // walk a along its contiguous axis

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int m, k;
      if (k_fast) { m = idx / BK; k = idx % BK; }
      else        { k = idx / BM; m = idx % BM; }
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K)
                     ? widen(a[(long long)gm * sam + (long long)gk * sak])
                     : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? widen(b[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* a, const T* b, float* out, int M, int K, int N,
           long long sam, long long sak, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 16) {
    const dim3 grid((N + 127) / 128, (M + 15) / 16);
    packed_matmul_kernel<T, 16, 128, 32, 1, 8>
        <<<grid, 256, 0, s>>>(a, b, out, M, K, N, sam, sak);
  } else {
    const dim3 grid((N + 127) / 128, (M + 127) / 128);
    packed_matmul_kernel<T, 128, 128, 8, 8, 8>
        <<<grid, 256, 0, s>>>(a, b, out, M, K, N, sam, sak);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int packed_matmul_f32(const void* a, const void* b, float* out,
                                 int M, int K, int N, long long sam,
                                 long long sak, int device, void* stream) {
  return launch(static_cast<const float*>(a), static_cast<const float*>(b),
                out, M, K, N, sam, sak, device, stream);
}

extern "C" int packed_matmul_bf16(const void* a, const void* b, float* out,
                                  int M, int K, int N, long long sam,
                                  long long sak, int device, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), out, M, K, N, sam, sak,
                device, stream);
}
