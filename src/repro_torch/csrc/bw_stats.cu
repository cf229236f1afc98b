// Dense Baum-Welch moments on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bw_stats.py, bw_stats (_kernel).
//
//   n[c]        = sum_f G[f, c]
//   f[c, d]     = sum_f G[f, c] x[f, d]
//   S[c, i*D+j] = sum_f G[f, c] x[f, i] x[f, j]
//
// G [F, C] posteriors, x [F, D], all f32; n [C], f [C, D], S [C, D*D] f32.
//
// S_c is symmetric, so only its upper triangle is summed: P = D(D+1)/2
// pairs i <= j, each written to both S[c, i*D+j] and S[c, j*D+i]. The two
// halves are the same sum, so S is exactly symmetric.
//
// Bound on the H100: operations. The work is 2*F*C*(P + D + 1) FLOPs
// against F*C + F*D floats read and C*(D*D + D + 1) written: at D = 72 some
// 1,350 FLOPs per byte of G, far above the card's f32 ratio. Without tensor
// cores the ceiling is the CUDA cores' f32 FMA rate.
//
// Design: one SGEMM out[c, e] = sum_f G[f, c] X2[f, e] over the extended
// output width e in [0, P + D + 1), with X2[f, e] = x_i x_j (e = the packed
// index of pair i <= j, row-major over the upper triangle), x_d (e = P + d)
// or 1 (e = P + D, which gives n). The B operand X2 is never read from
// memory: each block copies the 8 frames of the current reduction slab of x
// into shared memory and forms its 8 x 128 slab of X2 from them, so the
// [F, D*D] expansion never reaches device memory -- the property of the TPU
// kernel worth keeping, and gmm_loglik.cu's design with the roles of the
// operands swapped. Each block owns one (128 components x 128 e) tile of the
// output and walks all of F itself, so no partial sum crosses blocks: no
// atomics, and every output is summed in one fixed order (the result is
// bitwise repeatable). Each thread holds an 8x8 tile of sums. Ragged F, C
// and E are masked: rows past F read zero, components and columns past the
// edge read zero and are not written.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                       // components per block
constexpr int BN = 128;                       // extended columns per block
constexpr int BK = 8;                         // frames per reduction slab
constexpr int THREADS = 256;                  // 16 x 16, 8x8 outputs each
constexpr int LD = BM + 4;                    // slab row stride (16-byte rows)

// Extended column e -> (i, j): a pair i <= j of S (e < P), x_i (j = -1,
// P <= e < P + D), the ones column (i = -1) or past the edge (i = -2).
__device__ void decode(int e, int D, int P, int& i, int& j) {
  if (e < P) {
    i = 0;
    while (e >= D - i) {
      e -= D - i;
      ++i;
    }
    j = i + e;
  } else if (e < P + D) {
    i = e - P;
    j = -1;
  } else {
    i = (e == P + D) ? -1 : -2;
    j = -1;
  }
}

__global__ void __launch_bounds__(THREADS)
bw_stats_kernel(const float* __restrict__ G, const float* __restrict__ x,
                float* __restrict__ n_out, float* __restrict__ f_out,
                float* __restrict__ S_out, int F, int C, int D) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                           // [BK][LD]: G slab, c-major
  float* Bs = As + BK * LD;                   // [BK][LD]: X2 slab
  float* xs = Bs + BK * LD;                   // [BK][D]: the slab's frames

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = blockIdx.y * BM;
  const int e0 = blockIdx.x * BN;
  const int P = D * (D + 1) / 2;

  // Each thread forms the same two X2 columns in every slab: column
  // bn = tid % BN at slab rows bk0 and bk0 + 4. Decode its e once.
  const int bn = tid % BN;
  const int bk0 = tid / BN;                   // 0 or 1
  int ei, ej;
  decode(e0 + bn, D, P, ei, ej);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BK) {
    for (int idx = tid; idx < BK * BM; idx += THREADS) {
      const int k = idx / BM, m = idx - (idx / BM) * BM;
      const int f = f0 + k, c = c0 + m;
      As[k * LD + m] = (f < F && c < C) ? G[(size_t)f * C + c] : 0.f;
    }
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int k = idx / D;
      const int f = f0 + k;
      xs[idx] = (f < F) ? x[(size_t)f * D + (idx - k * D)] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BK; r += THREADS / BN) {
      const int k = bk0 + r;
      const float* xk = xs + k * D;
      float v;
      if (ei == -2) v = 0.f;
      else if (ei == -1) v = (f0 + k < F) ? 1.f : 0.f;
      else if (ej < 0) v = xk[ei];
      else v = xk[ei] * xk[ej];
      Bs[k * LD + bn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k * LD + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k * LD + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k * LD + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k * LD + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int DD = D * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = e0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    int ci, cj;
    decode(col, D, P, ci, cj);
    if (ci == -2) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (c >= C) continue;
      if (cj >= 0) {
        S_out[(size_t)c * DD + ci * D + cj] = acc[i][j];
        if (ci != cj) S_out[(size_t)c * DD + cj * D + ci] = acc[i][j];
      } else if (ci >= 0) {
        f_out[(size_t)c * D + ci] = acc[i][j];
      } else {
        n_out[c] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int bw_stats_f32(const float* G, const float* x, float* n,
                            float* f, float* S, int F, int C, int D,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C == 0) return 0;
  const size_t smem = sizeof(float) * (2 * (size_t)BK * LD + (size_t)BK * D);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bw_stats_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int E = D * (D + 1) / 2 + D + 1;
  const dim3 grid((E + BN - 1) / BN, (C + BM - 1) / BM);
  bw_stats_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      G, x, n, f, S, F, C, D);
  return (int)cudaGetLastError();
}
