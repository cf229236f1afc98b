// Causal GQA flash attention, forward pass, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (_kernel).
//
//   o[b, i, h] = sum_{j <= i} softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(hd))
//                v[b, j, h/G]
//
// q [B, S, H, hd], k and v [B, S, KVH, hd], G = H / KVH; f32 or bf16 in,
// f32 inside, o [B, S, H, hd] in the input type.
//
// Bound on the H100: operations. The function needs 4*B*H*hd*S^2/2 FLOPs
// (two products over the causal half) against (2*B*S*H + 2*B*S*KVH)*hd
// elements moved: hundreds of FLOPs per byte at S in the thousands. This
// kernel runs its products on the CUDA cores in f32, so its ceiling is the
// f32 FMA rate, not the tensor cores' bf16 rate.
//
// Design: one block per (q tile of 64 rows, head, batch), 256 threads as
// 16 x 16; thread (ty, tx) owns query rows ty + 16i (i < 4). The q tile,
// then each 64-row k and v tile, are staged in shared memory as f32
// (3 x 32 KB at hd = 128, above the 48 KB default, so the entry point
// raises the block's dynamic shared memory limit). Each thread computes a
// 4 x 4 block of scores, the row max and row sum go across the 16 lanes
// of a row by warp shuffles, and the running max m, sum l and the output
// accumulator (4 rows x hd/16 columns) stay in registers across kv tiles:
// the [S, S] scores never reach device memory, the property of the TPU
// kernel worth keeping. Tiles wholly above the diagonal are skipped;
// masked scores are -1e30, as in the TPU kernel; rows and keys past S are
// masked here, so any S is exact. The p tile goes through shared memory
// for P.V and stays f32 there (the TPU kernel keeps p in f32 as well).
// Blocks of the longest rows are issued first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // kv rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PLD = BKV + 1;    // p tile row stride
constexpr float NEG = -1e30f;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)2 * BQ * (HD + 1) + (size_t)BKV * HD + (size_t)BQ * PLD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KVH, float scale) {
  constexpr int LD = HD + 1;        // q and k tile row stride
  constexpr int CPT = HD / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BKV][LD]
  float* Vs = Ks + BKV * LD;        // [BKV][HD]
  float* Ps = Vs + BKV * HD;        // [BQ][PLD]

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = qt * BQ;

  const size_t qrow = (size_t)H * HD;        // row strides, in elements
  const size_t krow = (size_t)KVH * HD;
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * krow + (size_t)kh * HD;
  const T* vb = v + (size_t)b * S * krow + (size_t)kh * HD;
  T* ob = o + (size_t)b * S * qrow + (size_t)h * HD;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx - (idx / HD) * HD;
    const int s = q0 + r;
    Qs[r * LD + d] = s < S ? to_f32(qb[(size_t)s * qrow + d]) : 0.f;
  }

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();   // the last tile's readers are done; Qs is written
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int r = idx / HD, d = idx - (idx / HD) * HD;
      const int s = k0 + r;
      const bool in = s < S;
      Ks[r * LD + d] = in ? to_f32(kb[(size_t)s * krow + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[(size_t)s * krow + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
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
    for (int c = 0; c < BKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = Vs[c * HD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      store(&ob[(size_t)qpos * qrow + tx + 16 * cc], acc[i][cc] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KVH, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = (float)std::pow((double)HD, -0.5);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KVH, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KVH, int hd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
#define FA_CASE(N) \
  case N:          \
    return launch<T, N>(q, k, v, o, B, S, H, KVH, st);
    FA_CASE(16) FA_CASE(32) FA_CASE(48) FA_CASE(64) FA_CASE(80) FA_CASE(96)
    FA_CASE(112) FA_CASE(128) FA_CASE(144) FA_CASE(160) FA_CASE(176)
    FA_CASE(192) FA_CASE(208) FA_CASE(224) FA_CASE(240) FA_CASE(256)
#undef FA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KVH, int hd, int device,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, KVH, hd, device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KVH, int hd, int device,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, hd, device,
                                 stream);
}
