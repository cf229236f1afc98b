// Causal GQA flash attention, backward pass, on Hopper (sm_90a).
//
// Replaces: the derivative of src/repro/kernels/flash_attention.py,
// flash_attention (_kernel). The TPU kernel is forward only; the JAX package
// trains through jnp autodiff of its blockwise attention
// (src/repro/models/layers.py, blockwise_causal_attention), which keeps each
// block's probabilities. This is the derivative of the forward kernel in
// flash_attention.cu, recomputed tile by tile from the forward's row
// log-sum-exps:
//
//   P_ij  = exp(s q_i . k_j - lse_i)            (0 above the diagonal)
//   dV_j  = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j,   Delta_i = dO_i . o_i
//   dS_ij = P_ij (dP_ij - Delta_i)
//   dQ_i  = s sum_j dS_ij k_j,   dK_j = s sum_i dS_ij q_i
//
// with s = hd^-1/2 and, under GQA, dK and dV of a kv head summed over the
// G = H / KVH query heads that read it. q, o, dO, dQ [B, S, H, hd], k, v,
// dK, dV [B, S, KVH, hd], all in the input type (f32 or bf16); lse and
// Delta [B, H, S] f32. Every product and sum is f32; a bf16 result is
// rounded once, at its store.
//
// Bound on the H100: operations. Five products over the causal half
// (Q.K^T again, dO.V^T, P^T.dO, dS^T.Q, dS.K): 5 * 2 * B*H*hd*S^2/2 FLOPs
// against (4 B S H + 4 B S KVH) hd elements and the lse moved.
//
// Design: three kernels, no atomics, so the gradients are the same bits on
// every run.
//   - delta_kernel: one warp per (b, row, head), Delta = dO . o summed by
//     a shuffle tree.
//   - dq_kernel: one block per (query tile, head, batch), longest rows
//     first; the q and dO tiles stay in shared memory while the (k, v)
//     tiles up to the diagonal pass through; dS goes through shared memory
//     for dS.K, dQ accumulates in registers.
//   - dkdv_kernel: one block per (key tile, kv head, batch), longest first;
//     the k and v tiles stay in shared memory while the query tiles from
//     the diagonal on pass through, head by head of the kv head's group in
//     order, so GQA's sum over the group is a fixed-order sum in the block;
//     P and dS go through shared memory for P^T.dO and dS^T.Q.
// All three run on the CUDA cores (f32 FMAs), 256 threads as 16 x 16, the
// score tile split 4 x 4 (2 x 2 above hd 128) a thread as in the forward's
// f32 kernel. Tiles are 64 rows up to hd = 128 and 32 above, so that the
// four [rows][hd + 1] f32 tiles fit a block's shared memory at hd = 256.
// Keys and queries at or past S load as zeros and are masked; a tile wholly
// above the diagonal is never visited. This is the simple kernel that is
// right: the tensor cores are left for a later redesign (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows of a query or key tile, by head dim: 64 up to hd 128, 32 above
template <int HD>
struct Tile {
  static constexpr int BR = HD <= 128 ? 64 : 32;
  static constexpr int RI = BR / 16;    // score rows (and columns) a thread
  static constexpr int CPT = HD / 16;   // hd columns a thread
  static constexpr int LD = HD + 1;     // [rows][hd] tile row stride
  static constexpr int PLD = BR + 1;    // [rows][rows] tile row stride
  // dq: q, dO, k, v tiles, dS, lse and Delta
  static constexpr int DQ_FLOATS = 4 * BR * LD + BR * PLD + 2 * BR;
  // dkdv: k, v, q, dO tiles, P and dS, lse and Delta
  static constexpr int DKDV_FLOATS = 4 * BR * LD + 2 * BR * PLD + 2 * BR;
  static_assert(DKDV_FLOATS * 4 <= 232448, "over the block's shared memory");
};

// Delta[b, h, i] = dO[b, i, h] . o[b, i, h]: one warp a row, rows in the
// [B, S, H] order of o
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int S, int H,
             int hd) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(ld(op + d), ld(dp + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % S);
    const long long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// rows r0 .. r0 + BR - 1 of a [S, heads, HD] slab (row stride `stride`
// elements) into a [BR][LD] f32 tile, zeros past S
template <int HD, int BR, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int r0, int S) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < BR * HD; idx += THREADS) {
    const int r = idx / HD, d = idx - (idx / HD) * HD;
    const int s = r0 + r;
    dst[r * LD + d] = s < S ? ld(src + (size_t)s * stride + d) : 0.f;
  }
}

// sc = Qt . Kt^T and dp = dOt . Vt^T for this thread's RI x RI scores (rows
// ty + 16 i of the query tile, columns tx + 16 j of the key tile)
template <int HD, int RI>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&sc)[RI][RI],
                                       float (&dp)[RI][RI]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      sc[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[RI], ov[RI], kv[RI], vv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + d];
      ov[i] = dOs[(ty + 16 * i) * LD + d];
      kv[i] = Ks[(tx + 16 * i) * LD + d];
      vv[i] = Vs[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int KVH, float scale) {
  using L = Tile<HD>;
  constexpr int BR = L::BR, RI = L::RI, CPT = L::CPT, LD = L::LD,
                PLD = L::PLD;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BR][LD]
  float* dOs = Qs + BR * LD;      // [BR][LD]
  float* Ks = dOs + BR * LD;      // [BR][LD]
  float* Vs = Ks + BR * LD;       // [BR][LD]
  float* dSs = Vs + BR * LD;      // [BR][PLD]
  float* Ls = dSs + BR * PLD;     // [BR]
  float* Ds = Ls + BR;            // [BR]

  const int nq = (S + BR - 1) / BR;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * BR;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KVH * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const size_t koff = (size_t)b * S * krow + (size_t)kh * HD;
  const float* lrow = lse + ((size_t)b * H + h) * S;
  const float* drow = delta + ((size_t)b * H + h) * S;

  load_tile<HD, BR>(Qs, q + qoff, qrow, q0, S);
  load_tile<HD, BR>(dOs, dout + qoff, qrow, q0, S);
  for (int r = tid; r < BR; r += THREADS) {
    const int s = q0 + r;
    Ls[r] = s < S ? lrow[s] : 0.f;
    Ds[r] = s < S ? drow[s] : 0.f;
  }

  float acc[RI][CPT];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {   // key tiles up to the diagonal
    const int k0 = kt * BR;
    __syncthreads();   // the last tile's readers are done
    load_tile<HD, BR>(Ks, k + koff, krow, k0, S);
    load_tile<HD, BR>(Vs, v + koff, krow, k0, S);
    __syncthreads();
    float sc[RI][RI], dp[RI][RI];
    scores<HD, RI>(Qs, dOs, Ks, Vs, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = (kpos <= qpos && qpos < S)
                            ? expf(fmaf(sc[i][j], scale, -Ls[r]))
                            : 0.f;
        dSs[r * PLD + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dSs[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float kk = Ks[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][cc] = fmaf(dsv[i], kk, acc[i][cc]);
      }
    }
  }

  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      st(dqb + (size_t)qpos * qrow + tx + 16 * cc, acc[i][cc] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KVH,
            float scale) {
  using L = Tile<HD>;
  constexpr int BR = L::BR, RI = L::RI, CPT = L::CPT, LD = L::LD,
                PLD = L::PLD;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BR][LD]
  float* Vs = Ks + BR * LD;       // [BR][LD]
  float* Qs = Vs + BR * LD;       // [BR][LD]
  float* dOs = Qs + BR * LD;      // [BR][LD]
  float* Ps = dOs + BR * LD;      // [BR][PLD]: [query][key]
  float* dSs = Ps + BR * PLD;     // [BR][PLD]
  float* Ls = dSs + BR * PLD;     // [BR]
  float* Ds = Ls + BR;            // [BR]

  const int nq = (S + BR - 1) / BR;
  const int kt = blockIdx.x;      // key tile 0 sees the most queries: first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = kt * BR;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KVH * HD;
  const size_t koff = (size_t)b * S * krow + (size_t)kh * HD;

  load_tile<HD, BR>(Ks, k + koff, krow, k0, S);
  load_tile<HD, BR>(Vs, v + koff, krow, k0, S);

  // this thread's rows ty + 16 i of the key tile, columns tx + 16 cc
  float accK[RI][CPT], accV[RI][CPT];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      accK[i][c] = 0.f;
      accV[i][c] = 0.f;
    }

  for (int g = 0; g < G; ++g) {   // the group's query heads, in order
    const int h = kh * G + g;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const float* lrow = lse + ((size_t)b * H + h) * S;
    const float* drow = delta + ((size_t)b * H + h) * S;
    for (int qt = kt; qt < nq; ++qt) {   // query tiles from the diagonal
      const int q0 = qt * BR;
      __syncthreads();   // the last tile's readers are done
      load_tile<HD, BR>(Qs, q + qoff, qrow, q0, S);
      load_tile<HD, BR>(dOs, dout + qoff, qrow, q0, S);
      for (int r = tid; r < BR; r += THREADS) {
        const int s = q0 + r;
        Ls[r] = s < S ? lrow[s] : 0.f;
        Ds[r] = s < S ? drow[s] : 0.f;
      }
      __syncthreads();
      float sc[RI][RI], dp[RI][RI];
      scores<HD, RI>(Qs, dOs, Ks, Vs, ty, tx, sc, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const float p = (kpos <= qpos && qpos < S)
                              ? expf(fmaf(sc[i][j], scale, -Ls[r]))
                              : 0.f;
          Ps[r * PLD + tx + 16 * j] = p;
          dSs[r * PLD + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {   // the tile's query rows, in order
        float pv[RI], dsv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[r * PLD + ty + 16 * i];
          dsv[i] = dSs[r * PLD + ty + 16 * i];
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const float ov = dOs[r * LD + tx + 16 * cc];
          const float qv = Qs[r * LD + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            accV[i][cc] = fmaf(pv[i], ov, accV[i][cc]);
            accK[i][cc] = fmaf(dsv[i], qv, accK[i][cc]);
          }
        }
      }
    }
  }

  T* dkb = dk + koff;
  T* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const size_t at = (size_t)kpos * krow + tx + 16 * cc;
      st(dkb + at, accK[i][cc] * scale);
      st(dvb + at, accV[i][cc]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int H, int KVH, cudaStream_t st) {
  using L = Tile<HD>;
  const int dq_smem = L::DQ_FLOATS * (int)sizeof(float);
  const int dkdv_smem = L::DKDV_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem);
  if (err != cudaSuccess) return (int)err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long rows = (long long)B * S * H;
  delta_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                    THREADS, 0, st>>>(static_cast<const T*>(o), dop, dl, rows,
                                      S, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)std::pow((double)HD, -0.5);
  const int nt = (S + L::BR - 1) / L::BR;
  dq_kernel<T, HD><<<dim3(nt, H, B), THREADS, dq_smem, st>>>(
      qp, kp, vp, dop, lp, dl, static_cast<T*>(dq), S, H, KVH, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, HD><<<dim3(nt, KVH, B), THREADS, dkdv_smem, st>>>(
      qp, kp, vp, dop, lp, dl, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      KVH, scale);
  return (int)cudaGetLastError();
}

int prologue(int H, int KVH, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q, k, v, o, lse (the forward's), dout, then dq, dk, dv and the [B, H, S]
// f32 scratch for Delta; B, S, H, KVH, hd, device, stream
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       void* delta, int B, int S, int H,
                                       int KVH, int hd, int device,
                                       void* stream) {
  const int err = prologue(H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
#define FAB_CASE(N)                                                         \
  case N:                                                                   \
    return launch<float, N>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, \
                            H, KVH, st);
    FAB_CASE(16) FAB_CASE(32) FAB_CASE(48) FAB_CASE(64) FAB_CASE(80)
    FAB_CASE(96) FAB_CASE(112) FAB_CASE(128) FAB_CASE(144) FAB_CASE(160)
    FAB_CASE(176) FAB_CASE(192) FAB_CASE(208) FAB_CASE(224) FAB_CASE(240)
    FAB_CASE(256)
#undef FAB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        void* delta, int B, int S, int H,
                                        int KVH, int hd, int device,
                                        void* stream) {
  const int err = prologue(H, KVH, device);
  if (err != 0 || B == 0 || S == 0 || H == 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {   // BF16_HEAD_DIMS in kernels/flash_attention.py
    case 64:
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, dout, dq, dk, dv,
                                       delta, B, S, H, KVH, st);
    case 128:
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, dout, dq, dk, dv,
                                        delta, B, S, H, KVH, st);
    case 192:
      return launch<__nv_bfloat16, 192>(q, k, v, o, lse, dout, dq, dk, dv,
                                        delta, B, S, H, KVH, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
