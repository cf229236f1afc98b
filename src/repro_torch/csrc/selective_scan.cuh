// What the scan's forward (csrc/selective_scan.cu) and backward
// (csrc/selective_scan_bwd.cu) share: the blocks' channels and chunk
// steps, the d_state instances and groups, the exp2 they take the f32
// decays with, the masked loads and stores of rows of d_state values, and
// the sum of the state groups' partials.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 64;          // channels per block
constexpr int BT = 16;          // time steps per chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int GROUP = 64;       // states a group: the widest instance
constexpr int MAX_DS = 256;     // the widest d_state: GROUP x 4

// the instance a d_state runs: the least of 4, 8, 16, 32 and 64 at or above
// it (the states above it masked); past 64 the 64-state instance, once for
// each group of GROUP states (groups); 0 past MAX_DS
__host__ __device__ constexpr int instance(int ds) {
  return ds < 1 ? 0 : ds <= 4 ? 4 : ds <= 8 ? 8 : ds <= 16 ? 16
                    : ds <= 32 ? 32 : ds <= MAX_DS ? GROUP : 0;
}

// the groups of up to GROUP states a d_state is cut into: a grid axis of
// the forward and backward launches, each group a block's states
__host__ __device__ constexpr int groups(int ds) {
  return (ds + GROUP - 1) / GROUP;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// steps t0 .. t0 + BT - 1 of the [B, T, ds] array src into dst [BT][DS]
// by cp.async (and of src2 into dst2 in the same loop where dst2 is not
// null): 16-byte copies when ds is the instance's DS, else one float at a
// time with the states ds .. DS - 1 zero; steps past T read zero. The
// backward's gradient pass up to 64 states (scan_bwd_kernel) takes this
// form; the other kernels the one below, which also takes a group.
template <int THR, int DS>
__device__ __forceinline__ void load_states(float* dst, const float* src,
                                            float* dst2, const float* src2,
                                            int b, int t0, int T, int ds) {
  if (ds == DS) {
    for (int idx = threadIdx.x; idx < BT * DS / 4; idx += THR) {
      const int r = idx / (DS / 4), k = (idx % (DS / 4)) * 4;
      const bool in = t0 + r < T;
      const size_t off = ((size_t)b * T + t0 + r) * DS + k;
      cp_async16_zfill(dst + r * DS + k, in ? src + off : src, in ? 16 : 0);
      if (dst2 != nullptr)
        cp_async16_zfill(dst2 + r * DS + k, in ? src2 + off : src2,
                         in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * DS; idx += THR) {
      const int r = idx / DS, k = idx % DS;
      const bool in = t0 + r < T && k < ds;
      const size_t off = ((size_t)b * T + t0 + r) * ds + k;
      cp_async4_zfill(dst + r * DS + k, in ? src + off : src, in ? 4 : 0);
      if (dst2 != nullptr)
        cp_async4_zfill(dst2 + r * DS + k, in ? src2 + off : src2,
                        in ? 4 : 0);
    }
  }
}

// steps t0 .. t0 + BT - 1 of the states s0 .. s0 + ds - 1 of the [B, T,
// lds] array src into dst [BT][DS] by cp.async (and of src2 into dst2 in
// the same loop where dst2 is not null: the forward's Bc and Cc): 16-byte
// copies when ds is the instance's DS and the rows are 16-byte aligned,
// else one float at a time with the states ds .. DS - 1 zero; steps past T
// read zero. lds is the d_state, s0 the first state of the block's group.
template <int THR, int DS>
__device__ __forceinline__ void load_states(float* dst, const float* src,
                                            float* dst2, const float* src2,
                                            int b, int t0, int T, int ds,
                                            int lds, int s0) {
  if (ds == DS && lds % 4 == 0) {
    for (int idx = threadIdx.x; idx < BT * DS / 4; idx += THR) {
      const int r = idx / (DS / 4), k = (idx % (DS / 4)) * 4;
      const bool in = t0 + r < T;
      const size_t off = ((size_t)b * T + t0 + r) * lds + s0 + k;
      cp_async16_zfill(dst + r * DS + k, in ? src + off : src, in ? 16 : 0);
      if (dst2 != nullptr)
        cp_async16_zfill(dst2 + r * DS + k, in ? src2 + off : src2,
                         in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * DS; idx += THR) {
      const int r = idx / DS, k = idx % DS;
      const bool in = t0 + r < T && k < ds;
      const size_t off = ((size_t)b * T + t0 + r) * lds + s0 + k;
      cp_async4_zfill(dst + r * DS + k, in ? src + off : src, in ? 4 : 0);
      if (dst2 != nullptr)
        cp_async4_zfill(dst2 + r * DS + k, in ? src2 + off : src2,
                        in ? 4 : 0);
    }
  }
}

// y[i] += parts[i] + parts[stride + i] + .., the partial sums of the state
// groups past the first (whose partial y holds) added in group order, each
// group's n elements `stride` after the last's: no atomics, the same bits
// every run. The parts are a scratch the wrapper frees on return, so that y
// owns only its own bytes.
__global__ void sum_groups_kernel(float* __restrict__ y,
                                  const float* __restrict__ parts,
                                  long long n, long long stride, int nparts) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = y[i];
    for (int g = 0; g < nparts; ++g) acc += parts[g * stride + i];
    y[i] = acc;
  }
}

inline int sum_groups(float* y, const float* parts, long long n,
                      long long stride, int nparts, cudaStream_t st) {
  if (nparts < 1 || n == 0) return 0;
  const long long want = (n + 255) / 256;
  sum_groups_kernel<<<(unsigned)(want < 65535 ? want : 65535), 256, 0, st>>>(
      y, parts, n, stride, nparts);
  return (int)cudaGetLastError();
}

// v[0 .. N) to p[0 .. n), n = the states of this lane below ds (all N, 16
// bytes at a time, when the instance's DS is ds itself)
template <int N>
__device__ __forceinline__ void store_states(float* p, const float (&v)[N],
                                             int n, bool full) {
  if (full) {
#pragma unroll
    for (int s = 0; s < N; s += 4)
      *reinterpret_cast<float4*>(p + s) =
          make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < N; ++s)
      if (s < n) p[s] = v[s];
  }
}

}  // namespace
