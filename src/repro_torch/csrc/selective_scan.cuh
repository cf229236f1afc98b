// What the scan's forward (csrc/selective_scan.cu) and backward
// (csrc/selective_scan_bwd.cu) share: the blocks' channels and chunk
// steps, the d_state instances, the exp2 they take the f32 decays with,
// and the masked loads and stores of rows of d_state values.
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

// the instance a d_state runs: the least of 4, 8, 16, 32 and 64 at or above
// it (the states above it masked); 0 past 64
__host__ __device__ constexpr int instance(int ds) {
  return ds < 1 ? 0 : ds <= 4 ? 4 : ds <= 8 ? 8 : ds <= 16 ? 16
                    : ds <= 32 ? 32 : ds <= 64 ? 64 : 0;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// steps t0 .. t0 + BT - 1 of the [B, T, ds] array src into dst [BT][DS]
// by cp.async (and of src2 into dst2 in the same loop where dst2 is not
// null: the forward's Bc and Cc): 16-byte copies when ds is the
// instance's DS, else one float at a time with the states ds .. DS - 1
// zero; steps past T read zero
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
