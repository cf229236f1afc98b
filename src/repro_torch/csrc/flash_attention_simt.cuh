// The f32 attention kernels' common parts on the CUDA cores (namespace simt
// of flash_attention.cu and flash_attention_bwd.cu): the block shape and
// the two register-blocked products every kernel is made of.
//
// A block is THREADS = 256 threads and owns R rows (64 or 128, a kernel's
// template argument): query rows in the forward and the dQ kernel, key
// rows in the dK/dV kernel. It walks the other side in steps of TILE =
// 128 rows (keys, or queries). A step is two kinds of product, each on
// its own microtile:
//
//   score  S[R][TILE] = A . B^T over the head dim, B (and A where it is not
//          resident) read from a ring slab of DC columns, rows DC + 4
//          floats apart. Warp w owns R / 8 rows in groups of 8: at R = 64
//          one group, its 32 lanes the B rows l + 32 j (j < 4), 8 x 4
//          scores a thread; at R = 128 two groups of 16 lanes, the B rows
//          l + 16 j (j < 8), 8 x 8. Every 4 columns a thread loads 16
//          bytes of each of its 8 A rows (the same address across a
//          quarter-warp: a broadcast) and of each of its B rows (8
//          consecutive rows a quarter-warp: distinct banks, the stride an
//          odd number of 16-byte units): 12 loads for 128 FMAs at R = 64,
//          16 for 256 at R = 128. The softmax's row max and sum are
//          shuffles across a group's lanes.
//   apply  out[R][WC] += T[R][TILE] . X[TILE][WC], T the P or dS tile
//          [R][PLD] in shared memory, X streamed through the ring KC rows
//          at a time. Thread (tr, tc) owns TM consecutive rows and the TN4
//          float4 columns tc + CT j: TM 16-byte loads of T (a broadcast
//          across the tc) and TN4 of each X row feed TM x TN4 x 16 FMAs
//          every 4 rows of X (8 x 16 outputs at R = 64 and WC = 512, 8 x 8
//          at R = 128 and WC = 128, 8 x 4 at R = 64 and WC = 128).
//
// What bounds them is the FMA issue and the work beside it: on the H100
// the products alone ran at 60-69% of the f32 FMA rate on the work their
// tiles compute (an f32 SGEMM by torch.mm at 77%), and a kernel's ring
// copies, barriers and softmax added their time to the products' rather
// than overlapping it (PERF.md §6 has the breakdown). The 8 x 8 microtile, with two thirds of the loads an FMA, is
// taken where the registers hold it.
//
// Every sum is an f32 FMA chain in the order of its index (columns for a
// score, rows of X for an apply), so a kernel's results repeat bitwise.
#pragma once

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace attn_simt {

constexpr int THREADS = 256;     // 8 warps
constexpr int TILE = 128;        // the other side's rows a step
constexpr int PLD = TILE + 4;    // row stride of an [R][PLD] P or dS tile

// the score product's lanes at R rows a block: row groups of 8 a warp,
// lanes a group, B rows a lane
template <int R>
struct Rows {
  static constexpr int RG = R / 64;
  static constexpr int LG = 32 / RG;
  static constexpr int KJ = TILE / LG;
  static_assert(R == 64 || R == 128, "rows a block");
};

// the apply product's thread layout at R rows and block width WC (a
// multiple of 32): CT threads across the columns (2048 / R where it
// divides WC / 4, else 16 or 8), RT = THREADS / CT across the rows
template <int WC, int R>
struct Cols {
  static constexpr int Q4 = WC / 4;                        // float4 columns
  static constexpr int CTM = 2048 / R;
  static constexpr int CT = Q4 % CTM == 0 ? CTM : Q4 % 16 == 0 ? 16 : 8;
  static constexpr int TN4 = Q4 / CT;                      // a thread's
  static constexpr int RT = THREADS / CT;
  static constexpr int TM = R / RT;                        // rows a thread
  static_assert(WC % 32 == 0 && TM * RT == R, "block width");
};

// the largest power of two up to TILE rows of X, WC wide, in `floats`
__host__ __device__ constexpr int chunk_rows(int WC, int floats) {
  int r = TILE;
  while (r * WC > floats) r /= 2;
  return r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// acc[i][j] += A[i] . B[kl + LG j] over DC columns: B a ring slab (rows DC
// + 4 floats apart), A a slab too or a resident tile (rows ald floats
// apart), both at the slab's first column and A at the thread's first row.
// U: the column loop's unroll (of DC / 4 steps); 8 x 8 microtiles take 1
// or 2, or ptxas hoists the next steps' loads past the 255 registers
template <int DC, int R, int U = DC / 4>
__device__ __forceinline__ void score(const float* A, int ald,
                                      const float* B,
                                      float (&acc)[8][Rows<R>::KJ], int kl) {
  using G = Rows<R>;
  constexpr int SLD = DC + 4;
#pragma unroll U
  for (int d = 0; d < DC; d += 4) {
    float4 b[G::KJ];
#pragma unroll
    for (int j = 0; j < G::KJ; ++j)
      b[j] = ld4(B + (kl + G::LG * j) * SLD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = ld4(A + i * ald + d);
#pragma unroll
      for (int j = 0; j < G::KJ; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] (row r0 + i, columns 4 (c4 + CT j) ..) += sum over the KC rows
// k of X of T[r0 + i][k] X[k][..]: T at the chunk's first column of the
// [R][PLD] tile, X [KC][WC]; U: the row loop's unroll (of KC / 4 steps)
template <int WC, int R, int KC, int U = KC / 4>
__device__ __forceinline__ void apply(const float* T, const float* X,
                                      float4 (&acc)[Cols<WC, R>::TM]
                                                   [Cols<WC, R>::TN4],
                                      int r0, int c4) {
  using C = Cols<WC, R>;
#pragma unroll U
  for (int k = 0; k < KC; k += 4) {
    float4 t[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) t[i] = ld4(T + (r0 + i) * PLD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < C::TN4; ++j) {
        const float4 x = ld4(X + (k + kk) * WC + 4 * (c4 + C::CT * j));
#pragma unroll
        for (int i = 0; i < C::TM; ++i) fma4(acc[i][j], lane4(t[i], kk), x);
      }
    }
  }
}

// one value across the LG lanes of a row group (xor shuffles stay inside
// it: LG is 32 or 16)
template <int LG>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int LG>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 4 f32 values of a row to global memory at column col: one float4 store
// where hd is a multiple of 4 (16-byte aligned rows), else one element at
// a time; columns at or past hd are skipped
__device__ __forceinline__ void store4(float* row, int col, int hd,
                                       float4 v) {
  if ((hd & 3) == 0) {
    if (col < hd) *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < hd) row[col + e] = lane4(v, e);
}

}  // namespace attn_simt
