// Mamba selective scan on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan (_kernel).
//
//   h_t = exp(dt_t A) h_{t-1} + dx_t B_t,   y_t = C_t . h_t
//
// dt, dx [B, T, di], A [di, ds], Bc, Cc [B, T, ds], h0 [B, di, ds] or
// null (zeros), all f32; y [B, T, di] and h_last [B, di, ds] f32. One
// template instance for each ds in {4, 8, 16, 32, 64}. For training, hs
// (null, or [B, ceil(T / BT), di, ds] f32) receives the state at the start
// of every BT-step chunk (hs[:, 0] = h0), from which the backward kernel
// (namespace bwd, below) recomputes each chunk's states.
//
// Bound on the H100: the bytes. Per (b, t, channel) the function reads dt
// and dx and writes y (12 bytes); Bc and Cc are ds floats per (b, t),
// shared by all di channels. At B = 4, T = 2048, di = 8192, ds = 16: 805
// MB, 0.24 ms at 3.35 TB/s. Its 1.07 G exponentials (one per state and
// step) take 0.26 ms on the MUFU unit alone (16 a clock an SM, 1.98 GHz),
// but the FMA pipe can take a share of them as a polynomial (~8
// instructions each, beside the ~4 of the recurrence a state): split so,
// they need ~0.19 ms, under the bytes.
//
// What held the previous kernel back: one thread per (b, channel) with all
// 16 states, so 1,024 warps at Jamba's shape (~7.8 an SM) and 8 loads in
// flight a thread to hide a sequential loop; and an accurate expf per
// state (a range reduction on the f32 pipe, then MUFU).
//
// Design:
//   - d_state is split over lanes: lanes(ds) lanes of one warp share a
//     channel (2 at ds = 16), each holding ds / lanes consecutive states
//     and their row of A in registers for the whole of T (twice the warps
//     at ds = 16). Each lane of a channel reads the step's dt and dx and
//     takes part in the shuffles, so more lanes cost more than they hide:
//     at Jamba's shape 4 lanes a channel were slower on the card than 2,
//     and 1 no faster. A lane sums C_s h_s over its states in ascending
//     order; the lanes' sums are added by __shfl_xor over 1, then 2 apart,
//     reduce-scattered over groups of `lanes` steps (lane l keeps step l
//     of a group): each y is (p0 + p1) + (p2 + p3), the same on every run.
//   - A block is 64 channels of one batch row. Chunks of 16 time steps of
//     dt and dx ([16, 64] tiles, 256-byte rows) and of Bc and Cc come in
//     through a 3-stage cp.async ring, so two chunks are in flight while
//     one is computed; y is staged in shared memory and leaves as
//     coalesced rows.
//   - log2(e) is folded into A once (a2 = A log2 e, in registers), and each
//     decay is ex2.approx.ftz(dt a2): one FMUL and one MUFU.EX2, without
//     expf's range reduction. The decays lie in (0, 1]; ex2.approx's
//     relative error (~2^-22) stays far inside the 1e-4 x max|plain| the
//     scan is held to (chip_smoke.py prints the margin).
//   - The state starts from h0 when given and is written back to h_last,
//     so one kernel serves prefill and a decode step (T = 1). The [B, T,
//     di, ds] transition tensors of the XLA scan never exist, the property
//     of the TPU kernel worth keeping.
// At ds = 16 the kernel runs at about 59% of its bytes bound; on the card,
// copies with the exponentials, or the dt and dx loads, or the shuffles
// taken out each ran only a little faster, so no one unit sets the pace of
// what is left.
// Shared memory (dynamic): 3 x 16 x (2 x 64 + 2 ds) floats and the [16,
// 64] y tile: 34 KB at ds = 16; blocks of 128 threads, at least 4 an SM, so
// Jamba's 512 blocks fill the card in one wave. Channels past di and steps
// past T are masked.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 64;          // channels per block
constexpr int BT = 16;          // time steps per chunk
constexpr int STAGES = 3;       // chunks in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// lanes of a warp that share a channel: 2, each with half the states; 1 at
// ds = 4 and 4 from ds = 32 on, so that a lane holds 4 to 16 states
__host__ __device__ constexpr int lanes(int ds) {
  return ds == 4 ? 1 : ds <= 16 ? 2 : 4;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The lanes' partial sums of L steps, reduce-scattered: added over lanes 1
// apart, then 2 apart, lane l keeping step l. Each step's y comes out as
// (p0 + p1) + (p2 + p3) of its lanes' partials (up to the order of each
// addition's two operands, which does not change the sum): what a full
// xor tree gives every lane, with 3 shuffles for 4 steps instead of 8.
template <int L>
__device__ __forceinline__ float reduce_scatter(const float (&p)[L], int l) {
  if constexpr (L == 1) {
    return p[0];
  } else if constexpr (L == 2) {
    const float send = (l & 1) ? p[0] : p[1];
    return ((l & 1) ? p[1] : p[0]) + __shfl_xor_sync(FULL, send, 1);
  } else {
    static_assert(L == 4, "lanes() gives 1, 2 or 4");
    float w[2];                   // w[j]: step 2j + (l & 1)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float send = (l & 1) ? p[2 * j] : p[2 * j + 1];
      w[j] = ((l & 1) ? p[2 * j + 1] : p[2 * j]) +
             __shfl_xor_sync(FULL, send, 1);
    }
    const float send = (l & 2) ? w[0] : w[1];
    return ((l & 2) ? w[1] : w[0]) + __shfl_xor_sync(FULL, send, 2);
  }
}

// shared memory in floats: per stage dt [BT][CH], dx [BT][CH], Bc [BT][DS],
// Cc [BT][DS]; then y [BT][CH]
__host__ __device__ constexpr int smem_floats(int ds) {
  return STAGES * BT * (2 * CH + 2 * ds) + BT * CH;
}

template <int DS>
__global__ void __launch_bounds__(CH * lanes(DS), DS <= 16 ? 4 : 2)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ dx,
                      const float* __restrict__ A,
                      const float* __restrict__ Bc,
                      const float* __restrict__ Cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, float* __restrict__ hs,
                      int T, int di) {
  constexpr int L = lanes(DS);            // lanes per channel
  constexpr int S = DS / L;               // states per lane
  constexpr int THR = CH * L;
  constexpr int STAGE = BT * (2 * CH + 2 * DS);
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + STAGES * STAGE;      // [BT][CH]

  const int tid = threadIdx.x;
  const int ch = tid / L, l = tid % L;
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const bool live = d < di;
  const bool vec = (di % 4) == 0;         // dt, dx, y rows 16-byte aligned

  // chunk c (time steps c*BT..) into ring stage st; steps past T and
  // channels past di read zero
  auto load_chunk = [&](int c, int st) {
    float* dts = smem + st * STAGE;
    float* dxs = dts + BT * CH;
    float* bs = dxs + BT * CH;
    float* cs = bs + BT * DS;
    const int t0 = c * BT;
    if (vec) {
      for (int idx = tid; idx < BT * CH / 4; idx += THR) {
        const int r = idx / (CH / 4), k = (idx % (CH / 4)) * 4;
        const int t = t0 + r;
        const bool in = t < T && d0 + k < di;
        const size_t off = ((size_t)b * T + t) * di + d0 + k;
        cp_async16_zfill(dts + r * CH + k, in ? dt + off : dt, in ? 16 : 0);
        cp_async16_zfill(dxs + r * CH + k, in ? dx + off : dx, in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BT * CH; idx += THR) {
        const int r = idx / CH, k = idx % CH;
        const int t = t0 + r;
        const bool in = t < T && d0 + k < di;
        const size_t off = ((size_t)b * T + t) * di + d0 + k;
        cp_async4_zfill(dts + r * CH + k, in ? dt + off : dt, in ? 4 : 0);
        cp_async4_zfill(dxs + r * CH + k, in ? dx + off : dx, in ? 4 : 0);
      }
    }
    for (int idx = tid; idx < BT * DS / 4; idx += THR) {
      const int r = idx / (DS / 4), k = (idx % (DS / 4)) * 4;
      const int t = t0 + r;
      const bool in = t < T;
      const size_t off = ((size_t)b * T + t) * DS + k;
      cp_async16_zfill(bs + r * DS + k, in ? Bc + off : Bc, in ? 16 : 0);
      cp_async16_zfill(cs + r * DS + k, in ? Cc + off : Cc, in ? 16 : 0);
    }
  };

  const int nchunk = (T + BT - 1) / BT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunk) load_chunk(s, s);
    cp_commit();
  }

  float a2[S], h[S];
  const size_t row = ((size_t)b * di + d) * DS + l * S;   // h0, h_last
#pragma unroll
  for (int s = 0; s < S; s += 4) {
    const float4 av = live ? *reinterpret_cast<const float4*>(
                                 A + (size_t)d * DS + l * S + s)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hv = (live && h0 != nullptr)
                          ? *reinterpret_cast<const float4*>(h0 + row + s)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    a2[s] = av.x * LOG2E; a2[s + 1] = av.y * LOG2E;
    a2[s + 2] = av.z * LOG2E; a2[s + 3] = av.w * LOG2E;
    h[s] = hv.x; h[s + 1] = hv.y; h[s + 2] = hv.z; h[s + 3] = hv.w;
  }

  for (int c = 0; c < nchunk; ++c) {
    if (hs != nullptr && live) {  // the state at the chunk's start
      float* hc = hs + (((size_t)b * nchunk + c) * di + d) * DS + l * S;
#pragma unroll
      for (int s = 0; s < S; s += 4)
        *reinterpret_cast<float4*>(hc + s) =
            make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
    }
    cp_wait<STAGES - 2>();        // chunk c has landed (this thread's copies)
    __syncthreads();              // everyone's; chunk c-1's stage and y free
    const int nx = c + STAGES - 1;
    if (nx < nchunk) load_chunk(nx, nx % STAGES);
    cp_commit();
    const float* dts = smem + (c % STAGES) * STAGE;
    const float* dxs = dts + BT * CH;
    const float* bs = dxs + BT * CH;
    const float* cs = bs + BT * DS;
    const int nt = min(BT, T - c * BT);
    // groups of L steps (L divides BT). Steps past T read zeros, dt = dx
    // = 0, so they leave h as it is (ex2(+-0) is exactly 1) and their y is
    // not written out.
    const int ng = (nt + L - 1) / L;
#pragma unroll 2
    for (int g = 0; g < ng; ++g) {
      float p[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int tt = g * L + j;
        const float dtv = dts[tt * CH + ch], dxv = dxs[tt * CH + ch];
        float bv[S], cv[S];
#pragma unroll
        for (int s = 0; s < S; s += 4) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(bs + tt * DS + l * S + s);
          const float4 c4 =
              *reinterpret_cast<const float4*>(cs + tt * DS + l * S + s);
          bv[s] = b4.x; bv[s + 1] = b4.y; bv[s + 2] = b4.z; bv[s + 3] = b4.w;
          cv[s] = c4.x; cv[s + 1] = c4.y; cv[s + 2] = c4.z; cv[s + 3] = c4.w;
        }
        float q = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          h[s] = fmaf(ex2(dtv * a2[s]), h[s], dxv * bv[s]);
          q = fmaf(h[s], cv[s], q);
        }
        p[j] = q;
      }
      ys[(g * L + l) * CH + ch] = reduce_scatter<L>(p, l);
    }
    __syncthreads();              // the chunk's y tile is complete
    const int t0 = c * BT;
    if (vec) {
      for (int idx = tid; idx < nt * CH / 4; idx += THR) {
        const int r = idx / (CH / 4), k = (idx % (CH / 4)) * 4;
        if (d0 + k < di)
          *reinterpret_cast<float4*>(y + ((size_t)b * T + t0 + r) * di + d0 +
                                     k) =
              *reinterpret_cast<const float4*>(ys + r * CH + k);
      }
    } else {
      for (int idx = tid; idx < nt * CH; idx += THR) {
        const int r = idx / CH, k = idx % CH;
        if (d0 + k < di)
          y[((size_t)b * T + t0 + r) * di + d0 + k] = ys[r * CH + k];
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < S; s += 4)
    *reinterpret_cast<float4*>(h_last + row + s) =
        make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
}

template <int DS>
int launch(const float* dt, const float* dx, const float* A, const float* Bc,
           const float* Cc, const float* h0, float* y, float* h_last,
           float* hs, int B, int T, int di, void* stream) {
  const int smem = (int)sizeof(float) * smem_floats(DS);
  if (smem > 48 * 1024) {       // only ds = 64; a decode step stays lean
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((di + CH - 1) / CH, B);
  selective_scan_kernel<DS><<<grid, CH * lanes(DS), smem,
                              (cudaStream_t)stream>>>(dt, dx, A, Bc, Cc, h0,
                                                       y, h_last, hs, T,
                                                       di);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ backward ----
//
// The derivative of the scan (the TPU kernel is forward only; the JAX
// package trains through jnp autodiff of its chunked associative scan,
// src/repro/models/mamba.py, _ssm_scan). With a_t = exp(dt_t A) and the
// adjoint g_t = dL/dh_t,
//
//   g_t      = dy_t C_t + a_{t+1} g_{t+1}      (g_{T-1} = dy C + dh_last)
//   d(dx_t)  = sum_s g_t B_t
//   d(dt_t)  = sum_s g_t A a_t h_{t-1}
//   dA       = sum_{b,t} g_t dt_t a_t h_{t-1}
//   dB_t     = sum_d g_t dx_t,    dC_t = sum_d dy_t h_t
//   dh0      = a_0 g_0
//
// Bound on the H100: the bytes (dt, dx, dy and the saved states read, d(dt)
// and d(dx) written; 19 operations a (b, t, d, s) against 24 bytes a (b, t,
// d) at ds = 16).
//
// What held the previous kernel back: one block per (64 channels, batch
// row) walked all of T's 16-step chunks in turn, so at Jamba's B = 1, di =
// 8192 the card held 512 warps (about 4 an SM) on a sequential loop with
// its loads exposed. The thread count, di x lanes x B, was what was short:
// more parallelism has to come from time.
//
// Design: T is cut into segments of seg_chunks chunks (SEG_CHUNKS in
// kernels/selective_scan.py), each starting on a chunk boundary, where the
// forward saved the state (hs). The adjoint is linear in its carry: run
// through a segment from a carry K into its last step, it leaves
// L + P K, with L the carry it leaves from zero and P the product of the
// segment's decays (per state). Three passes:
//   1. carry_kernel: each segment but the first runs its adjoint back from
//      a zero carry (reading dt, dy and Cc only) and writes L and P, P the
//      running product of the same ex2(dt A log2 e) decays the forward and
//      pass 3 use.
//   2. carries_kernel: per (b, channel, state), the segments last to first:
//      K = dh_last (or 0) into the last one, K_{s-1} = L_s + P_s K_s, in
//      that fixed order; each K_s overwrites L_s.
//   3. scan_bwd_kernel: every segment at once, from its true carry K_s,
//      recomputes each chunk's states from hs and runs the adjoint back
//      through the chunk, emitting the gradients.
// A block is (64 channels, segment, batch row), ds / 4 lanes a channel,
// each with 4 consecutive states (a float4 of A, h, the carry and dA), so a
// chunk's 16 states before each step stay in 64 registers a thread (no
// shared-memory state buffer: at ds = 16 a block is 256 threads and 78 KB,
// two an SM). Each chunk's dt, dx, dy, Bc, Cc and start state come in
// through a 3-stage cp.async ring, walked last to first, so two chunks are
// in flight while one is computed. No atomics: a channel's lanes add their
// partials by xor shuffles (1, 2, .. apart); dB and dC, sums over di, are
// summed over the warp's channels by xor shuffles, over the block's warps
// in warp order, and written as one partial a block, [B, blocks, T, ds]
// (a step's partial comes from its segment's block); dA is a partial a
// (batch row, segment), [B, nseg, di, ds]. sum_mid_kernel then adds the
// partials in index order. Every gradient is the same bits on every run.
// Steps past T load as zeros (dt = dx = dy = 0: a decay of 1, nothing
// added), so they pass the carry through unchanged and are not stored.
// Instances for ds up to 32 (BWD_D_STATES in kernels/selective_scan.py): at
// 32 a block is 512 threads and 147 KB.
//
// On the card (H100 80GB HBM3, 700 W; chip_smoke.py phase 13 sweeps the
// segment length at Jamba's B = 1, T = 4096, di = 8192, ds = 16): ms and
// share of the bytes bound by chunks a segment (segments) 256 (1): 1.658,
// 0.145; 64 (4): 1.394, 0.173; 32 (8): 1.419, 0.170; 16 (16): 1.442,
// 0.167; 8 (32): 1.477, 0.163; 4 (64): 1.527, 0.158. So one segment is
// already 4x the previous kernel (6.699 ms): the register-resident states,
// 4 lanes a channel (twice the warps) and the overlapped loads did most of
// it; segments add ~15%, flat from 4 to 16 of them, and more cost pass 1's
// share. What is left is not the bytes (~17% of their bound): the kernel
// issues two ex2 a state and step (recompute and adjoint) and the dB and
// dC shuffle trees beside the recurrence; which of them sets the pace
// needs the card's counters. SEG_CHUNKS is 32.
namespace bwd {

constexpr int STAGES = 3;   // chunks in flight, as in the forward
constexpr int SL = 4;       // states a lane

// lanes a channel: ds / 4
__host__ __device__ constexpr int blanes(int ds) { return ds / SL; }

// floats a ring stage of pass 3: dt, dx, dy [BT][CH]; Bc, Cc [BT][ds];
// the chunk's start states [CH][ds]
__host__ __device__ constexpr int stage_floats(int ds) {
  return 3 * BT * CH + 2 * BT * ds + CH * ds;
}

// shared memory of pass 3 in floats: the ring; d(dx), d(dt) [BT][CH]; the
// warps' dB and dC sums [warps][BT][ds]
__host__ __device__ constexpr int smem_floats(int ds) {
  return STAGES * stage_floats(ds) + 2 * BT * CH +
         2 * (CH * blanes(ds) / 32) * BT * ds;
}

// shared memory of pass 1 in floats: a ring of dt, dy [BT][CH], Cc [BT][ds]
__host__ __device__ constexpr int carry_smem_floats(int ds) {
  return STAGES * (2 * BT * CH + BT * ds);
}

// the sum over the channels of a warp that share lane index l: xor over
// lanes L, 2L, .. 16 apart (every lane ends with the same bits)
template <int L>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int off = L; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// the sum over a channel's L lanes: xor over 1, 2, .. apart
template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 1; off < L; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// steps t0 .. t0 + BT - 1 of the [B, T, di] array src, channels d0 .. d0
// + CH - 1, into dst [BT][CH] by cp.async; steps past T and channels past
// di read 0
template <int THR>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int b, int t0, int T, int d0,
                                          int di, bool vec) {
  if (vec) {   // di % 4 == 0: 16-byte rows
    for (int idx = threadIdx.x; idx < BT * CH / 4; idx += THR) {
      const int r = idx / (CH / 4), k = (idx % (CH / 4)) * 4;
      const bool in = t0 + r < T && d0 + k < di;
      const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
      cp_async16_zfill(dst + r * CH + k, in ? src + off : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * CH; idx += THR) {
      const int r = idx / CH, k = idx % CH;
      const bool in = t0 + r < T && d0 + k < di;
      const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
      cp_async4_zfill(dst + r * CH + k, in ? src + off : src, in ? 4 : 0);
    }
  }
}

// steps t0 .. t0 + BT - 1 of the [B, T, DS] array src into dst [BT][DS]
template <int THR, int DS>
__device__ __forceinline__ void load_steps(float* dst, const float* src,
                                           int b, int t0, int T) {
  for (int idx = threadIdx.x; idx < BT * DS / 4; idx += THR) {
    const int r = idx / (DS / 4), k = (idx % (DS / 4)) * 4;
    const bool in = t0 + r < T;
    const size_t off = ((size_t)b * T + t0 + r) * DS + k;
    cp_async16_zfill(dst + r * DS + k, in ? src + off : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[SL]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void unpack(const float4 v, float (&out)[SL]) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// Pass 1: segment blockIdx.y + 1's adjoint from a zero carry, its last
// chunk first: lcarry = the carry it leaves, decay = the product of its
// decays, [B, nseg, di, ds]
template <int DS>
__global__ void __launch_bounds__(CH * DS / SL)
carry_kernel(const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ Cc, const float* __restrict__ dy,
             float* __restrict__ lcarry, float* __restrict__ decay, int T,
             int di, int seg_chunks, int nseg) {
  constexpr int L = blanes(DS);
  constexpr int THR = CH * L;
  constexpr int STG = 2 * BT * CH + BT * DS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ch = tid / L, l = tid % L;
  const int seg = blockIdx.y + 1, b = blockIdx.z;
  const int d0 = blockIdx.x * CH, d = d0 + ch;
  const bool live = d < di, vec = (di % 4) == 0;
  const int nchunk = (T + BT - 1) / BT;
  const int c_hi = min(nchunk, (seg + 1) * seg_chunks) - 1;
  const int n = c_hi - seg * seg_chunks + 1;   // chunks, walked last first

  auto load = [&](int i, int st) {
    float* dts = smem + st * STG;
    const int t0 = (c_hi - i) * BT;
    load_rows<THR>(dts, dt, b, t0, T, d0, di, vec);
    load_rows<THR>(dts + BT * CH, dy, b, t0, T, d0, di, vec);
    load_steps<THR, DS>(dts + 2 * BT * CH, Cc, b, t0, T);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_commit();
  }

  float a2[SL], carry[SL], prod[SL];
  unpack(live ? ld4(A + (size_t)d * DS + l * SL)
              : make_float4(0.f, 0.f, 0.f, 0.f), a2);
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    a2[s] *= LOG2E;
    carry[s] = 0.f;
    prod[s] = 1.f;
  }
  for (int i = 0; i < n; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < n) load(nx, nx % STAGES);
    cp_commit();
    const float* dts = smem + (i % STAGES) * STG;
    const float* dys = dts + BT * CH;
    const float* cs = dys + BT * CH;
#pragma unroll
    for (int tt = BT - 1; tt >= 0; --tt) {
      const float dtv = dts[tt * CH + ch], dyv = dys[tt * CH + ch];
      float cv[SL];
      unpack(ld4(cs + tt * DS + l * SL), cv);
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        const float at = ex2(dtv * a2[s]);
        carry[s] = at * fmaf(dyv, cv[s], carry[s]);
        prod[s] *= at;
      }
    }
  }
  if (!live) return;
  const size_t srow = (((size_t)b * nseg + seg) * di + d) * DS + l * SL;
  st4(lcarry + srow, carry);
  st4(decay + srow, prod);
}

// Pass 2: per (b, 4 states of a channel), the carries into each segment's
// last step, last segment first: K = dh_last (or 0), then K_{s-1} = L_s +
// P_s K_s; K_s overwrites L_s (lcarry [B, nseg, di, ds]); q4 = di * ds / 4
__global__ void carries_kernel(const float* __restrict__ dh_last,
                               float* __restrict__ lcarry,
                               const float* __restrict__ decay, int B,
                               long long q4, int nseg) {
  const long long n = (long long)B * q4;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / q4, q = idx % q4;
    float k[SL] = {0.f, 0.f, 0.f, 0.f};
    if (dh_last != nullptr) unpack(ld4(dh_last + 4 * idx), k);
    for (int s = nseg - 1; s >= 1; --s) {
      const size_t off = ((size_t)(b * nseg + s) * q4 + q) * 4;
      float lv[SL], pv[SL];
      unpack(ld4(lcarry + off), lv);
      unpack(ld4(decay + off), pv);
      st4(lcarry + off, k);
#pragma unroll
      for (int j = 0; j < SL; ++j) k[j] = fmaf(pv[j], k[j], lv[j]);
    }
    st4(lcarry + (size_t)(b * nseg * q4 + q) * 4, k);
  }
}

// Pass 3: the gradients of segment blockIdx.y from its carry K
template <int DS>
__global__ void __launch_bounds__(CH * DS / SL, DS <= 16 ? 2 : 1)
scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ dx,
                const float* __restrict__ A, const float* __restrict__ Bc,
                const float* __restrict__ Cc, const float* __restrict__ hs,
                const float* __restrict__ dy,
                const float* __restrict__ kcarry, float* __restrict__ ddt,
                float* __restrict__ ddx, float* __restrict__ dA_part,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                float* __restrict__ dh0, int T, int di, int seg_chunks,
                int nseg) {
  constexpr int L = blanes(DS);           // lanes per channel
  constexpr int THR = CH * L;
  constexpr int NW = THR / 32;
  constexpr int STG = stage_floats(DS);
  extern __shared__ __align__(16) float smem[];
  float* gdx = smem + STAGES * STG;       // [BT][CH]
  float* gdt = gdx + BT * CH;
  float* redB = gdt + BT * CH;            // [NW][BT][DS]
  float* redC = redB + NW * BT * DS;

  const int tid = threadIdx.x;
  const int ch = tid / L, l = tid % L;
  const int warp = tid / 32, wl = tid % 32;
  const int blk = blockIdx.x, seg = blockIdx.y, b = blockIdx.z;
  const int nblk = gridDim.x;
  const int d0 = blk * CH, d = d0 + ch;
  const bool live = d < di, vec = (di % 4) == 0;
  const int nchunk = (T + BT - 1) / BT;
  const int c_hi = min(nchunk, (seg + 1) * seg_chunks) - 1;
  const int n = c_hi - seg * seg_chunks + 1;   // chunks, walked last first

  // chunk c_hi - i into ring stage st: dt, dx, dy, Bc, Cc and the state
  // the forward saved at its start (channels past di read 0)
  auto load = [&](int i, int st) {
    float* dts = smem + st * STG;
    const int c = c_hi - i, t0 = c * BT;
    load_rows<THR>(dts, dt, b, t0, T, d0, di, vec);
    load_rows<THR>(dts + BT * CH, dx, b, t0, T, d0, di, vec);
    load_rows<THR>(dts + 2 * BT * CH, dy, b, t0, T, d0, di, vec);
    float* bs = dts + 3 * BT * CH;
    load_steps<THR, DS>(bs, Bc, b, t0, T);
    load_steps<THR, DS>(bs + BT * DS, Cc, b, t0, T);
    float* hsm = bs + 2 * BT * DS;
    const float* hc = hs + ((size_t)b * nchunk + c) * di * DS + (size_t)d0 * DS;
    for (int idx = tid; idx < CH * DS / 4; idx += THR) {
      const bool in = d0 + idx * 4 / DS < di;
      cp_async16_zfill(hsm + idx * 4, in ? hc + idx * 4 : hs, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_commit();
  }

  const size_t srow = (((size_t)b * nseg + seg) * di + d) * DS + l * SL;
  float a[SL], a2[SL], carry[SL], dA[SL];
  unpack(live ? ld4(A + (size_t)d * DS + l * SL)
              : make_float4(0.f, 0.f, 0.f, 0.f), a);
  unpack(live ? ld4(kcarry + srow) : make_float4(0.f, 0.f, 0.f, 0.f), carry);
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    a2[s] = a[s] * LOG2E;
    dA[s] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    cp_wait<STAGES - 2>();        // chunk i has landed (this thread's copies)
    __syncthreads();              // everyone's; chunk i-1's buffers free
    const int nx = i + STAGES - 1;
    if (nx < n) load(nx, nx % STAGES);
    cp_commit();
    const float* dts = smem + (i % STAGES) * STG;
    const float* dxs = dts + BT * CH;
    const float* dys = dxs + BT * CH;
    const float* bs = dys + BT * CH;
    const float* cs = bs + BT * DS;
    const float* hsm = cs + BT * DS;
    const int t0 = (c_hi - i) * BT;
    const int nt = min(BT, T - t0);

    // the chunk's states again, from its saved start, each before its step
    // kept in registers; dC's terms on the way
    float hb[BT][SL], h[SL];
    unpack(ld4(hsm + ch * DS + l * SL), h);
#pragma unroll
    for (int tt = 0; tt < BT; ++tt) {
      const float dtv = dts[tt * CH + ch], dxv = dxs[tt * CH + ch];
      const float dyv = dys[tt * CH + ch];
      float bv[SL];
      unpack(ld4(bs + tt * DS + l * SL), bv);
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        hb[tt][s] = h[s];
        h[s] = fmaf(ex2(dtv * a2[s]), h[s], dxv * bv[s]);
        const float v = channel_sum<L>(dyv * h[s]);
        if (wl < L) redC[(warp * BT + tt) * DS + l * SL + s] = v;
      }
    }

    // the adjoint, back through the chunk
#pragma unroll
    for (int tt = BT - 1; tt >= 0; --tt) {
      const float dtv = dts[tt * CH + ch], dxv = dxs[tt * CH + ch];
      const float dyv = dys[tt * CH + ch];
      float bv[SL], cv[SL];
      unpack(ld4(bs + tt * DS + l * SL), bv);
      unpack(ld4(cs + tt * DS + l * SL), cv);
      float gx = 0.f, gt = 0.f;
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        const float at = ex2(dtv * a2[s]);
        const float g = fmaf(dyv, cv[s], carry[s]);
        gx = fmaf(g, bv[s], gx);
        const float w = g * at * hb[tt][s];
        gt = fmaf(w, a[s], gt);
        dA[s] = fmaf(w, dtv, dA[s]);
        const float v = channel_sum<L>(g * dxv);
        if (wl < L) redB[(warp * BT + tt) * DS + l * SL + s] = v;
        carry[s] = at * g;
      }
      gx = lane_sum<L>(gx);
      gt = lane_sum<L>(gt);
      if (l == 0) {
        gdx[tt * CH + ch] = gx;
        gdt[tt * CH + ch] = gt;
      }
    }
    __syncthreads();              // gdx, gdt, redB, redC complete

    for (int idx = tid; idx < nt * CH; idx += THR) {
      const int r = idx / CH, k = idx % CH;
      if (d0 + k < di) {
        const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
        ddx[off] = gdx[idx];
        ddt[off] = gdt[idx];
      }
    }
    for (int idx = tid; idx < nt * DS; idx += THR) {
      const int r = idx / DS, s = idx % DS;
      float sb = 0.f, sc = 0.f;
      for (int w = 0; w < NW; ++w) {   // the block's warps, in order
        sb += redB[(w * BT + r) * DS + s];
        sc += redC[(w * BT + r) * DS + s];
      }
      const size_t off = (((size_t)b * nblk + blk) * T + t0 + r) * DS + s;
      dB_part[off] = sb;
      dC_part[off] = sc;
    }
  }
  if (!live) return;
  st4(dA_part + srow, dA);
  if (seg == 0 && dh0 != nullptr)
    st4(dh0 + ((size_t)b * di + d) * DS + l * SL, carry);
}

// out[i, k] = sum_j in[i, j, k], j in order: the per-block partials added
__global__ void sum_mid_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int I, int J,
                               long long K) {
  const long long n = (long long)I * K;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long i = idx / K, k = idx % K;
    const float* p = in + i * J * K + k;
    float acc = 0.f;
    for (int j = 0; j < J; ++j) acc += p[(long long)j * K];
    out[idx] = acc;
  }
}

int grid_for(long long n) {
  const long long want = (n + 255) / 256;
  return (int)(want < 65535 ? want : 65535);
}

int sum_mid(const float* in, float* out, int I, int J, long long K,
            cudaStream_t st) {
  const long long n = (long long)I * K;
  if (n > 0) sum_mid_kernel<<<grid_for(n), 256, 0, st>>>(in, out, I, J, K);
  return (int)cudaGetLastError();
}

template <int DS>
int launch(const float* dt, const float* dx, const float* A, const float* Bc,
           const float* Cc, const float* hs, const float* dy,
           const float* dh_last, float* ddt, float* ddx, float* lcarry,
           float* decay, float* dA_part, float* dB_part, float* dC_part,
           float* dA, float* dB, float* dC, float* dh0, int B, int T, int di,
           int seg_chunks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (seg_chunks <= 0) return (int)cudaErrorInvalidValue;
  const int nchunk = (T + BT - 1) / BT;
  const int nseg = (nchunk + seg_chunks - 1) / seg_chunks;
  const int nblk = (di + CH - 1) / CH;
  const int threads = CH * blanes(DS);
  const int smem = (int)sizeof(float) * smem_floats(DS);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nseg > 1) {
    carry_kernel<DS><<<dim3(nblk, nseg - 1, B), threads,
                       sizeof(float) * carry_smem_floats(DS), st>>>(
        dt, A, Cc, dy, lcarry, decay, T, di, seg_chunks, nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long q4 = (long long)di * DS / 4;
  carries_kernel<<<grid_for(B * q4), 256, 0, st>>>(dh_last, lcarry, decay, B,
                                                   q4, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_bwd_kernel<DS><<<dim3(nblk, nseg, B), threads, smem, st>>>(
      dt, dx, A, Bc, Cc, hs, dy, lcarry, ddt, ddx, dA_part, dB_part, dC_part,
      dh0, T, di, seg_chunks, nseg);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  if ((e = sum_mid(dA_part, dA, 1, B * nseg, (long long)di * DS, st)) != 0)
    return e;
  if ((e = sum_mid(dB_part, dB, B, nblk, (long long)T * DS, st)) != 0)
    return e;
  return sum_mid(dC_part, dC, B, nblk, (long long)T * DS, st);
}

}  // namespace bwd

}  // namespace

// lanes a channel for this d_state (kernels/selective_scan.lanes is
// checked against this)
extern "C" int selective_scan_lanes(int ds) { return lanes(ds); }

// hs: null, or [B, ceil(T / BT), di, ds] for the chunks' start states
extern "C" int selective_scan_f32(const float* dt, const float* dx,
                                  const float* A, const float* Bc,
                                  const float* Cc, const float* h0, float* y,
                                  float* h_last, float* hs, int B, int T,
                                  int di, int ds, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || di == 0) return 0;
  switch (ds) {
    case 4:
      return launch<4>(dt, dx, A, Bc, Cc, h0, y, h_last, hs, B, T, di,
                       stream);
    case 8:
      return launch<8>(dt, dx, A, Bc, Cc, h0, y, h_last, hs, B, T, di,
                       stream);
    case 16:
      return launch<16>(dt, dx, A, Bc, Cc, h0, y, h_last, hs, B, T, di,
                        stream);
    case 32:
      return launch<32>(dt, dx, A, Bc, Cc, h0, y, h_last, hs, B, T, di,
                        stream);
    case 64:
      return launch<64>(dt, dx, A, Bc, Cc, h0, y, h_last, hs, B, T, di,
                        stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward: dt, dx, A, Bc, Cc and the forward's hs; dy, dh_last (or
// null); out d(dt), d(dx) [B, T, di], the scratch lcarry and decay [B, nseg,
// di, ds], dA_part [B, nseg, di, ds], dB_part and dC_part [B, ceil(di / 64),
// T, ds], then dA [di, ds], dB, dC [B, T, ds] and dh0 [B, di, ds] (or null);
// B, T, di, ds, the segment length in chunks, device, stream. nseg =
// ceil(ceil(T / 16) / seg_chunks).
extern "C" int selective_scan_bwd_f32(
    const float* dt, const float* dx, const float* A, const float* Bc,
    const float* Cc, const float* hs, const float* dy, const float* dh_last,
    float* ddt, float* ddx, float* lcarry, float* decay, float* dA_part,
    float* dB_part, float* dC_part, float* dA, float* dB, float* dC,
    float* dh0, int B, int T, int di, int ds, int seg_chunks, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || di == 0 || T == 0) return 0;
  switch (ds) {   // BWD_D_STATES in kernels/selective_scan.py
#define SSB_CASE(N)                                                          \
  case N:                                                                    \
    return bwd::launch<N>(dt, dx, A, Bc, Cc, hs, dy, dh_last, ddt, ddx,      \
                          lcarry, decay, dA_part, dB_part, dC_part, dA, dB,  \
                          dC, dh0, B, T, di, seg_chunks, stream);
    SSB_CASE(4) SSB_CASE(8) SSB_CASE(16) SSB_CASE(32)
#undef SSB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
