// Mamba selective scan, backward pass, on Hopper (sm_90a): the derivative
// of csrc/selective_scan.cu's scan, both of its forms (see the design
// below).
//
// Replaces: the derivative of src/repro/kernels/selective_scan.py,
// selective_scan (_kernel). A source of its own beside the forward's, so
// that the two compile in parallel.
#include "selective_scan.cuh"

namespace {

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
// Instances for ds 4, 8, 16, 32 and 64; every d_state from 1 to 64 runs the
// least at or above it, the states past ds masked: they load as zeros (A = C
// = h = 0, so their adjoint and states stay 0), the internal carries and
// partials keep the instance's width and the sums of dA, dB and dC drop
// them. At 32 a block is 512 threads and 147 KB. At 64, 16 lanes a channel,
// a block keeps 512 threads by holding 32 channels (bch): each thread keeps
// its 16 steps x 4 states before each step in 64 registers within the 128 a
// 512-thread block allows, as at 32; 198 KB of shared memory, the warps' dB
// and dC sums 128 KB of it. The f32 form at a d_state of its own instance
// runs the kernels as they were before masking (WHOLE); the masked ones, and
// the 16-bit forms (Step), are instances of their own.
//
// Past 64 states (65 to 256, BWD_D_STATES), the states are cut into groups
// of 64 (groups), a grid axis folded into x beside the channel blocks: the
// recurrence and its adjoint are independent in every (channel, state), so
// each group runs the 64-state instance as it is on its own states (the last
// one's past ds masked). The per-state results are each group's slice: the
// carries, decays and dA partials [B, nseg, di, W] and the dB and dC
// partials [B, blocks, T, W] are W = 64 x groups states wide, and
// sum_mid_kernel drops the states past ds; dh0 is written in place. d(dx)
// and d(dt) sum over the states: group 0 writes its partials to them, the
// others theirs to a [groups - 1, 2, B, T, di] scratch that the wrapper
// frees on return, and sum_groups_kernel adds those into them in group
// order. No atomics, so the same bits every run. The gradient pass past 64
// states is a kernel of its own (scan_bwd_groups_kernel): with the group
// terms in scan_bwd_kernel, folded to constants at one group, the f32 pass
// at d_state 16 ran 2.55% slower on an H100 (PERF.md §6). Up to
// 64 states carry_kernel runs with GROUPED false, every group term a
// constant that folds away (its SASS is the same as without them).
// Widening the per-warp layout instead would put a
// channel's 64 lanes across two warps (the shuffle sums stop at a warp) and
// need about 512 KB of shared memory for the warps' dB and dC sums at 256.
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
// channels a block: 64, and 32 at ds = 64 (16 lanes a channel), so that a
// block stays at 512 threads and a thread at the 128 registers its
// chunk's 16 x 4 states need
__host__ __device__ constexpr int bch(int ds) { return ds <= 32 ? CH : CH / 2; }

// floats a ring stage of pass 3: dt, dx, dy [BT][bch]; Bc, Cc [BT][ds];
// the chunk's start states [bch][ds]
__host__ __device__ constexpr int stage_floats(int ds) {
  return 3 * BT * bch(ds) + 2 * BT * ds + bch(ds) * ds;
}

// shared memory of pass 3 in floats: the ring; d(dx), d(dt) [BT][bch];
// the warps' dB and dC sums [warps][BT][ds]
__host__ __device__ constexpr int smem_floats(int ds) {
  return STAGES * stage_floats(ds) + 2 * BT * bch(ds) +
         2 * (bch(ds) * blanes(ds) / 32) * BT * ds;
}

// shared memory of pass 1 in floats: a ring of dt, dy [BT][bch], Cc
// [BT][ds]
__host__ __device__ constexpr int carry_smem_floats(int ds) {
  return STAGES * (2 * BT * bch(ds) + BT * ds);
}

// The transitions by their type R: float, the f32 scan (decays
// ex2(dt A log2 e), nothing rounded); bf16 or f16, the rounded tree's
// recurrence taken in f32 at its rounded transitions: a = R(exp(dt A)),
// b = R(dx B), and y's R(h) and R(C). A rounding passes its cotangent
// through (astype's transpose): the decay's derivative is the unrounded
// exp(dt A), and d(dx), dB take g as b's cotangent.
template <typename R>
struct Step {
  static constexpr bool F32 = std::is_same<R, float>::value;
  // the rounding of a value to R, widened back
  static __device__ __forceinline__ float rnd(float x) {
    if constexpr (F32) return x;
    else if constexpr (std::is_same<R, __half>::value)
      return __half2float(__float2half_rn(x));
    else return __bfloat162float(__float2bfloat16_rn(x));
  }
};

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
template <int THR, int C>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int b, int t0, int T, int d0,
                                          int di, bool vec) {
  if (vec) {   // di % 4 == 0: 16-byte rows
    for (int idx = threadIdx.x; idx < BT * C / 4; idx += THR) {
      const int r = idx / (C / 4), k = (idx % (C / 4)) * 4;
      const bool in = t0 + r < T && d0 + k < di;
      const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
      cp_async16_zfill(dst + r * C + k, in ? src + off : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * C; idx += THR) {
      const int r = idx / C, k = idx % C;
      const bool in = t0 + r < T && d0 + k < di;
      const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
      cp_async4_zfill(dst + r * C + k, in ? src + off : src, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// p[0 .. 4), each element at or past n read as 0: one 16-byte load where
// all four are in and p is aligned
__device__ __forceinline__ float4 ld4m(const float* p, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) return ld4(p);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[SL]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void unpack(const float4 v, float (&out)[SL]) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// Pass 1: segment blockIdx.y + 1's adjoint from a zero carry, its last
// chunk first: lcarry = the carry it leaves, decay = the product of its
// decays, [B, nseg, di, DS] (states past ds stay 0 and 1)
template <typename R, int DS, bool WHOLE, bool GROUPED>
__global__ void __launch_bounds__(bch(DS) * DS / SL)
carry_kernel(const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ Cc, const float* __restrict__ dy,
             float* __restrict__ lcarry, float* __restrict__ decay, int T,
             int di, int lds_in, int seg_chunks, int nseg) {
  using Q = Step<R>;
  // (WHOLE in one group: a row is the instance's DS states)
  const int lds = WHOLE && !GROUPED ? DS : lds_in;
  constexpr int L = blanes(DS);
  constexpr int CH = bch(DS);
  constexpr int THR = CH * L;
  constexpr int STG = 2 * BT * CH + BT * DS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ch = tid / L, l = tid % L;
  const int seg = blockIdx.y + 1, b = blockIdx.z;
  // blockIdx.x: (state group, channel block); the group's states s0 .. s0
  // + ds - 1 of the lds a row holds, its slice of the [.., W] scratch (in
  // one group the terms fold away)
  const int nblk = GROUPED ? (di + CH - 1) / CH : (int)gridDim.x;
  const int grp = GROUPED ? (int)blockIdx.x / nblk : 0;
  const int blk = GROUPED ? (int)blockIdx.x % nblk : (int)blockIdx.x;
  const int s0 = grp * DS, W = GROUPED ? groups(lds) * DS : DS;
  const int ds = WHOLE ? DS : GROUPED ? min(DS, lds - s0) : lds;
  const int d0 = blk * CH, d = d0 + ch;
  const bool live = d < di, vec = (di % 4) == 0;
  const int nchunk = (T + BT - 1) / BT;
  const int c_hi = min(nchunk, (seg + 1) * seg_chunks) - 1;
  const int n = c_hi - seg * seg_chunks + 1;   // chunks, walked last first

  auto load = [&](int i, int st) {
    float* dts = smem + st * STG;
    const int t0 = (c_hi - i) * BT;
    load_rows<THR, CH>(dts, dt, b, t0, T, d0, di, vec);
    load_rows<THR, CH>(dts + BT * CH, dy, b, t0, T, d0, di, vec);
    load_states<THR, DS>(dts + 2 * BT * CH, Cc, nullptr, nullptr, b, t0, T,
                         ds, lds, s0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_commit();
  }

  float a[SL], a2[SL], carry[SL], prod[SL];
  unpack(live ? (WHOLE ? ld4(A + (size_t)d * lds + s0 + l * SL)
                      : ld4m(A + (size_t)d * lds + s0 + l * SL, ds - l * SL))
              : make_float4(0.f, 0.f, 0.f, 0.f), a);
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    a2[s] = a[s] * LOG2E;
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
        const float at =
            Q::F32 ? ex2(dtv * a2[s]) : Q::rnd(expf(dtv * a[s]));
        carry[s] = at * fmaf(dyv, Q::rnd(cv[s]), carry[s]);
        prod[s] *= at;
      }
    }
  }
  if (!live) return;
  const size_t srow =
      (((size_t)b * nseg + seg) * di + d) * W + s0 + l * SL;
  st4(lcarry + srow, carry);
  st4(decay + srow, prod);
}

// Pass 2: per (b, 4 states of a channel), the carries into each segment's
// last step, last segment first: K = dh_last (or 0), then K_{s-1} = L_s +
// P_s K_s; K_s overwrites L_s (lcarry [B, nseg, di, DS]); q4 = di * DS / 4;
// dh_last is [B, di, ds]
__global__ void carries_kernel(const float* __restrict__ dh_last,
                               float* __restrict__ lcarry,
                               const float* __restrict__ decay, int B,
                               long long q4, int nseg, int DS, int ds) {
  const long long n = (long long)B * q4;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / q4, q = idx % q4;
    float k[SL] = {0.f, 0.f, 0.f, 0.f};
    if (dh_last != nullptr) {
      if (ds == DS) {
        unpack(ld4(dh_last + 4 * idx), k);
      } else {
        const long long d = 4 * q / DS;
        const int s0 = (int)(4 * q % DS);
        unpack(ld4m(dh_last + ((long long)b * (q4 * 4 / DS) + d) * ds + s0,
                    ds - s0), k);
      }
    }
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
template <typename R, int DS, bool WHOLE>
__global__ void __launch_bounds__(bch(DS) * DS / SL, DS <= 16 ? 2 : 1)
scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ dx,
                const float* __restrict__ A, const float* __restrict__ Bc,
                const float* __restrict__ Cc, const float* __restrict__ hs,
                const float* __restrict__ dy,
                const float* __restrict__ kcarry, float* __restrict__ ddt,
                float* __restrict__ ddx, float* __restrict__ dA_part,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                float* __restrict__ dh0, int T, int di, int ds_in,
                int seg_chunks, int nseg) {
  using Q = Step<R>;
  const int ds = WHOLE ? DS : ds_in;
  constexpr int L = blanes(DS);           // lanes per channel
  constexpr int CH = bch(DS);
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
  constexpr bool full = WHOLE;
  const int nchunk = (T + BT - 1) / BT;
  const int c_hi = min(nchunk, (seg + 1) * seg_chunks) - 1;
  const int n = c_hi - seg * seg_chunks + 1;   // chunks, walked last first

  // chunk c_hi - i into ring stage st: dt, dx, dy, Bc, Cc and the state
  // the forward saved at its start (channels past di read 0)
  auto load = [&](int i, int st) {
    float* dts = smem + st * STG;
    const int c = c_hi - i, t0 = c * BT;
    load_rows<THR, CH>(dts, dt, b, t0, T, d0, di, vec);
    load_rows<THR, CH>(dts + BT * CH, dx, b, t0, T, d0, di, vec);
    load_rows<THR, CH>(dts + 2 * BT * CH, dy, b, t0, T, d0, di, vec);
    float* bs = dts + 3 * BT * CH;
    load_states<THR, DS>(bs, Bc, nullptr, nullptr, b, t0, T, ds);
    load_states<THR, DS>(bs + BT * DS, Cc, nullptr, nullptr, b, t0, T, ds);
    float* hsm = bs + 2 * BT * DS;
    const float* hc = hs + ((size_t)b * nchunk + c) * di * ds + (size_t)d0 * ds;
    if (full) {
      for (int idx = tid; idx < CH * DS / 4; idx += THR) {
        const bool in = d0 + idx * 4 / DS < di;
        cp_async16_zfill(hsm + idx * 4, in ? hc + idx * 4 : hs, in ? 16 : 0);
      }
    } else {   // [CH][DS] from rows of ds, states ds.. zero
      for (int idx = tid; idx < CH * DS; idx += THR) {
        const int r = idx / DS, k = idx % DS;
        const bool in = d0 + r < di && k < ds;
        cp_async4_zfill(hsm + idx, in ? hc + r * ds + k : hs, in ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_commit();
  }

  const size_t srow = (((size_t)b * nseg + seg) * di + d) * DS + l * SL;
  float a[SL], a2[SL], carry[SL], dA[SL];
  unpack(live ? (WHOLE ? ld4(A + (size_t)d * DS + l * SL)
                      : ld4m(A + (size_t)d * ds + l * SL, ds - l * SL))
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
        if constexpr (Q::F32)
          h[s] = fmaf(ex2(dtv * a2[s]), h[s], dxv * bv[s]);
        else
          h[s] = fmaf(Q::rnd(expf(dtv * a[s])), h[s],
                      Q::rnd(dxv * bv[s]));
        const float v = channel_sum<L>(dyv * Q::rnd(h[s]));
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
        // the decay, and its derivative's exp (the same in f32)
        const float e = Q::F32 ? ex2(dtv * a2[s]) : expf(dtv * a[s]);
        const float at = Q::rnd(e);
        const float g = fmaf(dyv, Q::rnd(cv[s]), carry[s]);
        gx = fmaf(g, bv[s], gx);
        const float w = g * e * hb[tt][s];
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
  if (seg == 0 && dh0 != nullptr) {
    float* p = dh0 + ((size_t)b * di + d) * ds + l * SL;
    if (full) {
      st4(p, carry);
    } else {
#pragma unroll
      for (int s = 0; s < SL; ++s)
        if (l * SL + s < ds) p[s] = carry[s];
    }
  }
}

// Pass 3 past 64 states: the gradients of segment blockIdx.y from its
// carry K, for the state group and channel block of blockIdx.x
template <typename R, int DS, bool WHOLE>
__global__ void __launch_bounds__(bch(DS) * DS / SL, DS <= 16 ? 2 : 1)
scan_bwd_groups_kernel(
    const float* __restrict__ dt, const float* __restrict__ dx,
    const float* __restrict__ A, const float* __restrict__ Bc,
    const float* __restrict__ Cc, const float* __restrict__ hs,
    const float* __restrict__ dy, const float* __restrict__ kcarry,
    float* __restrict__ ddt, float* __restrict__ ddx,
    float* __restrict__ parts, float* __restrict__ dA_part,
    float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ dh0, int T, int di, int lds, int seg_chunks,
    int nseg) {
  using Q = Step<R>;
  constexpr int L = blanes(DS);           // lanes per channel
  constexpr int CH = bch(DS);
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
  const int seg = blockIdx.y, b = blockIdx.z;
  // blockIdx.x: (state group, channel block); the group's states s0 .. s0
  // + ds - 1 of the lds a row holds, its slice of the [.., W] scratch, and
  // its partial d(dt) and d(dx): group 0's in ddt and ddx, group g's the
  // slices [g - 1, 0] and [g - 1, 1] of parts [groups - 1, 2, B, T, di],
  // added in group order by sum_groups_kernel
  const int nblk = (di + CH - 1) / CH;
  const int grp = (int)blockIdx.x / nblk, blk = (int)blockIdx.x % nblk;
  const int s0 = grp * DS, W = groups(lds) * DS;
  const int ds = WHOLE ? DS : min(DS, lds - s0);
  const size_t btd = (size_t)gridDim.z * T * di;
  float* ddt_g = grp == 0 ? ddt : parts + (size_t)(grp - 1) * 2 * btd;
  float* ddx_g = grp == 0 ? ddx : parts + ((size_t)(grp - 1) * 2 + 1) * btd;
  const int d0 = blk * CH, d = d0 + ch;
  const bool live = d < di, vec = (di % 4) == 0;
  constexpr bool full = WHOLE;
  const int nchunk = (T + BT - 1) / BT;
  const int c_hi = min(nchunk, (seg + 1) * seg_chunks) - 1;
  const int n = c_hi - seg * seg_chunks + 1;   // chunks, walked last first

  // chunk c_hi - i into ring stage st: dt, dx, dy, Bc, Cc and the state
  // the forward saved at its start (channels past di read 0)
  auto load = [&](int i, int st) {
    float* dts = smem + st * STG;
    const int c = c_hi - i, t0 = c * BT;
    load_rows<THR, CH>(dts, dt, b, t0, T, d0, di, vec);
    load_rows<THR, CH>(dts + BT * CH, dx, b, t0, T, d0, di, vec);
    load_rows<THR, CH>(dts + 2 * BT * CH, dy, b, t0, T, d0, di, vec);
    float* bs = dts + 3 * BT * CH;
    load_states<THR, DS>(bs, Bc, nullptr, nullptr, b, t0, T, ds, lds, s0);
    load_states<THR, DS>(bs + BT * DS, Cc, nullptr, nullptr, b, t0, T, ds,
                         lds, s0);
    float* hsm = bs + 2 * BT * DS;
    const float* hc =
        hs + ((size_t)b * nchunk + c) * di * lds + (size_t)d0 * lds + s0;
    if (full) {
      for (int idx = tid; idx < CH * DS / 4; idx += THR) {
        const int r = idx * 4 / DS, k = idx * 4 % DS;
        const bool in = d0 + r < di;
        cp_async16_zfill(hsm + idx * 4, in ? hc + (size_t)r * lds + k : hs,
                         in ? 16 : 0);
      }
    } else {   // [CH][DS] from rows of lds, states ds.. zero
      for (int idx = tid; idx < CH * DS; idx += THR) {
        const int r = idx / DS, k = idx % DS;
        const bool in = d0 + r < di && k < ds;
        cp_async4_zfill(hsm + idx, in ? hc + (size_t)r * lds + k : hs,
                        in ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_commit();
  }

  const size_t srow =
      (((size_t)b * nseg + seg) * di + d) * W + s0 + l * SL;
  float a[SL], a2[SL], carry[SL], dA[SL];
  unpack(live ? (WHOLE ? ld4(A + (size_t)d * lds + s0 + l * SL)
                      : ld4m(A + (size_t)d * lds + s0 + l * SL, ds - l * SL))
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
        if constexpr (Q::F32)
          h[s] = fmaf(ex2(dtv * a2[s]), h[s], dxv * bv[s]);
        else
          h[s] = fmaf(Q::rnd(expf(dtv * a[s])), h[s],
                      Q::rnd(dxv * bv[s]));
        const float v = channel_sum<L>(dyv * Q::rnd(h[s]));
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
        // the decay, and its derivative's exp (the same in f32)
        const float e = Q::F32 ? ex2(dtv * a2[s]) : expf(dtv * a[s]);
        const float at = Q::rnd(e);
        const float g = fmaf(dyv, Q::rnd(cv[s]), carry[s]);
        gx = fmaf(g, bv[s], gx);
        const float w = g * e * hb[tt][s];
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
        ddx_g[off] = gdx[idx];
        ddt_g[off] = gdt[idx];
      }
    }
    for (int idx = tid; idx < nt * DS; idx += THR) {
      const int r = idx / DS, s = idx % DS;
      float sb = 0.f, sc = 0.f;
      for (int w = 0; w < NW; ++w) {   // the block's warps, in order
        sb += redB[(w * BT + r) * DS + s];
        sc += redC[(w * BT + r) * DS + s];
      }
      const size_t off = (((size_t)b * nblk + blk) * T + t0 + r) * W + s0 + s;
      dB_part[off] = sb;
      dC_part[off] = sc;
    }
  }
  if (!live) return;
  st4(dA_part + srow, dA);
  if (seg == 0 && dh0 != nullptr) {
    float* p = dh0 + ((size_t)b * di + d) * lds + s0 + l * SL;
    if (full) {
      st4(p, carry);
    } else {
#pragma unroll
      for (int s = 0; s < SL; ++s)
        if (l * SL + s < ds) p[s] = carry[s];
    }
  }
}

// out[i, k] = sum_j in[i, j, k], j in order: the per-block partials added.
// k runs over rows of DS states, of which the first ds are kept: out is
// [I, K / DS, ds]
__global__ void sum_mid_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int I, int J,
                               long long K, int DS, int ds) {
  const long long n = (long long)I * K;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long i = idx / K, k = idx % K;
    if (ds != DS && k % DS >= ds) continue;
    const float* p = in + i * J * K + k;
    float acc = 0.f;
    for (int j = 0; j < J; ++j) acc += p[(long long)j * K];
    out[ds == DS ? idx : (i * (K / DS) + k / DS) * ds + k % DS] = acc;
  }
}

int grid_for(long long n) {
  const long long want = (n + 255) / 256;
  return (int)(want < 65535 ? want : 65535);
}

int sum_mid(const float* in, float* out, int I, int J, long long K, int DS,
            int ds, cudaStream_t st) {
  const long long n = (long long)I * K;
  if (n > 0)
    sum_mid_kernel<<<grid_for(n), 256, 0, st>>>(in, out, I, J, K, DS, ds);
  return (int)cudaGetLastError();
}

template <typename R, int DS, bool WHOLE, bool GROUPED>
int launch_kernels(const float* dt, const float* dx, const float* A,
                   const float* Bc, const float* Cc, const float* hs,
                   const float* dy, const float* dh_last, float* ddt,
                   float* ddx, float* parts, float* lcarry, float* decay,
                   float* dA_part, float* dB_part, float* dC_part, float* dA,
                   float* dB, float* dC, float* dh0, int B, int T, int di,
                   int ds, int seg_chunks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (seg_chunks <= 0) return (int)cudaErrorInvalidValue;
  const int nchunk = (T + BT - 1) / BT;
  const int nseg = (nchunk + seg_chunks - 1) / seg_chunks;
  // a (state group, channel block) pair a block along x; the scratch
  // rows are W = groups x DS states wide
  const int nblk = (di + bch(DS) - 1) / bch(DS);
  const int ngrp = groups(ds), W = ngrp * DS;
  const int threads = bch(DS) * blanes(DS);
  const int smem = (int)sizeof(float) * smem_floats(DS);
  cudaError_t err;
  if constexpr (GROUPED)
    err = cudaFuncSetAttribute(scan_bwd_groups_kernel<R, DS, WHOLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  else
    err = cudaFuncSetAttribute(scan_bwd_kernel<R, DS, WHOLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  if (nseg > 1) {
    const int csmem = (int)sizeof(float) * carry_smem_floats(DS);
    if (csmem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             carry_kernel<R, DS, WHOLE, GROUPED>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             csmem)) != cudaSuccess)
      return (int)err;
    carry_kernel<R, DS, WHOLE, GROUPED><<<dim3(nblk * ngrp, nseg - 1, B),
                                         threads, csmem, st>>>(
        dt, A, Cc, dy, lcarry, decay, T, di, ds, seg_chunks, nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long q4 = (long long)di * W / 4;
  carries_kernel<<<grid_for(B * q4), 256, 0, st>>>(dh_last, lcarry, decay, B,
                                                   q4, nseg, W, ds);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (GROUPED)
    scan_bwd_groups_kernel<R, DS, WHOLE><<<dim3(nblk * ngrp, nseg, B),
                                           threads, smem, st>>>(
        dt, dx, A, Bc, Cc, hs, dy, lcarry, ddt, ddx, parts, dA_part, dB_part,
        dC_part, dh0, T, di, ds, seg_chunks, nseg);
  else
    scan_bwd_kernel<R, DS, WHOLE><<<dim3(nblk, nseg, B), threads, smem,
                                    st>>>(
        dt, dx, A, Bc, Cc, hs, dy, lcarry, ddt, ddx, dA_part, dB_part,
        dC_part, dh0, T, di, ds, seg_chunks, nseg);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const long long btd = (long long)B * T * di;   // the groups' d(dt), d(dx)
  if ((e = sum_groups(ddt, parts, btd, 2 * btd, ngrp - 1, st)) != 0 ||
      (e = sum_groups(ddx, parts + btd, btd, 2 * btd, ngrp - 1, st)) != 0)
    return e;
  if ((e = sum_mid(dA_part, dA, 1, B * nseg, (long long)di * W, W, ds,
                   st)) != 0)
    return e;
  if ((e = sum_mid(dB_part, dB, B, nblk, (long long)T * W, W, ds, st)) != 0)
    return e;
  return sum_mid(dC_part, dC, B, nblk, (long long)T * W, W, ds, st);
}

// past 64 states the grouped kernels; in one group the per-instance ones
template <typename R, int DS, bool WHOLE>
int launch(const float* dt, const float* dx, const float* A, const float* Bc,
           const float* Cc, const float* hs, const float* dy,
           const float* dh_last, float* ddt, float* ddx, float* parts,
           float* lcarry, float* decay, float* dA_part, float* dB_part,
           float* dC_part, float* dA, float* dB, float* dC, float* dh0, int B,
           int T, int di, int ds, int seg_chunks, void* stream) {
#define SSB_KERNEL_ARGS                                                     \
  dt, dx, A, Bc, Cc, hs, dy, dh_last, ddt, ddx, parts, lcarry, decay,      \
      dA_part, dB_part, dC_part, dA, dB, dC, dh0, B, T, di, ds, seg_chunks, \
      stream
  if constexpr (DS == GROUP) {
    if (groups(ds) > 1)
      return launch_kernels<R, DS, WHOLE, true>(SSB_KERNEL_ARGS);
  }
  return launch_kernels<R, DS, WHOLE, false>(SSB_KERNEL_ARGS);
#undef SSB_KERNEL_ARGS
}

}  // namespace bwd

template <int DS>
int backward(int form, const float* dt, const float* dx, const float* A,
             const float* Bc, const float* Cc, const float* hs,
             const float* dy, const float* dh_last, float* ddt, float* ddx,
             float* parts, float* lcarry, float* decay, float* dA_part,
             float* dB_part, float* dC_part, float* dA, float* dB, float* dC,
             float* dh0, int B, int T, int di, int ds, int seg_chunks,
             void* stream) {
#define SSB_ARGS                                                            \
  dt, dx, A, Bc, Cc, hs, dy, dh_last, ddt, ddx, parts, lcarry, decay,      \
      dA_part, dB_part, dC_part, dA, dB, dC, dh0, B, T, di, ds, seg_chunks, \
      stream
  // the f32 form where every group holds its instance's DS states (ds is
  // DS, or past 64 a multiple of it) runs the kernels as they were before
  // masking (WHOLE); every other case the masked ones
  switch (form) {
    case 0:
      return ds % DS == 0 ? bwd::launch<float, DS, true>(SSB_ARGS)
                      : bwd::launch<float, DS, false>(SSB_ARGS);
    case 1: return bwd::launch<__nv_bfloat16, DS, false>(SSB_ARGS);
    case 2: return bwd::launch<__half, DS, false>(SSB_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSB_ARGS
}

}  // namespace

// the geometry of a d_state's backward launch, for kernels/selective_scan.py
// to be held against: out = {instance, state groups, lanes a channel,
// channels a block, shared memory of the gradient pass}
extern "C" int selective_scan_bwd_geometry(int ds, int* out) {
  const int n = instance(ds);
  if (n == 0) return (int)cudaErrorInvalidValue;
  out[0] = n;
  out[1] = groups(ds);
  out[2] = bwd::blanes(n);
  out[3] = bwd::bch(n);
  out[4] = (int)sizeof(float) * bwd::smem_floats(n);
  return 0;
}

// The backward: dt, dx, A, Bc, Cc and the forward's hs; dy, dh_last (or
// null); out d(dt), d(dx) [B, T, di], the scratch lcarry and decay [B, nseg,
// di, W], dA_part [B, nseg, di, W], dB_part and dC_part [B, ceil(di /
// bch(n)), T, W] (n = the d_state's instance, W = n x groups(ds)), then
// dA [di, ds], dB, dC [B, T, ds] and dh0 [B, di, ds] (or null); B, T, di,
// ds, the segment length in chunks, form, device, stream. nseg =
// ceil(ceil(T / 16) / seg_chunks). parts: null up to 64 states, else a
// [groups(ds) - 1, 2, B, T, di] scratch for the other groups' partial d(dt)
// and d(dx), added into ddt and ddx in group order.
extern "C" int selective_scan_bwd_f32(
    const float* dt, const float* dx, const float* A, const float* Bc,
    const float* Cc, const float* hs, const float* dy, const float* dh_last,
    float* ddt, float* ddx, float* parts, float* lcarry, float* decay,
    float* dA_part, float* dB_part, float* dC_part, float* dA, float* dB,
    float* dC, float* dh0, int B, int T, int di, int ds, int seg_chunks,
    int form, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || di == 0 || T == 0) return 0;
  switch (instance(ds)) {   // BWD_D_STATES in kernels/selective_scan.py
#define SSB_CASE(N)                                                          \
  case N:                                                                    \
    return backward<N>(form, dt, dx, A, Bc, Cc, hs, dy, dh_last, ddt, ddx,   \
                       parts, lcarry, decay, dA_part, dB_part, dC_part, dA,  \
                       dB, dC, dh0, B, T, di, ds, seg_chunks, stream);
    SSB_CASE(4) SSB_CASE(8) SSB_CASE(16) SSB_CASE(32) SSB_CASE(64)
#undef SSB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
