// Mamba selective scan on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan (_kernel).
//
//   h_t = exp(dt_t A) h_{t-1} + dx_t B_t,   y_t = C_t . h_t
//
// dt, dx [B, T, di], A [di, ds], Bc, Cc [B, T, ds], h0 [B, di, ds] or
// null (zeros), all f32; y [B, T, di] and h_last [B, di, ds] f32. One
// template instance for each ds in {4, 8, 16, 32, 64}; any ds from 1 to 64
// runs the least at or above it (instance), the states past ds masked: they
// read as zero (A = B = C = h0 = 0, so they stay 0) and are not stored. From
// 65 to 256 the states are cut into groups of 64 (groups), a third grid
// axis: the recurrence is independent in every (channel, state), so each
// group runs the 64-state instance as it is on its own states (the last
// one's past ds masked) and writes its slice of h_last and hs. Only y sums
// over the states: group 0 writes its partial y to y, the others theirs to
// a [groups - 1, B, T, di] scratch that the wrapper frees on return, and
// sum_groups_kernel adds them into y in group order (no atomics: the same
// bits every run). The y traffic grows with the groups (a read and
// a write of [B, T, di] more for each), beside the groups' reads of dt and
// dx. Two forms: the f32 scan (this header) and, at a 16-bit scan_dtype, the
// reference's rounded tree (namespace tree, below). For training, hs (null,
// or [B, ceil(T / BT), di, ds] f32) receives the state at the start of every
// BT-step chunk (hs[:, 0] = h0), from which the backward kernels
// (csrc/selective_scan_bwd.cu) recompute each chunk's states.
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
#include "selective_scan.cuh"

namespace {

constexpr int STAGES = 3;       // chunks in flight

// lanes of a warp that share a channel: 2, each with half the states; 1 at
// ds = 4 and 4 from ds = 32 on, so that a lane holds 4 to 16 states
__host__ __device__ constexpr int lanes(int ds) {
  return ds == 4 ? 1 : ds <= 16 ? 2 : 4;
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

// WHOLE: ds is the instance's DS (the kernel as it was before masking);
// else the states ds .. DS - 1 are masked
template <int DS, bool WHOLE>
__global__ void __launch_bounds__(CH * lanes(DS), DS <= 16 ? 4 : 2)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ dx,
                      const float* __restrict__ A,
                      const float* __restrict__ Bc,
                      const float* __restrict__ Cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ parts, float* __restrict__ h_last,
                      float* __restrict__ hs, int T, int di, int lds_in) {
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
  constexpr bool full = WHOLE;
  // the block's group of states: s0 .. s0 + ds - 1 of the lds a row of A,
  // Bc, Cc and h holds; its partial y goes to y (group 0) or to its slice
  // of parts, which sum_groups_kernel adds in group order. An instance
  // below GROUP has one group: the terms fold away.
  // (WHOLE below GROUP: a row is the instance's DS states)
  const int lds = WHOLE && DS < GROUP ? DS : lds_in;
  const int grp = DS < GROUP ? 0 : (int)blockIdx.z;
  const int s0 = grp * DS;
  const int ds = WHOLE ? DS : DS < GROUP ? lds : min(DS, lds - s0);
  float* yg = grp == 0 ? y : parts + (size_t)(grp - 1) * gridDim.y * T * di;

  // chunk c (time steps c*BT..) into ring stage st; steps past T,
  // channels past di and states past ds read zero
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
    load_states<THR, DS>(bs, Bc, cs, Cc, b, t0, T, ds, lds, s0);
  };

  const int nchunk = (T + BT - 1) / BT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunk) load_chunk(s, s);
    cp_commit();
  }

  float a2[S], h[S];
  const size_t row = ((size_t)b * di + d) * lds + s0 + l * S;  // h0, h_last
  if (full) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const float4 av = live ? *reinterpret_cast<const float4*>(
                                   A + (size_t)d * lds + s0 + l * S + s)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 hv = (live && h0 != nullptr)
                            ? *reinterpret_cast<const float4*>(h0 + row + s)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      a2[s] = av.x * LOG2E; a2[s + 1] = av.y * LOG2E;
      a2[s + 2] = av.z * LOG2E; a2[s + 3] = av.w * LOG2E;
      h[s] = hv.x; h[s + 1] = hv.y; h[s + 2] = hv.z; h[s + 3] = hv.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool in = live && l * S + s < ds;
      a2[s] = (in ? A[(size_t)d * lds + s0 + l * S + s] : 0.f) * LOG2E;
      h[s] = in && h0 != nullptr ? h0[row + s] : 0.f;
    }
  }

  for (int c = 0; c < nchunk; ++c) {
    if (hs != nullptr && live)    // the state at the chunk's start
      store_states<S>(hs + (((size_t)b * nchunk + c) * di + d) * lds + s0 +
                          l * S,
                      h, ds - l * S, full);
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
          *reinterpret_cast<float4*>(yg + ((size_t)b * T + t0 + r) * di + d0 +
                                     k) =
              *reinterpret_cast<const float4*>(ys + r * CH + k);
      }
    } else {
      for (int idx = tid; idx < nt * CH; idx += THR) {
        const int r = idx / CH, k = idx % CH;
        if (d0 + k < di)
          yg[((size_t)b * T + t0 + r) * di + d0 + k] = ys[r * CH + k];
      }
    }
  }
  if (!live) return;
  store_states<S>(h_last + row, h, ds - l * S, full);
}

template <int DS, bool WHOLE>
int launch_f32(const float* dt, const float* dx, const float* A,
               const float* Bc, const float* Cc, const float* h0, float* y,
               float* parts, float* h_last, float* hs, int B, int T, int di,
               int ds, void* stream) {
  const int smem = (int)sizeof(float) * smem_floats(DS);
  if (smem > 48 * 1024) {       // only ds = 64; a decode step stays lean
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<DS, WHOLE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((di + CH - 1) / CH, B, groups(ds));
  selective_scan_kernel<DS, WHOLE><<<grid, CH * lanes(DS), smem,
                                    (cudaStream_t)stream>>>(
      dt, dx, A, Bc, Cc, h0, y, parts, h_last, hs, T, di, ds);
  return (int)cudaGetLastError();
}

// WHOLE where every group holds DS states on 16-byte aligned rows: ds is
// DS, or past 64 a multiple of it
template <int DS>
int launch(const float* dt, const float* dx, const float* A, const float* Bc,
           const float* Cc, const float* h0, float* y, float* parts,
           float* h_last, float* hs, int B, int T, int di, int ds,
           void* stream) {
  return ds % DS == 0
             ? launch_f32<DS, true>(dt, dx, A, Bc, Cc, h0, y, parts, h_last,
                                    hs, B, T, di, ds, stream)
             : launch_f32<DS, false>(dt, dx, A, Bc, Cc, h0, y, parts, h_last,
                                     hs, B, T, di, ds, stream);
}

// ----------------------------------------------- 16-bit transitions ----
//
// scan_dtype bf16 or f16 (configs: SSMConfig.scan_dtype): the reference's
// chunked associative scan, src/repro/models/mamba.py, _ssm_scan, with its
// rounding. Per chunk of 64 steps (all of T when 64 does not divide it)
// and per (b, channel, state) chain, the transitions a_t = R(exp(dt_t A))
// and b_t = R(dx_t B_t) (R: round to the 16-bit type) go through
// lax.associative_scan's tree of combines
//   (al, bl) o (ar, br) = (R(al ar), R(R(bl ar) + br))    bf16
//                         (R(al ar), R(bl ar + br))       f16
// (the two types as XLA on the CPU rounds them: kernels/ref.py, combine),
// then h_t = f32(A_t) h + f32(B_t) in f32 from the chunk's start state h,
// carried in f32 from chunk to chunk, and y_t = sum_s f32(R(h_t))
// f32(R(C_t)) in f32. Operands and results are f32, as the reference's dt,
// dx, Bc and Cc are.
//
// The tree in step order: prefix t of the tree is the left fold, largest
// first, of the aligned power-of-two blocks that t + 1's bits give, each a
// balanced tree of combines (kernels/ref.py, tree_scan). So a chain walks
// its chunk in order with a binary counter: element t joins the counter
// (merged with the full blocks below its lowest zero bit, balanced), and
// the prefix is the fold of the block above it with the new block. A fold
// is kept beside each block of the counter, so a step costs the reference's
// two combines on average and the [B, c, di, ds] prefixes never exist.
// The counter sits in registers: slots 0 to 3 (blocks of 1 to 8 steps) and
// their folds, touched as the unrolled steps of a 16-step chunk fix; the
// chunk's block joins the slots of 16 and 32 steps at its last step, by
// the chunk's place in its group of 64; and F, the fold of the blocks
// above the chunk, leads every fold within it. A ragged T is one chunk of
// T steps: each group of 64 then merges into a high counter of
// block-of-64 slots at its end, and the fold of the high slots (H) leads
// the next group's folds. The high slots and
// their folds are the tree's workspace: thread-local arrays of KH slots
// for each of a lane's S states, of which ceil(log2(T / 64 + 1)) are used
// (4 at the ragged T = 1000 chip_smoke.py checks: 2 x 4 x 4 x 4 = 128
// bytes a lane, 640 reserved).
//
// Layout: S = 4 states a lane, tlanes(ds) = ds / 4 lanes a channel and
// tch(ds) channels a block (64, or 256 threads' worth from ds = 32 on);
// the f32 kernel's 3-stage cp.async ring of 16-step chunks of dt, dx, Bc
// and Cc, its y tile in shared memory, written out as rows. A step's
// lanes' partial sums of y (each over its 4 states, ascending) are added
// by a reduce-scatter over groups of `lanes` steps: xor 1 apart, then 2,
// .., each y the adjacent-pairs tree of its lanes' partials. exp is the
// accurate expf (a rounding of the decay to 8 bits must see the value
// torch.exp gives), and h_t's product and sum are __fmul_rn / __fadd_rn
// (unfused, as the reference's). save_states writes the state at every
// 16-step chunk start (the f32 h_t before it): those of the 64-step chunks
// and three between, from which the backward recomputes.
// Bound on the H100: the bytes, as the f32 kernel's. The work: about two
// combines a (b, t, d, s) beside the decay and h_t, ~30 instructions where
// the f32 kernel issues ~6 (PERF.md §6 has its time).
namespace tree {

constexpr int S = 4;            // states a lane
constexpr int G = 64;           // steps a group: the reference's chunk
constexpr int KH = 20;          // slots of the high counter: T < 2^26

__host__ __device__ constexpr int tlanes(int ds) { return ds / S; }
__host__ __device__ constexpr int tch(int ds) {
  return tlanes(ds) <= 4 ? CH : 256 / tlanes(ds);
}
// shared memory in floats: per stage dt, dx [BT][tch], Bc, Cc [BT][DS];
// then y [BT][tch]
__host__ __device__ constexpr int smem_floats(int ds) {
  return STAGES * BT * (2 * tch(ds) + 2 * ds) + BT * tch(ds);
}

template <typename R>
struct Tr;

template <>
struct Tr<__nv_bfloat16> {
  using V = __nv_bfloat162;     // (a, b)
  static __device__ __forceinline__ V pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ V combine(V l, V r) {
    const float ar = __low2float(r);
    return pack(__fmul_rn(__low2float(l), ar),
                __fadd_rn(rnd(__fmul_rn(__high2float(l), ar)),
                          __high2float(r)));
  }
};

template <>
struct Tr<__half> {
  using V = __half2;
  static __device__ __forceinline__ V pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ V combine(V l, V r) {
    const float ar = __low2float(r);
    return pack(__fmul_rn(__low2float(l), ar),
                __fadd_rn(__fmul_rn(__high2float(l), ar), __high2float(r)));
  }
};

// the lanes' partial sums of L steps, reduce-scattered: lanes 1 apart,
// then 2, .., lane l keeping step l; each step's sum is the adjacent-pairs
// tree of its lanes' partials
template <int L>
__device__ __forceinline__ float reduce_scatter(float (&v)[L], int l) {
#pragma unroll
  for (int o = 1, n = L; o < L; o <<= 1) {
    n >>= 1;
    const bool up = (l & o) != 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[2 * i] : v[2 * i + 1];
      v[i] = (up ? v[2 * i + 1] : v[2 * i]) + __shfl_xor_sync(FULL, send, o);
    }
  }
  return v[0];
}

// element x joins the counter at step tt < 15 of a 16-step chunk: merged
// with the full blocks of slots 0 .. 3 below tt's lowest zero bit, then
// folded after the next block above it, or after F (the fold of every
// block above the chunk) where there is none and hasF. Returns the prefix.
template <typename Q>
__device__ __forceinline__ typename Q::V insert(typename Q::V x, int tt,
                                                typename Q::V (&slot)[4],
                                                typename Q::V (&fold)[4],
                                                typename Q::V F, bool hasF) {
  int k = 0;
#pragma unroll
  for (; k < 4; ++k) {
    if (!((tt >> k) & 1)) break;
    x = Q::combine(slot[k], x);
  }
  int above = -1;
#pragma unroll
  for (int j = 3; j > k; --j)
    if (((tt + 1) >> j) & 1) above = j;
  typename Q::V P = x;
  if (above >= 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == above) P = Q::combine(fold[j], x);
  } else if (hasF) {
    P = Q::combine(F, x);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j == k) {
      slot[j] = x;
      fold[j] = P;
    }
  return P;
}

template <typename R, int DS>
__global__ void __launch_bounds__(tch(DS) * tlanes(DS))
tree_kernel(const float* __restrict__ dt, const float* __restrict__ dx,
            const float* __restrict__ A, const float* __restrict__ Bc,
            const float* __restrict__ Cc, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ parts,
            float* __restrict__ h_last, float* __restrict__ hs, int T, int di,
            int lds) {
  using Q = Tr<R>;
  using V = typename Q::V;
  constexpr int L = tlanes(DS);
  constexpr int C = tch(DS);
  constexpr int THR = C * L;
  constexpr int STAGE = BT * (2 * C + 2 * DS);
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + STAGES * STAGE;      // [BT][C]

  const int tid = threadIdx.x;
  const int ch = tid / L, l = tid % L;
  const int b = blockIdx.y, d0 = blockIdx.x * C;
  const int d = d0 + ch;
  const bool live = d < di;
  const bool vec = (di % 4) == 0;
  // the block's group of states and its partial y, as in the f32 kernel
  const int grp = DS < GROUP ? 0 : (int)blockIdx.z;
  const int s0 = grp * DS;
  const int ds = DS < GROUP ? lds : min(DS, lds - s0);
  const bool full = ds == DS && lds % 4 == 0;
  float* yg = grp == 0 ? y : parts + (size_t)(grp - 1) * gridDim.y * T * di;

  auto load_chunk = [&](int c, int st) {
    float* dts = smem + st * STAGE;
    float* dxs = dts + BT * C;
    float* bs = dxs + BT * C;
    float* cs = bs + BT * DS;
    const int t0 = c * BT;
    if (vec) {
      for (int idx = tid; idx < BT * C / 4; idx += THR) {
        const int r = idx / (C / 4), k = (idx % (C / 4)) * 4;
        const bool in = t0 + r < T && d0 + k < di;
        const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
        cp_async16_zfill(dts + r * C + k, in ? dt + off : dt, in ? 16 : 0);
        cp_async16_zfill(dxs + r * C + k, in ? dx + off : dx, in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BT * C; idx += THR) {
        const int r = idx / C, k = idx % C;
        const bool in = t0 + r < T && d0 + k < di;
        const size_t off = ((size_t)b * T + t0 + r) * di + d0 + k;
        cp_async4_zfill(dts + r * C + k, in ? dt + off : dt, in ? 4 : 0);
        cp_async4_zfill(dxs + r * C + k, in ? dx + off : dx, in ? 4 : 0);
      }
    }
    load_states<THR, DS>(bs, Bc, cs, Cc, b, t0, T, ds, lds, s0);
  };

  const int nchunk = (T + BT - 1) / BT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunk) load_chunk(s, s);
    cp_commit();
  }

  // per state: A, the chunk's start state, the latest h_t (the state
  // before the next step); the counter: slots 0 .. 3 (blocks of 1 to 8
  // steps) and their folds, s4 and s5 (16 and 32 steps), F the fold of the
  // blocks above the current 16-step chunk, H that of the high slots
  float a[S], hst[S], hcur[S];
  V slot[S][4], fold[S][4], s4[S], s5[S], F[S], H[S];
  V hslot[S][KH], hfold[S][KH];           // the high counter (ragged T)
  const size_t row = ((size_t)b * di + d) * lds + s0 + l * S;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool in = live && l * S + s < ds;
    a[s] = in ? A[(size_t)d * lds + s0 + l * S + s] : 0.f;
    hst[s] = in && h0 != nullptr ? h0[row + s] : 0.f;
    hcur[s] = hst[s];
    H[s] = F[s] = Q::pack(1.f, 0.f);
  }
  const bool ragged = (T % G) != 0;       // one chunk of T steps

  const int ngroup = (T + G - 1) / G;
  for (int g = 0; g < ngroup; ++g) {
    const bool hasH = ragged && g > 0;
    for (int q = 0; q < G / BT; ++q) {   // the group's 16-step chunks
      const int c = g * (G / BT) + q;
      const bool hasF = q > 0 || hasH;
      if (q == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) F[s] = H[s];
      }
      if (c < nchunk) {
        if (hs != nullptr && live)          // the state at the chunk's start
          store_states<S>(hs + (((size_t)b * nchunk + c) * di + d) * lds +
                              s0 + l * S, hcur, ds - l * S, full);
        cp_wait<STAGES - 2>();
        __syncthreads();
        const int nx = c + STAGES - 1;
        if (nx < nchunk) load_chunk(nx, nx % STAGES);
        cp_commit();
        const float* dts = smem + (c % STAGES) * STAGE;
        const float* dxs = dts + BT * C;
        const float* bs = dxs + BT * C;
        const float* cs = bs + BT * DS;
        const int nt = min(BT, T - c * BT);
#pragma unroll
        for (int j0 = 0; j0 < BT; j0 += L) {
          float p[L];
#pragma unroll
          for (int j = 0; j < L; ++j) {
            const int tt = j0 + j;          // the step in the chunk
            p[j] = 0.f;
            if (tt < nt) {
              const float dtv = dts[tt * C + ch], dxv = dxs[tt * C + ch];
              const float4 b4 =
                  *reinterpret_cast<const float4*>(bs + tt * DS + l * S);
              const float4 c4 =
                  *reinterpret_cast<const float4*>(cs + tt * DS + l * S);
              const float bv[S] = {b4.x, b4.y, b4.z, b4.w};
              const float cv[S] = {c4.x, c4.y, c4.z, c4.w};
              float qs = 0.f;
#pragma unroll
              for (int s = 0; s < S; ++s) {
                V x = Q::pack(expf(dtv * a[s]), __fmul_rn(dxv, bv[s]));
                V P;
                if (tt < BT - 1) {
                  P = insert<Q>(x, tt, slot[s], fold[s], F[s], hasF);
                } else {
                  // the chunk's 16-step block joins s4, s5, or (at the
                  // group's end) the high counter
#pragma unroll
                  for (int k = 0; k < 4; ++k) x = Q::combine(slot[s][k], x);
                  if (q == 0 || q == 2) {
                    s4[s] = x;
                    P = q == 2 ? Q::combine(F[s], x)
                               : hasH ? Q::combine(H[s], x) : x;
                  } else if (q == 1) {
                    x = Q::combine(s4[s], x);
                    s5[s] = x;
                    P = hasH ? Q::combine(H[s], x) : x;
                  } else {
                    x = Q::combine(s5[s], Q::combine(s4[s], x));
                    P = x;
                    if (ragged) {   // the group's block into the high slots
                      int k = 0;
                      for (; (g >> k) & 1; ++k)
                        x = Q::combine(hslot[s][k], x);
                      int above = k + 1;
                      while (above < KH && !(((g + 1) >> above) & 1))
                        ++above;
                      P = above < KH ? Q::combine(hfold[s][above], x) : x;
                      hslot[s][k] = x;
                      hfold[s][k] = P;
                      H[s] = P;
                    }
                  }
                  F[s] = P;
                }
                const float hv = __fadd_rn(
                    __fmul_rn(__low2float(P), hst[s]), __high2float(P));
                hcur[s] = hv;
                qs = fmaf(Q::rnd(hv), Q::rnd(cv[s]), qs);
              }
              p[j] = qs;
            }
          }
          ys[(j0 + l) * C + ch] = reduce_scatter<L>(p, l);
        }
        __syncthreads();            // the chunk's y tile is complete
        const int t0 = c * BT;
        if (vec) {
          for (int idx = tid; idx < nt * C / 4; idx += THR) {
            const int r = idx / (C / 4), k = (idx % (C / 4)) * 4;
            if (d0 + k < di)
              *reinterpret_cast<float4*>(yg + ((size_t)b * T + t0 + r) * di +
                                         d0 + k) =
                  *reinterpret_cast<const float4*>(ys + r * C + k);
          }
        } else {
          for (int idx = tid; idx < nt * C; idx += THR) {
            const int r = idx / C, k = idx % C;
            if (d0 + k < di)
              yg[((size_t)b * T + t0 + r) * di + d0 + k] = ys[r * C + k];
          }
        }
      }
    }
    if (!ragged) {                // the next chunk starts from h_63
#pragma unroll
      for (int s = 0; s < S; ++s) hst[s] = hcur[s];
    }
  }
  if (!live) return;
  store_states<S>(h_last + row, hcur, ds - l * S, full);
}

template <typename R, int DS>
int launch(const float* dt, const float* dx, const float* A, const float* Bc,
           const float* Cc, const float* h0, float* y, float* parts,
           float* h_last, float* hs, int B, int T, int di, int ds,
           void* stream) {
  if ((long long)T >= ((long long)G << KH)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * smem_floats(DS);
  cudaError_t err = cudaFuncSetAttribute(
      tree_kernel<R, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + tch(DS) - 1) / tch(DS), B, groups(ds));
  tree_kernel<R, DS><<<grid, tch(DS) * tlanes(DS), smem,
                       (cudaStream_t)stream>>>(dt, dx, A, Bc, Cc, h0, y,
                                               parts, h_last, hs, T, di, ds);
  return (int)cudaGetLastError();
}

}  // namespace tree


// the transitions' type by the entry points' form: 0 f32, 1 bf16, 2 f16
// (kernels/selective_scan.FORMS); past 64 states the groups' partial y
// added in group order
template <int DS>
int forward(int form, const float* dt, const float* dx, const float* A,
            const float* Bc, const float* Cc, const float* h0, float* y,
            float* parts, float* h_last, float* hs, int B, int T, int di,
            int ds, void* stream) {
  int err;
  switch (form) {
    case 0:
      err = launch<DS>(dt, dx, A, Bc, Cc, h0, y, parts, h_last, hs, B, T, di,
                       ds, stream);
      break;
    case 1:
      err = tree::launch<__nv_bfloat16, DS>(dt, dx, A, Bc, Cc, h0, y, parts,
                                            h_last, hs, B, T, di, ds, stream);
      break;
    case 2:
      err = tree::launch<__half, DS>(dt, dx, A, Bc, Cc, h0, y, parts, h_last,
                                     hs, B, T, di, ds, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const long long btd = (long long)B * T * di;
  return sum_groups(y, parts, btd, btd, groups(ds) - 1, (cudaStream_t)stream);
}


}  // namespace

// lanes a channel for this d_state's instance (kernels/selective_scan.lanes
// is checked against this)
extern "C" int selective_scan_lanes(int ds) { return lanes(instance(ds)); }

// the geometry of a d_state's forward launch, for kernels/selective_scan.py
// to be held against: out = {instance, state groups, tree lanes, tree
// channels, tree shared memory}
extern "C" int selective_scan_geometry(int ds, int* out) {
  const int n = instance(ds);
  if (n == 0) return (int)cudaErrorInvalidValue;
  out[0] = n;
  out[1] = groups(ds);
  out[2] = tree::tlanes(n);
  out[3] = tree::tch(n);
  out[4] = (int)sizeof(float) * tree::smem_floats(n);
  return 0;
}

// y: [B, T, di], which receives group 0's partial sum and then the
// others'; parts: null up to 64 states, else a [groups(ds) - 1, B, T, di]
// scratch for the other groups' partials; hs: null, or [B, ceil(T / BT),
// di, ds] for the chunks' start states; form: the transitions' type (0
// f32, 1 bf16, 2 f16); any ds from 1 to 256
extern "C" int selective_scan_f32(const float* dt, const float* dx,
                                  const float* A, const float* Bc,
                                  const float* Cc, const float* h0, float* y,
                                  float* parts, float* h_last, float* hs,
                                  int B, int T, int di, int ds, int form,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || di == 0) return 0;
  switch (instance(ds)) {   // D_STATES in kernels/selective_scan.py
#define SSF_CASE(N)                                                         \
  case N:                                                                   \
    return forward<N>(form, dt, dx, A, Bc, Cc, h0, y, parts, h_last, hs, B, T, \
                      di, ds, stream);
    SSF_CASE(4) SSF_CASE(8) SSF_CASE(16) SSF_CASE(32) SSF_CASE(64)
#undef SSF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
