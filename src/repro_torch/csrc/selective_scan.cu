// Mamba selective scan on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan (_kernel).
//
//   h_t = exp(dt_t A) h_{t-1} + dx_t B_t,   y_t = C_t . h_t
//
// dt, dx [B, T, di], A [di, ds], Bc, Cc [B, T, ds], h0 [B, di, ds] or
// null (zeros), all f32; y [B, T, di] and h_last [B, di, ds] f32.
//
// Bound on the H100: bytes. Per (b, t, channel) the function reads dt and
// dx and writes y (12 bytes) and does ds exponentials and 3*ds FMA-class
// operations; Bc and Cc are ds floats per (b, t), shared by all di
// channels. At ds = 16 that is about 5 operations per byte, far below the
// card's ratio.
//
// Design: one thread per (b, channel d), its h[16] in registers for the
// whole of T and its row of A too, walking t in order: the [B, T, di, ds]
// transition tensors of the XLA scan never exist, the property of the TPU
// kernel worth keeping. A block is 128 channels of one batch row; it
// stages a chunk of 64 time steps of Bc and Cc in shared memory, read by
// all its channels as broadcasts. dt, dx and y are read and written along
// d, so a warp's access is one contiguous 128-byte line; each thread
// loads the dt and dx of 8 steps before it computes them, so that 8 loads
// are in flight. The state h starts from h0 when given and is written
// back to h_last, so a decode step carries it on. expf, not __expf: the
// decay exp(dt A) is compared with the plain version to 1e-4.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int BT = 64;         // time steps of Bc, Cc staged per chunk
constexpr int UNROLL = 8;      // dt, dx loads in flight per thread
constexpr int DS = 16;         // d_state, the state in registers

__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ dx,
                      const float* __restrict__ A,
                      const float* __restrict__ Bc,
                      const float* __restrict__ Cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int T, int di) {
  __shared__ float Bs[BT * DS];
  __shared__ float Cs[BT * DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = live ? A[(size_t)d * DS + s] : 0.f;
    h[s] = (live && h0 != nullptr) ? h0[((size_t)b * di + d) * DS + s] : 0.f;
  }

  const size_t base = (size_t)b * T * di + d;   // (b, 0, d)
  for (int t0 = 0; t0 < T; t0 += BT) {
    const int nt = min(BT, T - t0);
    __syncthreads();   // the last chunk's readers are done
    for (int idx = threadIdx.x; idx < nt * DS; idx += THREADS) {
      const size_t src = ((size_t)b * T + t0) * DS + idx;
      Bs[idx] = Bc[src];
      Cs[idx] = Cc[src];
    }
    __syncthreads();
    if (!live) continue;
    for (int t1 = 0; t1 < nt; t1 += UNROLL) {
      float dtv[UNROLL], dxv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const size_t off = base + (size_t)(t0 + t1 + u) * di;
        const bool in = t1 + u < nt;
        dtv[u] = in ? dt[off] : 0.f;
        dxv[u] = in ? dx[off] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int tt = t1 + u;
        if (tt >= nt) break;
        float yv = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = expf(dtv[u] * a[s]) * h[s] + dxv[u] * Bs[tt * DS + s];
          yv = fmaf(h[s], Cs[tt * DS + s], yv);
        }
        y[base + (size_t)(t0 + tt) * di] = yv;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < DS; ++s) h_last[((size_t)b * di + d) * DS + s] = h[s];
}

}  // namespace

extern "C" int selective_scan_f32(const float* dt, const float* dx,
                                  const float* A, const float* Bc,
                                  const float* Cc, const float* h0, float* y,
                                  float* h_last, int B, int T, int di, int ds,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != DS) return (int)cudaErrorInvalidValue;
  if (B == 0 || di == 0) return 0;
  const dim3 grid((di + THREADS - 1) / THREADS, B);
  selective_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      dt, dx, A, Bc, Cc, h0, y, h_last, T, di);
  return (int)cudaGetLastError();
}
