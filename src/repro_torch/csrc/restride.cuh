// The attention entries' staging (flash_attention.cu,
// flash_attention_bwd.cu): the tensor maps' row stride must be a multiple
// of 8 bf16 elements (16 bytes), so at any other head dim the entries copy
// q, k, v (o and dO for the backward) into buffers ld = ceil8(hd) columns
// wide, zeros past hd, run the kernels on them, and copy the outputs back
// hd wide. One launch copies up to RESTRIDE_MAX matrices (blockIdx.y the
// matrix), a block a row at a time. kernels/flash_attention.stage is its
// function in plain torch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace restride {

constexpr int RESTRIDE_MAX = 8;
constexpr int THREADS = 128;

struct Mats {
  const uint16_t* src[RESTRIDE_MAX];
  uint16_t* dst[RESTRIDE_MAX];
  long long rows[RESTRIDE_MAX];
  int w_in, w_out;
};

// each row's first min(w_in, w_out) elements, zeros past w_in
__global__ void __launch_bounds__(THREADS) restride_kernel(Mats m) {
  const int t = blockIdx.y;
  for (long long row = blockIdx.x; row < m.rows[t]; row += gridDim.x) {
    const uint16_t* s = m.src[t] + row * m.w_in;
    uint16_t* d = m.dst[t] + row * m.w_out;
    for (int c = threadIdx.x; c < m.w_out; c += THREADS)
      d[c] = c < m.w_in ? s[c] : (uint16_t)0;
  }
}

// n matrices, src[i] [rows[i], w_in] into dst[i] [rows[i], w_out]
inline int copy(int n, const void* const* src, void* const* dst,
                const long long* rows, int w_in, int w_out,
                cudaStream_t st) {
  if (n < 1 || n > RESTRIDE_MAX) return (int)cudaErrorInvalidValue;
  Mats m{};
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    m.src[i] = static_cast<const uint16_t*>(src[i]);
    m.dst[i] = static_cast<uint16_t*>(dst[i]);
    m.rows[i] = rows[i];
    most = rows[i] > most ? rows[i] : most;
  }
  if (most == 0) return 0;
  m.w_in = w_in;
  m.w_out = w_out;
  const unsigned blocks = (unsigned)(most < 8192 ? most : 8192);
  restride_kernel<<<dim3(blocks, n), THREADS, 0, st>>>(m);
  return (int)cudaGetLastError();
}

}  // namespace restride
