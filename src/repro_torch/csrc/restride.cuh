// The attention entries' staging (flash_attention.cu,
// flash_attention_bwd.cu): the tensor maps' row stride must be a multiple
// of 8 bf16 elements (16 bytes), so at any other head dim the bf16 entries
// copy q, k, v (o and dO for the backward) into buffers ld = ceil8(hd)
// columns wide, zeros past hd, run the kernels on them, and copy the
// outputs back hd wide; the f32 entries copy their operands ld = ceil4(hd)
// wide (16-byte cp.async rows) and write their outputs hd wide themselves.
// One launch copies up to RESTRIDE_MAX matrices (blockIdx.y the matrix), a
// block a row at a time, of 2-byte (uint16_t) or 4-byte (uint32_t)
// elements. kernels/flash_attention.stage is its function in plain torch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace restride {

constexpr int RESTRIDE_MAX = 8;
constexpr int THREADS = 128;

template <typename E>
struct Mats {
  const E* src[RESTRIDE_MAX];
  E* dst[RESTRIDE_MAX];
  long long rows[RESTRIDE_MAX];
  int w_in, w_out;
};

// each row's first min(w_in, w_out) elements, zeros past w_in
template <typename E>
__global__ void __launch_bounds__(THREADS) restride_kernel(Mats<E> m) {
  const int t = blockIdx.y;
  for (long long row = blockIdx.x; row < m.rows[t]; row += gridDim.x) {
    const E* s = m.src[t] + row * m.w_in;
    E* d = m.dst[t] + row * m.w_out;
    for (int c = threadIdx.x; c < m.w_out; c += THREADS)
      d[c] = c < m.w_in ? s[c] : (E)0;
  }
}

// n matrices, src[i] [rows[i], w_in] into dst[i] [rows[i], w_out], of
// elements of E's size
template <typename E = uint16_t>
inline int copy(int n, const void* const* src, void* const* dst,
                const long long* rows, int w_in, int w_out,
                cudaStream_t st) {
  if (n < 1 || n > RESTRIDE_MAX) return (int)cudaErrorInvalidValue;
  Mats<E> m{};
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    m.src[i] = static_cast<const E*>(src[i]);
    m.dst[i] = static_cast<E*>(dst[i]);
    m.rows[i] = rows[i];
    most = rows[i] > most ? rows[i] : most;
  }
  if (most == 0) return 0;
  m.w_in = w_in;
  m.w_out = w_out;
  const unsigned blocks = (unsigned)(most < 8192 ? most : 8192);
  restride_kernel<E><<<dim3(blocks, n), THREADS, 0, st>>>(m);
  return (int)cudaGetLastError();
}

}  // namespace restride
