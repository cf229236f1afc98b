// Packed-symmetric TVM E-step matmul (sm_90a): out[M, N] = a[M, K] @ b[K, N].
//
// Replaces: src/repro/kernels/tvm_estep.py, _packed_matmul (_matmul_kernel),
// which backs both tvm_estep_l (L = n @ U_packed, [U, C] @ [C, P]) and
// tvm_estep_a (A = n^T @ PP_packed, [C, U] @ [U, P]); P = R(R+1)/2.
//
// a is the row-major n itself, read through (stride_m, stride_k) = (lda, 1)
// (L: a K-contiguous) or (1, lda) (A: n^T, a M-contiguous), never a
// transposed copy. b is row-major [K, N] with row stride ldb. Inputs are f32
// or bf16; products and sums are always f32 (bf16 x bf16 is exact in f32).
// The wrapper (kernels/tvm_estep.py, `form`) picks one of three kernels:
//
// stream (M <= 16, f32 or bf16: L at serving). Bound by reading b once:
// 2*M FLOPs per element of b. One block per 64 columns of b, 256 threads;
// b's [BK x 64] slabs (8 KB) and a's [16 x BK] slabs come together through
// a 4-stage cp.async ring (a by plain loads when it is n^T or its rows are
// not 16-byte aligned). Warp g multiplies the slab's k rows g*BK/8 ..
// (g+1)*BK/8 - 1 into 16 x 2 sums in registers (a read four k at a time,
// broadcast); the eight warps' sums are added in warp order through shared
// memory at the end.
//
// sgemm (M > 16, f32: A at training, L at training and extract). Bound by
// the f32 FMA rate (no TF32: the contract is full f32). 128 x 128 tiles,
// 256 threads with 8 x 8 sums each read as float4 from k-major slabs,
// 16-deep slabs of b (and of a for A, whose n^T slab is k-major in memory)
// through a 3-stage ring of 16-byte cp.async copies, one barrier per slab,
// two blocks an SM. L's a slab is m-major in memory: it is read one slab
// ahead into registers and stored transposed after the products. Blocks
// walk M fastest, so the blocks that share a column tile of b run
// together and find it in L2.
//
// wgmma (M > 16, bf16). The tensor cores, bf16 in and f32 accumulators. A
// producer warp fills a 3-stage ring of (a, b) tiles (128 x 64 and 64 x
// 128, 16 KB each) by 2-d TMA with the 128-byte swizzle; two consumer
// warpgroups of 64 rows each run m64n128k16 wgmma from shared memory. b is
// N-major (MN-major B); a is K-major for L and M-major for A (the
// descriptors' transpose bits). Bound by writing the f32 output (4*M*N
// bytes, most of the traffic): the accumulators go through shared memory
// (a padded [64][136] tile per warpgroup) and leave as coalesced float4
// rows. TMA needs 16-byte row strides: lda and ldb multiples of 8 (the
// wrapper pads otherwise). Two blocks an SM.
//
// All three: ragged M, K and N read zeros at the edge (zero-filled copies,
// TMA's out-of-bounds fill) and stores are masked. One block owns each
// output and sums its reduction in one fixed order: no atomics, bitwise
// repeatable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

// two neighbouring elements, widened
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// 16 bytes of T at src (`valid` elements of them real, the rest zero) into
// dst. vec: one cp.async with zero fill, src 16-byte aligned (the tensor's
// base when valid = 0); otherwise plain loads, for rows that are not
// 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int valid,
                                       bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    cp_async16_zfill(dst, src, valid * (int)sizeof(T));
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) dst[j] = j < valid ? src[j] : zero<T>();
  }
}

__device__ __forceinline__ int clamp_len(int n, int e) {
  return n < 0 ? 0 : (n > e ? e : n);
}

// ------------------------------------------------------------- stream ----

namespace stream {

constexpr int MMAX = 16;
constexpr int BN = 64;             // columns of b per block
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T>
struct Shape {
  static constexpr int BK = 128 / sizeof(T);        // 8 KB b slabs
  static constexpr int KW = BK / WARPS;             // k rows per warp
  static constexpr int AS_LD = BK + 16 / sizeof(T); // a slab row, 16-byte rows
  static constexpr int B_BYTES = BK * BN * sizeof(T);
  static constexpr int A_BYTES = MMAX * AS_LD * sizeof(T);
  static constexpr int STAGE_BYTES = B_BYTES + A_BYTES;
  static constexpr int RED_BYTES = WARPS * MMAX * BN * 4;  // end: warp sums
  static constexpr int SMEM =
      STAGES * STAGE_BYTES > RED_BYTES ? STAGES * STAGE_BYTES : RED_BYTES;
  static constexpr int CHUNKS = BK * BN * sizeof(T) / 16 / THREADS;
};

// four neighbouring elements, widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// a_vec: a is K-contiguous with 16-byte rows, so its [M, BK] slab comes
// through the ring as 16-byte copies too; otherwise (n^T, or unaligned
// rows) by plain loads
template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const T* __restrict__ a, const T* __restrict__ b,
       float* __restrict__ out, int M, int K, int N, long long sam,
       long long sak, long long ldb, bool vec, bool a_vec) {
  using S = Shape<T>;
  constexpr int BK = S::BK;
  constexpr int CPR = BN * sizeof(T) / 16;           // 16-byte chunks a row
  constexpr int EPC = 16 / sizeof(T);                // elements a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int nslab = (K + BK - 1) / BK;

  auto b_stage = [&](int st) {
    return reinterpret_cast<T*>(smem + st * S::STAGE_BYTES);
  };
  auto a_stage = [&](int st) {
    return reinterpret_cast<T*>(smem + st * S::STAGE_BYTES + S::B_BYTES);
  };
  auto load = [&](int slab, int st) {
    T* dst = b_stage(st);
#pragma unroll
    for (int i = 0; i < S::CHUNKS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / CPR, c = (idx % CPR) * EPC;
      const int gk = slab * BK + r, gn = n0 + c;
      const int valid = gk < K ? clamp_len(N - gn, EPC) : 0;
      copy16(dst + r * BN + c, valid ? b + gk * ldb + gn : b, valid, vec);
    }
    T* as = a_stage(st);
    if (a_vec) {   // MMAX rows of BK / EPC chunks: one chunk a thread
      constexpr int ACPR = BK / EPC;
      if (tid < MMAX * ACPR) {
        const int m = tid / ACPR, k = (tid % ACPR) * EPC;
        const int gk = slab * BK + k;
        const int valid = m < M ? clamp_len(K - gk, EPC) : 0;
        cp_async16_zfill(as + m * S::AS_LD + k, valid ? a + m * sam + gk : a,
                         valid * (int)sizeof(T));
      }
    } else {
      for (int idx = tid; idx < MMAX * BK; idx += THREADS) {
        const int m = idx / BK, k = idx % BK, gk = slab * BK + k;
        as[m * S::AS_LD + k] =
            (m < M && gk < K) ? a[m * sam + gk * sak] : zero<T>();
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_commit();
  }

  float acc[MMAX][2];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) acc[m][0] = acc[m][1] = 0.f;

  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 2>();   // slab s has landed (this thread's copies)
    __syncthreads();         // everyone's; slab s - 1's stage is free
    const int nx = s + STAGES - 1;
    if (nx < nslab) load(nx, nx % STAGES);
    cp_commit();
    const T* bs = b_stage(s % STAGES);
    const T* as = a_stage(s % STAGES);
#pragma unroll
    for (int q = 0; q < S::KW; q += 4) {
      const int k = warp * S::KW + q;
      float b0[4], b1[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 v = load2(bs + (k + kk) * BN + 2 * lane);
        b0[kk] = v.x;
        b1[kk] = v.y;
      }
#pragma unroll
      for (int m = 0; m < MMAX; ++m) {
        const float4 av = load4(as + m * S::AS_LD + k);
        acc[m][0] = fmaf(av.x, b0[0], acc[m][0]);
        acc[m][1] = fmaf(av.x, b1[0], acc[m][1]);
        acc[m][0] = fmaf(av.y, b0[1], acc[m][0]);
        acc[m][1] = fmaf(av.y, b1[1], acc[m][1]);
        acc[m][0] = fmaf(av.z, b0[2], acc[m][0]);
        acc[m][1] = fmaf(av.z, b1[2], acc[m][1]);
        acc[m][0] = fmaf(av.w, b0[3], acc[m][0]);
        acc[m][1] = fmaf(av.w, b1[3], acc[m][1]);
      }
    }
  }

  // the eight warps' sums, added in warp order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);      // [WARPS][MMAX][BN]
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
    *reinterpret_cast<float2*>(red + (warp * MMAX + m) * BN + 2 * lane) =
        make_float2(acc[m][0], acc[m][1]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MMAX * BN / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int m = idx / BN, c = idx % BN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[(w * MMAX + m) * BN + c];
    if (m < M && n0 + c < N) out[(size_t)m * N + n0 + c] = v;
  }
}

template <typename T>
int launch(const T* a, const T* b, float* out, int M, int K, int N,
           long long sam, long long sak, long long ldb, bool vec,
           cudaStream_t s) {
  if (M > MMAX) return (int)cudaErrorInvalidValue;
  const int smem = Shape<T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool a_vec = sak == 1 && sam % (16 / sizeof(T)) == 0 &&
                     (uintptr_t)a % 16 == 0;
  kernel<T><<<(N + BN - 1) / BN, THREADS, smem, s>>>(a, b, out, M, K, N, sam,
                                                    sak, ldb, vec, a_vec);
  return (int)cudaGetLastError();
}

}  // namespace stream

// -------------------------------------------------------------- sgemm ----

namespace sgemm {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int THREADS = 256;             // 16 x 16, 8 x 8 outputs each
constexpr int AS_LD = BM + 4;            // a slab row (k-major), 16-byte rows
constexpr int A_FLOATS = BK * AS_LD;
constexpr int B_FLOATS = BK * BN;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int SMEM = sizeof(float) * STAGES * STAGE_FLOATS;

// A_KFAST: a is K-contiguous (a[m * lda + k], L); else M-contiguous
// (a[k * lda + m], A: n^T). Both multiply from a k-major [BK][BM] slab:
// an M-contiguous slab lands so by cp.async; a K-contiguous one is read
// a slab ahead into registers (two float4 a thread, BM rows of four k)
// and stored transposed after the products.
template <bool A_KFAST>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const float* __restrict__ a, const float* __restrict__ b,
       float* __restrict__ out, int M, int K, int N, long long lda,
       long long ldb, bool vec) {
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x;
  // a warp is 4 x 8 threads: its float4 reads of each operand's slab row
  // span 64 and 128 bytes, one shared-memory wavefront each
  const int tx = (tid / 32) % 2 * 8 + tid % 8;
  const int ty = (tid / 64) * 4 + (tid % 32) / 8;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nslab = (K + BK - 1) / BK;

  auto load = [&](int slab, int st) {
    float* as = smf + st * STAGE_FLOATS;
    float* bs = as + A_FLOATS;
    const int k0 = slab * BK;
    if (!A_KFAST) {   // BK rows of BM: 32 chunks a row
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / (BM / 4), m = (idx % (BM / 4)) * 4;
        const int gm = m0 + m, gk = k0 + k;
        const int valid = gk < K ? clamp_len(M - gm, 4) : 0;
        copy16(as + k * AS_LD + m, valid ? a + gk * lda + gm : a, valid, vec);
      }
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / (BN / 4), n = (idx % (BN / 4)) * 4;
      const int gk = k0 + k, gn = n0 + n;
      const int valid = gk < K ? clamp_len(N - gn, 4) : 0;
      copy16(bs + k * BN + n, valid ? b + gk * ldb + gn : b, valid, vec);
    }
  };
  float4 areg[BM * BK / 4 / THREADS];
  auto fetch_a = [&](int slab) {   // A_KFAST: BM rows of BK, 4 chunks a row
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int gm = m0 + idx / (BK / 4), gk = slab * BK + (idx % (BK / 4)) * 4;
      const int valid = gm < M ? clamp_len(K - gk, 4) : 0;
      const float* src = a + gm * lda + gk;
      if (vec && valid == 4) {
        areg[i] = *reinterpret_cast<const float4*>(src);
      } else {
        areg[i] = make_float4(valid > 0 ? src[0] : 0.f, valid > 1 ? src[1] : 0.f,
                              valid > 2 ? src[2] : 0.f, valid > 3 ? src[3] : 0.f);
      }
    }
  };
  auto store_a = [&](int st) {
    float* as = smf + st * STAGE_FLOATS;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int m = idx / (BK / 4), k = (idx % (BK / 4)) * 4;
      as[(k + 0) * AS_LD + m] = areg[i].x;
      as[(k + 1) * AS_LD + m] = areg[i].y;
      as[(k + 2) * AS_LD + m] = areg[i].z;
      as[(k + 3) * AS_LD + m] = areg[i].w;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) {
      load(s, s);
      if (A_KFAST) {
        fetch_a(s);
        store_a(s);
      }
    }
    cp_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < nslab; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = s + STAGES - 1;
    if (nx < nslab) {
      load(nx, nx % STAGES);
      if (A_KFAST) fetch_a(nx);
    }
    cp_commit();
    const float* as = smf + (s % STAGES) * STAGE_FLOATS;
    const float* bs = as + A_FLOATS;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + k * AS_LD + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * AS_LD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * BN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * BN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (A_KFAST && nx < nslab) store_a(nx % STAGES);
  }

  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
    float* row = out + (size_t)gm * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gn = n0 + half * 64 + tx * 4;
      const float* v = &acc[i][4 * half];
      if (vec_out && gn + 3 < N) {
        *reinterpret_cast<float4*>(row + gn) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[gn + j] = v[j];
      }
    }
  }
}

int launch(const float* a, const float* b, float* out, int M, int K, int N,
           long long sam, long long sak, long long ldb, bool vec,
           cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (sak == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<true><<<grid, THREADS, SMEM, s>>>(a, b, out, M, K, N, sam, ldb,
                                             vec);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<false><<<grid, THREADS, SMEM, s>>>(a, b, out, M, K, N, sak, ldb,
                                              vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace sgemm

// -------------------------------------------------------------- wgmma ----

namespace tc {

constexpr int BM = 128;                  // two consumer warpgroups of 64
constexpr int BN = 128;
constexpr int BK = 64;                   // 128 bytes of bf16: one swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int TILE = 16384;              // bytes of one a or one b tile
constexpr int CHUNK = 8192;              // 64 rows x 128 bytes
constexpr int STAGE_BYTES = 2 * TILE;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int OUT_LD = BN + 8;           // staging row (floats), no conflicts
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;   // + alignment slack
static_assert(2 * 64 * OUT_LD * 4 <= BAR_OFF, "staging fits in the ring");
static_assert(2 * SMEM <= 232448, "two blocks an SM");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A_KFAST: a is K-contiguous (L); else M-contiguous (A, n^T).
template <bool A_KFAST>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const __grid_constant__ CUtensorMap amap,
       const __grid_constant__ CUtensorMap bmap, float* __restrict__ out,
       int M, int K, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full = base + BAR_OFF;        // full[s] = full + 8 s
  const uint32_t empty = full + 8 * STAGES;    // empty[s] = empty + 8 s
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nslab = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);   // one arrival per warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: stage s holds a's tile at +0 and b's at +TILE
    if (tid == CONSUMERS) {
      for (int j = 0; j < nslab; ++j) {
        const int s = j % STAGES;
        bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        const uint32_t st = base + s * STAGE_BYTES;
        bar_expect_tx(fb, STAGE_BYTES);
        if (A_KFAST) {   // one box: 128 m rows x 64 k
          tma_load_2d(st, &amap, fb, j * BK, m0);
        } else {         // two boxes: 64 k rows x 64 m, one per warpgroup
          tma_load_2d(st, &amap, fb, m0, j * BK);
          tma_load_2d(st + CHUNK, &amap, fb, m0 + 64, j * BK);
        }
        tma_load_2d(st + TILE, &bmap, fb, n0, j * BK);
        tma_load_2d(st + TILE + CHUNK, &bmap, fb, n0 + 64, j * BK);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int j = 0; j < nslab; ++j) {
    const int s = j % STAGES;
    bar_wait(full + 8 * s, (j / STAGES) & 1);
    const uint32_t at = base + s * STAGE_BYTES + wg * CHUNK;
    const uint32_t bt = base + s * STAGE_BYTES + TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc(bt + kk * 16 * 128, CHUNK, 1024);
      if (A_KFAST)
        mma_ss_n128<0, 1>(acc, desc(at + kk * 32, 16, 1024), db, 1);
      else
        mma_ss_n128<1, 1>(acc, desc(at + kk * 16 * 128, CHUNK, 1024), db, 1);
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[i]);
    if (lane == 0) bar_arrive(empty + 8 * s);
  }

  // epilogue: accumulators -> shared memory (the ring, now idle) ->
  // coalesced rows of out. acc[4c + e]: row 16 warp + lane/4 (+8 for
  // e >= 2), column 8c + 2 (lane % 4) + e % 2.
  consumers_sync();   // both warpgroups are done reading the ring
  float* stage = reinterpret_cast<float*>(base_ptr) + wg * 64 * OUT_LD;
  const int r0 = 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    *reinterpret_cast<float2*>(stage + r0 * OUT_LD + col) =
        make_float2(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<float2*>(stage + (r0 + 8) * OUT_LD + col) =
        make_float2(acc[4 * c + 2], acc[4 * c + 3]);
  }
  consumers_sync();
  const bool vec_out = (N % 4) == 0;
  const int t = tid % 128;
#pragma unroll 4
  for (int r = t / 32; r < 64; r += 4) {
    const int gm = m0 + 64 * wg + r;
    if (gm >= M) continue;
    const int c = 4 * (t % 32), gn = n0 + c;
    const float4 v = *reinterpret_cast<const float4*>(stage + r * OUT_LD + c);
    float* row = out + (size_t)gm * N;
    if (vec_out && gn + 3 < N) {
      *reinterpret_cast<float4*>(row + gn) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gn + q < N) row[gn + q] = e[q];
    }
  }
}

// A row-major bf16 matrix of `rows` rows (row stride ld elements, `cols`
// of them real) as a 2-d map, boxes of box_c columns x box_r rows, 128-byte
// swizzle; reads past the edge give zeros.
bool make_map(CUtensorMap* map, const void* ptr, long long rows,
              long long cols, long long ld, int box_c, int box_r) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const __nv_bfloat16* a, const __nv_bfloat16* b, float* out, int M,
           int K, int N, long long sam, long long sak, long long ldb,
           cudaStream_t s) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const long long lda = sak == 1 ? sam : sak;
  if (lda % 8 != 0 || ldb % 8 != 0 || (uintptr_t)a % 16 != 0 ||
      (uintptr_t)b % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  const bool kfast = sak == 1;
  // a: L, [M rows, K cols]; A, [K rows, M cols] (n itself)
  const bool ok_a = kfast ? make_map(&am, a, M, K, lda, BK, BM)
                          : make_map(&am, a, K, M, lda, 64, BK);
  if (!ok_a || !make_map(&bm, b, K, N, ldb, 64, BK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto* fn = kfast ? kernel<true> : kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, THREADS, SMEM, s>>>(am, bm, out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace tc

// form: kernels/tvm_estep.py FORMS (0 stream, 1 sgemm, 2 wgmma)
template <typename T>
int dispatch(const T* a, const T* b, float* out, int M, int K, int N,
             long long sam, long long sak, long long ldb, int form,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!((sak == 1 && sam >= K) || (sam == 1 && sak >= M)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int E = 16 / sizeof(T);
  const long long lda = sak == 1 ? sam : sak;
  const bool vec = lda % E == 0 && ldb % E == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)b % 16 == 0;
  if (form == 0) return stream::launch(a, b, out, M, K, N, sam, sak, ldb, vec, s);
  if constexpr (sizeof(T) == 4) {
    if (form == 1) return sgemm::launch(a, b, out, M, K, N, sam, sak, ldb, vec, s);
  } else {
    if (form == 2) return tc::launch(a, b, out, M, K, N, sam, sak, ldb, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int packed_matmul_f32(const void* a, const void* b, float* out,
                                 int M, int K, int N, long long sam,
                                 long long sak, long long ldb, int form,
                                 int device, void* stream) {
  return dispatch(static_cast<const float*>(a), static_cast<const float*>(b),
                  out, M, K, N, sam, sak, ldb, form, device, stream);
}

extern "C" int packed_matmul_bf16(const void* a, const void* b, float* out,
                                  int M, int K, int N, long long sam,
                                  long long sak, long long ldb, int form,
                                  int device, void* stream) {
  return dispatch(static_cast<const __nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(b), out, M, K, N, sam,
                  sak, ldb, form, device, stream);
}
