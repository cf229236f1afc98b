"""CUDA kernel wrappers: the packed-symmetric TVM E-step contractions.

  L-assembly       L_packed[U, P] = n[U, C]   @ U_packed[C, P]
  A-accumulation   A_packed[C, P] = nᵀ[C, U] @ PP_packed[U, P]

Both launch ``csrc/packed_matmul.cu`` on n itself: L reads it K-contiguous
(strides (C, 1)), A reads nᵀ M-contiguous (strides (1, C)), never a
transposed copy. Inputs are both f32 or both bf16 (the caller casts,
``ops._estep_cast``); the result is always f32. ``form`` picks the kernel
from the operands' type and M alone: ``stream`` for M <= 16 (L at serving),
``sgemm`` for f32 above, ``wgmma`` for bf16 above. The kernels mask ragged
U, C and P themselves; the wgmma form's TMA needs rows of a multiple of 8
elements, and ``tma_pad`` pads n or b into a scratch copy where they are
not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_ENTRY = {torch.float32: "packed_matmul_f32",
          torch.bfloat16: "packed_matmul_bf16"}
# the kernels of csrc/packed_matmul.cu, by the number its entry points take
FORMS = {"stream": 0, "sgemm": 1, "wgmma": 2}
STREAM_MAX_M = 16      # csrc/packed_matmul.cu, stream::MMAX
TMA_ALIGN = 8          # bf16 elements in 16 bytes
# csrc/packed_matmul.cu, by form: output tile (rows, columns), threads a
# block and slabs in flight (the stream form's tile is all M rows by 64)
TILE = {"stream": (STREAM_MAX_M, 64), "sgemm": (128, 128),
        "wgmma": (128, 128)}
THREADS = {"stream": 256, "sgemm": 256, "wgmma": 288}
STAGES = {"stream": 4, "sgemm": 3, "wgmma": 3}


def form(dtype: torch.dtype, M: int, K: int, N: int) -> str:
    """The kernel that computes an [M, K] @ [K, N] product of ``dtype``
    operands: the b-streaming kernel while M <= 16, else the CUDA-core
    SGEMM (f32) or the tensor cores (bf16). K and N choose nothing."""
    del K, N
    if M <= STREAM_MAX_M:
        return "stream"
    return "sgemm" if dtype == torch.float32 else "wgmma"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(f: str, esz: int) -> int:
    """Shared memory of a block of form ``f`` on ``esz``-byte inputs:
    stream (``stream::Shape::SMEM``), the larger of its ring of 128-byte-
    deep b and a slabs and the eight warps' sums; sgemm (``sgemm::SMEM``),
    its ring of a [16][132] and b [16][128] f32 slabs; wgmma
    (``tc::SMEM``), its ring of 16 KB a and b tiles, the mbarriers and
    1024 bytes of alignment slack."""
    if f == "stream":
        bk = 128 // esz
        stage = bk * 64 * esz + STREAM_MAX_M * (bk + 16 // esz) * esz
        return max(STAGES[f] * stage, 8 * STREAM_MAX_M * 64 * 4)
    if f == "sgemm":
        return 4 * STAGES[f] * (16 * 132 + 16 * 128)
    return STAGES[f] * 2 * 16384 + 2 * STAGES[f] * 8 + 1024


def tma_pad(t: torch.Tensor) -> torch.Tensor:
    """``t`` [rows, cols] itself when cols is a multiple of 8, else a
    zero-padded copy [rows, round_up(cols, 8)] (torch.empty, then filled):
    the rows TMA can address. The padding lies past the logical M, K or N,
    so it reads as the zeros TMA gives past an edge."""
    rows, cols = t.shape
    if cols % TMA_ALIGN == 0:
        return t
    out = torch.empty((rows, _round_up(cols, TMA_ALIGN)), dtype=t.dtype,
                      device=t.device)
    out[:, :cols] = t
    out[:, cols:] = 0
    return out


def check_strides(a, M: int, K: int, stride_m: int, stride_k: int) -> None:
    """a [rows, ld] row-major is read as [M, K] through (stride_m,
    stride_k): only (ld, 1) (K-contiguous, K <= ld, M <= rows) or (1, ld)
    (M-contiguous, M <= ld, K <= rows); anything else raises."""
    rows, ld = a.shape
    if (stride_m, stride_k) == (ld, 1):
        ok = K <= ld and M <= rows
    elif (stride_m, stride_k) == (1, ld):
        ok = M <= ld and K <= rows
    else:
        ok = False
    if not ok:
        raise ValueError(f"tvm_estep: a {tuple(a.shape)} cannot be read as "
                         f"[{M}, {K}] through strides "
                         f"({stride_m}, {stride_k}); the kernels take "
                         f"(row length, 1) or (1, row length)")


def plain(a, b, M: int, K: int, stride_m: int, stride_k: int):
    """The kernels' function in plain tensor code, on the same operands and
    strides (padded or not): a read as [M, K], b's first K rows; f32."""
    check_strides(a, M, K, stride_m, stride_k)
    A = torch.as_strided(a, (M, K), (stride_m, stride_k))
    return A.to(torch.float32) @ b[:K].to(torch.float32)


def packed_matmul(a, b, M: int, K: int, stride_m: int, stride_k: int):
    """a [rows, ld] viewed as [M, K] through (stride_m, stride_k); b [K', N]
    with K' >= K -> ([M, N] f32, "<dtype>_<form>" of the kernel that ran)."""
    check_strides(a, M, K, stride_m, stride_k)
    _build.require_cuda("tvm_estep", a, b)
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"tvm_estep: operands must both be float32 or both "
                        f"bfloat16, got {a.dtype} and {b.dtype}")
    if b.shape[0] < K:
        raise ValueError(f"tvm_estep: reduction {K} against b "
                         f"{tuple(b.shape)}")
    N = b.shape[1]
    f = form(a.dtype, M, K, N)
    if f == "wgmma":
        kfast = stride_k == 1
        a, b = tma_pad(a), tma_pad(b)
        ld = a.shape[1]
        stride_m, stride_k = (ld, 1) if kfast else (1, ld)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = getattr(_build.load("packed_matmul"), _ENTRY[a.dtype])(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
        stride_m, stride_k, b.shape[1], FORMS[f], *_build.launch_args(a))
    _build.check(err, "packed_matmul")
    return out, f"{str(a.dtype).removeprefix('torch.')}_{f}"


def _count(wrapper, key: str) -> None:
    wrapper.launches += 1
    wrapper.by_form[key] += 1


def tvm_estep_l(n, U_packed):
    """n [U, C] @ U_packed [C, P] -> L_packed [U, P] f32."""
    U, C = n.shape
    out, key = packed_matmul(n, U_packed, U, C, C, 1)
    _count(tvm_estep_l, key)
    return out


def tvm_estep_a(n, PP_packed):
    """nᵀ [C, U] @ PP_packed [U, P] -> A_packed [C, P] f32."""
    U, C = n.shape
    out, key = packed_matmul(n, PP_packed, C, U, 1, C)
    _count(tvm_estep_a, key)
    return out


def reset_counts() -> None:
    """Launch counts, in all and by "<dtype>_<form>", set to 0."""
    for w in (tvm_estep_l, tvm_estep_a):
        w.launches = 0
        w.by_form = dict.fromkeys(("float32_stream", "float32_sgemm",
                                   "bfloat16_stream", "bfloat16_wgmma"), 0)


reset_counts()
