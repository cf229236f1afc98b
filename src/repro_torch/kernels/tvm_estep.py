"""CUDA kernel wrappers: the packed-symmetric TVM E-step contractions.

  L-assembly       L_packed[U, P] = n[U, C]   @ U_packed[C, P]
  A-accumulation   A_packed[C, P] = nᵀ[C, U] @ PP_packed[U, P]

Both launch the one kernel of ``csrc/packed_matmul.cu``; A hands it nᵀ as
strides over n, not as a copy. Inputs are both f32 or both bf16 (the
caller casts, ``ops._estep_cast``); the result is always f32. The kernel
masks ragged U, C and P itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_ENTRY = {torch.float32: "packed_matmul_f32",
          torch.bfloat16: "packed_matmul_bf16"}


def _packed_matmul(a, b, M, K, stride_m, stride_k):
    """a viewed as [M, K] through (stride_m, stride_k); b [K, N]."""
    _build.require_cuda("tvm_estep", a, b)
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"tvm_estep: operands must both be float32 or both "
                        f"bfloat16, got {a.dtype} and {b.dtype}")
    if b.shape[0] != K:
        raise ValueError(f"tvm_estep: reduction {K} against b "
                         f"{tuple(b.shape)}")
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = getattr(_build.load("packed_matmul"), _ENTRY[a.dtype])(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
        stride_m, stride_k, *_build.launch_args(a))
    _build.check(err, "packed_matmul")
    return out


def tvm_estep_l(n, U_packed):
    """n [U, C] @ U_packed [C, P] -> L_packed [U, P] f32."""
    U, C = n.shape
    out = _packed_matmul(n, U_packed, U, C, C, 1)
    tvm_estep_l.launches += 1
    return out


def tvm_estep_a(n, PP_packed):
    """nᵀ [C, U] @ PP_packed [U, P] -> A_packed [C, P] f32."""
    U, C = n.shape
    out = _packed_matmul(n, PP_packed, C, U, 1, C)
    tvm_estep_a.launches += 1
    return out


tvm_estep_l.launches = 0
tvm_estep_a.launches = 0
