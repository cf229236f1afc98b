"""CUDA kernel wrapper: causal GQA flash attention, forward.

Launches ``csrc/flash_attention.cu`` (which says what it replaces, what
bounds it and how it is laid out). The kernel masks ragged S itself, so
any S is exact. ``ops.flash_attention`` dispatches here for CUDA tensors
and to ``ref.flash_attention`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q, k, v):
    """q: [B, S, H, hd]; k, v: [B, S, KVH, hd], one dtype (float32 or
    bfloat16), contiguous on one CUDA device; H a multiple of KVH, hd a
    multiple of 16 up to 256 -> o [B, S, H, hd] in q's dtype. The scores
    and p stay f32 inside the kernel."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a "
                         "multiple of 16 up to 256")
    _build.require_cuda("flash_attention", q, k, v)
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: operands must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    o = torch.empty_like(q)
    err = getattr(_build.load("flash_attention"), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        KVH, hd, *_build.launch_args(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
