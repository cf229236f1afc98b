"""CUDA kernel wrapper: causal GQA flash attention, forward.

Launches ``csrc/flash_attention.cu`` (which says what it replaces, what
bounds it and how it is laid out): bf16 on the tensor cores (``wgmma``,
with p split into bf16 hi and lo parts so that P.V keeps p's f32
precision), f32 on the CUDA cores. The kernels mask ragged S themselves,
so any S is exact. ``ops.flash_attention`` dispatches here for CUDA
tensors and to ``ref.flash_attention`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# entry point and the kernel it runs, by input type
KERNELS = {
    torch.float32: ("flash_attention_f32", "CUDA-core f32"),
    torch.bfloat16: ("flash_attention_bf16", "tensor-core bf16 (wgmma)"),
}
# head dims with a bf16 tensor-core instance (csrc: tc::dispatch)
BF16_HEAD_DIMS = (64, 128, 192)
# csrc/flash_attention.cu: query rows a block, threads a block and (bf16)
# (k, v) tiles in flight, by input type
BQ = {torch.float32: 64, torch.bfloat16: 128}
THREADS = {torch.float32: 256, torch.bfloat16: 288}
TC_STAGES = 3


def kv_rows(dtype: torch.dtype, hd: int) -> int:
    """Key rows a (k, v) tile: 64 in f32; 128 in bf16 up to hd 128, else
    64 (``Layout::BKV``)."""
    return 128 if dtype == torch.bfloat16 and hd <= 128 else 64


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Shared memory of a block: f32 (``simt::smem_bytes``) the q and o
    tiles [64][hd + 1], a k or v tile [64][hd] and p [64][65]; bf16
    (``tc::Layout::BYTES``) the q tile, the ring of k and v tiles, the
    mbarriers and 1024 bytes of alignment slack."""
    if dtype == torch.float32:
        bq = BQ[dtype]
        return 4 * (2 * bq * (hd + 1) + 64 * hd + bq * 65)
    return (BQ[dtype] * hd * 2 + 2 * TC_STAGES * kv_rows(dtype, hd) * hd * 2
            + (2 * TC_STAGES + 1) * 8 + 1024)


def flash_attention(q, k, v):
    """q: [B, S, H, hd]; k, v: [B, S, KVH, hd], one dtype (float32 or
    bfloat16), contiguous on one CUDA device; H a multiple of KVH; hd a
    multiple of 16 up to 256 in f32, one of ``BF16_HEAD_DIMS`` in bf16
    -> o [B, S, H, hd] in q's dtype. Scores stay f32 inside, and p keeps
    f32 precision (in bf16 as a hi and lo pair)."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: operands must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16 and hd not in BF16_HEAD_DIMS:
        raise ValueError(f"flash_attention: bf16 head_dim {hd} has no "
                         f"tensor-core instance; supported: {BF16_HEAD_DIMS}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a "
                         "multiple of 16 up to 256")
    _build.require_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    o = torch.empty_like(q)
    err = getattr(_build.load("flash_attention"), KERNELS[q.dtype][0])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        KVH, hd, *_build.launch_args(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
