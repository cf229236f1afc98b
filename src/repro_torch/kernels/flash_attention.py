"""CUDA kernel wrappers: causal GQA flash attention, forward and backward.

The forward launches ``csrc/flash_attention.cu`` (which says what it
replaces, what bounds it and how it is laid out): bf16 on the tensor
cores (``wgmma``, with p split into bf16 hi and lo parts so that P.V
keeps p's f32 precision), f32 on the CUDA cores. With ``lse=True`` it
also returns each row's log-sum-exp [B, H, S] f32, which the backward
(``csrc/flash_attention_bwd.cu``) recomputes the probabilities from. The
kernels mask ragged S themselves, so any S is exact.
``ops.flash_attention`` dispatches here for CUDA tensors (through an
autograd function when a gradient is wanted) and to
``ref.flash_attention`` for CPU tensors. ``backward_blocks`` is the
backward kernels' algorithm in plain tensor code, tile by tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# entry point and the kernel it runs, by input type
KERNELS = {
    torch.float32: ("flash_attention_f32", "CUDA-core f32"),
    torch.bfloat16: ("flash_attention_bf16", "tensor-core bf16 (wgmma)"),
}
BWD_KERNELS = {
    torch.float32: "flash_attention_bwd_f32",
    torch.bfloat16: "flash_attention_bwd_bf16",
}
# head dims with a bf16 instance, the tensor-core forward's (csrc:
# tc::dispatch) and the backward's (csrc/flash_attention_bwd.cu)
BF16_HEAD_DIMS = (64, 128, 192)
# csrc/flash_attention.cu: query rows a block, threads a block and (bf16)
# (k, v) tiles in flight, by input type
BQ = {torch.float32: 64, torch.bfloat16: 128}
THREADS = {torch.float32: 256, torch.bfloat16: 288}
TC_STAGES = 3
# csrc/flash_attention_bwd.cu: threads a block
BWD_THREADS = 256


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


def bwd_rows(hd: int) -> int:
    """Rows of a query or key tile of the backward (``Tile::BR``): 64 up
    to hd 128, 32 above."""
    return 64 if hd <= 128 else 32


def bwd_smem_bytes(hd: int) -> int:
    """Shared memory of a dK/dV block (``Tile::DKDV_FLOATS``, the larger
    of the two): the k, v, q and dO tiles [rows][hd + 1], P and dS
    [rows][rows + 1], the rows' lse and Delta, all f32."""
    br = bwd_rows(hd)
    return 4 * (4 * br * (hd + 1) + 2 * br * (br + 1) + 2 * br)


def _check_operands(name, q, k, v, bf16_dims, what):
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: operands must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16 and hd not in bf16_dims:
        raise ValueError(f"{name}: bf16 head_dim {hd} has no {what} "
                         f"instance; supported: {bf16_dims}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 16 "
                         "up to 256")


def flash_attention(q, k, v, lse: bool = False):
    """q: [B, S, H, hd]; k, v: [B, S, KVH, hd], one dtype (float32 or
    bfloat16), contiguous on one CUDA device; H a multiple of KVH; hd a
    multiple of 16 up to 256 in f32, one of ``BF16_HEAD_DIMS`` in bf16
    -> o [B, S, H, hd] in q's dtype, and with ``lse`` also the rows'
    log-sum-exp [B, H, S] f32. Scores stay f32 inside, and p keeps f32
    precision (in bf16 as a hi and lo pair)."""
    _check_operands("flash_attention", q, k, v, BF16_HEAD_DIMS,
                    "tensor-core")
    _build.require_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    out_lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
               if lse else None)
    err = getattr(_build.load("flash_attention"), KERNELS[q.dtype][0])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if out_lse is None else out_lse.data_ptr(), B, S, H,
        k.shape[2], hd, *_build.launch_args(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (o, out_lse) if lse else o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """The gradients of ``flash_attention``: q, k, v as there, o its
    output, lse its [B, H, S] f32 log-sum-exps, do the output's gradient
    (q's shape and dtype), all contiguous on one CUDA device -> (dq, dk,
    dv) in q's dtype. Takes the head dims the forward takes; no atomics,
    so the same bits every run."""
    _check_operands("flash_attention_bwd", q, k, v, BF16_HEAD_DIMS,
                    "backward")
    B, S, H, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"flash_attention_bwd: shapes o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}, lse {tuple(lse.shape)}")
    if (o.dtype != q.dtype or do.dtype != q.dtype
            or lse.dtype != torch.float32):
        raise TypeError("flash_attention_bwd: o and do in q's dtype, lse "
                        "float32")
    _build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = getattr(_build.load("flash_attention_bwd"), BWD_KERNELS[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, S, H, k.shape[2], hd,
        *_build.launch_args(q))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def lse_blocks(q, k, block: int = 64):
    """The rows' log-sum-exp [B, H, S] f32 of the scaled causal scores, as
    the forward kernels form it: a running max and sum over key tiles of
    ``block`` rows, each tile's sum rescaled to the new max."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, S, KVH, H // KVH, hd)
    kf = k.to(f32)
    pos = torch.arange(S, device=q.device)
    m = torch.full((B, S, KVH, H // KVH), -1e30, dtype=f32, device=q.device)
    lsum = torch.zeros_like(m)
    for k0 in range(0, S, block):
        s = torch.einsum("bqkgh,bskh->bqkgs", qf, kf[:, k0:k0 + block]
                         ) * hd ** -0.5
        ok = pos[:, None] >= pos[None, k0:k0 + block]
        s = torch.where(ok[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        lsum = lsum * torch.exp(m - m_new) + torch.exp(
            s - m_new[..., None]).sum(-1)
        m = m_new
    return (m + torch.log(lsum)).reshape(B, S, H).permute(0, 2, 1)


def backward_blocks(q, k, v, o, lse, do, block: int = 64):
    """The backward kernels' algorithm in plain tensor code, in f32, tile
    by tile (the CPU tests hold it against autograd of
    ``ref.flash_attention``): Delta = rowsum(dO o); the dQ pass walks the
    key tiles of each query tile up to the diagonal; the dK/dV pass walks,
    for each key tile, the group's query heads in order and their query
    tiles from the diagonal on; P = exp(s q.k - lse) recomputed in each
    pass. Same arguments and results as ``flash_attention_bwd``."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    f32 = torch.float32
    qf, kf, vf, of, dof = (t.to(f32) for t in (q, k, v, o, do))
    scale = hd ** -0.5
    delta = (dof * of).sum(-1).permute(0, 2, 1)            # [B, H, S]
    pos = torch.arange(S, device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    tiles = range(0, S, block)

    def tile_p_ds(h, q0, k0):
        qt, ot = qf[:, q0:q0 + block, h], dof[:, q0:q0 + block, h]
        kt, vt = kf[:, k0:k0 + block, h // G], vf[:, k0:k0 + block, h // G]
        s = torch.einsum("bqd,bkd->bqk", qt, kt) * scale
        ok = pos[q0:q0 + block, None] >= pos[None, k0:k0 + block]
        p = torch.where(ok[None], torch.exp(
            s - lse[:, h, q0:q0 + block, None]), 0.0)
        dp = torch.einsum("bqd,bkd->bqk", ot, vt)
        return p, p * (dp - delta[:, h, q0:q0 + block, None])

    for h in range(H):
        for q0 in tiles:
            acc = torch.zeros_like(dq[:, q0:q0 + block, h])
            for k0 in range(0, q0 + 1, block):
                _, ds = tile_p_ds(h, q0, k0)
                acc = acc + ds @ kf[:, k0:k0 + block, h // G]
            dq[:, q0:q0 + block, h] = acc * scale
    for kh in range(KVH):
        for k0 in tiles:
            acc_k = torch.zeros_like(dk[:, k0:k0 + block, kh])
            acc_v = torch.zeros_like(acc_k)
            for h in range(kh * G, kh * G + G):
                for q0 in range(k0, S, block):
                    p, ds = tile_p_ds(h, q0, k0)
                    acc_v = acc_v + p.transpose(1, 2) @ dof[:, q0:q0 + block,
                                                            h]
                    acc_k = acc_k + ds.transpose(1, 2) @ qf[:, q0:q0 + block,
                                                            h]
            dk[:, k0:k0 + block, kh] = acc_k * scale
            dv[:, k0:k0 + block, kh] = acc_v
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
