"""CUDA kernel wrappers: fused alignment (diag preselect, top-K and packed
rescore in one launch), and its rescore alone for a given selection.

Both launch the one kernel of ``csrc/gmm_align.cu`` (which says what it
replaces, what bounds it and how it is laid out); ``gmm_rescore_fused``
hands it the selection instead of letting it choose. The kernel masks
ragged F and C itself. Ids given to ``gmm_rescore_fused`` must lie in
[0, C): ``ops.gmm_rescore_fused`` clips them. ``streaming_topk`` is the
kernel's top-K in plain tensor code and ``geometry`` its blocks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# csrc/gmm_align.cu: components per chunk, coefficient d-rows per slab,
# slabs in flight, the largest K of the streaming merge, frames per block
# of the streaming instance, the whole-row instance's frame slots in the
# product and the frames a block of it keeps (the most that fit, of
# these), shared memory a block may have, threads a block
THREADS = 256
NC = 128
BKD = 8
STAGES = 3
STREAM_K = 32
BF_STREAM = 64
BF_PRODUCT_ROWS = 16
BF_ROWS = (16, 8)
MAX_SMEM = 232448


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(C: int, D: int, stream: bool, rows: int) -> int:
    """Shared memory of a block of the streaming or the whole-row instance
    keeping ``rows`` frames (``smem_words`` in csrc/gmm_align.cu): the
    larger of phase A (the slab ring, x d-major for the product's frame
    slots, then the chunk's scores and the merge's lists and buffers, or
    whole score rows) and phase B (the pair table and the frames' rows)."""
    E2 = 1 + D + D * (D + 1) // 2
    slots = BF_STREAM if stream else BF_PRODUCT_ROWS
    phase_a = (STAGES * 2 * BKD * NC + _round_up(D, BKD) * slots
               + (rows * NC + 4 * rows * STREAM_K + 2 * rows if stream
                  else rows * _round_up(C, NC)))
    phase_b = _round_up(E2, 4) + rows * (2 * D + 2)
    return 4 * max(phase_a, phase_b)


def geometry(C: int, D: int, K: int, rescore_only: bool = False):
    """(frames per block, streaming merge?, shared-memory bytes) of the
    kernel for these shapes (``geometry`` and ``smem_words`` in
    csrc/gmm_align.cu): the streaming instance for K <= STREAM_K and for
    the rescore alone, else whole score rows for the most frames of
    BF_ROWS that fit. Raises where none fits in a block's shared memory."""
    stream = rescore_only or K <= STREAM_K
    for bf in (BF_STREAM,) if stream else BF_ROWS:
        smem = smem_bytes(C, D, stream, bf)
        if smem <= MAX_SMEM:
            return bf, stream, smem
    raise ValueError(
        f"gmm_align: C={C}, D={D}, K={K} needs {smem} bytes of shared "
        f"memory a block, above the {MAX_SMEM} a block may have")


def kernel_geometry(C: int, D: int, K: int, rescore_only: bool = False):
    """What ``geometry`` gives, as the CUDA side computes it for the launch
    (``gmm_align_geometry``), or None where it refuses the shapes."""
    out = (ctypes.c_int * 3)()
    err = _build.load("gmm_align").gmm_align_geometry(
        C, D, K, int(rescore_only), ctypes.addressof(out))
    return None if err else (out[0], bool(out[1]), out[2])


def smem_optin(device: int = 0) -> int:
    """The shared memory a block of card ``device`` may opt in to, as the
    CUDA runtime reads it (``device_smem_optin``)."""
    out = (ctypes.c_int * 1)()
    _build.check(_build.load("gmm_align").device_smem_optin(
        device, ctypes.addressof(out)), "device_smem_optin")
    return out[0]


def streaming_topk(scores, top_k: int, chunk: int = NC):
    """The kernel's selection in plain tensor code: scores [F, C] walked in
    chunks of ``chunk`` components, ascending; each chunk merged into a
    running best-``top_k`` list, best first, where an equal score never
    displaces an earlier (lower) id; at the end a slot whose entry is -inf
    takes id 0, then the NaN rule (a NaN below C-1: C-1 in every slot; a
    NaN at C-1 alone: C-1 first, then the best K-1 of the others): what
    ``ref.argmax_topk`` gives. -> sel [F, K] int64."""
    F, C = scores.shape
    dev = scores.device
    ninf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    lv = torch.full((F, top_k), float("-inf"), dtype=scores.dtype,
                    device=dev)
    li = torch.full((F, top_k), C, dtype=torch.int64, device=dev)  # lose
    for c0 in range(0, C, chunk):
        v = scores[:, c0:c0 + chunk]
        ids = torch.arange(c0, c0 + v.shape[1], device=dev).expand(F, -1)
        nan = torch.isnan(v)
        # a NaN never enters; it sorts with the sentinels, after every score
        v = torch.where(nan, ninf, v)
        ids = torch.where(nan, C, ids)
        # the best K by (score descending, id ascending): sort by id, then
        # stably by score
        allv, alli = torch.cat([lv, v], 1), torch.cat([li, ids], 1)
        order = torch.sort(alli, dim=1, stable=True).indices
        allv, alli = torch.gather(allv, 1, order), torch.gather(alli, 1, order)
        order = torch.sort(allv, dim=1, descending=True, stable=True).indices
        order = order[:, :top_k]
        lv, li = torch.gather(allv, 1, order), torch.gather(alli, 1, order)
    li = torch.where(lv == float("-inf"), 0, li)
    nan = torch.isnan(scores)
    last = nan[:, C - 1] & ~nan[:, :C - 1].any(dim=1)
    li = torch.where(last[:, None], torch.cat(
        [torch.full((F, 1), C - 1, device=dev), li[:, :top_k - 1]], 1), li)
    li = torch.where(nan[:, :C - 1].any(dim=1)[:, None], C - 1, li)
    return li.clamp(max=C - 1)


def _check(name, x, A2, *rest):
    F, D = x.shape
    E2 = A2.shape[1]
    if E2 != 1 + D + D * (D + 1) // 2:
        raise ValueError(f"{name}: A2 {tuple(A2.shape)} is not the packed "
                         f"rows of D={D}")
    _build.require_cuda(name, x, A2, *rest)
    if any(t.dtype != torch.float32 for t in (x, A2, *rest)):
        raise TypeError(f"{name}: the kernel takes float32 operands")
    return F, D, A2.shape[0], E2


def gmm_align(x, dconst, dlin, dquad, A2, top_k: int):
    """x: [F, D]; dconst: [C]; dlin, dquad: [D, C]; A2: [C, E2], f32 on one
    CUDA device -> (sel_ll [F, K] f32, sel [F, K] int64)."""
    F, D, C, E2 = _check("gmm_align", x, A2, dconst, dlin, dquad)
    if dconst.shape != (C,) or dlin.shape != (D, C) or dquad.shape != (D, C):
        raise ValueError(f"gmm_align: diag coefficients {tuple(dconst.shape)}"
                         f", {tuple(dlin.shape)}, {tuple(dquad.shape)} for "
                         f"C={C}, D={D}")
    if not 1 <= top_k <= C:
        raise ValueError(f"gmm_align: top_k={top_k} outside [1, C={C}]")
    geometry(C, D, top_k)
    dlin, dquad = _build.aligned(dlin), _build.aligned(dquad)
    ll = torch.empty((F, top_k), dtype=torch.float32, device=x.device)
    sel = torch.empty((F, top_k), dtype=torch.int64, device=x.device)
    err = _build.load("gmm_align").gmm_align_f32(
        x.data_ptr(), dconst.data_ptr(), dlin.data_ptr(), dquad.data_ptr(),
        A2.data_ptr(), ll.data_ptr(), sel.data_ptr(), F, C, D, top_k, E2,
        *_build.launch_args(x))
    _build.check(err, "gmm_align")
    gmm_align.launches += 1
    return ll, sel


def gmm_rescore_fused(x, sel, A2):
    """x: [F, D] f32; sel: [F, K] int64 in [0, C); A2: [C, E2] f32, all on
    one CUDA device -> [F, K] f32 selected log-likelihoods."""
    F, D, C, E2 = _check("gmm_rescore_fused", x, A2)
    _build.require_cuda("gmm_rescore_fused", sel)
    if sel.dtype != torch.int64 or sel.ndim != 2 or sel.shape[0] != F:
        raise ValueError(f"gmm_rescore_fused: sel must be int64 [{F}, K], "
                         f"got {sel.dtype} {tuple(sel.shape)}")
    K = sel.shape[1]
    geometry(C, D, K, rescore_only=True)
    ll = torch.empty((F, K), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_align").gmm_rescore_fused_f32(
        x.data_ptr(), sel.data_ptr(), A2.data_ptr(), ll.data_ptr(), F, C, D,
        K, E2, *_build.launch_args(x))
    _build.check(err, "gmm_rescore_fused")
    gmm_rescore_fused.launches += 1
    return ll


gmm_align.launches = 0
gmm_rescore_fused.launches = 0
