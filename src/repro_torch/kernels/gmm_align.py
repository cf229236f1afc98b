"""CUDA kernel wrappers: fused alignment (diag preselect, top-K and packed
rescore in one launch), and its rescore alone for a given selection.

Both launch the one kernel of ``csrc/gmm_align.cu`` (which says what it
replaces, what bounds it and how it is laid out); ``gmm_rescore_fused``
hands it the selection instead of letting it choose. The kernel masks
ragged F and C itself. Ids given to ``gmm_rescore_fused`` must lie in
[0, C): ``ops.gmm_rescore_fused`` clips them. ``streaming_topk`` is the
kernel's top-K in plain tensor code, ``select_topk`` the spill form's
selection and ``geometry`` its blocks and forms.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# csrc/gmm_align.cu: components per chunk, coefficient d-rows per slab,
# slabs in flight, the largest K of the streaming merge, frames per block
# of the streaming instance, the whole-row instance's frame slots in the
# product and the frames a block of it keeps (the most that fit, of
# these), shared memory a block may have, threads a block, threads of the
# spill form's select block, the key of -inf, the slots a block of the
# rescore alone takes (its grid's second axis)
THREADS = 256
SEL_THREADS = 256
SLOT_SPLIT = 256
KEY_NINF = 0x007FFFFF
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


class Geometry(NamedTuple):
    rows: int            # frames a block keeps (the spill's preselect: 64)
    stream: bool         # the streaming merge
    smem: int            # shared-memory bytes a block
    spill: bool          # the spill form: preselect, select, rescore
    wide: bool           # phase B's pair table in device memory


def smem_bytes(C: int, D: int, stream: bool, rows: int, wide: bool = False,
               spill: bool = False) -> int:
    """Shared memory of a block of the streaming or the whole-row instance
    keeping ``rows`` frames (``smem_words`` in csrc/gmm_align.cu): the
    larger of phase A (the slab ring, x d-major for the product's frame
    slots, then the chunk's scores and the merge's lists and buffers, or
    whole score rows, or in the spill form nothing) and phase B (the pair
    table and the frames' rows, or, ``wide``, a row a warp; none in the
    spill form's preselect)."""
    E2 = 1 + D + D * (D + 1) // 2
    slots = BF_STREAM if stream or spill else BF_PRODUCT_ROWS
    phase_a = (STAGES * 2 * BKD * NC + _round_up(D, BKD) * slots
               + (0 if spill else
                  rows * NC + 4 * rows * STREAM_K + 2 * rows if stream
                  else rows * _round_up(C, NC)))
    phase_b = (0 if spill else THREADS // 32 * (2 * D + 2) if wide
               else _round_up(E2, 4) + rows * (2 * D + 2))
    return 4 * max(phase_a, phase_b)


def geometry(C: int, D: int, K: int, rescore_only: bool = False):
    """The kernel's blocks and form for these shapes (``geometry`` and
    ``smem_words`` in csrc/gmm_align.cu): the streaming instance for K <=
    STREAM_K and for the rescore alone, else whole score rows for the most
    frames of BF_ROWS that fit; each with phase B's pair table in shared
    memory, else wide (in device memory). For K > STREAM_K where no
    whole-row block fits, the spill form (its preselect's 64-frame blocks
    and shared memory, its rescore's ``wide``). Raises where none fits (D
    above 552)."""
    stream = rescore_only or K <= STREAM_K
    for wide in (False, True):
        for bf in (BF_STREAM,) if stream else BF_ROWS:
            smem = smem_bytes(C, D, stream, bf, wide)
            if smem <= MAX_SMEM:
                return Geometry(bf, stream, smem, False, wide)
    if not stream:
        r = geometry(C, D, K, rescore_only=True)
        smem = smem_bytes(C, D, False, BF_STREAM, spill=True)
        if smem <= MAX_SMEM:
            return Geometry(BF_STREAM, False, smem, True, r.wide)
    raise ValueError(
        f"gmm_align: C={C}, D={D}, K={K} needs {smem} bytes of shared "
        f"memory a block, above the {MAX_SMEM} a block may have")


def kernel_geometry(C: int, D: int, K: int, rescore_only: bool = False):
    """What ``geometry`` gives, as the CUDA side computes it for the launch
    (``gmm_align_geometry``), or None where it refuses the shapes."""
    out = (ctypes.c_int * 5)()
    err = _build.load("gmm_align").gmm_align_geometry(
        C, D, K, int(rescore_only), ctypes.addressof(out))
    return None if err else Geometry(out[0], bool(out[1]), out[2],
                                     bool(out[3]), bool(out[4]))


def spill_words(F: int, C: int, K: int) -> int:
    """int32 words of the spill form's scratch: the scores [F, Cp] (Cp = C
    rounded up to NC), then keys and ids [F, K] twice."""
    return F * _round_up(C, NC) + 4 * F * K


def pair_table(D: int, device=None) -> torch.Tensor:
    """int32 [E2]: phase B's code i0 | i1 << 16 of each expansion entry, as
    the kernel builds it in shared memory and its wide form reads it, over a
    frame's row [x | 1 | 2x | 1]: e = 0 is (D, D), e = 1 + d is (d, D), then
    each upper-triangle pair (i, j) in ``ref._quad_pairs``' order is (i, j)
    on the diagonal and (i, D + 1 + j) off it."""
    i = torch.arange(D)
    t0, t1 = torch.triu_indices(D, D)
    first = torch.cat([torch.tensor([D]), i, t0])
    second = torch.cat([torch.tensor([D]), torch.full((D,), D),
                        torch.where(t0 == t1, t1, D + 1 + t1)])
    table = (first | second << 16).to(torch.int32)
    return table if device is None else table.to(device)


@functools.lru_cache(maxsize=8)
def _table_on(D: int, device: torch.device) -> torch.Tensor:
    return pair_table(D, device)


def order_keys(scores):
    """The select kernel's keys of scores [F, C] f32 in plain tensor code:
    int64 values of the uint32 keys, larger for better scores; NaN above
    every score and -0 as +0."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    u = s.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 2 ** 31)
    return torch.where(torch.isnan(scores), 0xFFFFFFFF, key)


def select_topk(scores, top_k: int):
    """The spill form's selection (``select_kernel``) in plain tensor code,
    pass by pass: scores [F, C] -> sel [F, K] int64. Per frame: a NaN below
    C-1 gives C-1 in every slot; else the keys (``order_keys``); for K < C
    a radix select over 8-bit digits, most significant first, finds the
    K-th key T and how many keys equal to T to take; the winners in id
    order (every key above T, the lowest ids of those equal to it); four
    stable passes over their digits, least significant first, each
    descending; a slot whose key is -inf's takes id 0."""
    F, C = scores.shape
    K = top_k
    keys = order_keys(scores)
    out = torch.empty((F, K), dtype=torch.int64, device=scores.device)
    for f in range(F):
        if torch.isnan(scores[f, :C - 1]).any():
            out[f] = C - 1
            continue
        k = keys[f]
        T, mask, need = 0, 0, 0
        if K < C:
            need = K
            for shift in (24, 16, 8, 0):
                sub = k[(k & mask) == T]
                hist = torch.bincount((sub >> shift) & 255, minlength=256)
                cum, b = 0, 255
                while b > 0 and cum + int(hist[b]) < need:
                    cum += int(hist[b])
                    b -= 1
                T |= b << shift
                mask |= 255 << shift
                need -= cum
            eq = k == T
            take = (k > T) | (eq & (torch.cumsum(eq.long(), 0) <= need))
        else:
            take = torch.ones_like(k, dtype=torch.bool)
        ids = torch.nonzero(take)[:, 0]             # id order
        kk = k[ids]
        for shift in (0, 8, 16, 24):
            order = torch.sort((kk >> shift) & 255, descending=True,
                               stable=True).indices
            kk, ids = kk[order], ids[order]
        out[f] = torch.where(kk == KEY_NINF, 0, ids)
    return out


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


def gmm_align(x, dconst, dlin, dquad, A2, top_k: int, scratch=None):
    """x: [F, D]; dconst: [C]; dlin, dquad: [D, C]; A2: [C, E2], f32 on one
    CUDA device -> (sel_ll [F, K] f32, sel [F, K] int64). ``scratch``: the
    spill form's int32 buffer of ``spill_words(F, C, K)`` words, for a
    caller that reads back the preselect's scores (its first F x Cp words,
    float32 [F, Cp]); allocated here when None."""
    F, D, C, E2 = _check("gmm_align", x, A2, dconst, dlin, dquad)
    if dconst.shape != (C,) or dlin.shape != (D, C) or dquad.shape != (D, C):
        raise ValueError(f"gmm_align: diag coefficients {tuple(dconst.shape)}"
                         f", {tuple(dlin.shape)}, {tuple(dquad.shape)} for "
                         f"C={C}, D={D}")
    if not 1 <= top_k <= C:
        raise ValueError(f"gmm_align: top_k={top_k} outside [1, C={C}]")
    g = geometry(C, D, top_k)
    dlin, dquad = _build.aligned(dlin), _build.aligned(dquad)
    pair = _table_on(D, x.device).data_ptr() if g.wide else None
    words = spill_words(F, C, top_k)
    if not (g.spill and F):
        scratch = None
    elif scratch is None:
        scratch = torch.empty(words, dtype=torch.int32, device=x.device)
    elif (scratch.dtype != torch.int32 or scratch.device != x.device
          or not scratch.is_contiguous() or scratch.numel() < words):
        raise ValueError(f"gmm_align: scratch must be {words} contiguous "
                         f"int32 words on {x.device}")
    ll = torch.empty((F, top_k), dtype=torch.float32, device=x.device)
    sel = torch.empty((F, top_k), dtype=torch.int64, device=x.device)
    err = _build.load("gmm_align").gmm_align_f32(
        x.data_ptr(), dconst.data_ptr(), dlin.data_ptr(), dquad.data_ptr(),
        A2.data_ptr(), pair, None if scratch is None else scratch.data_ptr(),
        ll.data_ptr(), sel.data_ptr(), F, C, D, top_k, E2,
        *_build.launch_args(x))
    _build.check(err, "gmm_align")
    gmm_align.launches += 1
    _count_form(gmm_align, g)
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
    g = geometry(C, D, K, rescore_only=True)
    pair = _table_on(D, x.device).data_ptr() if g.wide else None
    ll = torch.empty((F, K), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_align").gmm_rescore_fused_f32(
        x.data_ptr(), sel.data_ptr(), A2.data_ptr(), pair, ll.data_ptr(), F,
        C, D, K, E2, *_build.launch_args(x))
    _build.check(err, "gmm_rescore_fused")
    gmm_rescore_fused.launches += 1
    _count_form(gmm_rescore_fused, g)
    return ll


def _count_form(fn, g: Geometry) -> None:
    """One launch of ``fn`` by the forms it took: the spill form, and wide
    phase B (both where the spill form's rescore is wide)."""
    if g.spill:
        fn.by_form["spill"] += 1
    if g.wide:
        fn.by_form["wide"] += 1


gmm_align.launches = 0
gmm_rescore_fused.launches = 0
# launches by the forms past the streaming and whole-row instances
gmm_align.by_form = {"spill": 0, "wide": 0}
gmm_rescore_fused.by_form = {"spill": 0, "wide": 0}
