"""CUDA kernel wrapper: dense Baum-Welch moments n, f and S.

Launches ``csrc/bw_stats.cu`` (which says what it replaces, what bounds it
and how it is laid out): one SGEMM Γᵀ X₂ over the extended columns that
``pair_table`` codes, on frames cut into ``splits`` runs whose partial sums
the kernel's second pass adds in a fixed order. The kernel masks ragged F
and C itself. ``ops.bw_stats`` dispatches here for CUDA tensors and to
``ref.bw_stats`` for CPU tensors; ``moments`` is the kernel's arithmetic in
plain tensor code.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

# csrc/bw_stats.cu: component and column tile, frames per slab, slabs in
# flight, threads a block, shared memory a block may have, blocks an SM
BM = 128
BN = 128
BK = 16
STAGES = 4
THREADS = 256
MAX_SMEM = 232448
BLOCKS_PER_SM = 2
MAX_SPLITS = 8
MIN_SPLIT_FRAMES = 1024


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(D: int) -> int:
    """Shared memory of a block of the main pass (``smem_bytes`` in
    csrc/bw_stats.cu): the ring of (Γ, x) slabs, x's rows padded to
    (D + 2) rounded up to 4, two X₂ slabs, the pair codes and the slabs'
    frame ids."""
    xs_ld = _round_up(D + 2, 4)
    return (4 * (STAGES * (BK * BM + BK * xs_ld) + 2 * BK * BN)
            + 4 * (BN + STAGES * BK))


def n_columns(D: int) -> int:
    """E = D(D+1)/2 + D + 1: S's upper triangle, f, n."""
    return D * (D + 1) // 2 + D + 1


def kernel_smem(D: int):
    """``smem_bytes`` as the CUDA side computes it (``bw_stats_geometry``),
    or None where it refuses D."""
    out = (ctypes.c_int * 1)()
    err = _build.load("bw_stats").bw_stats_geometry(D, ctypes.addressof(out))
    return None if err else out[0]


def pair_table(D: int, device=None) -> torch.Tensor:
    """int32 [Ep] (Ep = E rounded up to BN): extended column e is
    X₂[f, e] = x̃[f, i0] x̃[f, i1], code i0 | i1 << 16, over x̃ = [x | 1 |
    0]. e < P: the e-th upper-triangle pair (i, j), i <= j, row-major (the
    order of ``ref._quad_pairs``); then (d, D) for x_d; (D, D) for the ones
    column (n); (D+1, D+1) past E. Raises where a block of the kernel
    would not fit in shared memory (D above 710)."""
    if smem_bytes(D) > MAX_SMEM:
        raise ValueError(f"bw_stats: D={D} needs {smem_bytes(D)} bytes of "
                         f"shared memory a block, above the {MAX_SMEM} a "
                         f"block may have")
    i0, i1, _ = ref._quad_pairs(D)
    d = torch.arange(D)
    first = torch.cat([i0, d, torch.tensor([D])])
    second = torch.cat([i1, torch.full((D,), D), torch.tensor([D])])
    E = n_columns(D)
    pad = _round_up(E, BN) - E
    first = torch.cat([first, torch.full((pad,), D + 1)])
    second = torch.cat([second, torch.full((pad,), D + 1)])
    table = (first | second << 16).to(torch.int32)
    return table if device is None else table.to(device)


@functools.lru_cache(maxsize=8)
def _table_on(D: int, device: torch.device) -> torch.Tensor:
    return pair_table(D, device)


def splits(F: int, C: int, D: int, n_sm: int) -> int:
    """The number of runs each tile's frames are cut into: at most
    MAX_SPLITS, each at least MIN_SPLIT_FRAMES (unless F is smaller), the
    count whose blocks fill the card's 2-a-SM slots in the fewest
    part-empty waves; ties go to fewer splits."""
    tiles = -(-C // BM) * (_round_up(n_columns(D), BN) // BN)
    slots = BLOCKS_PER_SM * n_sm
    most = max(1, min(MAX_SPLITS, F // MIN_SPLIT_FRAMES))
    best, best_fill = 1, 0.0
    for n in range(1, most + 1):
        blocks = tiles * n
        fill = blocks / (-(-blocks // slots) * slots)
        if fill > best_fill + 1e-9:
            best, best_fill = n, fill
    return best


def split_len(n: int, nsplit: int) -> int:
    """Frames per run when n frames are cut into nsplit runs: ceil(n /
    nsplit), rounded up to the kernel's 16-frame slab (csrc/bw_stats.cu,
    split_len); the last run may be shorter, or empty."""
    return _round_up(-(-n // nsplit), BK)


def frame_lists(gamma):
    """The compaction pass in plain tensor code: for each 128-component
    tile, the frames with a non-zero Γ in it, in frame order -> a list of
    int64 tensors, one per tile."""
    C = gamma.shape[1]
    return [torch.nonzero(gamma[:, t * BM:(t + 1) * BM].ne(0).any(dim=1))
            [:, 0] for t in range(-(-C // BM))]


def moments(gamma, x, table, nsplit: int = 1, compact: bool = False):
    """The kernel's function in plain tensor code: for each 128-component
    tile, its frames (all of them, or its ``frame_lists`` entry when
    ``compact``) cut into ``nsplit`` runs of ``split_len``; the partial
    Γᵀ X₂ over the coded columns per run, added in run order; each column
    scattered by its code. -> (n [C], f [C, D], S [C, D*D]) f32."""
    F, C = gamma.shape
    D = x.shape[1]
    E = n_columns(D)
    xt = torch.cat([x.float(), x.new_ones(F, 1), x.new_zeros(F, 1)], dim=1)
    code = table[:E].long().to(x.device)
    i0, i1 = code & 0xffff, code >> 16
    x2 = xt[:, i0] * xt[:, i1]                                  # [F, E]
    out = x2.new_empty((C, E))
    lists = frame_lists(gamma) if compact else None
    for t in range(-(-C // BM)):
        cols = slice(t * BM, (t + 1) * BM)
        frames = lists[t] if compact else torch.arange(F, device=x.device)
        per = split_len(frames.numel(), nsplit)
        acc = x2.new_zeros((gamma[:, cols].shape[1], E))
        for z in range(nsplit):
            run = frames[z * per:(z + 1) * per]
            acc = acc + gamma[run, cols].float().T @ x2[run]
        out[cols] = acc
    n, f, S = out.new_empty(C), out.new_empty(C, D), out.new_empty(C, D, D)
    n[:] = out[:, (i0 == D).nonzero()[0, 0]]
    is_f = (i1 == D) & (i0 < D)
    f[:, i0[is_f]] = out[:, is_f]
    is_s = i1 < D
    S[:, i0[is_s], i1[is_s]] = out[:, is_s]
    S[:, i1[is_s], i0[is_s]] = out[:, is_s]
    return n, f, S.reshape(C, D * D)


@functools.lru_cache(maxsize=4)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bw_stats(gamma, x, *, compact: bool = True):
    """gamma: [F, C]; x: [F, D], f32 on one CUDA device ->
    (n [C], f [C, D], S [C, D*D]) f32. Each component tile walks only the
    frames with a non-zero Γ in it, which a first pass lists (a tile that
    lists every frame walks them without the list); ``compact=False``
    walks every frame in every tile, the yardstick ``chip_smoke.py`` holds
    the compaction against."""
    F, C = gamma.shape
    if x.ndim != 2 or x.shape[0] != F:
        raise ValueError(f"bw_stats: shapes gamma {tuple(gamma.shape)}, "
                         f"x {tuple(x.shape)}")
    D = x.shape[1]
    _build.require_cuda("bw_stats", gamma, x)
    if gamma.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("bw_stats: the kernel takes float32 operands")
    dev = x.device
    table = _table_on(D, dev)
    nsplit = splits(F, C, D, _n_sm(dev))
    part = torch.empty((nsplit, C, table.shape[0]), dtype=torch.float32,
                       device=dev)
    T, Fp = -(-C // BM), max(F, 1)
    scratch = (None, None, None)
    if compact:
        flags = torch.empty((T, Fp), dtype=torch.uint8, device=dev)
        lists = torch.empty((T, Fp), dtype=torch.int32, device=dev)
        counts = torch.empty((T,), dtype=torch.int32, device=dev)
        scratch = (flags.data_ptr(), lists.data_ptr(), counts.data_ptr())
    n = torch.empty((C,), dtype=torch.float32, device=dev)
    f = torch.empty((C, D), dtype=torch.float32, device=dev)
    S = torch.empty((C, D * D), dtype=torch.float32, device=dev)
    err = _build.load("bw_stats").bw_stats_f32(
        gamma.data_ptr(), x.data_ptr(), table.data_ptr(), part.data_ptr(),
        *scratch, n.data_ptr(), f.data_ptr(), S.data_ptr(), F, Fp, C, D,
        table.shape[0], nsplit, *_build.launch_args(x))
    _build.check(err, "bw_stats")
    bw_stats.launches += 1
    return n, f, S


bw_stats.launches = 0
