"""CUDA kernel wrapper: dense Baum-Welch moments n, f and S.

Launches ``csrc/bw_stats.cu`` (which says what it replaces, what bounds it
and how it is laid out): one SGEMM Γᵀ X₂ over the extended columns that
``table`` codes, on frames cut into ``splits`` runs whose partial sums
the kernel's second pass adds in a fixed order. ``geometry`` gives the
form for D: rows (``pair_table``'s columns in 128-column tiles; D a
multiple of 4 up to 252) or pairs (``pairs_table``'s (I, J) tiles of S's
upper triangle; every other D). The kernel masks ragged F and C itself.
``ops.bw_stats`` dispatches here for CUDA tensors and to ``ref.bw_stats``
for CPU tensors; ``moments`` is the kernel's arithmetic in plain tensor
code.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

# csrc/bw_stats.cu: the rows form's component and column tile, frames per
# slab, slabs in flight, threads a block, shared memory a block may have,
# the largest D; the pairs form's component tile, index block, columns a
# tile and slabs in flight
BM = 128
BN = 128
BK = 16
STAGES = 4
THREADS = 256
MAX_SMEM = 232448
MAX_D = 4095
PM = 64
PB = 16
PN = PB * PB
PSTAGES = 8
# an SM's shared memory and what the card reserves of it a block; both
# forms' kernels are built for two blocks an SM (__launch_bounds__)
SM_SMEM = 233472
BLOCK_RESERVED = 1024
REG_BLOCKS = 2
MAX_SPLITS = 8
MIN_SPLIT_FRAMES = 1024


class Geometry(NamedTuple):
    pairs: bool          # the pairs form (else rows)
    smem: int            # shared-memory bytes a block
    tile: int            # components a block
    cols: int            # Ep, the columns of the table and the partials
    blocks: int          # blocks an SM


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pairs_form(D: int) -> bool:
    """The pairs form runs at every D but the multiples of 4 up to 252."""
    return D % 4 != 0 or D > 252


def pairs_columns(D: int) -> int:
    """Ep of the pairs form: PN columns for each (I, J) of the
    ceil(D / PB) index blocks, I <= J."""
    nb = -(-D // PB)
    return nb * (nb + 1) // 2 * PN


def smem_bytes(D: int) -> int:
    """Shared memory of a block of the main pass at D (csrc/bw_stats.cu):
    the rows form's ring of (Γ, x) slabs with x's rows padded to (D + 2)
    rounded up to 4, two X₂ slabs, the pair codes and the slabs' frame
    ids (``smem_bytes``); the pairs form's ring of (Γ, x at 2 PB + 1
    columns) slabs, two X₂ slabs and the frame ids, whatever D
    (``pairs::smem_bytes``)."""
    if pairs_form(D):
        return (4 * (PSTAGES * (BK * PM + BK * (2 * PB + 1)) + 2 * BK * PN)
                + 4 * PSTAGES * BK)
    xs_ld = _round_up(D + 2, 4)
    return (4 * (STAGES * (BK * BM + BK * xs_ld) + 2 * BK * BN)
            + 4 * (BN + STAGES * BK))


def n_columns(D: int) -> int:
    """E = D(D+1)/2 + D + 1: S's upper triangle, f, n."""
    return D * (D + 1) // 2 + D + 1


def geometry(D: int) -> Geometry:
    """The launch for D (``bw_stats_geometry`` in csrc/bw_stats.cu): its
    form, shared memory, component tile, columns and blocks an SM (two,
    the kernels' register budget, unless shared memory holds fewer).
    Raises outside 1..MAX_D."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"bw_stats: D={D} is outside 1..{MAX_D} (the "
                         f"codes' 16-bit fields)")
    pairs = pairs_form(D)
    smem = smem_bytes(D)
    blocks = min(REG_BLOCKS, SM_SMEM // (smem + BLOCK_RESERVED))
    cols = pairs_columns(D) if pairs else _round_up(n_columns(D), BN)
    return Geometry(pairs, smem, PM if pairs else BM, cols, blocks)


def kernel_geometry(D: int):
    """``geometry`` as the CUDA side computes it for the launch
    (``bw_stats_geometry``; its blocks an SM from the CUDA occupancy
    calculator on the current device), or None where it refuses D."""
    out = (ctypes.c_int * 5)()
    err = _build.load("bw_stats").bw_stats_geometry(D, ctypes.addressof(out))
    return None if err else Geometry(bool(out[0]), *out[1:5])


def table(D: int, device=None) -> torch.Tensor:
    """The table the form at D reads: ``pairs_table`` or ``pair_table``."""
    return (pairs_table if pairs_form(D) else pair_table)(D, device)


def pairs_table(D: int, device=None) -> torch.Tensor:
    """int32 [pairs_columns(D)]: the pairs form's column codes i | j << 16
    (X₂ = x̃_i x̃_j over x̃ = [x | 1 | 0]). Tile t is the t-th (a, b), a <=
    b, of the ceil(D / PB) index blocks in row-major order; its column l *
    PB + m is the pair (PB a + l, PB b + m) where that is i <= j < D.
    A diagonal tile's other slots (l > m, or past D) take, in slot
    order, f's columns (PB a + l, D) for its indices and then, in tile 0,
    n's (D, D); slots left over and off-diagonal pairs past D are (D + 1,
    D + 1), unused. Every tile's first column is (PB a, PB b)."""
    nb = -(-D // PB)
    a, b = torch.triu_indices(nb, nb)
    l = torch.arange(PB).repeat_interleave(PB)
    m = torch.arange(PB).repeat(PB)
    i = (PB * a[:, None] + l[None]).clone()
    j = (PB * b[:, None] + m[None]).clone()
    used = (i <= j) & (j < D)
    i[~used] = D + 1
    j[~used] = D + 1
    for t in torch.nonzero(a == b)[:, 0].tolist():
        free = torch.nonzero(~used[t])[:, 0]
        idx = torch.arange(PB * a[t].item(), min(D, PB * (a[t].item() + 1)))
        fi = torch.cat([idx, torch.tensor([D] if t == 0 else [],
                                          dtype=torch.int64)])
        i[t, free[:fi.numel()]] = fi
        j[t, free[:fi.numel()]] = D
    code = (i | j << 16).reshape(-1).to(torch.int32)
    return code if device is None else code.to(device)


def pair_table(D: int, device=None) -> torch.Tensor:
    """int32 [Ep] (Ep = E rounded up to BN): the rows form's codes.
    Extended column e is X₂[f, e] = x̃[f, i0] x̃[f, i1], code i0 | i1 <<
    16, over x̃ = [x | 1 | 0]. e < P: the e-th upper-triangle pair (i, j),
    i <= j, row-major (the order of ``ref._quad_pairs``); then (d, D) for
    x_d; (D, D) for the ones column (n); (D+1, D+1) past E."""
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
    return table(D, device)


def splits(F: int, C: int, D: int, n_sm: int) -> int:
    """The number of runs each tile's frames are cut into: at most
    MAX_SPLITS, each at least MIN_SPLIT_FRAMES (unless F is smaller), the
    count whose blocks fill the card's slots (``geometry``'s blocks an SM
    times the SMs) in the fewest part-empty waves; ties go to fewer
    splits."""
    g = geometry(D)
    tiles = -(-C // g.tile) * (g.cols // (PN if g.pairs else BN))
    slots = g.blocks * n_sm
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


def frame_lists(gamma, tile: int = BM):
    """The compaction pass in plain tensor code: for each ``tile``-component
    tile (the form's: 128 rows, 64 pairs), the frames with a non-zero Γ in
    it, in frame order -> a list of int64 tensors, one per tile."""
    C = gamma.shape[1]
    return [torch.nonzero(gamma[:, t * tile:(t + 1) * tile].ne(0)
                          .any(dim=1))[:, 0] for t in range(-(-C // tile))]


def moments(gamma, x, table, nsplit: int = 1, compact: bool = False,
            tile: int = BM):
    """The kernel's function in plain tensor code: for each ``tile``-
    component tile, its frames (all of them, or its ``frame_lists`` entry
    when ``compact``) cut into ``nsplit`` runs of ``split_len``; the
    partial Γᵀ X₂ over the table's columns per run, added in run order;
    each used column scattered by its code. Either form's table: the rows
    form's ``pair_table`` with tile=BM, the pairs form's ``pairs_table``
    with tile=PM. -> (n [C], f [C, D], S [C, D*D]) f32."""
    F, C = gamma.shape
    D = x.shape[1]
    xt = torch.cat([x.float(), x.new_ones(F, 1), x.new_zeros(F, 1)], dim=1)
    code = table.long().to(x.device)
    i0, i1 = code & 0xffff, code >> 16
    keep = i0 <= D
    i0, i1 = i0[keep], i1[keep]
    x2 = xt[:, i0] * xt[:, i1]                       # [F, used columns]
    out = x2.new_empty((C, i0.numel()))
    lists = frame_lists(gamma, tile) if compact else None
    for t in range(-(-C // tile)):
        cols = slice(t * tile, (t + 1) * tile)
        frames = lists[t] if compact else torch.arange(F, device=x.device)
        per = split_len(frames.numel(), nsplit)
        acc = x2.new_zeros((gamma[:, cols].shape[1], i0.numel()))
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
    g = geometry(D)
    codes = _table_on(D, dev)
    nsplit = splits(F, C, D, _n_sm(dev))
    part = torch.empty((nsplit, C, g.cols), dtype=torch.float32, device=dev)
    T, Fp = -(-C // g.tile), max(F, 1)
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
        gamma.data_ptr(), x.data_ptr(), codes.data_ptr(), part.data_ptr(),
        *scratch, n.data_ptr(), f.data_ptr(), S.data_ptr(), F, Fp, C, D,
        g.cols, nsplit, *_build.launch_args(x))
    _build.check(err, "bw_stats")
    bw_stats.launches += 1
    bw_stats.by_form["pairs" if g.pairs else "rows"] += 1
    return n, f, S


bw_stats.launches = 0
# launches by form (``geometry``)
bw_stats.by_form = {"rows": 0, "pairs": 0}
