"""CUDA kernel wrappers: causal GQA flash attention, forward and backward.

The forward launches ``csrc/flash_attention.cu`` (which says what it
replaces, what bounds it and how it is laid out): bf16 on the tensor
cores (``wgmma``, with p split into bf16 hi and lo parts so that P.V
keeps p's f32 precision), f32 on the CUDA cores. With ``lse=True`` it
also returns each row's log-sum-exp [B, H, S] f32, which the backward
(``csrc/flash_attention_bwd.cu``) recomputes the probabilities from: bf16
on the tensor cores (P and dS split into bf16 hi and lo parts for their
products; above hd 128 each gradient's columns split over two
warpgroups and the dK/dV pass's query heads over ``bwd_splits``
blocks), f32 on the CUDA cores. Every head dim from 1 to 512
(``HEAD_DIMS``) runs in both types, forward and backward (``route`` and
``bwd_scope`` name the kernel): bf16 runs the tensor-core instance of
its width ``tc_width`` (64, 128, 192, 256 or 512 forward; 64, 128, 256
or 512 backward), its columns past hd zero (the TMA fills them) and
never stored. The tensor maps' row stride must be a multiple of 8, so a
bf16 head dim that is not one is staged (``staged``): the C entry copies
q, k, v (and o and dO for the backward) into buffers ``ld(hd)`` columns
wide, zeros past hd (``csrc/restride.cuh``; ``stage`` is its plain
version), in a scratch allocated here, and copies the outputs, written
that wide, back hd wide; the scale is always hd^-1/2 of the true head
dim. f32 runs on the CUDA cores (exact f32 FMAs, register-blocked
products fed by 16-byte shared loads from a ``cp.async`` ring; the .cu
headers and ``csrc/flash_attention_simt.cuh`` say how): blocks of
``simt_rows`` rows (128 or 64) walking the other side 128 rows a step, on
the instance of ``simt_width`` (forward) or ``simt_bwd_width`` (backward;
past hd 256 two column slices), the columns past hd zero from the
copies; a head dim that is not a multiple of 4 is staged
``ld(hd, float32)`` wide. Past 512 the wrappers raise. The kernels mask
ragged S themselves, so any S is exact.
``ops.flash_attention`` dispatches here for CUDA tensors (through an
autograd function when a gradient is wanted) and to
``ref.flash_attention`` for CPU tensors. ``backward_blocks`` is the
backward kernels' algorithm in plain tensor code, tile by tile.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# entry point and the kernel it runs, by input type
KERNELS = {
    torch.float32: ("flash_attention_f32", "CUDA-core f32"),
    torch.bfloat16: ("flash_attention_bf16", "tensor-core bf16 (wgmma)"),
}
# the domain: every head dim runs in both types, forward and backward
HEAD_DIMS = tuple(range(1, 513))
# the widths of the tensor-core instances, forward (csrc: tc::width, the
# instance of tc_width(hd); 512 is namespace wide) and backward (no
# instance of width 192: 129 to 192 run 256): a bf16 head dim runs the
# least one at or above it
TC_WIDTHS = (64, 128, 192, 256, 512)
BWD_TC_WIDTHS = (64, 128, 256, 512)
# the widths of the CUDA-core instances, f32 (csrc: SIMT_WIDTH_LIST and
# simt::width): the forward's (SIMT_WIDTHS) and the backward's
# (SIMT_BWD_WIDTHS, the gradients' columns a block); a head dim runs the
# least one at or above it (the backward past 256: at or above half of
# it, in SIMT_BWD_SLICES column slices). Each width fixes the apply
# product's thread layout and slab rows; the head-dim loop of the score
# product is cut at the head dim
SIMT_WIDTHS = tuple(range(32, 257, 32)) + (320, 384, 448, 512)
SIMT_BWD_WIDTHS = tuple(range(32, 257, 32))
SIMT_MAX_SLICE = 256
SIMT_BWD_SLICES = 2
# csrc/flash_attention_simt.cuh: a CUDA-core block's own rows (query rows,
# or key rows in the dK/dV kernel: SIMT_ROWS, or SIMT_WIDE_ROWS up to a
# kernel's SIMT_WIDE_UPTO width, where 8 x 8 microtiles fit the
# registers), the other side's rows a step, the P and dS tiles' row
# stride; csrc/flash_attention.cu and csrc/flash_attention_bwd.cu (simt):
# the rings' slabs in flight, the head-dim columns of a score slab
# (SIMT_DC; the backward's SIMT_DC2 where the slab holds the block's own
# rows too), a slab's floats, and the widest ld whose k and v tiles the
# dK/dV kernel keeps resident
SIMT_ROWS = 64
SIMT_WIDE_ROWS = 128
SIMT_WIDE_UPTO = {"fwd": 128, "dq": 128, "dkdv": 64}
SIMT_TILE = 128
SIMT_PLD = SIMT_TILE + 4
SIMT_STAGES = 3
SIMT_DC = 32
SIMT_DC2 = 16
SIMT_STAGE = SIMT_TILE * (SIMT_DC + 4)
SIMT_BWD_STAGE = (SIMT_WIDE_ROWS + SIMT_TILE) * (SIMT_DC2 + 4)
SIMT_KV_RESIDENT = 192
# csrc/flash_attention.cu: query rows a block (tensor cores: up to hd 192,
# see tc_rows; CUDA cores: SIMT_ROWS), threads a block by namespace and
# (tensor cores) (k, v) tiles in flight
BQ = {torch.float32: SIMT_ROWS, torch.bfloat16: 128}
THREADS = {"simt": 256, "tc": 288}
TC_STAGES = 3
# the width-512 instances (namespace wide of both sources): the forward's
# (k, v) tiles of WIDE_BKV keys, the backward's ring tiles of WIDE_TILE
# rows, WIDE_STAGES of either in flight, and each output's columns split
# over WIDE_SLICES blocks (a grid axis), two warpgroups' each
WIDE_BKV = 32
WIDE_TILE = 16
WIDE_STAGES = 3
WIDE_SLICES = 2
# log2(e): the kernels' exponentials are exp2 of log2-scaled scores
LOG2E = 1.4426950408889634
# csrc/flash_attention_bwd.cu: threads a dK/dV block by namespace (tc:
# two consumer warpgroups and a producer warpgroup) and the tensor-core
# kernels' tiles in flight up to width 256
BWD_THREADS = {"tc": 384, "simt": 256}
BWD_TC_STAGES = 4
# the tensor-core kernels above hd 128 (tc::SPLIT_ROWS, wide::ROWS): rows
# a dQ or dK/dV block, shared by its two warpgroups
BWD_SPLIT_ROWS = 64
# the dK/dV pass's split over a group's query heads (bwd_splits) above hd
# 128 in bf16 and at every f32 head dim: at most BWD_SPLITS blocks a (key tile, kv head, slice, batch row),
# each writing f32 partial sums that a fourth kernel adds in split order,
# and no more than it takes to reach BWD_SPLIT_BLOCKS blocks (about two an
# SM). chip_smoke.py's sweep of 1, 2, 4 and 8 at Gemma 2B's S = 4096, H =
# 8, KVH = 1 (64 key tiles a batch row; H100 80GB HBM3, 700 W, PERF.md
# §6): at B = 1, 2.391, 1.392, 0.946, 0.955 ms (the grid's 64 blocks leave
# most SMs idle); at B = 4, 3.529, 3.558, 3.651, 4.019 ms (256 blocks
# fill the card, and a split only adds the workspace's traffic). So 4 at
# B = 1 and 1 at B = 4, Gemma's training micro-batch.
BWD_SPLITS = 8
BWD_SPLIT_BLOCKS = 256


def _in_domain(hd: int, name: str = "flash_attention") -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head_dim 1 to "
                         f"{HEAD_DIMS[-1]}, not {hd}")


# the launch counts' forms (``form``)
FORMS = ("tc", "tc8", "staged", "wide", "simt")


def form(dtype: torch.dtype, hd: int) -> str:
    """A launch's form, forward or backward, by which ``by_form`` counts
    it: f32 "simt" (the CUDA cores); bf16 "wide" past hd 256 (the
    width-512 instances), below "staged" at a head dim that is not a
    multiple of 8 (its operands copied ``ld(hd)`` wide), "tc8" at a
    multiple of 8 only and "tc" at one of 16."""
    _in_domain(hd)
    if dtype != torch.bfloat16:
        return "simt"
    return ("wide" if hd > 256 else "staged" if hd % 8 else
            "tc8" if hd % 16 else "tc")


def ld(hd: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The row stride of a launch's operands: for bf16 (and its outputs)
    hd rounded up to a multiple of 8, which makes every global stride of
    the TMA's tensor maps a multiple of 16 bytes; for f32 up to a multiple
    of 4, whole 16-byte rows for the ``cp.async`` copies."""
    m = 8 if dtype == torch.bfloat16 else 4
    return -(-hd // m) * m


def staged(dtype: torch.dtype, hd: int) -> bool:
    """Whether a launch copies its operands into buffers ``ld(hd, dtype)``
    columns wide (a head dim that is not a multiple of 8 in bf16, of 4 in
    f32)."""
    return ld(hd, dtype) != hd


def tc_width(hd: int, backward: bool = False) -> int:
    """The width of the tensor-core instance a bf16 head dim runs (the
    template argument of ``tc::launch``, or 512 for namespace ``wide``):
    the least of TC_WIDTHS (BWD_TC_WIDTHS for the backward) at or above
    hd. Its tiles are that wide; the columns past hd arrive as zeros from
    the TMA (the maps' extent is hd), add nothing to the products and are
    not stored."""
    _in_domain(hd)
    return next(w for w in (BWD_TC_WIDTHS if backward else TC_WIDTHS)
                if w >= hd)


def simt_width(hd: int) -> int:
    """The width of the CUDA-core forward instance an f32 head dim runs
    (``simt::width`` of csrc/flash_attention.cu): the least of SIMT_WIDTHS
    at or above hd; the columns past hd arrive as zeros and are not
    stored."""
    _in_domain(hd)
    return next(w for w in SIMT_WIDTHS if w >= hd)


def simt_tile_ld(hd: int) -> int:
    """Row stride of a CUDA-core kernel's resident tile (the forward's q,
    the dQ kernel's q and dO, the dK/dV kernel's k and v;
    ``simt::q_ld``, ``simt::tile_ld``): ``ld(hd, float32)`` in whole
    slabs of SIMT_DC columns, and 4 more."""
    return -(-ld(hd, torch.float32) // SIMT_DC) * SIMT_DC + 4


def simt_resident(hd: int, kernel: str) -> bool:
    """Whether a CUDA-core backward kernel ("dq" or "dkdv") keeps its own
    rows' operands resident (``simt::dq_resident``, ``kv_resident``): on
    SIMT_ROWS-row blocks only, the dQ kernel's q and dO with one column
    slice (ld up to SIMT_MAX_SLICE), the dK/dV kernel's k and v up to
    SIMT_KV_RESIDENT; else they stream through the ring beside the other
    side's rows."""
    n = ld(hd, torch.float32)
    return simt_rows(hd, kernel) == SIMT_ROWS and n <= (
        SIMT_MAX_SLICE if kernel == "dq" else SIMT_KV_RESIDENT)


def simt_bwd_slices(hd: int) -> int:
    """Column slices of the f32 backward's gradients (``simt::slices``):
    1 up to SIMT_MAX_SLICE, SIMT_BWD_SLICES above."""
    _in_domain(hd, "flash_attention_bwd")
    return 1 if hd <= SIMT_MAX_SLICE else SIMT_BWD_SLICES


def simt_bwd_width(hd: int) -> int:
    """The width of the CUDA-core backward instance an f32 head dim runs
    (``simt::width`` of csrc/flash_attention_bwd.cu): the least of
    SIMT_BWD_WIDTHS at or above the columns of one of its
    ``simt_bwd_slices``."""
    n = -(-ld(hd, torch.float32) // simt_bwd_slices(hd))
    return next(w for w in SIMT_BWD_WIDTHS if w >= n)


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel family of csrc/flash_attention.cu that a forward runs:
    "tc" (wgmma, namespaces tc and wide) for bf16, "simt" (the CUDA
    cores) for f32. Raises past the domain."""
    _in_domain(hd)
    return "tc" if dtype == torch.bfloat16 else "simt"


def tc_rows(hd: int) -> int:
    """Query rows a block of the tensor-core forward (``tc::Layout::BQ``):
    128 (one 64-row slice for each consumer warpgroup), and 64 above hd
    192, where the two warpgroups share the block's rows and each holds a
    share of the output's columns (a 64 x 256 f32 accumulator would not
    fit one warpgroup's registers beside S and p)."""
    return BQ[torch.bfloat16] // 2 if hd > 192 else BQ[torch.bfloat16]


def simt_rows(hd: int, kernel: str = "fwd") -> int:
    """Rows of a block of a CUDA-core kernel (``simt::rows``,
    ``dq_rows``, ``kv_rows``): query rows of the forward ("fwd") and the
    dQ kernel ("dq"), key rows of the dK/dV kernel ("dkdv"); SIMT_WIDE_ROWS
    on instances up to SIMT_WIDE_UPTO wide, else SIMT_ROWS."""
    w = simt_width(hd) if kernel == "fwd" else simt_bwd_width(hd)
    return SIMT_WIDE_ROWS if w <= SIMT_WIDE_UPTO[kernel] else SIMT_ROWS


def q_rows(dtype: torch.dtype, hd: int) -> int:
    """Query rows a block of the forward launch."""
    return tc_rows(hd) if route(dtype, hd) == "tc" else simt_rows(hd)


def kv_rows(dtype: torch.dtype, hd: int) -> int:
    """Key rows a (k, v) tile: on the tensor cores 128 up to hd 128, 64 up
    to 256 (``Layout::BKV``), WIDE_BKV above; on the CUDA cores a step's
    SIMT_TILE keys."""
    if route(dtype, hd) == "tc":
        return 128 if hd <= 128 else 64 if hd <= 256 else WIDE_BKV
    return SIMT_TILE


def slices(dtype: torch.dtype, hd: int) -> int:
    """Blocks a row tile's output columns split over (a grid axis) in the
    forward: WIDE_SLICES on the width-512 tensor-core instance, else 1
    (the CUDA cores' default, ``simt::SLICES``)."""
    return WIDE_SLICES if route(dtype, hd) == "tc" and hd > 256 else 1


def bwd_slices(dtype: torch.dtype, hd: int) -> int:
    """Blocks a key (query) tile's gradient columns split over in the
    backward: ``slices`` on the tensor cores, ``simt_bwd_slices`` on the
    CUDA cores."""
    if bwd_scope(dtype, hd) == "tc":
        return slices(dtype, hd)
    return simt_bwd_slices(hd)


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Shared memory of a forward block: on the CUDA cores
    (``simt::smem_bytes``) the ring of SIMT_STAGES slabs of SIMT_STAGE
    floats, the P tile [rows][SIMT_PLD], a row's rescale and the
    resident q tile [rows][``simt_tile_ld``], rows ``simt_rows(hd)``, f32
    (190,976 bytes at hd 128, 221,440 at 512); on the tensor cores
    (``tc::Layout::BYTES``, ``wide::BYTES``) the q tile of
    ``tc_rows(hd)`` rows, the ring of ``TC_STAGES`` k tiles and v tiles
    (the v tile the slice's columns only on the width-512 instance), the
    mbarriers and 1024 bytes of alignment slack (230,456 bytes at hd 256,
    214,072 above)."""
    if route(dtype, hd) == "simt":
        r = simt_rows(hd)
        return 4 * (SIMT_STAGES * SIMT_STAGE + r * SIMT_PLD + r
                    + r * simt_tile_ld(hd))
    w = tc_width(hd)
    return (tc_rows(hd) * w * 2 + TC_STAGES * kv_rows(dtype, hd)
            * (w + w // slices(dtype, hd)) * 2 + (2 * TC_STAGES + 1) * 8
            + 1024)


def geometry(dtype: torch.dtype, hd: int) -> tuple:
    """(route: 1 the tensor cores, 0 the CUDA cores; the instance's width;
    query rows a block; shared memory a block) of a forward, what
    ``flash_attention_geometry`` of csrc/flash_attention.cu gives."""
    tc = route(dtype, hd) == "tc"
    return (int(tc), tc_width(hd) if tc else simt_width(hd),
            q_rows(dtype, hd), smem_bytes(dtype, hd))


def bwd_scope(dtype: torch.dtype, hd: int) -> str:
    """The kernel family of csrc/flash_attention_bwd.cu that a call runs:
    "tc" (wgmma, namespaces tc and wide) for bf16, "simt" (the CUDA cores)
    for f32. Raises past the domain."""
    _in_domain(hd, "flash_attention_bwd")
    return "tc" if dtype == torch.bfloat16 else "simt"


def bwd_splits(dtype: torch.dtype, B: int, S: int, H: int, KVH: int,
               hd: int) -> int:
    """Blocks the dK/dV pass splits a group of G = H / KVH query heads
    over, each block walking G / splits of them: on the tensor cores above
    hd 128 (``tc::KvLayout::SPLIT``, namespace wide) and on the CUDA cores
    at every head dim, the smallest divisor of G up to BWD_SPLITS that
    brings the grid (key tiles of ``bwd_rows`` x kv heads x ``bwd_slices``
    x batch rows) to BWD_SPLIT_BLOCKS blocks, or the largest if none does;
    1 elsewhere (a block walks the whole group)."""
    if bwd_scope(dtype, hd) == "tc" and hd <= 128:
        return 1
    G = H // KVH
    blocks = (-(-S // bwd_rows(dtype, hd)) * KVH * B
              * bwd_slices(dtype, hd))
    fits = [n for n in range(1, min(G, BWD_SPLITS) + 1) if G % n == 0]
    return next((n for n in fits if blocks * n >= BWD_SPLIT_BLOCKS),
                fits[-1])


def bwd_rows(dtype: torch.dtype, hd: int) -> int:
    """Key rows of a dK/dV block (and, on the CUDA cores, rows of every
    tile of both passes): on the tensor cores (``tc::KvLayout::BK``) 128,
    two warpgroups of 64, and BWD_SPLIT_ROWS above hd 128, both
    warpgroups' with a share of the columns each; on the CUDA cores the
    dK/dV kernel's ``simt_rows(hd, "dkdv")``."""
    if bwd_scope(dtype, hd) == "tc":
        return BWD_SPLIT_ROWS if hd > 128 else 128
    return simt_rows(hd, "dkdv")


def bwd_query_rows(hd: int) -> int:
    """Query rows of a (q, dO) tile of the tensor-core dK/dV kernel
    (``tc::KvLayout::BQ`` of ``tc_width(hd, True)``, ``wide::TILE``): 64 up
    to hd 64, 32 up to 256, WIDE_TILE above, so that S^T, dP^T and their
    fragments fit beside the accumulators (dK's and dV's columns, 128 each
    above hd 128: 128 f32 registers a thread at hd 128 and above) and the
    ring beside the k and v tiles."""
    return 64 if hd <= 64 else 32 if hd <= 256 else WIDE_TILE


def bwd_smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Shared memory of a dK/dV block. Tensor cores (``tc::KvLayout``,
    ``wide::BYTES``): the k and v tiles of ``bwd_rows`` rows, the ring of
    (q, dO) tiles (BWD_TC_STAGES of them, WIDE_STAGES at width 512), the
    mbarriers and 1024 bytes of alignment slack, bf16 (197,704 bytes at
    hd 256, 230,456 at 512). CUDA cores (``simt::kv_bytes``): the ring of
    SIMT_STAGES slabs of SIMT_BWD_STAGE floats, the P and dS tiles
    [rows][SIMT_PLD] and, where ``simt_resident``, the k and v tiles
    [SIMT_ROWS][``simt_tile_ld``], f32 (196,608 bytes at hd 64, 197,632 at
    128, 129,024 past 192; the dQ kernel's, ``dq_smem_bytes``, holds one
    tile)."""
    br = bwd_rows(dtype, hd)
    if bwd_scope(dtype, hd) == "tc":
        w = tc_width(hd, backward=True)
        stages = WIDE_STAGES if hd > 256 else BWD_TC_STAGES
        return (2 * br * w * 2 + 2 * stages * bwd_query_rows(hd) * w * 2
                + (2 * stages + 1) * 8 + 1024)
    res = simt_resident(hd, "dkdv")
    return 4 * (SIMT_STAGES * SIMT_BWD_STAGE + 2 * br * SIMT_PLD
                + (2 * SIMT_ROWS * simt_tile_ld(hd) if res else 0))


def dq_smem_bytes(hd: int) -> int:
    """Shared memory of a block of the CUDA-core dQ kernel
    (``simt::dq_bytes``): the ring, the dS tile and, where
    ``simt_resident``, the q and dO tiles, f32."""
    res = simt_resident(hd, "dq")
    return 4 * (SIMT_STAGES * SIMT_BWD_STAGE
                + simt_rows(hd, "dq") * SIMT_PLD
                + (2 * SIMT_ROWS * simt_tile_ld(hd) if res else 0))


def bwd_geometry(dtype: torch.dtype, hd: int) -> tuple:
    """(route: 1 the tensor cores, 0 the CUDA cores; the instance's width;
    key rows a dK/dV block; its shared memory) of a backward, what
    ``flash_attention_bwd_geometry`` of csrc/flash_attention_bwd.cu
    gives."""
    tc = bwd_scope(dtype, hd) == "tc"
    return (int(tc), tc_width(hd, backward=True) if tc
            else simt_bwd_width(hd), bwd_rows(dtype, hd),
            bwd_smem_bytes(dtype, hd))


def kernel_geometry(dtype: torch.dtype, hd: int, backward: bool = False):
    """``geometry`` (or ``bwd_geometry``) as the CUDA side computes it, or
    None where it refuses the head dim; needs the built library, so it
    runs on a machine with nvcc."""
    name = "flash_attention_bwd" if backward else "flash_attention"
    out = (ctypes.c_int * 4)()
    err = getattr(_build.load(name), f"{name}_geometry")(
        int(dtype == torch.bfloat16), hd, out)
    return None if err else tuple(out)


def longest_first(i: int, j: int, z: int, grid) -> tuple:
    """The (tile, y, z) that block (i, j, z) of a (tiles, y, z) ``grid``
    takes in the tensor-core kernels above hd 128 (``longest_first`` in
    csrc/hopper.cuh): the linear block index walks every (y, z) of tile 0
    before any of tile 1."""
    X, Y, Z = grid
    lin = (z * Y + j) * X + i
    r = lin % (Y * Z)
    return lin // (Y * Z), r % Y, r // Y


def _check_operands(name, q, k, v):
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: operands must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    _in_domain(hd, name)


def stage(x, width: int):
    """x [..., hd] ``width`` columns wide, zeros past hd (or cut to
    ``width``), x itself where it is that wide already: the staging copy
    of ``csrc/restride.cuh`` in plain torch."""
    hd = x.shape[-1]
    return x if hd == width else F.pad(x, (0, width - hd))


def stage_elems(B: int, S: int, H: int, KVH: int, hd: int,
                backward: bool = False,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Elements of a staged launch's scratch, ``ld(hd, dtype)`` wide: bf16
    q, k, v and o (the backward: q, o, dO, dQ, k, v, dK and dV); f32 q, k
    and v (the backward: q, dO, k and v; the f32 kernels write their
    outputs hd wide themselves)."""
    w = ld(hd, dtype)
    if dtype == torch.float32:
        return B * S * ((2 * H if backward else H) + 2 * KVH) * w
    n = 2 if backward else 1
    return 2 * n * B * S * (H + KVH) * w


def flash_attention(q, k, v, lse: bool = False, _slices=None):
    """q: [B, S, H, hd]; k, v: [B, S, KVH, hd], one dtype (float32 or
    bfloat16), contiguous on one CUDA device; H a multiple of KVH; hd in
    HEAD_DIMS (1 to 512) -> o [B, S, H, hd] in q's dtype, and with ``lse``
    also the rows' log-sum-exp [B, H, S] f32. Scores stay f32 inside, and
    p keeps f32 precision (on the tensor cores as a bf16 hi and lo pair).
    A head dim that is not a multiple of 8 (bf16) or 4 (f32) is staged:
    the entry copies q, k and v ``ld(hd, dtype)`` wide (zeros past hd)
    into a scratch allocated here (bf16: and o, written that wide, back).
    ``_slices`` splits an f32 launch's o columns over that many blocks a
    row tile, each recomputing S (chip_smoke.py's measure of the split;
    default 1). Launches are counted in ``launches`` and by form in
    ``by_form``."""
    _check_operands("flash_attention", q, k, v)
    _build.require_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    o = torch.empty_like(q)
    out_lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
               if lse else None)
    lib = _build.load("flash_attention")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if out_lse is None else out_lse.data_ptr())
    if _slices is not None and (q.dtype != torch.float32 or _slices < 1):
        raise ValueError(f"flash_attention: {_slices} column slices at "
                         f"{q.dtype}")
    scratch = (torch.empty(stage_elems(B, S, H, KVH, hd, dtype=q.dtype),
                           dtype=q.dtype, device=q.device)
               if staged(q.dtype, hd) else None)
    if q.dtype == torch.float32:
        err = lib.flash_attention_f32(
            *ptrs, None if scratch is None else scratch.data_ptr(), B, S, H,
            KVH, hd, _slices or 0, *_build.launch_args(q))
    else:
        err = lib.flash_attention_bf16(
            *ptrs, None if scratch is None else scratch.data_ptr(), B, S, H,
            KVH, hd, *_build.launch_args(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.by_form[form(q.dtype, hd)] += 1
    return (o, out_lse) if lse else o


def flash_attention_bwd(q, k, v, o, lse, do, _splits=None):
    """The gradients of ``flash_attention``: q, k, v as there, o its
    output, lse its [B, H, S] f32 log-sum-exps, do the output's gradient
    (q's shape and dtype), all contiguous on one CUDA device -> (dq, dk,
    dv) in q's dtype. Takes the head dims the forward takes; no atomics,
    so the same bits every run. bf16 runs on the tensor cores with P and
    dS as bf16 hi/lo pairs (the .cu header states the precision contract),
    staged as the forward is (q, k, v, o and dO copied ``ld(hd)`` wide into
    a scratch allocated here, the gradients copied back); f32 on the CUDA
    cores in exact f32, q, dO, k and v staged ``ld(hd, float32)`` wide
    where hd is not a multiple of 4. The dK/dV pass splits the group's
    query heads over ``bwd_splits`` blocks (bf16 above hd 128, f32 at
    every head dim), which write f32 partial sums to a workspace
    allocated here, [2, splits, B, S, KVH, ld(hd)] (f32: hd wide; none
    for 1; 32 MiB a split at Gemma 2B's B = 1, S = 4096), added in split
    order by a fourth kernel. ``_splits`` overrides ``bwd_splits`` for
    chip_smoke.py's sweep (a divisor of H / KVH; 1 at bf16 head dims up
    to 128).
    Launches are counted in ``launches`` and by form in ``by_form``."""
    _check_operands("flash_attention_bwd", q, k, v)
    B, S, H, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"flash_attention_bwd: shapes o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}, lse {tuple(lse.shape)}")
    if (o.dtype != q.dtype or do.dtype != q.dtype
            or lse.dtype != torch.float32):
        raise TypeError("flash_attention_bwd: o and do in q's dtype, lse "
                        "float32")
    _build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd: operands must be 16-byte "
                         "aligned")
    KVH = k.shape[2]
    splits = (bwd_splits(q.dtype, B, S, H, KVH, hd) if _splits is None
              else _splits)
    scope = bwd_scope(q.dtype, hd)
    if splits != 1 and ((scope == "tc" and hd <= 128) or splits < 1
                        or (H // KVH) % splits):
        raise ValueError(f"flash_attention_bwd: {splits} splits of "
                         f"{H // KVH} query heads at {q.dtype} head_dim {hd}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr())
    lib = _build.load("flash_attention_bwd")
    work = (torch.empty((2, splits, B, S, KVH, ld(hd, q.dtype)
                         if q.dtype == torch.bfloat16 else hd),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    scratch = (torch.empty(stage_elems(B, S, H, KVH, hd, backward=True,
                                       dtype=q.dtype),
                           dtype=q.dtype, device=q.device)
               if staged(q.dtype, hd) else None)
    entry = (lib.flash_attention_bwd_f32 if q.dtype == torch.float32
             else lib.flash_attention_bwd_bf16)
    err = entry(*args, None if work is None else work.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, S, H,
                KVH, hd, splits, *_build.launch_args(q))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.by_form[form(q.dtype, hd)] += 1
    return dq, dk, dv


def reset_counts() -> None:
    """Both wrappers' launch counts to 0, by form too."""
    for w in (flash_attention, flash_attention_bwd):
        w.launches = 0
        w.by_form = dict.fromkeys(FORMS, 0)


reset_counts()


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


def split_bf16(x):
    """x (f32) as the bf16 pair the tensor-core kernels feed their
    products: hi = bf16(x), lo = bf16(x - hi), both widened to f32."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def backward_blocks(q, k, v, o, lse, do, block: int = 64):
    """The backward kernels' algorithm in plain tensor code, in f32, tile
    by tile (the CPU tests hold it against autograd of
    ``ref.flash_attention``), with ``block`` rows a tile: Delta =
    rowsum(dO o); the dQ pass walks, for each query tile, the key tiles up
    to the diagonal: S = Q.K^T, dP = dO.V^T, P = exp2(S s log2 e - lse
    log2 e), dS = P (dP - Delta), dQ += dS.K; the dK/dV pass walks, for
    each key tile, the group's query heads in order and their query tiles
    from the diagonal on, on the transposed tiles S^T = K.Q^T and dP^T =
    V.dO^T: dV += P^T.dO, dK += dS^T.Q. The group's heads are cut into
    the tensor-core kernel's ``bwd_splits`` runs in order (at hd 256 often
    several, whatever the input type); each run's sums (dK's scaled) are a
    partial, and the partials are added in split order, as the hd-256
    kernels' fourth pass adds them. With bf16 inputs P and dS enter their
    products as bf16 hi + lo (``split_bf16``: the hi product, then the lo
    one, into the f32 sum), as on the tensor cores. Same arguments and
    results as ``flash_attention_bwd``."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    f32 = torch.float32
    qf, kf, vf, of, dof = (t.to(f32) for t in (q, k, v, o, do))
    scale = hd ** -0.5
    scale_log2 = scale * LOG2E
    lse2 = lse.to(f32) * LOG2E                              # [B, H, S]
    delta = (dof * of).sum(-1).permute(0, 2, 1)            # [B, H, S]
    pos = torch.arange(S, device=q.device)
    split = q.dtype == torch.bfloat16

    def mm_split(x, y):
        """x @ y with x as the kernels feed it: its bf16 hi and lo parts
        (bf16 inputs), or itself."""
        if not split:
            return x @ y
        hi, lo = split_bf16(x)
        return hi @ y + lo @ y

    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    tiles = range(0, S, block)
    for h in range(H):                                     # the dQ pass
        for q0 in tiles:
            qs = slice(q0, q0 + block)
            qt, ot = qf[:, qs, h], dof[:, qs, h]
            acc = torch.zeros_like(qt)
            for k0 in range(0, q0 + block, block):
                ks = slice(k0, k0 + block)
                kt, vt = kf[:, ks, h // G], vf[:, ks, h // G]
                s = torch.einsum("bqd,bkd->bqk", qt, kt)
                ok = pos[qs, None] >= pos[None, ks]
                p = torch.where(ok[None], torch.exp2(
                    s * scale_log2 - lse2[:, h, qs, None]), 0.0)
                dp = torch.einsum("bqd,bkd->bqk", ot, vt)
                acc = acc + mm_split(p * (dp - delta[:, h, qs, None]), kt)
            dq[:, qs, h] = acc * scale
    gs = G // bwd_splits(torch.bfloat16, B, S, H, KVH, hd)
    for kh in range(KVH):                                  # the dK/dV pass
        for k0 in tiles:
            ks = slice(k0, k0 + block)
            kt, vt = kf[:, ks, kh], vf[:, ks, kh]
            part_k, part_v = [], []
            for h0 in range(kh * G, kh * G + G, gs):       # the splits
                acc_k = torch.zeros_like(kt)
                acc_v = torch.zeros_like(kt)
                for h in range(h0, h0 + gs):
                    for q0 in range(k0, S, block):
                        qs = slice(q0, q0 + block)
                        qt, ot = qf[:, qs, h], dof[:, qs, h]
                        st = torch.einsum("bkd,bqd->bkq", kt, qt)
                        ok = pos[ks, None] <= pos[None, qs]
                        pt = torch.where(ok[None], torch.exp2(
                            st * scale_log2 - lse2[:, h, None, qs]), 0.0)
                        dpt = torch.einsum("bkd,bqd->bkq", vt, ot)
                        acc_v = acc_v + mm_split(pt, ot)
                        acc_k = acc_k + mm_split(
                            pt * (dpt - delta[:, h, None, qs]), qt)
                part_k.append(acc_k * scale)
                part_v.append(acc_v)
            sum_k, sum_v = part_k[0], part_v[0]
            for pk, pv in zip(part_k[1:], part_v[1:]):     # in split order
                sum_k, sum_v = sum_k + pk, sum_v + pv
            dk[:, ks, kh] = sum_k
            dv[:, ks, kh] = sum_v
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
