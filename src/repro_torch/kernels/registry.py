"""Kernel registry: what the check passes and the roofline read about each
hand-written CUDA kernel, without launching anything (the counterpart of
``repro/kernels/registry.py``).

Each kernel of ``csrc/`` registers a :class:`KernelSpec`. Its
``describe(cfg)`` gives a :class:`KernelInstance` at one configuration:

  * the grid, the threads a block and, per grid axis, the extent it walks
    and the tile a block takes (KRN001: the grid covers the extent; the
    kernels mask ragged edges themselves);
  * every output's tiles and the grid point that writes each (KRN002:
    coverage and races), or, for a kernel whose blocks take
    data-dependent runs (``gmm_rescore``'s work items), the runs;
  * the shared memory a block asks for, from the wrappers' own geometry
    functions (KRN004 against the card's opt-in limit);
  * its async-copy rings: ``cp.async`` stages or TMA stages, read from the
    ``.cu`` source by KRN003.

``work(cfg)`` gives (flops, bytes, dtype) of one call: the least work the
function needs, each input read once and each output written once, the
count ``chip_smoke.py``'s bounds and ``analysis/op_cost.py`` use.
``moved(cfg)``, where a kernel has it, gives the bytes its launches move
in the form ``geometry`` picks for cfg: the re-reads its blocks make (x
once a component block, W once a frame block), its scratch written and
read back, the select's passes; ``chip_smoke.py`` prints its time over
the memory rate beside the bound. For
``gmm_rescore`` and ``gmm_align`` the rows of the packed table a call
touches depend on the ids; ``rows_touched`` in cfg gives them (default:
every row the pairs could reach).

The two backward kernels (``flash_attention_bwd``, ``selective_scan_bwd``)
are the port's own: the TPU kernels are forward only, and the JAX package
trains through jnp autodiff. Their ``replaces`` names the TPU kernel they
are the derivative of.

Configs use the wrappers' shape names. ``default_config`` is a small
shape the check gate verifies; ``main_config`` the main paths' shape
(PERF.md §6), which ``chip_smoke.py`` phase 11 checks on the card. Where a
kernel has several launches (``bw_stats``' compaction and finishing
passes, ``gmm_rescore``'s sort), the instance describes the launch that
does the work.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from repro_torch.analysis.optable import DTYPE_BYTES
from repro_torch.kernels import bw_stats as _bw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm_align as _ga
from repro_torch.kernels import gmm_loglik as _gl
from repro_torch.kernels import gmm_rescore as _gr
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import tvm_estep as _te

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _cdiv(n: int, b: int) -> int:
    return -(-n // b)


@dataclass(frozen=True)
class Axis:
    """One grid axis: what it walks, its extent and a block's tile."""
    name: str
    extent: int
    tile: int


@dataclass(frozen=True)
class BlockMap:
    """One output: its shape, a block's tile of it and the grid point ->
    tile index map."""
    name: str
    array_shape: Tuple[int, ...]
    block: Tuple[int, ...]
    index_map: Callable
    dtype: str = "float32"


@dataclass(frozen=True)
class Ring:
    """An async-copy ring inside the kernel: 'cp.async' or 'tma', its
    stages, and the namespace of the ``.cu`` source that holds it (None:
    the whole file)."""
    kind: str
    stages: int
    scope: Optional[str] = None


@dataclass(frozen=True)
class KernelInstance:
    """A KernelSpec at one concrete config."""
    grid: Tuple[int, ...]
    threads: int
    smem_bytes: int
    axes: Tuple[Axis, ...]
    outputs: Tuple[BlockMap, ...] = ()
    rings: Tuple[Ring, ...] = ()
    scope: Optional[str] = None         # namespace of the launched kernel
    # data-dependent runs (first, length) along a flattened output of
    # ``run_extent`` elements, one a block, where outputs cannot say it
    runs: Optional[Tuple[Tuple[int, int], ...]] = None
    run_extent: int = 0


@dataclass(frozen=True)
class KernelSpec:
    name: str
    source: str                          # file under csrc/
    describe: Callable[[dict], KernelInstance]
    work: Callable[[dict], Tuple[float, float, str]]
    default_config: dict
    main_config: dict
    reduction_axes: Tuple[int, ...] = ()   # grid axes that accumulate
    masks_ragged: bool = True              # the kernel masks ragged edges
    replaces: str = ""                     # the TPU kernel, file:line
    moved: Optional[Callable[[dict], float]] = None   # the form's bytes

    def config(self, config: Optional[dict] = None) -> dict:
        cfg = dict(self.default_config)
        if config:
            cfg.update(config)
        return cfg

    def instance(self, config: Optional[dict] = None) -> KernelInstance:
        return self.describe(self.config(config))

    def cost(self, config: Optional[dict] = None):
        """(flops, bytes, dtype) of one call at ``config``."""
        return self.work(self.config(config))

    @property
    def path(self) -> Path:
        return CSRC / self.source


KERNELS: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    KERNELS[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    return KERNELS[name]


def all_specs():
    return [KERNELS[k] for k in sorted(KERNELS)]


# ---------------------------------------------------------------------------
# gmm_loglik: dense loglik as one packed SGEMM (csrc/gmm_loglik.cu)
# ---------------------------------------------------------------------------


def _gmm_loglik_instance(cfg: dict) -> KernelInstance:
    """The form ``geometry`` picks for D: 128-frame blocks (the narrow
    form) or the rows form's 32, 64 or 128 frames (D >= 205), 128
    components a block either way."""
    F, C, D = cfg["F"], cfg["C"], cfg["D"]
    g = _gl.geometry(D)
    bn = _gl.RBN if g.wide else _gl.BN
    Cp = _cdiv(C, bn) * bn
    grid = (Cp // bn, _cdiv(F, g.bm))
    return KernelInstance(
        grid=grid, threads=_gl.THREADS, smem_bytes=g.smem,
        axes=(Axis("components", C, bn), Axis("frames", F, g.bm)),
        outputs=(BlockMap("out", (F, C), (g.bm, bn),
                          lambda j, i: (i, j)),),
        rings=(Ring("cp.async", _gl.RING, scope="rows") if g.wide
               else Ring("cp.async", _gl.STAGES),),
        scope="rows" if g.wide else None)


def _gmm_loglik_work(cfg: dict):
    """E2 products per (frame, component), the packed form's need; the
    rows form (D >= 205) issues each as three TF32 products (3xTF32) on
    the tensor cores, counted at the TF32 rate, so that its bound is what
    its arithmetic could reach."""
    F, C, D = cfg["F"], cfg["C"], cfg["D"]
    E2 = 1 + D + D * (D + 1) // 2
    nbytes = 4.0 * (F * D + C + D * C + C * D * D + F * C)
    if _gl.geometry(D).wide:
        return 3 * 2.0 * F * C * E2, nbytes, "tfloat32"
    return 2.0 * F * C * E2, nbytes, "float32"


def _gmm_loglik_moved(cfg: dict) -> float:
    """x read once a component block, the packed W (narrow: [E2p, Cp];
    rows: [Cp, K], which its packing pass writes from one read of P) once
    a frame block (and const with it, rows), out written once."""
    F, C, D = cfg["F"], cfg["C"], cfg["D"]
    g = _gl.geometry(D)
    Cp = _cdiv(C, _gl.BN) * _gl.BN
    fb = _cdiv(F, g.bm)
    if g.wide:
        K = _gl.rows_positions(D)
        return 4.0 * (F * D * (Cp // _gl.RBN) + (K + 1) * Cp * fb + F * C
                      + C * D * D + Cp * K)
    E2p = _cdiv(1 + D + D * (D + 1) // 2, _gl.BK) * _gl.BK
    return 4.0 * (F * D * (Cp // _gl.BN) + E2p * Cp * fb + F * C)


# ---------------------------------------------------------------------------
# gmm_rescore: the sparse rung, pairs grouped by component
# ---------------------------------------------------------------------------


def _rescore_counts(cfg: dict):
    """Pairs a component: cfg["counts"], else the F*K pairs spread over
    the first ``rows_touched`` components as evenly as they go."""
    import torch
    if cfg.get("counts") is not None:
        return torch.as_tensor(cfg["counts"])
    pairs, C = cfg["F"] * cfg["K"], cfg["C"]
    rows = max(1, min(cfg.get("rows_touched") or C, C, pairs))
    counts = torch.zeros(C, dtype=torch.int64)
    counts[:rows] = pairs // rows
    counts[:pairs % rows] += 1
    return counts


def _gmm_rescore_instance(cfg: dict) -> KernelInstance:
    F, K, C, D = cfg["F"], cfg["K"], cfg["C"], cfg["D"]
    g = _gr.geometry(F, K, C, D)
    items = _gr.work_items(_rescore_counts(cfg), g.bp)
    runs = tuple((int(a), int(n)) for _, a, n in items.tolist())
    return KernelInstance(
        grid=(g.max_items,), threads=_gr.THREADS, smem_bytes=g.smem_bytes,
        axes=(Axis("pairs", F * K, g.bp),),
        rings=(Ring("cp.async", 1),), runs=runs, run_extent=F * K)


def _gmm_rescore_work(cfg: dict):
    F, K, C, D = cfg["F"], cfg["K"], cfg["C"], cfg["D"]
    rows = cfg.get("rows_touched") or min(C, F * K)
    E = 1 + D + D * D                        # ref.rescore_pack's row
    return (2.0 * F * K * (D * D + D + 1),
            4.0 * (F * D + rows * E + F * K) + 8.0 * F * K, "float32")


def _gmm_rescore_moved(cfg: dict) -> float:
    """The sort: sel read twice (counting, then scattering) and the pair
    indices written and read once; each work item's row of A (P whole or
    strip by strip, the same bytes) and its frames' rows; out once."""
    F, K, C, D = cfg["F"], cfg["K"], cfg["C"], cfg["D"]
    g = _gr.geometry(F, K, C, D)
    items = _gr.work_items(_rescore_counts(cfg), g.bp).shape[0]
    return (16.0 * F * K + 8.0 * F * K + 4.0 * F * K
            + 4.0 * items * (1 + D + D * D) + 4.0 * F * K * D)


# ---------------------------------------------------------------------------
# gmm_align: diag preselect, top-K and packed rescore in one kernel
# ---------------------------------------------------------------------------


def _align_geometry(cfg: dict) -> "_ga.Geometry":
    """The launch's geometry: cfg's override of rows (and stream, wide),
    else ``geometry``."""
    C, D, K = cfg["C"], cfg["D"], cfg["K"]
    only = cfg.get("rescore_only", False)
    if cfg.get("rows") is not None:
        rows = cfg["rows"]
        stream = cfg.get("stream", only or K <= _ga.STREAM_K)
        wide = cfg.get("wide", False)
        return _ga.Geometry(rows, stream,
                            _ga.smem_bytes(C, D, stream, rows, wide),
                            False, wide)
    return _ga.geometry(C, D, K, only)


def _gmm_align_instance(cfg: dict) -> KernelInstance:
    """The fused launch, or in the spill form its preselect, whose 64-frame
    blocks write the score rows [F, Cp] (its select and rescore follow)."""
    F, C, D, K = cfg["F"], cfg["C"], cfg["D"], cfg["K"]
    g = _align_geometry(cfg)
    rows = g.rows
    if g.spill:
        Cp = _cdiv(C, _ga.NC) * _ga.NC
        outs = (BlockMap("scores", (F, Cp), (rows, Cp), lambda i: (i, 0)),)
    elif cfg.get("rescore_only", False) and K > _ga.SLOT_SPLIT:
        # the rescore alone past SLOT_SPLIT slots: a block a run of them
        ks = _ga.SLOT_SPLIT
        return KernelInstance(
            grid=(_cdiv(F, rows), _cdiv(K, ks)), threads=_ga.THREADS,
            smem_bytes=g.smem,
            axes=(Axis("frames", F, rows), Axis("slots", K, ks)),
            outputs=(BlockMap("ll", (F, K), (rows, ks),
                              lambda i, j: (i, j)),),
            rings=(Ring("cp.async", _ga.STAGES),))
    else:
        outs = (BlockMap("ll", (F, K), (rows, K), lambda i: (i, 0)),)
        if not cfg.get("rescore_only", False):
            outs += (BlockMap("sel", (F, K), (rows, K), lambda i: (i, 0),
                              dtype="int64"),)
    return KernelInstance(
        grid=(_cdiv(F, rows),), threads=_ga.THREADS, smem_bytes=g.smem,
        axes=(Axis("frames", F, rows),), outputs=outs,
        rings=(Ring("cp.async", _ga.STAGES),))


def _gmm_align_work(cfg: dict):
    """The preselect's 2·F·C·(2D + 1) and the rescore's 2·F·K·E2
    operations; x, the diag coefficients, the touched packed rows and the
    outputs (ll f32, sel int64) once. ``rescore_only``: the rescore of a
    given selection (``gmm_rescore_fused``), sel read instead."""
    F, C, D, K = cfg["F"], cfg["C"], cfg["D"], cfg["K"]
    E2 = 1 + D + D * (D + 1) // 2
    rows = cfg.get("rows_touched") or min(C, F * K)
    if cfg.get("rescore_only", False):
        return (2.0 * F * K * E2,
                4.0 * (F * D + rows * E2 + F * K) + 8.0 * F * K, "float32")
    return (2.0 * F * C * (2 * D + 1) + 2.0 * F * K * E2,
            4.0 * (F * D + C * (2 * D + 1) + rows * E2) + 12.0 * F * K,
            "float32")


def _gmm_align_moved(cfg: dict) -> float:
    """The preselect's diag coefficients once a frame block and x once; the
    rescore's packed row once a (frame, slot) pair (and, wide, the pair
    table's entries with it); ll and sel once. The spill form adds its
    score rows [F, Cp] written, then read by the select (the NaN scan, 4
    radix-select passes where K < C, the compaction), and the K keys and
    ids (8 bytes each) written by the compaction and by each of the 4 LSD
    passes, which read them twice (digits, then the scatter)."""
    F, C, D, K = cfg["F"], cfg["C"], cfg["D"], cfg["K"]
    g = _align_geometry(cfg)
    E2 = 1 + D + D * (D + 1) // 2
    rescore = 4.0 * F * K * E2 * (2 if g.wide else 1) + 4.0 * F * K
    if cfg.get("rescore_only", False):
        return 4.0 * F * D + 8.0 * F * K + rescore
    blocks = _cdiv(F, _ga.BF_STREAM if g.spill else g.rows)
    total = (4.0 * F * D + 4.0 * blocks * C * (2 * D + 1) + 8.0 * F * K
             + rescore)
    if g.spill:
        Cp = _cdiv(C, _ga.NC) * _ga.NC
        passes = 2 + (4 if K < C else 0)
        total += 4.0 * F * Cp + 4.0 * F * C * passes + 8.0 * F * K * (1 + 4 * 3)
    return total


# ---------------------------------------------------------------------------
# tvm_estep: the packed E-step products (csrc/packed_matmul.cu), 3 forms
# ---------------------------------------------------------------------------


def _tvm_form(cfg: dict) -> str:
    import torch
    dt = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
    return cfg.get("form") or _te.form(dt, cfg["M"], cfg["K"], cfg["N"])


def _tvm_estep_instance(cfg: dict) -> KernelInstance:
    M, K, N = cfg["M"], cfg["K"], cfg["N"]
    f = _tvm_form(cfg)
    esz = DTYPE_BYTES[cfg.get("dtype", "float32")]
    bm, bn = _te.TILE[f]
    scope = {"stream": "stream", "sgemm": "sgemm", "wgmma": "tc"}[f]
    if f == "stream":
        grid, axes = (_cdiv(N, bn),), (Axis("columns", N, bn),)
        out = BlockMap("out", (M, N), (bm, bn), lambda j: (0, j))
    else:
        grid = (_cdiv(M, bm), _cdiv(N, bn))
        axes = (Axis("rows", M, bm), Axis("columns", N, bn))
        out = BlockMap("out", (M, N), (bm, bn), lambda i, j: (i, j))
    ring = Ring("tma" if f == "wgmma" else "cp.async", _te.STAGES[f], scope)
    return KernelInstance(
        grid=grid, threads=_te.THREADS[f], smem_bytes=_te.smem_bytes(f, esz),
        axes=axes, outputs=(out,), rings=(ring,), scope=scope)


def _tvm_estep_work(cfg: dict):
    M, K, N = cfg["M"], cfg["K"], cfg["N"]
    dt = cfg.get("dtype", "float32")
    esz = DTYPE_BYTES[dt]
    return 2.0 * M * K * N, esz * (M * K + K * N) + 4.0 * M * N, dt


# ---------------------------------------------------------------------------
# bw_stats: Γᵀ X₂ over the coded columns, frames cut into runs
# ---------------------------------------------------------------------------


def _bw_stats_instance(cfg: dict) -> KernelInstance:
    """The form ``geometry`` picks for D: rows (128 components x 128
    columns a block) or pairs (64 components x one (I, J) tile of 256)."""
    F, C, D = cfg["F"], cfg["C"], cfg["D"]
    g = _bw.geometry(D)
    width = _bw.PN if g.pairs else _bw.BN
    nsplit = cfg.get("nsplit") or _bw.splits(F, C, D, cfg.get("n_sm", 132))
    T = _cdiv(C, g.tile)
    run = _bw.split_len(F, nsplit)
    return KernelInstance(
        grid=(g.cols // width, T, nsplit), threads=_bw.THREADS,
        smem_bytes=g.smem,
        axes=(Axis("columns", g.cols, width), Axis("components", C, g.tile),
              Axis("frames", F, run)),
        # each frame run writes its own partial sums; the finishing pass
        # adds them in run order
        outputs=(BlockMap("part", (nsplit, C, g.cols), (1, g.tile, width),
                          lambda e, t, z: (z, t, e)),),
        rings=(Ring("cp.async", _bw.PSTAGES, scope="pairs") if g.pairs
               else Ring("cp.async", _bw.STAGES),),
        scope="pairs" if g.pairs else None)


def _bw_stats_work(cfg: dict):
    """S_c is symmetric: D(D+1)/2 products per (frame, component) for S,
    D for f and 1 for n (times ``touched``, the share of (frame, tile)
    pairs with a non-zero Γ over the form's component tiles, where
    given); all of S is written."""
    F, C, D = cfg["F"], cfg["C"], cfg["D"]
    E = _bw.n_columns(D)
    return (2.0 * F * C * E * cfg.get("touched", 1.0),
            4.0 * (F * C + F * D + C * (D * D + D + 1)), "float32")


def _bw_stats_moved(cfg: dict) -> float:
    """Γ once a column tile (its compaction pass reads it once more), x's
    columns a block reads (rows: all D; pairs: its 2 x 16 indices) once a
    (column tile, component tile), the partial sums written and read by
    the finishing pass, n, f and S written; ``touched`` over the form's
    component tiles."""
    F, C, D = cfg["F"], cfg["C"], cfg["D"]
    g = _bw.geometry(D)
    nsplit = cfg.get("nsplit") or _bw.splits(F, C, D, cfg.get("n_sm", 132))
    ct = g.cols // (_bw.PN if g.pairs else _bw.BN)
    xcols = 2 * _bw.PB if g.pairs else D
    touched = cfg.get("touched", 1.0)
    return (4.0 * F * C * (ct * touched + 1)
            + 4.0 * F * xcols * ct * _cdiv(C, g.tile) * touched
            + 8.0 * nsplit * C * g.cols + 4.0 * C * (D * D + D + 1))


# ---------------------------------------------------------------------------
# flash_attention: causal GQA forward, bf16 on wgmma, f32 on CUDA cores
# ---------------------------------------------------------------------------


def _flash_instance(cfg: dict) -> KernelInstance:
    """One block per (query tile, head, batch row); past hd 256 (bf16, the
    width-512 instance, namespace wide) one per (query tile, head x
    column slice, batch row), numbered ``longest_first``, each writing its
    slice of o's columns. f32 (the CUDA cores): one per (``simt_rows``
    query rows, head, batch row), the longest rows first
    (``longest_first``, tile nq - 1 first), with its ``cp.async`` ring."""
    import torch
    B, S, H, hd = cfg["B"], cfg["S"], cfg["H"], cfg["hd"]
    dt = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
    bq = _fa.q_rows(dt, hd)
    route = _fa.route(dt, hd)
    sl = _fa.slices(dt, hd)
    grid = (_cdiv(S, bq), H * sl, B)
    if route == "simt":
        def tile(i, j, b):
            """(batch row, query tile, head, column slice) of a block."""
            x, y, bb = _fa.longest_first(i, j, b, grid)
            return bb, grid[0] - 1 - x, y // sl, y % sl
        scope, ring = "simt", Ring("cp.async", _fa.SIMT_STAGES, "simt")
    elif sl > 1:
        def tile(i, j, b):
            """(batch row, query tile, head, column slice) of a block."""
            qt, y, bb = _fa.longest_first(i, j, b, grid)
            return bb, qt, y // sl, y % sl
        scope, ring = "wide", Ring("tma", _fa.WIDE_STAGES, "wide")
    else:
        def tile(i, h, b):
            return b, i, h, 0
        scope, ring = route, Ring("tma", _fa.TC_STAGES, route)
    return KernelInstance(
        grid=grid, threads=_fa.THREADS[route],
        smem_bytes=_fa.smem_bytes(dt, hd),
        axes=(Axis("queries", S, bq), Axis("heads x slices", H * sl, 1),
              Axis("batch", B, 1)),
        outputs=(BlockMap("o", (B, S, H, hd), (1, bq, 1, -(-hd // sl)),
                          tile, dtype=cfg.get("dtype", "float32")),),
        rings=(ring,), scope=scope)


def _flash_work(cfg: dict):
    B, S, H, KVH, hd = cfg["B"], cfg["S"], cfg["H"], cfg["KVH"], cfg["hd"]
    dt = cfg.get("dtype", "float32")
    # causal: half of Q·Kᵀ and of P·V; q and o [B, S, H, hd], k and v
    # [B, S, KVH, hd]; with ``lse`` (a training forward) the rows'
    # log-sum-exps [B, H, S] f32
    return (4.0 * B * H * hd * S * S / 2,
            DTYPE_BYTES[dt] * hd * (2 * B * S * H + 2 * B * S * KVH)
            + (4.0 * B * H * S if cfg.get("lse") else 0.0), dt)


# ---------------------------------------------------------------------------
# flash_attention_bwd: the attention's gradients, dQ and dK/dV passes
# ---------------------------------------------------------------------------


def _flash_bwd_instance(cfg: dict) -> KernelInstance:
    """The dK/dV launch: one block per (key tile, kv head, batch row); on
    the tensor cores (bf16) with its TMA ring of (q, dO) tiles. Above hd
    128 one block per (key tile, kv head x split, batch row), and past 256
    (the width-512 instance, namespace wide) per (key tile, (kv head x
    column slice) x split, batch row), numbered ``longest_first``, each
    writing its slice of the columns, as its split's f32 partial dK and dV
    where ``bwd_splits`` > 1 (the fourth kernel adds them). f32 (the CUDA
    cores): one per (``bwd_rows`` key rows, (kv head x column slice) x
    split, batch row) at every head dim, numbered ``longest_first``, with its
    ``cp.async`` ring; ``simt_bwd_slices`` column slices past hd 256, the
    split ``bwd_splits`` (or the config's ``splits``)."""
    import torch
    B, S, H, KVH, hd = cfg["B"], cfg["S"], cfg["H"], cfg["KVH"], cfg["hd"]
    dt = cfg.get("dtype", "float32")
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    scope = _fa.bwd_scope(tdt, hd)
    br = _fa.bwd_rows(tdt, hd)
    splits = cfg.get("splits") or _fa.bwd_splits(tdt, B, S, H, KVH, hd)
    sl = _fa.bwd_slices(tdt, hd)
    cols = -(-hd // sl)
    if scope == "simt" and sl > 1:
        cols = _fa.simt_bwd_width(hd)
    grid = (_cdiv(S, br), KVH * sl * splits, B)
    if scope == "simt" or hd > 128:
        def tile(i, j, b):
            """(split, batch row, key tile, kv head, column slice) of block
            (i, j, b)."""
            kt, y, bb = _fa.longest_first(i, j, b, grid)
            return y % splits, bb, kt, y // (splits * sl), (y // splits) % sl
        if splits > 1:
            outs = tuple(BlockMap(n, (splits, B, S, KVH, hd),
                                  (1, 1, br, 1, cols), tile)
                         for n in ("dk_part", "dv_part"))
        else:
            outs = tuple(BlockMap(n, (B, S, KVH, hd), (1, br, 1, cols),
                                  lambda i, j, b: tile(i, j, b)[1:],
                                  dtype=dt) for n in ("dk", "dv"))
    else:
        outs = tuple(BlockMap(n, (B, S, KVH, hd), (1, br, 1, hd),
                              lambda i, kh, b: (b, i, kh, 0), dtype=dt)
                     for n in ("dk", "dv"))
    wide = scope == "tc" and hd > 256
    return KernelInstance(
        grid=grid, threads=_fa.BWD_THREADS[scope],
        smem_bytes=_fa.bwd_smem_bytes(tdt, hd),
        axes=(Axis("keys", S, br),
              Axis("kv_heads x slices x splits", KVH * sl * splits, 1),
              Axis("batch", B, 1)),
        outputs=outs,
        rings=((Ring("tma", _fa.WIDE_STAGES, "wide") if wide else
                Ring("tma", _fa.BWD_TC_STAGES, "tc"),) if scope == "tc"
               else (Ring("cp.async", _fa.SIMT_STAGES, "simt"),)),
        scope="wide" if wide else scope)


def _flash_bwd_work(cfg: dict):
    """Five products over the causal half (Q·Kᵀ again, dO·Vᵀ, Pᵀ·dO,
    dSᵀ·Q, dS·K); q, o, dO read and dQ written [B, S, H, hd], k, v read
    and dK, dV written [B, S, KVH, hd], the lse read."""
    B, S, H, KVH, hd = cfg["B"], cfg["S"], cfg["H"], cfg["KVH"], cfg["hd"]
    dt = cfg.get("dtype", "float32")
    return (5.0 * 2 * B * H * hd * S * S / 2,
            DTYPE_BYTES[dt] * hd * (4 * B * S * H + 4 * B * S * KVH)
            + 4.0 * B * H * S, dt)


# ---------------------------------------------------------------------------
# selective_scan: the Mamba recurrence, d_state over lanes
# ---------------------------------------------------------------------------


def _scan_instance(cfg: dict) -> KernelInstance:
    """The f32 forward (64 channels a block, ``lanes`` a channel) or, at a
    16-bit scan_dtype, the tree forward (namespace tree: ``tree_channels``
    a block, ``tree_lanes`` a channel), one block a (channel block, batch
    row, state group): past 64 states group 0 writes its partial y to y
    and each other group to its slice of a [groups - 1, B, T, di] scratch
    (sum_groups_kernel adds them into y; the map below takes y and the
    scratch as one [groups, B, T, di] array of partials), and each its
    states' slice of h_last."""
    B, T, di, ds = cfg["B"], cfg["T"], cfg["di"], cfg["ds"]
    sd = cfg.get("scan_dtype", "float32")
    tree = _ss.form(sd) != 0
    ch = _ss.tree_channels(ds) if tree else _ss.CH
    ng, n = _ss.groups(ds), _ss.instance(ds)
    return KernelInstance(
        grid=(_cdiv(di, ch), B, ng),
        threads=ch * (_ss.tree_lanes(ds) if tree else _ss.lanes(ds)),
        smem_bytes=_ss.smem_bytes(ds, sd),
        axes=(Axis("channels", di, ch), Axis("batch", B, 1),
              Axis("state groups", ds, n)),
        outputs=(BlockMap("y (group partials)", (ng, B, T, di),
                          (1, 1, T, ch), lambda i, b, g: (g, b, 0, i)),
                 BlockMap("h_last", (B, di, ds), (1, ch, n),
                          lambda i, b, g: (b, i, g))),
        rings=(Ring("cp.async", _ss.STAGES),),
        scope="tree" if tree else None)


def _scan_work(cfg: dict):
    """Per (b, t, d, s): dt·A, exp, ·h, dx·B, +, ·C, +; dt, dx, y per
    (b, t, d), Bc and Cc per (b, t), A, h_last (and h0) once; with
    ``save_states`` (a training forward) each chunk's start state. At a
    16-bit scan_dtype the tree's two combines (·, ·, + each) take the
    place of ·h and +, and h_t is f32(A_t)·h + f32(B_t): 12; the bytes do
    not change."""
    B, T, di, ds = cfg["B"], cfg["T"], cfg["di"], cfg["ds"]
    h0 = cfg.get("h0", False)
    saved = _ss.n_chunks(T) if cfg.get("save_states") else 0
    per = 7.0 if _ss.form(cfg.get("scan_dtype", "float32")) == 0 else 12.0
    return (per * B * T * di * ds,
            4.0 * (3 * B * T * di + 2 * B * T * ds + di * ds
                   + B * di * ds * (2 + saved if h0 else 1 + saved)),
            "float32")


# ---------------------------------------------------------------------------
# selective_scan_bwd: the scan's gradients, chunks walked in reverse
# ---------------------------------------------------------------------------


def _scan_bwd_instance(cfg: dict) -> KernelInstance:
    """The gradient pass: one block per (state group x 64 channels,
    segment, batch row), ds / 4 lanes a channel (the instance's), its
    chunks through a cp.async ring; past 64 states group 0 writes its
    partial d(dt) and d(dx) to the outputs and each other group to its
    slices of a [groups - 1, 2, B, T, di] scratch (sum_groups_kernel adds
    them into the outputs; the maps below take the outputs and the
    scratch as [groups, B, T, di] arrays of partials), and each its slice
    of the carries' scratch."""
    B, T, di, ds = cfg["B"], cfg["T"], cfg["di"], cfg["ds"]
    seg = _ss.SEG_CHUNKS * _ss.BT
    ch, n = _ss.bwd_channels(ds), _ss.instance(ds)
    ng, nblk = _ss.groups(ds), _cdiv(di, ch)
    return KernelInstance(
        grid=(nblk * ng, _ss.n_segments(T), B),
        threads=ch * _ss.bwd_lanes(ds),
        smem_bytes=_ss.bwd_smem_bytes(ds),
        axes=(Axis("state groups x channels", di * ng, ch),
              Axis("segments", T, seg), Axis("batch", B, 1)),
        outputs=(BlockMap("ddt (group partials)", (ng, B, T, di),
                          (1, 1, seg, ch),
                          lambda i, s, b: (i // nblk, b, s, i % nblk)),
                 BlockMap("ddx (group partials)", (ng, B, T, di),
                          (1, 1, seg, ch),
                          lambda i, s, b: (i // nblk, b, s, i % nblk)),
                 # dA's partial a (batch row, segment), each group's
                 # slice of the W = n x groups states, added by
                 # sum_mid_kernel
                 BlockMap("dA_part", (B, _ss.n_segments(T), di, n * ng),
                          (1, 1, ch, n),
                          lambda i, s, b: (b, s, i % nblk, i // nblk))),
        rings=(Ring("cp.async", _ss.STAGES, "bwd"),),
        scope="bwd")


def _scan_bwd_work(cfg: dict):
    """Per (b, t, d, s): the state again (dt·A, exp, ·h, dx·B, +), the
    adjoint (dy·C, a·g, +), d(dx) (·B, +), d(dt) and dA (g·a·h, ·A, +,
    ·dt, +), dB (g·dx, +) and dC (dy·h, +): 19. dt, dx, dy read and
    d(dt), d(dx) written per (b, t, d); Bc, Cc read and dB, dC written per
    (b, t); A read and dA written; the saved chunk states read (and
    dh_last read, dh0 written)."""
    B, T, di, ds = cfg["B"], cfg["T"], cfg["di"], cfg["ds"]
    state = B * di * ds
    extra = (1 if cfg.get("dh_last") else 0) + (1 if cfg.get("dh0") else 0)
    return (19.0 * B * T * di * ds,
            4.0 * (5 * B * T * di + 4 * B * T * ds + 2 * di * ds
                   + state * (_ss.n_chunks(T) + extra)), "float32")


register(KernelSpec(
    name="gmm_loglik", source="gmm_loglik.cu",
    describe=_gmm_loglik_instance, work=_gmm_loglik_work,
    default_config={"F": 512, "C": 256, "D": 12},
    main_config={"F": 4096, "C": 2048, "D": 72},
    replaces="src/repro/kernels/gmm_loglik.py:49", moved=_gmm_loglik_moved))
register(KernelSpec(
    name="gmm_rescore", source="gmm_rescore.cu",
    describe=_gmm_rescore_instance, work=_gmm_rescore_work,
    default_config={"F": 512, "C": 256, "D": 12, "K": 8},
    main_config={"F": 16384, "C": 2048, "D": 72, "K": 20},
    replaces="src/repro/kernels/gmm_rescore.py:129",
    moved=_gmm_rescore_moved))
register(KernelSpec(
    name="gmm_align", source="gmm_align.cu",
    describe=_gmm_align_instance, work=_gmm_align_work,
    default_config={"F": 512, "C": 256, "D": 12, "K": 8},
    main_config={"F": 16384, "C": 2048, "D": 72, "K": 20},
    replaces="src/repro/kernels/gmm_align.py:162", moved=_gmm_align_moved))
register(KernelSpec(
    name="tvm_estep", source="packed_matmul.cu",
    describe=_tvm_estep_instance, work=_tvm_estep_work,
    default_config={"M": 256, "K": 256, "N": 512, "dtype": "bfloat16"},
    main_config={"M": 512, "K": 2048, "N": 80200, "dtype": "float32"},
    replaces="src/repro/kernels/tvm_estep.py:63"))
register(KernelSpec(
    name="bw_stats", source="bw_stats.cu",
    describe=_bw_stats_instance, work=_bw_stats_work,
    default_config={"F": 1024, "C": 256, "D": 12},
    main_config={"F": 32768, "C": 2048, "D": 72},
    replaces="src/repro/kernels/bw_stats.py:54", moved=_bw_stats_moved))
register(KernelSpec(
    name="flash_attention", source="flash_attention.cu",
    describe=_flash_instance, work=_flash_work,
    default_config={"B": 1, "S": 256, "H": 4, "KVH": 2, "hd": 64,
                    "dtype": "bfloat16"},
    main_config={"B": 4, "S": 2048, "H": 32, "KVH": 8, "hd": 128,
                 "dtype": "bfloat16"},
    replaces="src/repro/kernels/flash_attention.py:80"))
register(KernelSpec(
    name="flash_attention_bwd", source="flash_attention_bwd.cu",
    describe=_flash_bwd_instance, work=_flash_bwd_work,
    default_config={"B": 1, "S": 256, "H": 4, "KVH": 2, "hd": 64,
                    "dtype": "bfloat16"},
    main_config={"B": 4, "S": 4096, "H": 32, "KVH": 32, "hd": 64,
                 "dtype": "bfloat16"},
    replaces="src/repro/kernels/flash_attention.py:80"))
register(KernelSpec(
    name="selective_scan_bwd", source="selective_scan_bwd.cu",
    describe=_scan_bwd_instance, work=_scan_bwd_work,
    default_config={"B": 2, "T": 64, "di": 256, "ds": 16},
    main_config={"B": 1, "T": 4096, "di": 8192, "ds": 16},
    replaces="src/repro/kernels/selective_scan.py:69"))
register(KernelSpec(
    name="selective_scan", source="selective_scan.cu",
    describe=_scan_instance, work=_scan_work,
    default_config={"B": 2, "T": 64, "di": 256, "ds": 16},
    main_config={"B": 4, "T": 2048, "di": 8192, "ds": 16},
    replaces="src/repro/kernels/selective_scan.py:69"))
