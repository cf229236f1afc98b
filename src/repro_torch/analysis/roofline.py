"""Roofline terms for the H100, and the fused-alignment cost model (the
counterpart of ``repro/analysis/roofline.py``, whose tables are a TPU
v5e's).

    compute term    = flops / peak rate of the operands' type
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / NVLink bandwidth a direction

``bound(flops, bytes, dtype)`` is the least time the card could take for
a call: the larger of the first two. The kernel registry's ``work`` gives
its arguments for each kernel, so the bound of a kernel reads the same
work whichever implementation runs. ``RooflineReport`` carries a whole
step's counts (``analysis/op_cost.py``) with the reference's fields and
``row()`` keys; ``roofline_from_counts`` builds one.

``align_cost_model`` and ``autotune_align`` model the instances the CUDA
``gmm_align`` has (``kernels/gmm_align.geometry``: streaming, whole-row
and spill) and pick the one ``geometry`` picks; they predict, they never
choose what runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.kernels import gmm_align as _ga

# ---------------------------------------------------------------------------
# Hardware profiles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hardware:
    """Peak rates of one device, the compute rate by operand type."""
    name: str
    peaks: Dict[str, float]          # FLOP/s by dtype name
    hbm_bw: float                    # B/s
    link_bw: float                   # B/s a direction to the other cards
    hbm_bytes: float                 # capacity

    def peak(self, dtype: str = "float32") -> float:
        return self.peaks[dtype]


# NVIDIA's H100 SXM data sheet, dense: 67 TFLOP/s f32 on the CUDA cores,
# 989 bf16 (and fp16) and 495 TF32 on the tensor cores; 80 GB of HBM3 at
# 3.35 TB/s; NVLink 4, 900 GB/s to the other cards, 450 each way. All at
# 700 W.
H100 = Hardware(name="h100-sxm",
                peaks={"float32": 67e12, "bfloat16": 989e12,
                       "float16": 989e12, "tfloat32": 495e12},
                hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)
HW = H100

# the reference's CPU profile for the same cost model (one core: GEMMs at
# ~8e10 FLOP/s f32, streaming ~2e10 B/s)
CPU_HW = Hardware(name="cpu",
                  peaks={"float32": 8e10, "bfloat16": 8e10, "float16": 8e10,
                         "tfloat32": 8e10},
                  hbm_bw=2e10, link_bw=1e9, hbm_bytes=4e9)


def bound(flops: float, nbytes: float, dtype: str = "float32",
          hw: Hardware = HW):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for the operands' type."""
    t_ops = flops / hw.peak(dtype) * 1e3
    t_mem = nbytes / hw.hbm_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def kernel_bound(name: str, config: dict, hw: Hardware = HW):
    """``bound`` of one call of a registered kernel at ``config``."""
    from repro_torch.kernels import registry
    return bound(*registry.get(name).cost(config), hw=hw)


# ---------------------------------------------------------------------------
# The fused alignment's cost model (kernels/gmm_align.py, csrc/gmm_align.cu)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlignTune:
    """The fused-alignment instance for one (C, K, D) cell: what
    ``geometry`` launches, with the model's time for it and for every
    instance the kernel admits there."""
    instance: str            # 'stream' (64-frame blocks) | 'rows' | 'spill'
    block_f: int             # frames a block keeps
    smem_bytes: int
    t_predicted: float       # model seconds for ``frames`` frames
    rows_per_frame: int      # packed rows a frame's rescore reads (K)
    candidates: tuple = ()   # ((instance, block_f, t_pred), ...)


def align_cost_model(C: int, K: int, D: int, *, block_f: int,
                     instance: str, frames: int = 4096,
                     rescore_only: bool = False,
                     hw: Hardware = HW) -> float:
    """Predicted seconds of one ``gmm_align`` launch over ``frames``
    frames: the preselect's roofline time plus the rescore's, since a
    block runs them one after the other.

    The preselect does 2·F·C·(2D + 1) operations whatever the block, and
    every frame block streams the diag coefficient slabs (2D + 1 rows of
    C) through its ring again: its bytes grow with ceil(frames /
    block_f), plus x once. The rescore does 2·F·K·E2 operations and reads
    one packed row (E2 floats) per (frame, slot) pair; ll (f32) and sel
    (int64) are written once. ``rescore_only`` (``gmm_rescore_fused``)
    has no preselect and reads sel instead of writing it. The spill form
    (64-frame preselect blocks) adds, between the two, its score rows [F,
    C] written and read back by the select (the NaN scan, 4 radix-select
    passes where K < C, the compaction) and the K keys and ids written by
    the compaction and by each of its 4 sort passes, which read them twice.
    """
    if instance not in ("stream", "rows", "spill"):
        raise ValueError(f"instance must be 'stream', 'rows' or 'spill': "
                         f"{instance!r}")
    E2 = 1 + D + D * (D + 1) // 2
    F = frames
    peak = hw.peak("float32")
    t = max(2.0 * F * K * E2 / peak,
            (4.0 * F * K * E2 + 12.0 * F * K) / hw.hbm_bw)
    if rescore_only:
        return t + 4.0 * F * D / hw.hbm_bw
    blocks = -(-F // block_f)
    if instance == "spill":
        t += (4.0 * F * C * (3 + (4 if K < C else 0))
              + 8.0 * F * K * 13) / hw.hbm_bw
    return t + max(2.0 * F * C * (2 * D + 1) / peak,
                   (4.0 * F * D + 4.0 * blocks * C * (2 * D + 1))
                   / hw.hbm_bw)


def _admitted(C: int, K: int, D: int, rescore_only: bool):
    """(instance, frames a block, shared memory) of every instance the
    kernel can run at these shapes: the streaming one for K <= STREAM_K
    and for the rescore alone; the whole-row one, 16 or 8 frames, for any
    K of a full alignment; each where it fits in a block's shared memory,
    with phase B's pair table there or, wide, in device memory; and the
    spill form for K > STREAM_K where no whole-row block fits."""
    def fits(stream: bool, bf: int):
        for wide in (False, True):
            smem = _ga.smem_bytes(C, D, stream, bf, wide)
            if smem <= _ga.MAX_SMEM:
                return smem
        return None

    out = []
    if rescore_only or K <= _ga.STREAM_K:
        smem = fits(True, _ga.BF_STREAM)
        if smem is not None:
            out.append(("stream", _ga.BF_STREAM, smem))
    if not rescore_only:
        for bf in _ga.BF_ROWS:
            smem = fits(False, bf)
            if smem is not None:
                out.append(("rows", bf, smem))
        if K > _ga.STREAM_K and not out:
            smem = _ga.smem_bytes(C, D, False, _ga.BF_STREAM, spill=True)
            if smem <= _ga.MAX_SMEM and fits(True, _ga.BF_STREAM):
                out.append(("spill", _ga.BF_STREAM, smem))
    return out


def autotune_align(C: int, K: int, D: int, *, device=None,
                   frames: int = 4096,
                   rescore_only: bool = False) -> AlignTune:
    """The instance ``gmm_align.geometry`` launches for (C, K, D), with
    ``align_cost_model``'s time for it and for every admitted instance
    (on the card's profile, or ``CPU_HW`` for a CPU ``device``).

    The model's fastest admitted instance must be the one ``geometry``
    launches (the streaming one wherever K allows it: the whole-row
    blocks stream the coefficient slabs 4 or 8 times as often), else this
    raises; it raises where ``geometry`` does too.
    ``chip_smoke.py`` prints predicted against measured for both
    instances at the main path's shapes.
    """
    import torch
    dev = torch.device("cuda" if device is None else device)
    hw = CPU_HW if dev.type == "cpu" else HW
    g = _ga.geometry(C, D, K, rescore_only)
    cands = tuple(
        (inst, bf, align_cost_model(C, K, D, block_f=bf, instance=inst,
                                    frames=frames,
                                    rescore_only=rescore_only, hw=hw))
        for inst, bf, _ in _admitted(C, K, D, rescore_only))
    win = min(cands, key=lambda c: c[2])     # ties go to the first listed
    pick = ("spill" if g.spill else "stream" if g.stream else "rows", g.rows)
    if win[:2] != pick:
        raise RuntimeError(f"autotune_align: the model picks {win[:2]}, "
                             f"geometry launches {pick}")
    # every instance scores one packed row per (frame, slot) pair
    return AlignTune(instance=pick[0], block_f=g.rows, smem_bytes=g.smem,
                     t_predicted=win[2], rows_per_frame=K, candidates=cands)


# ---------------------------------------------------------------------------
# A whole step's roofline
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float
    peak_memory_per_device: Optional[float] = None
    collectives: Dict[str, float] = field(default_factory=dict)
    dtype: str = "float32"               # the step's contractions' type
    hw: Hardware = HW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time: how close the step is to the
        compute roofline given its dominant term."""
        t_useful = ((self.model_flops_total / self.chips)
                    / self.hw.peak(self.dtype))
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.collective_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_per_device": self.peak_memory_per_device,
            "collectives": self.collectives,
        }


def roofline_from_counts(counter, *, arch: str, shape: str, mesh_desc: str,
                         chips: int, model_flops: float,
                         peak_memory: Optional[float] = None,
                         dtype: str = "float32",
                         hw: Hardware = HW) -> RooflineReport:
    """A report from an ``op_cost.OpCounter`` that counted one step on one
    device (its numbers are that device's, as the reference's partitioned
    HLO is per device)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops_per_device=float(counter.flops),
        bytes_per_device=float(counter.bytes),
        collective_bytes_per_device=float(counter.coll_bytes),
        model_flops_total=model_flops, peak_memory_per_device=peak_memory,
        collectives=dict(counter.coll), dtype=dtype, hw=hw)
