"""The port's ``analysis/`` and kernel registry on the CPU: the registry
against the wrappers' geometry and the ``.cu`` sources, the bounds
PERF.md §6 prints, ``autotune_align`` against ``gmm_align.geometry``,
``op_cost``'s contraction flops against the reference's HLO walker on
the same functions, kernel regions, and ``RooflineReport``'s keys.

Tolerances: flop counts are integers in floats, held exactly; the bounds
to PERF.md's printed digits.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as jroof  # noqa: E402
from repro.analysis.hlo_cost import analyze_hlo  # noqa: E402
from repro.core import alignment as JA  # noqa: E402
from repro.core import tvm as JT  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro_torch.analysis import op_cost, roofline  # noqa: E402
from repro_torch.configs.ivector_tvm import CONFIG  # noqa: E402
from repro_torch.core import alignment as TA  # noqa: E402
from repro_torch.core import trainer as TR  # noqa: E402
from repro_torch.core import tvm as TT  # noqa: E402
from repro_torch.core import ubm as TU  # noqa: E402
from repro_torch.kernels import bw_stats as tbw  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import gmm_align as tga  # noqa: E402
from repro_torch.kernels import gmm_loglik as tgl  # noqa: E402
from repro_torch.kernels import gmm_rescore as tgr  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.kernels import tvm_estep as tte  # noqa: E402
from repro_torch.launch import ivector_cell as IC  # noqa: E402

SEVEN = ("bw_stats", "flash_attention", "gmm_align", "gmm_loglik",
         "gmm_rescore", "selective_scan", "tvm_estep")
# the port's own kernels: the derivatives of two of the seven, which the
# TPU side left to jnp autodiff -> the TPU kernel each differentiates
BACKWARD = {"flash_attention_bwd": "flash_attention",
            "selective_scan_bwd": "selective_scan"}

# PERF.md §6's rows at the main paths' shapes -> (registry kernel, config,
# printed bound ms, bound by)
PERF_ROWS = {
    "gmm_loglik": ("gmm_loglik", {"F": 4096, "C": 2048, "D": 72},
                   "0.676", "operations"),
    "gmm_rescore": ("gmm_rescore", {"F": 16384, "K": 20, "C": 2048, "D": 72},
                    "0.0514", "operations"),
    "tvm_estep_l": ("tvm_estep", {"M": 16, "K": 2048, "N": 80200,
                                  "dtype": "float32"}, "0.198", "bytes"),
    "tvm_estep_l_train": ("tvm_estep", {"M": 512, "K": 2048, "N": 80200,
                                        "dtype": "float32"}, "2.510",
                          "operations"),
    "tvm_estep_a": ("tvm_estep", {"M": 2048, "K": 512, "N": 80200,
                                  "dtype": "float32"}, "2.510", "operations"),
    "tvm_estep_l_bf16": ("tvm_estep", {"M": 16, "K": 2048, "N": 80200,
                                       "dtype": "bfloat16"}, "0.0996",
                         "bytes"),
    "tvm_estep_l_bf16_train": ("tvm_estep", {"M": 512, "K": 2048, "N": 80200,
                                             "dtype": "bfloat16"}, "0.170",
                               "operations"),
    "tvm_estep_a_bf16": ("tvm_estep", {"M": 2048, "K": 512, "N": 80200,
                                       "dtype": "bfloat16"}, "0.221",
                         "bytes"),
    "bw_stats": ("bw_stats", {"F": 32768, "C": 2048, "D": 72}, "5.411",
                 "operations"),
    "gmm_align": ("gmm_align", {"F": 16384, "C": 2048, "D": 72, "K": 20},
                  "0.172", "operations"),
    "flash_attention": ("flash_attention", {"B": 4, "S": 2048, "H": 32,
                                            "KVH": 8, "hd": 128,
                                            "dtype": "bfloat16"}, "0.139",
                        "operations"),
    "selective_scan": ("selective_scan", {"B": 4, "T": 2048, "di": 8192,
                                          "ds": 16}, "0.241", "bytes"),
    # the backward kernels at a Jamba micro-batch's training shapes
    "flash_attention_bwd": ("flash_attention_bwd",
                            {"B": 1, "S": 4096, "H": 32, "KVH": 8, "hd": 128,
                             "dtype": "bfloat16"}, "0.347", "operations"),
    "selective_scan_bwd": ("selective_scan_bwd", {"B": 1, "T": 4096,
                                                  "di": 8192, "ds": 16},
                           "0.241", "bytes"),
}

# every (C, D, K) gmm_align.geometry meets in tests/test_torch_*.py: the
# geometry test's shapes, the Pallas-parity cases and the configs the
# fused rung runs at
ALIGN_SHAPES = ((2048, 72, 20), (2048, 72, 40), (2048, 72, 2048),
                (3072, 72, 40), (3073, 72, 40), (4096, 72, 40),
                (4096, 72, 4096), (6272, 72, 40), (23, 6, 5),
                (2048, 72, 32), (300, 5, 7), (8, 5, 4), (16, 8, 8),
                (16, 6, 4), (32, 6, 4), (16, 4, 4), (12, 4, 4),
                # the spill form and phase B in device memory
                (6273, 72, 33), (8192, 72, 64), (8192, 72, 8192),
                (65536, 72, 65536), (2048, 234, 20), (2048, 235, 20),
                (2048, 256, 20), (2048, 512, 20), (2048, 512, 40),
                (2048, 512, 2048), (8192, 512, 8192))


def test_registry_has_the_seven_kernels():
    """The seven TPU kernels' counterparts, plus the two backward kernels,
    each naming the TPU kernel it is the derivative of."""
    assert tuple(s.name for s in registry.all_specs()) == tuple(
        sorted(SEVEN + tuple(BACKWARD)))
    for spec in registry.all_specs():
        assert spec.path.exists(), spec.path
        assert spec.replaces.startswith("src/repro/kernels/")
    for bwd, fwd in BACKWARD.items():
        assert registry.get(bwd).replaces == registry.get(fwd).replaces


@pytest.mark.parametrize("row", sorted(PERF_ROWS))
def test_bounds_equal_perf_md(row):
    """The bound of every PERF.md §6 row, from the registry's work, to the
    printed digits."""
    name, cfg, printed, by = PERF_ROWS[row]
    ms, got_by = roofline.bound(*registry.get(name).cost(cfg))
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed and got_by == by, (row, ms, got_by)


def test_registry_shared_memory_is_the_wrappers_geometry():
    for spec in registry.all_specs():
        inst = spec.instance(spec.main_config)
        assert 0 < inst.smem_bytes <= tga.MAX_SMEM, spec.name
    assert (registry.get("gmm_align").instance(
        {"F": 16384, "C": 2048, "D": 72, "K": 20}).smem_bytes
        == tga.geometry(2048, 72, 20)[2])
    inst = registry.get("gmm_align").instance(
        {"F": 2048, "C": 2048, "D": 72, "K": 40})
    assert (inst.grid, inst.smem_bytes) == ((2048 // 16,),
                                            tga.geometry(2048, 72, 40)[2])
    g = tgr.geometry(16384, 20, 2048, 72)
    inst = registry.get("gmm_rescore").instance(
        {"F": 16384, "K": 20, "C": 2048, "D": 72})
    assert (inst.grid, inst.smem_bytes) == ((g.max_items,), g.smem_bytes)
    assert registry.get("gmm_loglik").instance(
        {"D": 72}).smem_bytes == tgl.smem_bytes(72)
    assert registry.get("bw_stats").instance(
        {"D": 72}).smem_bytes == tbw.smem_bytes(72)
    assert registry.get("selective_scan").instance(
        {"ds": 16}).smem_bytes == tss.smem_bytes(16)
    # the static_assert of csrc/flash_attention.cu: hd 192 fills a block
    assert tfa.smem_bytes(torch.bfloat16, 192) <= 232448
    for f in ("stream", "sgemm", "wgmma"):
        M = 16 if f == "stream" else 512
        dt = "bfloat16" if f == "wgmma" else "float32"
        inst = registry.get("tvm_estep").instance(
            {"M": M, "K": 2048, "N": 80200, "dtype": dt})
        assert inst.smem_bytes == tte.smem_bytes(f, 2 if f == "wgmma" else 4)


def _cu_int(src: str, name: str, scope=None) -> int:
    text = (registry.CSRC / src).read_text()
    if scope is not None:
        text = text[text.index(f"namespace {scope} {{"):]
    return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))


def test_wrapper_constants_are_the_cuda_ones():
    """The constants the registry's shared memory and grids are built from
    are those of the ``.cu`` sources."""
    for name in ("BM", "BN", "BK", "STAGES", "THREADS"):
        assert getattr(tgl, name) == _cu_int("gmm_loglik.cu", name), name
        assert getattr(tbw, name) == _cu_int("bw_stats.cu", name), name
    for name in ("CH", "BT"):
        assert getattr(tss, name) == _cu_int("selective_scan.cuh", name)
    assert tss.STAGES == _cu_int("selective_scan.cu", "STAGES")
    assert tga.THREADS == _cu_int("gmm_align.cu", "THREADS")
    assert tgr.THREADS == _cu_int("gmm_rescore.cu", "THREADS")
    for f, scope in (("stream", "stream"), ("sgemm", "sgemm"),
                     ("wgmma", "tc")):
        assert tte.STAGES[f] == _cu_int("packed_matmul.cu", "STAGES", scope)
        if f != "stream":
            assert tte.TILE[f] == (_cu_int("packed_matmul.cu", "BM", scope),
                                   _cu_int("packed_matmul.cu", "BN", scope))
    assert tte.TILE["stream"][1] == _cu_int("packed_matmul.cu", "BN",
                                            "stream")
    assert tte.THREADS["sgemm"] == _cu_int("packed_matmul.cu", "THREADS",
                                           "sgemm")
    assert tte.THREADS["wgmma"] == 32 + _cu_int("packed_matmul.cu",
                                                "CONSUMERS", "tc")
    # a CUDA-core block's rows by kernel and instance width: SIMT_WIDE_ROWS
    # up to SIMT_WIDE_UPTO, else SIMT_ROWS (BQ's f32 entry)
    assert tfa.BQ[torch.float32] == tfa.SIMT_ROWS
    rows_fns = {"fwd": ("flash_attention.cu", "rows"),
                "dq": ("flash_attention_bwd.cu", "dq_rows"),
                "dkdv": ("flash_attention_bwd.cu", "kv_rows")}
    for kernel, (src, fn) in rows_fns.items():
        text = (registry.CSRC / src).read_text()
        m = re.search(rf"constexpr int {fn}\(int W\) \{{\s+return W <= "
                      rf"(\d+) \? (\d+) : (\d+);", text)
        assert tuple(int(x) for x in m.groups()) == (
            tfa.SIMT_WIDE_UPTO[kernel], tfa.SIMT_WIDE_ROWS, tfa.SIMT_ROWS)
    assert (tfa.THREADS["simt"], tfa.SIMT_TILE) == tuple(
        _cu_int("flash_attention_simt.cuh", n) for n in ("THREADS", "TILE"))
    assert (tfa.SIMT_STAGES, tfa.SIMT_DC) == tuple(
        _cu_int("flash_attention.cu", n, "simt") for n in ("STAGES", "DC"))
    # a slab: TILE rows of a score slab's DC columns and 4 more, in both
    # sources
    fwd = (registry.CSRC / "flash_attention.cu").read_text()
    bwd = (registry.CSRC / "flash_attention_bwd.cu").read_text()
    assert "constexpr int STAGE = TILE * SLD;" in fwd
    assert "constexpr int STAGE = (128 + TILE) * (DC2 + 4);" in bwd
    assert tfa.SIMT_STAGE == tfa.SIMT_TILE * (tfa.SIMT_DC + 4)
    assert tfa.SIMT_BWD_STAGE == (tfa.SIMT_WIDE_ROWS + tfa.SIMT_TILE) * (
        tfa.SIMT_DC2 + 4)
    assert tfa.BQ[torch.bfloat16] == _cu_int("flash_attention.cu", "BQ",
                                             "tc")
    assert tfa.TC_STAGES == _cu_int("flash_attention.cu", "STAGES", "tc")
    assert (tfa.WIDE_STAGES, tfa.WIDE_BKV, tfa.WIDE_SLICES) == tuple(
        _cu_int("flash_attention.cu", n, "wide")
        for n in ("STAGES", "BKV", "SLICES"))


@pytest.mark.parametrize("hd", [64, 257, 512])
@pytest.mark.parametrize("splits", [1, 4])
def test_f32_attention_instances_are_the_kernels(hd, splits):
    """The registry's f32 attention instances are the CUDA-core launches
    as built: 64-row blocks of 256 threads with their ``cp.async`` rings
    and the sources' shared memory; the forward's grid (query tiles,
    heads, batch rows) numbered longest first (the first H x B blocks in
    launch order take the last query tile), the backward's (key tiles, (kv heads x
    column slices) x splits, batch rows) with two column slices past hd
    256 and, split, the partial dK and dV of each split; every output
    tile written once, and the kernel pass finds nothing."""
    from repro_torch.analysis.check import kernel_pass
    B, S, H, KVH = 2, 200, 8, 2
    cfg = dict(B=B, S=S, H=H, KVH=KVH, hd=hd, dtype="float32")
    fwd = registry.get("flash_attention")
    inst = fwd.instance(cfg)
    rows = 128 if hd <= 128 else 64
    nq = -(-S // rows)
    assert inst.grid == (nq, H, B) and inst.threads == 256
    # the ring, P, a row's rescale and the resident q tile
    qld = -(-hd // 32) * 32 + 4
    assert inst.smem_bytes == tfa.smem_bytes(torch.float32, hd) == 4 * (
        3 * 4608 + rows * (132 + 1 + qld))
    assert inst.rings == (registry.Ring("cp.async", tfa.SIMT_STAGES,
                                        "simt"),)
    o = inst.outputs[0]
    assert o.block == (1, rows, 1, hd)
    # the first H x B blocks in launch order take the last query tile,
    # every (head, batch row) of it, before any block takes another
    order = [np.unravel_index(n, (B, H, nq)) for n in range(nq * H * B)]
    first = [o.index_map(i, j, b) for b, j, i in order[:H * B]]
    assert {t[1] for t in first} == {nq - 1}
    assert {(t[0], t[2]) for t in first} == {(b, h) for b in range(B)
                                             for h in range(H)}
    tiles = {o.index_map(i, j, b) for i in range(nq) for j in range(H)
             for b in range(B)}
    assert len(tiles) == nq * H * B
    assert kernel_pass.check_kernel(fwd, cfg) == []
    bwd = registry.get("flash_attention_bwd")
    inst = bwd.instance(dict(cfg, splits=splits))
    sl = 1 if hd <= 256 else 2
    rows = 128 if hd <= 64 else 64
    nk = -(-S // rows)
    assert inst.grid == (nk, KVH * sl * splits, B) and inst.threads == 256
    # the ring, P and dS; no resident k and v tiles on 128-row blocks or
    # past ld 192
    assert inst.smem_bytes == tfa.bwd_smem_bytes(torch.float32, hd) == 4 * (
        3 * 5120 + 2 * rows * 132)
    assert inst.rings == (registry.Ring("cp.async", tfa.SIMT_STAGES,
                                        "simt"),)
    names = [m.name for m in inst.outputs]
    cols = hd if sl == 1 else tfa.simt_bwd_width(hd)
    if splits > 1:
        assert names == ["dk_part", "dv_part"]
        assert inst.outputs[0].block == (1, 1, rows, 1, cols)
    else:
        assert names == ["dk", "dv"]
        assert inst.outputs[0].block == (1, rows, 1, cols)
    assert kernel_pass.check_kernel(bwd, dict(cfg, splits=splits)) == []
    # the default split: the key tiles x 2 kv heads x 2 batch rows x the
    # slices (8 to 32 blocks) reach no 256 blocks at any divisor of the
    # group of 4, so the largest, 4; at S = 4096 and hd 128 the grid's 512
    # blocks need none
    want = 4
    assert tfa.bwd_splits(torch.float32, B, 4096, H, KVH, 128) == 1
    assert tfa.bwd_splits(torch.float32, B, S, H, KVH, hd) == want
    assert bwd.instance(cfg).grid == (nk, KVH * sl * want, B)


def test_backward_constants_are_the_cuda_ones():
    """The backward kernels' geometry in the wrappers (and so the
    registry's instances) is that of the ``.cu`` sources: the tensor-core
    attention backward's ring and threads, the scan backward's ring and
    states a lane."""
    assert tfa.BWD_TC_STAGES == _cu_int("flash_attention_bwd.cu", "STAGES",
                                        "tc")
    assert tfa.BWD_THREADS["tc"] == 128 + _cu_int("flash_attention_bwd.cu",
                                                  "CONSUMERS", "tc")
    assert tfa.BWD_THREADS["simt"] == _cu_int("flash_attention_simt.cuh",
                                              "THREADS")
    assert (tfa.SIMT_STAGES, tfa.SIMT_DC, tfa.SIMT_DC2,
            tfa.SIMT_MAX_SLICE, tfa.SIMT_KV_RESIDENT) == tuple(
        _cu_int("flash_attention_bwd.cu", n, "simt")
        for n in ("STAGES", "DC", "DC2", "MAX_SLICE", "KV_RESIDENT"))
    assert tss.STAGES == _cu_int("selective_scan_bwd.cu", "STAGES", "bwd")
    assert tss.BWD_STATES_PER_LANE == _cu_int("selective_scan_bwd.cu", "SL",
                                              "bwd")
    assert tfa.BWD_SPLIT_ROWS == _cu_int("flash_attention_bwd.cu",
                                         "SPLIT_ROWS", "tc")
    for hd in (64, 128, 256):
        inst = registry.get("flash_attention_bwd").instance(
            {"hd": hd, "dtype": "bfloat16"})
        assert inst.scope == "tc" and inst.rings[0].stages == 4
        assert inst.smem_bytes == tfa.bwd_smem_bytes(torch.bfloat16, hd)
    # hd 256: 64 key rows a block, both warpgroups', the dK/dV blocks of a
    # key tile split over the group's query heads (the default config's 2)
    inst = registry.get("flash_attention_bwd").instance(
        {"hd": 256, "dtype": "bfloat16"})
    assert inst.grid == (256 // tfa.BWD_SPLIT_ROWS, 2 * 2, 1)
    assert inst.threads == 128 + _cu_int("flash_attention_bwd.cu",
                                         "CONSUMERS", "tc")
    # bf16 hd 192 runs the width-256 instance; f32 the CUDA cores
    inst = registry.get("flash_attention_bwd").instance(
        {"hd": 192, "dtype": "bfloat16"})
    assert (inst.scope, inst.rings[0].stages, inst.threads) == ("tc", 4, 384)
    assert inst.smem_bytes == tfa.bwd_smem_bytes(torch.bfloat16, 256)
    inst = registry.get("flash_attention_bwd").instance(
        {"hd": 192, "dtype": "float32"})
    assert (inst.scope, inst.rings, inst.threads) == (
        "simt", (registry.Ring("cp.async", tfa.SIMT_STAGES, "simt"),),
        256)
    # past hd 256 the width-512 instance (namespace wide): its ring, and
    # the dK/dV blocks over (kv head x column slice) x split
    assert tfa.WIDE_STAGES == _cu_int("flash_attention_bwd.cu", "STAGES",
                                      "wide")
    assert (tfa.WIDE_TILE, tfa.WIDE_SLICES) == (
        _cu_int("flash_attention_bwd.cu", "TILE", "wide"),
        _cu_int("flash_attention_bwd.cu", "SLICES", "wide"))
    inst = registry.get("flash_attention_bwd").instance(
        {"hd": 320, "dtype": "bfloat16"})
    assert (inst.scope, inst.rings[0].stages) == ("wide", tfa.WIDE_STAGES)
    assert inst.grid == (256 // tfa.BWD_SPLIT_ROWS, 2 * tfa.WIDE_SLICES
                         * tfa.bwd_splits(torch.bfloat16, 1, 256, 4, 2, 320),
                         1)
    assert inst.smem_bytes == tfa.bwd_smem_bytes(torch.bfloat16, 320)
    inst = registry.get("selective_scan_bwd").instance(
        {"B": 1, "T": 4096, "di": 8192, "ds": 16})
    assert inst.grid == (128, tss.n_segments(4096), 1)
    assert inst.threads == 64 * 4 and inst.smem_bytes == tss.bwd_smem_bytes(
        16)


@pytest.mark.parametrize("C,D,K", ALIGN_SHAPES)
def test_autotune_pick_is_geometry(C, D, K):
    tune = roofline.autotune_align(C, K, D, device="cpu")
    g = tga.geometry(C, D, K)
    assert (tune.instance, tune.block_f, tune.smem_bytes) == (
        "spill" if g.spill else "stream" if g.stream else "rows", g.rows,
        g.smem)
    assert tune.t_predicted == min(t for _, _, t in tune.candidates)
    only = roofline.autotune_align(C, K, D, rescore_only=True)
    assert (only.instance, only.block_f) == ("stream", 64)


def test_autotune_candidates_and_refusal():
    t20 = roofline.autotune_align(2048, 20, 72, frames=16384)
    assert [c[:2] for c in t20.candidates] == [
        ("stream", 64), ("rows", 16), ("rows", 8)]
    t40 = roofline.autotune_align(2048, 40, 72, frames=16384)
    assert [c[:2] for c in t40.candidates] == [("rows", 16), ("rows", 8)]
    assert roofline.autotune_align(4096, 40, 72).block_f == 8
    # past C = 6272 at K > 32 no whole-row block fits: the spill form
    t = roofline.autotune_align(6273, 40, 72)
    assert [c[:2] for c in t.candidates] == [("spill", 64)]
    with pytest.raises(ValueError):
        roofline.autotune_align(2048, 20, 553)
    with pytest.raises(ValueError):
        roofline.align_cost_model(2048, 20, 72, block_f=64, instance="union")


def _old_model_flops(cfg, n_utts):
    """``model_flops`` as it was counted before it read autotune_align."""
    C, D, R, K = (cfg.n_components, cfg.feat_dim, cfg.ivector_dim,
                  cfg.posterior_top_k)
    F = n_utts * cfg.frames_per_utt
    align = 2.0 * F * 2 * D * C
    mode = cfg.rescore
    if mode == "sparse":
        align += 2.0 * F * K * (D * D + D)
    elif mode == "fused":
        align += 2.0 * F * K * (1 + D + D * (D + 1) // 2)
    else:
        align += 2.0 * F * (D * D + D) * C
    stats = 2.0 * F * K * (D * D + D)
    RR = R * (R + 1) / 2.0 if cfg.estep == "packed" else float(R * R)
    return (align + stats + 2.0 * n_utts * C * RR
            + 2.0 * n_utts * C * D * R + n_utts * (R ** 3) / 3.0 * 2
            + 2.0 * n_utts * C * (RR + D * R))


@pytest.mark.parametrize("rescore", ["sparse", "dense", "fused"])
def test_model_flops_unchanged(rescore):
    for estep in ("dense", "packed"):
        cfg = CONFIG.with_overrides(rescore=rescore, estep=estep)
        assert IC.model_flops(cfg, 8192) == _old_model_flops(cfg, 8192)


def test_roofline_report_row_keys_equal_the_reference():
    got = roofline.RooflineReport("ivector-tvm", "em_step", "(1, 1)", 1,
                                  1e12, 1e10, 0.0, 5e11).row()
    want = jroof.RooflineReport("ivector-tvm", "em_step", "(1, 1)", 1,
                                1e12, 1e10, 0.0, 5e11).row()
    assert list(got) == list(want)
    # f32 step on the H100: 1e12 flops at 67 TFLOP/s against 10 GB at
    # 3.35 TB/s
    assert got["dominant"] == "compute"
    assert got["t_compute_s"] == pytest.approx(1e12 / 67e12)
    assert got["roofline_fraction"] == pytest.approx(0.5)


def _gmm(rng, C, D):
    means = rng.standard_normal((C, D)).astype(np.float32)
    a = (0.3 * rng.standard_normal((C, D, D))).astype(np.float32)
    covs = (np.einsum("cij,ckj->cik", a, a) + np.eye(D)).astype(np.float32)
    return np.full(C, 1.0 / C, np.float32), means, covs


def test_op_cost_flops_equal_hlo_dots_align_frames():
    """Dense rung at toy sizes: the port's contraction flops (its plain
    versions walked, ``regions=False``) equal ``analyze_hlo``'s dot flops
    of the jitted JAX function, exactly. XLA rewrote none of the six dots
    here."""
    rng = np.random.default_rng(0)
    C, D, F, K = 16, 6, 97, 4
    w, m, c = _gmm(rng, C, D)
    x = rng.standard_normal((F, D)).astype(np.float32)
    jg = JU.FullGMM(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c))
    comp = jax.jit(lambda g, d, xx: JA.align_frames(
        xx, g, d, top_k=K, rescore="dense")).lower(
        jg, jg.to_diag(), jnp.asarray(x)).compile()
    want = analyze_hlo(comp.as_text())["flops"]
    tg = TU.FullGMM(torch.tensor(w), torch.tensor(m), torch.tensor(c))
    with op_cost.OpCounter(regions=False) as cnt:
        TA.align_frames(torch.tensor(x), tg, tg.to_diag(), top_k=K,
                        rescore="dense")
    assert cnt.flops == want > 0


@pytest.mark.parametrize("formulation", ["standard", "augmented"])
def test_op_cost_flops_equal_hlo_dots_em_accumulate(formulation):
    """Dense E-step accumulation at toy sizes, exactly (no dot rewritten)."""
    rng = np.random.default_rng(1)
    C, D, R, U = 8, 6, 5, 3
    _, m, S = _gmm(rng, C, D)
    T = rng.standard_normal((C, D, R)).astype(np.float32)
    n = rng.uniform(0.1, 5.0, (U, C)).astype(np.float32)
    f = rng.standard_normal((U, C, D)).astype(np.float32)
    prior = np.zeros(R, np.float32)
    jm = JT.TVModel(T=jnp.asarray(T), Sigma=jnp.asarray(S),
                    prior=jnp.asarray(prior), means=jnp.asarray(m),
                    formulation=formulation)
    comp = jax.jit(lambda mo, pr, nn, ff: JT.em_accumulate(
        mo, pr, nn, ff)).lower(jm, JT.precompute(jm, estep="dense"),
                               jnp.asarray(n), jnp.asarray(f)).compile()
    want = analyze_hlo(comp.as_text())["flops"]
    tm = TT.TVModel(T=torch.tensor(T), Sigma=torch.tensor(S),
                    prior=torch.tensor(prior), means=torch.tensor(m),
                    formulation=formulation)
    pre = TT.precompute(tm, estep="dense", device="cpu")
    with op_cost.OpCounter(regions=False) as cnt:
        TT.em_accumulate(tm, pre, torch.tensor(n), torch.tensor(f))
    assert cnt.flops == want > 0


def test_kernel_region_counts_the_registry_work():
    rng = np.random.default_rng(2)
    F, C, D, K = 50, 16, 6, 4
    x = torch.tensor(rng.standard_normal((F, D)), dtype=torch.float32)
    const, lin = torch.randn(C), torch.randn(D, C)
    P = torch.eye(D).reshape(1, D * D).repeat(C, 1)
    sel = torch.tensor(rng.integers(0, 6, (F, K)))
    n, pp = torch.rand(3, C), torch.rand(3, 10)
    with op_cost.OpCounter() as cnt:
        ops.gmm_loglik(x, const, lin, P)
        ops.gmm_rescore(x, sel, const, lin, P)
        ops.tvm_estep_a(n, pp, dtype="bf16")
    want = [registry.get("gmm_loglik").cost({"F": F, "C": C, "D": D}),
            registry.get("gmm_rescore").cost(
                {"F": F, "K": K, "C": C, "D": D,
                 "rows_touched": int(torch.unique(sel).numel())}),
            registry.get("tvm_estep").cost({"M": C, "K": 3, "N": 10,
                                            "dtype": "bfloat16"})]
    assert cnt.by_op == {}     # none of the plain versions' ops
    assert [cnt.kernels[k][1:] for k in
            ("gmm_loglik", "gmm_rescore", "tvm_estep_a")] == \
        [[w[0], w[1]] for w in want]
    assert cnt.flops == sum(w[0] for w in want)
    # walked instead, the plain versions' contractions are counted
    with op_cost.OpCounter(regions=False) as plain:
        ops.gmm_loglik(x, const, lin, P)
    assert plain.kernels == {} and plain.by_op["mm"][1] > 0
    # with no counter on, the region is the plain call
    assert op_cost._ACTIVE is None
    assert torch.equal(ops.gmm_loglik(x, const, lin, P),
                       ops.gmm_loglik.__wrapped__(x, const, lin, P))


def test_op_cost_collective_bytes():
    """Collective bytes come from the mesh's by-op counts while the
    counter is on; an all-reduce crosses the links twice."""
    class FakeMesh:
        by_op = {"all-reduce": [1, 100]}

    mesh = FakeMesh()
    with op_cost.OpCounter(mesh) as cnt:
        mesh.by_op["all-reduce"][1] += 40
        mesh.by_op["all-gather"] = [1, 8]
    assert cnt.coll == {"all-reduce": 80.0, "all-gather": 8.0}
    rep = roofline.roofline_from_counts(cnt, arch="a", shape="s",
                                        mesh_desc="m", chips=1,
                                        model_flops=0.0)
    assert rep.t_collective == pytest.approx(88.0 / 450e9)


def test_op_cost_training_iteration():
    """One fused training iteration on the CPU: every kernel of its path
    is counted by the registry, and counting changes nothing."""
    from repro_torch.configs.ivector_tvm import SMOKE
    cfg = SMOKE.with_overrides(rescore="fused", estep="packed")
    g = torch.Generator().manual_seed(0)
    C, D = cfg.n_components, cfg.feat_dim
    rng = np.random.default_rng(3)
    w, m, c = _gmm(rng, C, D)
    ubm = TU.FullGMM(torch.tensor(w), torch.tensor(m), torch.tensor(c))
    feats = torch.tensor(rng.standard_normal((4, 37, D)), dtype=torch.float32)
    model = TT.init_model(g, ubm.means, ubm.covs, cfg.ivector_dim,
                          cfg.formulation)
    with op_cost.OpCounter() as cnt:
        got = TR.iteration(cfg, model, ubm, feats)[0]
    want = TR.iteration(cfg, model, ubm, feats)[0]
    assert torch.equal(got.T, want.T)
    assert {"gmm_align", "tvm_estep_l", "tvm_estep_a"} <= set(cnt.kernels)
    assert cnt.flops > sum(v[1] for v in cnt.kernels.values()) > 0
